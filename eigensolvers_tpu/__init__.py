"""eigensolvers_tpu — a JAX targeted-eigensolver framework.

Computes a few interior eigenpairs of huge Hermitian operators near a target
energy, without diagonalizing directly.  Provides the same capabilities as the
reference research library (see SURVEY.md): inexact shift-and-invert (block)
Lanczos and the FEAST contour-integration eigensolver, written against an
abstract vector contract so dense (JAX), mesh-sharded, and matrix-product-state
backends all run through the same solver core.

Design (accelerator-first, not a port):
  * compute path: jax / XLA — jitted batched Krylov linear solvers,
    matmul-formulated subspace assembly, SoP (sum-of-products) operator
    application as mode-wise ``dot_general`` instead of materialized matrices;
  * distribution: ``jax.sharding.Mesh`` + XLA collectives, replacing the
    reference's (absent) MPI layer;
  * double precision is enabled on import: the linear-dependence thresholds of
    the solver contract (LINDEP_DEFAULT_VALUE = 1e-14) require float64.
    Explicit float32 arrays remain in reduced precision for speed.

Algorithm semantics follow the reference implementation
(/root/reference/inexact_Lanczos.py, /root/reference/feast.py); see the
individual modules for file:line parity citations.
"""

import jax as _jax

# Non-negotiable for the 1e-14 lindep semantics (SURVEY.md §7 "hard parts").
_jax.config.update("jax_enable_x64", True)

from .vectors.abstract import AbstractVector, LINDEP_DEFAULT_VALUE
from .vectors.dense import JaxVector
from .ops.operators import (
    AbstractOperator,
    DenseOperator,
    DiagonalOperator,
    GroupedSoPOperator,
    SumOfProductOperator,
    as_operator,
)
from .solvers.lanczos import inexactLanczosDiagonalization
from .solvers.feast import feastDiagonalization
from .solvers.chebyshev import chebyshevFilteredDiagonalization
from .solvers.slicing import spectrumSlicingDiagonalization
from .utils.subspace import (
    basisTransformation,
    diagonalizeHamiltonian,
    eigenvalueResidual,
    find_nearest,
    calculateTarget,
    get_pick_function_close_to_sigma,
    get_pick_function_maxOvlp,
    lowdinOrtho,
    lowdinOrthoMatrix,
    select_within_range,
)
from .utils.quadrature import quadraturePointsWeights
from .parallel.sharded import ShardedVector
from .vectors.mps import MPSVector, MPO
from .vectors.ttns import (TTNSVector, TTNO, TreeTopology, parseTree,
                           tree_layout)
from .vectors.mps_sweeps import als_solve, dmrg_eigensolve
from .vectors.ttns_sweeps import tree_als_solve, tree_dmrg_eigensolve
from .vectors.numpy_backend import NumpyVector
from .config import (VectorOptions, LinearSystemOptions, CompressOptions,
                     LanczosConfig, FeastConfig, normalize_options)

__version__ = "0.1.0"

__all__ = [
    "AbstractVector",
    "AbstractOperator",
    "DenseOperator",
    "DiagonalOperator",
    "GroupedSoPOperator",
    "SumOfProductOperator",
    "JaxVector",
    "ShardedVector",
    "MPSVector",
    "MPO",
    "TTNSVector",
    "TTNO",
    "TreeTopology",
    "parseTree",
    "tree_layout",
    "als_solve",
    "dmrg_eigensolve",
    "tree_als_solve",
    "tree_dmrg_eigensolve",
    "NumpyVector",
    "LINDEP_DEFAULT_VALUE",
    "as_operator",
    "inexactLanczosDiagonalization",
    "feastDiagonalization",
    "chebyshevFilteredDiagonalization",
    "spectrumSlicingDiagonalization",
    "basisTransformation",
    "diagonalizeHamiltonian",
    "eigenvalueResidual",
    "find_nearest",
    "calculateTarget",
    "get_pick_function_close_to_sigma",
    "get_pick_function_maxOvlp",
    "lowdinOrtho",
    "lowdinOrthoMatrix",
    "select_within_range",
    "quadraturePointsWeights",
    "VectorOptions",
    "LinearSystemOptions",
    "CompressOptions",
    "LanczosConfig",
    "FeastConfig",
    "normalize_options",
]
