"""Compressed (MPS) targeted eigensolve of a sum-of-products Hamiltonian —
the scalable path for product spaces too large to densify.

Parity: the role of the reference's TTNS Lanczos examples
(examples/ttns2_ch3cn.py) at a test-scale cut with a dense oracle check.
"""


# allow running directly from a checkout
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys

import numpy as np


def main():
    import jax
    # host-NumPy tensor networks: keep JAX off the GPU and its memory
    jax.config.update("jax_platforms", "cpu")
    from eigensolvers_tpu import (SumOfProductOperator,
                                  inexactLanczosDiagonalization,
                                  calculateTarget, find_nearest)
    from eigensolvers_tpu.models.synthetic import random_sop_terms
    from eigensolvers_tpu.vectors.mps import MPSVector

    dims = [3, 2, 3, 3, 3, 5]
    op = SumOfProductOperator.from_terms(
        6, dims, random_sop_terms(6, dims, 3, seed=1212))
    evE = np.linalg.eigvalsh(np.asarray(op.to_dense()))
    target = float(calculateTarget(evE, 8))

    options = {"compressArgs": {"maxD": 80, "eps": 1e-12},
               "linearSystemArgs": {"linearSolver": "minres",
                                    "linearIter": 800, "linear_tol": 1e-3,
                                    "maxD": 80, "eps": 1e-12}}
    guess = MPSVector.random(dims, maxD=60, options=options, seed=7)

    ev, uv, status = inexactLanczosDiagonalization(
        op, guess, target, L=25, maxit=10, eConv=1e-7, writeOut=True)

    got = find_nearest(ev, target)[1]
    want = find_nearest(evE, target)[1]
    print(f"MPS result {got:.10f} vs dense oracle {want:.10f} "
          f"(rel err {abs(got - want) / abs(want):.1e})")
    print(f"Krylov bond dims: {status['KSmaxD']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
