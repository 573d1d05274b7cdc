"""ShardedVector — the mesh-sharded backend of the AbstractVector contract.

The state vector lives partitioned over mesh axis "x" (its first tensor
axis); operators are row-partitioned to match.  All solver code is inherited
unchanged from :class:`JaxVector`: the jitted kernels are pure jnp programs,
so under GSPMD the compiler partitions them across the mesh and inserts the
collectives (all-gather of x for the row-sharded matvec, psum for the inner
products) — the XLA replacement for an MPI layer (SURVEY.md §2.4).

This backend fills the scalability role that TTNS compression plays in the
reference (SURVEY.md §5 "long-context analogue"): where the reference shrinks
the state via bond truncation, here the uncompressed state is spread over the
mesh, and the SoP operator's Kronecker structure keeps the matvec feasible
without materializing H.
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..vectors.dense import JaxVector
from ..ops.operators import (AbstractOperator, DenseOperator,
                             GroupedSoPOperator, SumOfProductOperator,
                             as_operator)
from .mesh import (batched_vector_sharding, make_mesh, operator_row_sharding,
                   vector_sharding)


class ShardedVector(JaxVector):
    """A JaxVector whose array is explicitly sharded over a device mesh.

    Construction pins the sharding; downstream jnp operations propagate it
    (GSPMD), so the whole Lanczos/FEAST machinery runs mesh-parallel without
    further changes.  1-D states of any length are accepted (zero-padded up
    to the mesh's "x" extent, with operators zero-embedded to match);
    multi-axis states must have their first axis divisible by it.
    """

    #: mesh used when none is passed explicitly (set via ``set_default_mesh``)
    _default_mesh: Optional[Mesh] = None

    def __init__(self, array, options: Optional[dict] = None,
                 mesh: Optional[Mesh] = None):
        if mesh is not None and not isinstance(mesh, Mesh):
            raise TypeError(
                f"mesh must be a jax.sharding.Mesh, got {type(mesh).__name__}"
                " — note from_array(array, mesh=..., options=...) takes the"
                " mesh BEFORE the options dict")
        arr = jnp.asarray(array)
        mesh = mesh or self._mesh_of(arr) or ShardedVector._default_mesh
        if mesh is None:
            mesh = make_mesh(batch=1)
        self.mesh = mesh
        xdim = mesh.shape["x"]
        if arr.shape[0] % xdim != 0:
            if arr.ndim == 1:
                # Transparent zero padding: collective ops are unaffected
                # (padding contributes 0 to dots/norms) and operators are
                # reconciled at application time via _as_operator →
                # PaddedOperator, which keeps padding lanes exactly zero.
                pad = (-arr.shape[0]) % xdim
                arr = jnp.concatenate([arr, jnp.zeros(pad, arr.dtype)])
            else:
                raise ValueError(
                    f"first axis {arr.shape[0]} not divisible by mesh "
                    f"x={xdim}; multi-axis states cannot be zero-padded "
                    f"(flatten first, or choose a compatible mesh)")
        sharding = vector_sharding(mesh, arr.ndim)
        if getattr(arr, "sharding", None) != sharding:
            arr = jax.device_put(arr, sharding)
        super().__init__(arr, options)

    @classmethod
    def _as_operator(cls, H, ref: "ShardedVector"):
        """Coerce H, zero-embedding it when ``ref`` carries padding (its
        first axis was rounded up to the mesh extent)."""
        op = as_operator(H)
        n_pad = ref.array.shape[0] if ref.array.ndim == 1 else op.shape[0]
        if op.shape[0] < n_pad:
            from ..ops.operators import PaddedOperator
            op = PaddedOperator(op, n_pad)
        return op

    @staticmethod
    def _mesh_of(arr) -> Optional[Mesh]:
        sh = getattr(arr, "sharding", None)
        m = getattr(sh, "mesh", None)
        if m is not None and "x" in getattr(m, "shape", {}):
            return m if isinstance(m, Mesh) else None
        return None

    @classmethod
    def set_default_mesh(cls, mesh: Optional[Mesh]):
        cls._default_mesh = mesh

    @classmethod
    def from_array(cls, array, mesh: Optional[Mesh] = None,
                   options: Optional[dict] = None) -> "ShardedVector":
        return cls(array, options, mesh=mesh)

    def to_state_dict(self) -> dict:
        return {"kind": np.asarray("sharded"), "array": np.asarray(self.array)}

    @classmethod
    def _place_batch(cls, B, ref: "ShardedVector", state_axis: int = 1):
        """Distribute a stacked (nlanes, n) solve batch P("b", "x"): lanes
        split over the mesh's "b" axis (FEAST quadrature×subspace lanes,
        block-Lanczos blocks — the reference's "prime batching target",
        feast.py:189-200, taken to actual multi-chip execution), state
        dimension over "x".  GSPMD partitions the vmapped solver accordingly;
        lanes never communicate, so the "b" axis is pure speedup."""
        mesh = getattr(ref, "mesh", None)
        if mesh is None or "b" not in mesh.shape:
            return B
        if state_axis == 1:
            return jax.device_put(B, batched_vector_sharding(mesh,
                                                             B.ndim - 1))
        # split-complex (nlanes, 2, n) stacks: state dim is the LAST axis
        spec = [None] * B.ndim
        spec[0], spec[state_axis] = "b", "x"
        return jax.device_put(B, NamedSharding(mesh, P(*spec)))

    @classmethod
    def _batch_lane_pad(cls, nlanes: int, ref: "ShardedVector") -> int:
        """Lanes must divide the "b" extent for the P("b", "x") placement."""
        mesh = getattr(ref, "mesh", None)
        if mesh is None or "b" not in mesh.shape:
            return 0
        return (-nlanes) % mesh.shape["b"]

    @classmethod
    def _stack(cls, vectors: List["ShardedVector"], pad_to: Optional[int] = None):
        """Stacked basis (m, n): rows replicated over "b", columns sharded
        over "x" — the layout under which S = V V^H lowers to a local matmul
        + psum over "x"."""
        V = JaxVector._stack(vectors, pad_to=pad_to)
        mesh = getattr(vectors[0], "mesh", None)
        if mesh is not None:
            V = jax.device_put(V, NamedSharding(mesh, P(None, "x")))
        return V


def shard_operator(H, mesh: Mesh) -> AbstractOperator:
    """Place an operator's arrays on the mesh:

    * dense (n, n) → row-partitioned P("x", None) (all-gather x, sharded y);
    * SoP factors → replicated (small per-mode matrices; the state stays
      sharded over its first mode and XLA re-shards mode contractions);
    * anything else → coerced via :func:`as_operator` and returned as-is.
    """
    op = as_operator(H)
    if isinstance(op, DenseOperator):
        return DenseOperator(jax.device_put(op.mat, operator_row_sharding(mesh)))
    if isinstance(op, SumOfProductOperator):
        rep = NamedSharding(mesh, P())
        factors = [jax.device_put(f, rep) for f in op.factors]
        new = SumOfProductOperator(factors, term_chunk=None,
                                   precision=op.precision)
        new.term_chunk = op.term_chunk
        new._true_nSum = op._true_nSum
        return new
    if isinstance(op, GroupedSoPOperator):
        rep = NamedSharding(mesh, P())
        groups = [(m, [jax.device_put(f, rep) for f in facs])
                  for m, facs in op.groups]
        return GroupedSoPOperator(op.dims, groups,
                                  id_coeff=jax.device_put(op.id_coeff, rep),
                                  precision=op.precision)
    return op
