"""Operator abstractions for the device compute path.

The reference passes raw ndarrays / scipy ``LinearOperator``s into the
algorithms (reference: numpyVector.py:147-154, feast.py:256).  Here operators
are small JAX pytrees with a ``matvec`` method, so they can be closed over by
``jax.jit`` / ``vmap`` / ``shard_map`` without retracing, and so the same
operator object drives the dense, sharded, and MPS backends.

* :class:`DenseOperator` — explicit (n, n) matrix; matvec is one matmul.
* :class:`DiagonalOperator` — diagonal matrix; matvec is an elementwise multiply.
* :class:`SumOfProductOperator` — H = Σ_s c_s ⊗_d A^{(d,s)}; matvec is a
  batched sequence of mode-wise ``dot_general`` contractions.  This is the
  TTNS-free way to apply product-basis Hamiltonians (e.g. MCTDH-style .op
  operators) without materializing the full matrix
  (SURVEY.md §5 "long-context analogue", reference: unittests/test_lanczosTTNS.py:45-53).
"""

from __future__ import annotations

from functools import reduce
from typing import List, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np


def resolve_precision(p):
    """Matmul precision for f32 operator applications.  "highest" is true
    f32 (~1e-7 relative matvec error).  "default" and "high" let XLA use
    faster reduced-precision products — on NVIDIA GPUs, TF32 tensor-core
    products (10-bit mantissa, ~1e-4..1e-3 relative matvec error).  An
    eigensolver's matvec IS the operator definition — silently flooring it
    at TF32 caps every solve tolerance and eigenvalue residual — so the
    framework default is "highest"; pass precision="default" where ML-grade
    accuracy is acceptable and the op is compute-bound."""
    if p is None or isinstance(p, jax.lax.Precision):
        return p
    return {"default": jax.lax.Precision.DEFAULT,
            "high": jax.lax.Precision.HIGH,
            "highest": jax.lax.Precision.HIGHEST}[str(p).lower()]


class AbstractOperator:
    """Minimal operator protocol: shape, dtype, matvec, to_dense."""

    shape: tuple
    dtype: object

    def matvec(self, x):
        raise NotImplementedError

    def matmat(self, X):
        """Apply to m stacked RHS: X (n, m) -> (n, m).  Default is a vmap of
        the matvec; operators with a cheaper fused multi-RHS path (e.g.
        :class:`~eigensolvers_tpu.ops.sparse.BSROperator`) override it."""
        return jax.vmap(self.matvec, in_axes=1, out_axes=1)(X)

    def to_dense(self):
        """Materialize as a dense (n, n) jnp array (oracle/small paths only)."""
        raise NotImplementedError

    def diagonal(self):
        """diag(H) as an (n,) array, or None when it is not cheaply
        available (used for Jacobi preconditioning of the shifted solves)."""
        return None

    # Allow ``operator @ array`` in user code.
    def __matmul__(self, x):
        return self.matvec(x)


@jax.tree_util.register_pytree_node_class
class DenseOperator(AbstractOperator):
    """Explicit dense matrix operator; the workhorse for n ≲ 10^5."""

    def __init__(self, mat, precision="highest"):
        self.mat = jnp.asarray(mat)
        self.precision = resolve_precision(precision)
        assert self.mat.ndim == 2 and self.mat.shape[0] == self.mat.shape[1], \
            f"need square matrix, got {self.mat.shape}"

    @property
    def shape(self):
        return self.mat.shape

    @property
    def dtype(self):
        return self.mat.dtype

    def matvec(self, x):
        flat = x.reshape(-1)
        # preferred_element_type keeps the product accumulating at (at least)
        # the input precision; the multiply precision is the operator's
        # (see resolve_precision — "highest" = true f32 by default).
        y = jnp.dot(self.mat, flat.astype(jnp.result_type(self.mat, flat)),
                    preferred_element_type=jnp.result_type(self.mat, flat),
                    precision=self.precision)
        return y.reshape(x.shape)

    def to_dense(self):
        return self.mat

    def diagonal(self):
        return jnp.diagonal(self.mat)

    def tree_flatten(self):
        return (self.mat,), (self.precision,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.mat = children[0]
        obj.precision = aux[0] if aux else jax.lax.Precision.HIGHEST
        return obj


@jax.tree_util.register_pytree_node_class
class DiagonalOperator(AbstractOperator):
    """Diagonal operator; matvec is elementwise."""

    def __init__(self, diag):
        self.diag = jnp.asarray(diag).reshape(-1)

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    @property
    def dtype(self):
        return self.diag.dtype

    def matvec(self, x):
        return (self.diag * x.reshape(-1)).reshape(x.shape)

    def to_dense(self):
        return jnp.diag(self.diag)

    def diagonal(self):
        return self.diag

    def tree_flatten(self):
        return (self.diag,), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.diag = children[0]
        return obj


@jax.tree_util.register_pytree_node_class
class SumOfProductOperator(AbstractOperator):
    """H = Σ_{s<nSum} ⊗_{d<nDim} A^{(d,s)}, with coefficients folded into the
    first non-identity factor of each term.

    Stored as per-mode stacked factor tensors ``factors[d]`` of shape
    (nSum, n_d, n_d), so a matvec is, for each mode d, one batched
    ``dot_general`` over the term axis — large, static-shaped contractions
    that XLA tiles onto matmul units.  Memory: the batched intermediate is
    (nSum, n) — use ``term_chunk`` to bound it for large grids.

    Role parity: the SoP operators of the reference's TTNS tests
    (reference: unittests/test_lanczosTTNS.py:45-53,
    operatornD.operatorSumOfProduct) and the MCTDH ``.op`` Hamiltonians.
    """

    def __init__(self, factors: Sequence, dims: Optional[Sequence[int]] = None,
                 term_chunk: Optional[int] = None, precision="highest"):
        """:param factors: list over modes d of arrays (nSum, n_d, n_d).
        :param term_chunk: if set, the matvec scans over the term axis in
            chunks of this size, bounding the batched intermediate to
            (term_chunk, n) elements.  Terms are zero-padded to a multiple of
            the chunk size at construction (zero terms contribute nothing).
        :param precision: matmul precision (see :func:`resolve_precision`)."""
        self.factors = [jnp.asarray(f) for f in factors]
        self.precision = resolve_precision(precision)
        assert len(self.factors) >= 1
        nSum = self.factors[0].shape[0]
        for f in self.factors:
            assert f.ndim == 3 and f.shape[0] == nSum and f.shape[1] == f.shape[2], \
                f"bad factor shape {f.shape}"
        self._true_nSum = nSum
        if term_chunk is not None and term_chunk < nSum:
            pad = (-nSum) % term_chunk
            if pad:
                self.factors = [
                    jnp.concatenate([f, jnp.zeros((pad,) + f.shape[1:], f.dtype)])
                    for f in self.factors]
        else:
            term_chunk = None
        self.term_chunk = term_chunk

    # -- construction helpers ------------------------------------------------
    @classmethod
    def from_terms(cls, nDim: int, dims: Sequence[int], terms, dtype=None,
                   term_chunk: Optional[int] = None):
        """Build from a list of terms ``(coeff, {mode_index: matrix})``;
        unspecified modes get identity factors, the coefficient is folded into
        the first mode's factor."""
        dtype = dtype or jnp.float64
        nSum = len(terms)
        stacked = []
        for d in range(nDim):
            eye = np.eye(dims[d], dtype=dtype)
            mats = []
            for (coeff, facs) in terms:
                m = np.asarray(facs.get(d, eye), dtype=dtype)
                if d == min(facs.keys(), default=0):
                    m = m * coeff
                mats.append(m)
            stacked.append(jnp.asarray(np.stack(mats)))
        return cls(stacked, term_chunk=term_chunk)

    @property
    def nDim(self):
        return len(self.factors)

    @property
    def nSum(self):
        return self.factors[0].shape[0]

    @property
    def dims(self):
        return tuple(int(f.shape[1]) for f in self.factors)

    @property
    def shape(self):
        n = int(np.prod(self.dims))
        return (n, n)

    @property
    def dtype(self):
        return jnp.result_type(*self.factors)

    def _apply_term_batch(self, factor_batch, xt, dims):
        """Apply a batch of product terms to x: (S, n_d, n_d) per mode,
        x reshaped to dims → (S, *dims) then summed over the term axis."""
        xb = jnp.broadcast_to(xt, (factor_batch[0].shape[0],) + dims)
        for d, f in enumerate(factor_batch):
            xb = jnp.moveaxis(xb, d + 1, -1)
            xb = jnp.einsum("sij,s...j->s...i", f, xb,
                            preferred_element_type=jnp.result_type(f, xb),
                            precision=self.precision)
            xb = jnp.moveaxis(xb, -1, d + 1)
        return xb.sum(axis=0)

    def matvec(self, x):
        dims = self.dims
        xt = x.reshape(dims)
        if self.term_chunk is None:
            y = self._apply_term_batch(self.factors, xt, dims)
        else:
            chunk = self.term_chunk
            nchunks = self.factors[0].shape[0] // chunk
            chunked = tuple(f.reshape((nchunks, chunk) + f.shape[1:])
                            for f in self.factors)

            def body(acc, fchunk):
                return acc + self._apply_term_batch(fchunk, xt, dims), None

            dtype = jnp.result_type(self.dtype, x.dtype)
            y, _ = jax.lax.scan(body, jnp.zeros(dims, dtype), chunked)
        return y.reshape(x.shape)

    def diagonal(self):
        """diag(⊗_d A_d) = ⊗_d diag(A_d), summed over terms — one (n,)
        vector (same footprint as a state), never materializing H."""
        diags = [jax.vmap(jnp.diagonal)(f) for f in self.factors]  # (S, n_d)
        acc = diags[0]
        for dg in diags[1:]:
            acc = (acc[:, :, None] * dg[:, None, :]).reshape(acc.shape[0], -1)
        return acc.sum(axis=0)

    def to_dense(self):
        """Materialize H as a dense matrix via Kronecker products (small
        oracle problems only)."""
        n = self.shape[0]
        out = np.zeros((n, n), dtype=np.result_type(*[np.asarray(f) for f in self.factors]))
        for s in range(self.nSum):
            term = reduce(np.kron, [np.asarray(f[s]) for f in self.factors])
            out += term
        return jnp.asarray(out)

    def tree_flatten(self):
        return tuple(self.factors), (self.term_chunk, self._true_nSum,
                                     self.precision)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.factors = list(children)
        obj.term_chunk, obj._true_nSum = aux[0], aux[1]
        obj.precision = aux[2] if len(aux) > 2 else jax.lax.Precision.HIGHEST
        return obj


@jax.tree_util.register_pytree_node_class
class GroupedSoPOperator(AbstractOperator):
    """Sum-of-products operator with terms grouped by mode support.

    Physical SoP Hamiltonians touch only a few modes per term (the MCTDH
    .op models: 2-4 active of 12 modes); applying stacked identity factors
    for the inactive modes (as the plain :class:`SumOfProductOperator`
    does) wastes most of the FLOPs.  Here terms sharing the same active-mode
    set form one batched group, and a matvec contracts only the active
    modes of each group; pure-identity terms collapse to one scalar.

    ``factors`` (property) materializes the full identity-padded stacked
    form for consumers that need it (MPO construction, sharding helpers).
    """

    def __init__(self, dims: Sequence[int], groups, id_coeff=0.0,
                 precision="highest"):
        """:param groups: list of (modes tuple, [per-active-mode arrays
        (S_g, n_d, n_d)]); :param id_coeff: summed coefficient of the pure
        identity terms; :param precision: matmul precision
        (see :func:`resolve_precision`)."""
        self._dims = tuple(int(d) for d in dims)
        self.groups = [(tuple(m), [jnp.asarray(f) for f in facs])
                       for m, facs in groups]
        self.id_coeff = jnp.asarray(id_coeff)
        self.precision = resolve_precision(precision)

    @classmethod
    def from_terms(cls, nDim: int, dims: Sequence[int], terms, dtype=None):
        """Same term format as :meth:`SumOfProductOperator.from_terms`."""
        dtype = dtype or jnp.float64
        by_support = {}
        id_coeff = 0.0
        for coeff, facs in terms:
            modes = tuple(sorted(facs.keys()))
            if not modes:
                id_coeff += coeff
                continue
            by_support.setdefault(modes, []).append((coeff, facs))
        groups = []
        for modes, group_terms in sorted(by_support.items()):
            stacked = []
            for j, d in enumerate(modes):
                mats = []
                for coeff, facs in group_terms:
                    m = np.asarray(facs[d], dtype=dtype)
                    if j == 0:
                        m = m * coeff
                    mats.append(m)
                stacked.append(np.stack(mats))
            if len(modes) == 1:
                # single-mode group: Σ_s c_s A_s is ONE matrix — presumming
                # cuts both the executed FLOPs and the (S, n) intermediate
                # traffic by S (the apply is memory-bound; see matvec)
                stacked = [stacked[0].sum(axis=0, keepdims=True)]
            groups.append((modes, [jnp.asarray(m) for m in stacked]))
        return cls(dims, groups, id_coeff=np.asarray(id_coeff, dtype))

    @property
    def dims(self):
        return self._dims

    @property
    def nDim(self):
        return len(self._dims)

    @property
    def nSum(self):
        return sum(g[1][0].shape[0] for g in self.groups) + 1

    @property
    def shape(self):
        n = int(np.prod(self._dims))
        return (n, n)

    @property
    def dtype(self):
        arrs = [f for _, facs in self.groups for f in facs]
        return jnp.result_type(self.id_coeff, *arrs) if arrs else \
            self.id_coeff.dtype

    @property
    def factors(self):
        """Full identity-padded stacked factors (for MPO/sharding
        consumers); the pure-identity coefficient becomes one extra term."""
        S_total = sum(facs[0].shape[0] for _, facs in self.groups) + 1
        out = []
        for d, n in enumerate(self._dims):
            eye = np.eye(n)
            mats = []
            for modes, facs in self.groups:
                S_g = facs[0].shape[0]
                if d in modes:
                    mats.append(np.asarray(facs[modes.index(d)]))
                else:
                    mats.append(np.broadcast_to(eye, (S_g, n, n)))
            idc = np.broadcast_to(eye, (1, n, n)).copy()
            if d == 0:
                idc = idc * np.asarray(self.id_coeff)
            mats.append(idc)
            out.append(jnp.asarray(np.concatenate(mats)))
        return out

    def matvec(self, x):
        """Per group: batched mode-wise contractions, trailing term-sum.
        An explicit fused s+j contraction on the final mode was tried and
        measured mildly SLOWER — XLA already fuses the broadcast and the
        trailing reduction into the einsum epilogues, and the two-
        contracting-dims dot forces a worse layout on the (S_g, n)
        intermediate."""
        dims = self._dims
        xt = x.reshape(dims)
        y = self.id_coeff * xt
        for modes, facs in self.groups:
            S_g = facs[0].shape[0]
            xb = jnp.broadcast_to(xt, (S_g,) + dims)
            for mode, f in zip(modes, facs):
                xb = jnp.moveaxis(xb, mode + 1, -1)
                xb = jnp.einsum("sij,s...j->s...i", f, xb,
                                preferred_element_type=jnp.result_type(f, xb),
                                precision=self.precision)
                xb = jnp.moveaxis(xb, -1, mode + 1)
            y = y + xb.sum(axis=0)
        return y.reshape(x.shape)

    def diagonal(self):
        """Per-group Kronecker of active-mode factor diagonals, broadcast
        over inactive modes; identity terms contribute id_coeff."""
        dims = self._dims
        n = int(np.prod(dims))
        out = jnp.full((n,), self.id_coeff,
                       dtype=jnp.result_type(self.dtype))
        out = out.reshape(dims)
        for modes, facs in self.groups:
            dg = [jax.vmap(jnp.diagonal)(f) for f in facs]   # (S_g, n_d)
            acc = dg[0]
            for g in dg[1:]:
                acc = (acc[:, :, None] * g[:, None, :]).reshape(acc.shape[0], -1)
            acc = acc.sum(axis=0)                            # (Π active n_d,)
            shape = [dims[d] if d in modes else 1 for d in range(len(dims))]
            out = out + acc.reshape(shape)
        return out.reshape(-1)

    def to_dense(self):
        n = self.shape[0]
        dt = np.result_type(*(np.asarray(f).dtype
                              for _, facs in self.groups for f in facs)) \
            if self.groups else np.float64
        out = np.asarray(self.id_coeff, dt) * np.eye(n, dtype=dt)
        for modes, facs in self.groups:
            S_g = facs[0].shape[0]
            for s in range(S_g):
                mats = []
                for d, nd in enumerate(self._dims):
                    if d in modes:
                        mats.append(np.asarray(facs[modes.index(d)][s]))
                    else:
                        mats.append(np.eye(nd, dtype=dt))
                out = out + reduce(np.kron, mats)
        return jnp.asarray(out)

    def tree_flatten(self):
        children = [self.id_coeff] + [f for _, facs in self.groups
                                      for f in facs]
        aux = (self._dims, tuple((m, len(facs)) for m, facs in self.groups),
               self.precision)
        return tuple(children), aux

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj._dims, meta = aux[0], aux[1]
        obj.precision = aux[2] if len(aux) > 2 else jax.lax.Precision.HIGHEST
        obj.id_coeff = children[0]
        rest = list(children[1:])
        groups = []
        for modes, nfac in meta:
            groups.append((modes, rest[:nfac]))
            rest = rest[nfac:]
        obj.groups = groups
        return obj


def fuse_sop_terms(dims: Sequence[int], terms, target: int = 256):
    """Coarsen a sum-of-products term list by fusing consecutive modes into
    super-modes of dimension ~``target``.

    A mode dimension like 12 or 14 (CH3CN HO-FBR cuts) makes every
    per-mode contraction a pass over the whole state with a tiny inner
    dimension.  Fusing consecutive modes (12x12 -> 144) gives fewer, wider
    contractions: each term's factor on a super-mode is the Kronecker
    product of its per-mode factors (identity for inactive modes *within
    an active super-mode*; super-modes with no active mode stay absent, so
    the grouped-apply FLOP saving survives).  More FLOPs per contraction
    (2*n*144 vs 2*n*12), fewer passes over the state.  On an H100 80GB
    HBM3 at a 700 W power limit, the CH3CN 7-mode N=12 cut (35.8M states,
    f32) applies in 59.5 ms fused at 256 vs 69.1 ms unfused (PERF.md).

    :param dims: per-mode dimensions
    :param terms: list of (coeff, {mode_index: matrix})
    :param target: aim for fused dimensions <= max(target, largest single
        mode)
    :returns: (fused_dims, fused_terms, partition) — partition is the list
        of original-mode index groups, for callers that need to map back
    """
    parts: List[List[int]] = []
    cur: List[int] = []
    prod = 1
    for d, nd in enumerate(dims):
        if cur and prod * int(nd) > target:
            parts.append(cur)
            cur, prod = [d], int(nd)
        else:
            cur.append(d)
            prod *= int(nd)
    if cur:
        parts.append(cur)
    fused_dims, fused_terms = regroup_sop_terms(dims, terms, parts)
    return fused_dims, fused_terms, parts


def regroup_sop_terms(dims: Sequence[int], terms, parts):
    """Regroup SoP terms onto an ARBITRARY partition of the modes.

    Generalizes the consecutive fusing of :func:`fuse_sop_terms`: ``parts``
    is a list of original-mode index groups, one per new (super-)mode, in
    any order; a group's factor is the Kronecker product of its members'
    factors (identity for inactive members).  An EMPTY group yields a
    dimension-1 virtual mode that no term touches — this is how MCTDH-style
    tree layouts with internal coordinate-free nodes (the reference's CH3CN
    tree, examples/ttns2_ch3cn_Block.py:62-76) map onto the one-mode-per-
    node tree backend.

    :returns: (new_dims, new_terms)
    """
    seen = sorted(d for p in parts for d in p)
    assert seen == list(range(len(dims))), \
        f"parts must partition modes 0..{len(dims) - 1}, got {parts}"
    new_dims = [int(np.prod([dims[d] for d in p])) if p else 1
                for p in parts]
    new_terms = []
    for coeff, facs in terms:
        new_facs = {}
        for pi, p in enumerate(parts):
            if not any(d in facs for d in p):
                continue
            mats = [np.asarray(facs[d]) if d in facs else np.eye(dims[d])
                    for d in p]
            new_facs[pi] = reduce(np.kron, mats)
        new_terms.append((coeff, new_facs))
    return new_dims, new_terms


@jax.tree_util.register_pytree_node_class
class CallableOperator(AbstractOperator):
    """Wraps a jittable matvec callable (the analogue of scipy
    LinearOperator).  ``fn`` must be traceable; captured arrays won't be
    donated/updated across calls."""

    def __init__(self, fn, shape, dtype):
        self.fn = fn
        self._shape = tuple(shape)
        self._dtype = dtype

    @property
    def shape(self):
        return self._shape

    @property
    def dtype(self):
        return self._dtype

    def matvec(self, x):
        return self.fn(x)

    def to_dense(self):
        n = self._shape[0]
        eye = jnp.eye(n, dtype=self._dtype)
        return jax.vmap(self.fn, in_axes=1, out_axes=1)(eye)

    def tree_flatten(self):
        return (), (self.fn, self._shape, self._dtype)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.fn, obj._shape, obj._dtype = aux
        return obj


@jax.tree_util.register_pytree_node_class
class PaddedOperator(AbstractOperator):
    """Zero-embeds an (n, n) operator into (n_pad, n_pad).

    Used by the sharded backend when the state dimension is not divisible by
    the mesh extent: vectors carry trailing zero padding, and the matvec
    keeps those lanes exactly zero (y[n:] = 0), so Krylov iterations started
    from zero-padded b never leave the logical subspace.  Note the shifted
    operator (sigma*I - H_pad) acts as sigma*I on the padding block, which is
    harmless for iterative solves but makes the *exact* dense path singular
    at sigma == 0 — exact solves slice back to the logical block instead.
    """

    def __init__(self, op: AbstractOperator, n_pad: int):
        assert n_pad >= op.shape[0]
        self.op = op
        self.n_pad = int(n_pad)

    @property
    def shape(self):
        return (self.n_pad, self.n_pad)

    @property
    def dtype(self):
        return self.op.dtype

    def matvec(self, x):
        n = self.op.shape[0]
        y = self.op.matvec(x[:n])
        return jnp.concatenate([y, jnp.zeros(self.n_pad - n, y.dtype)])

    def to_dense(self):
        n = self.op.shape[0]
        out = jnp.zeros((self.n_pad, self.n_pad), self.op.dtype)
        return out.at[:n, :n].set(self.op.to_dense())

    def diagonal(self):
        d = self.op.diagonal()
        if d is None:
            return None
        return jnp.concatenate(
            [d, jnp.zeros(self.n_pad - self.op.shape[0], d.dtype)])

    def tree_flatten(self):
        return (self.op,), (self.n_pad,)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        (obj.op,) = children
        (obj.n_pad,) = aux
        return obj


def as_operator(H) -> AbstractOperator:
    """Coerce a user-provided operator-like object into an AbstractOperator.

    Accepts: AbstractOperator (returned as-is), 2-D ndarray/jnp array
    (→ DenseOperator), scipy-style objects with .matvec/.shape/.dtype."""
    if isinstance(H, AbstractOperator):
        return H
    if isinstance(H, (np.ndarray, jnp.ndarray)) and np.ndim(H) == 2:
        return DenseOperator(H)
    try:
        import scipy.sparse as _sp
        if _sp.issparse(H):
            from .sparse import BSROperator
            return BSROperator.from_scipy(H)
    except ImportError:  # pragma: no cover
        pass
    if hasattr(H, "matvec") and hasattr(H, "shape"):
        dtype = getattr(H, "dtype", jnp.float64)
        return CallableOperator(H.matvec, H.shape, dtype)
    raise TypeError(f"cannot interpret {type(H)} as an operator")
