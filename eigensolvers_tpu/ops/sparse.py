"""Block-sparse operators.

The reference implicitly supports sparse H through scipy's ``H @ x``
(reference: numpyVector.py:152 works with any matmul-able object); here
sparse Hamiltonians are first-class:

* :class:`BSROperator` — block-ELL layout (fixed number of BxB blocks per
  block-row, zero-padded): ``data (nrb, nbpr, B, B)``, ``idx (nrb, nbpr)``.
  The matvec gathers whole B-blocks of x, so every FLOP is a dense (B, B)
  product, not a scalar gather.  Block data is stored per-block TRANSPOSED
  (the layout the apply consumes; re-transposing at apply time would stream
  the whole array an extra time per matvec).  The apply is one XLA gather
  + batched einsum; under ``vmap`` (FEAST lane stacks, block Lanczos) XLA
  batches it into the multi-RHS contraction that :meth:`BSROperator.matmat`
  writes out, so the block data is read once per batch, not once per lane.
* :func:`from_scipy` / ``as_operator`` integration for scipy.sparse inputs.

Block size defaults to 128.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .operators import AbstractOperator, resolve_precision


@jax.tree_util.register_pytree_node_class
class BSROperator(AbstractOperator):
    """Block-ELL sparse operator (see module docstring)."""

    def __init__(self, data, idx, n: int, precision="highest"):
        """``precision`` (see :func:`.operators.resolve_precision`): the
        default "highest" is true f32 for f32 blocks; "high" and "default"
        allow XLA faster, less exact f32 products.  On an H100 80GB HBM3
        (700 W limit) XLA does not take that option for this apply: at
        n=65536, B=128, 8 blocks per row, all three give the same 1.4e-7
        relative f32 matvec error against an f64 CSR product."""
        data = jnp.asarray(data)           # (nrb, nbpr, B, B)
        # The canonical on-device layout is per-block TRANSPOSED: the apply
        # computes y_row = x_row @ block^T, and transposing at apply time
        # would materialize the whole array once per matvec.  ``data`` is
        # exposed as a (lazily re-transposed) property for the cold paths
        # (to_dense).
        self.dataT = jnp.swapaxes(data, 2, 3)
        self.idx = jnp.asarray(idx, jnp.int32)  # (nrb, nbpr) block-col ids
        self.n = int(n)                    # logical (unpadded) dimension
        assert self.dataT.ndim == 4 and self.dataT.shape[2] == self.dataT.shape[3]
        assert self.idx.shape == self.dataT.shape[:2]
        self.precision = resolve_precision(precision)

    @property
    def data(self):
        """Blocks in natural (row-major) orientation — cold paths only;
        re-transposes on access."""
        return jnp.swapaxes(self.dataT, 2, 3)

    # -- properties ---------------------------------------------------------
    @property
    def block_size(self) -> int:
        return int(self.dataT.shape[2])

    @property
    def n_padded(self) -> int:
        return int(self.dataT.shape[0] * self.block_size)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.dataT.dtype

    @property
    def nnz(self) -> int:
        """Stored element count (incl. explicit zeros in padding blocks)."""
        return int(np.prod(self.dataT.shape))

    # -- construction -------------------------------------------------------
    @classmethod
    def from_dense(cls, H, block_size: int = 128, drop_tol: float = 0.0,
                   precision="highest") -> "BSROperator":
        H = np.asarray(H)
        n = H.shape[0]
        B = block_size
        nrb = -(-n // B)
        Hp = np.zeros((nrb * B, nrb * B), H.dtype)
        Hp[:n, :n] = H
        blocks = Hp.reshape(nrb, B, nrb, B).transpose(0, 2, 1, 3)
        norms = np.abs(blocks).max(axis=(2, 3))
        keep = norms > drop_tol
        nbpr = max(1, int(keep.sum(axis=1).max()))
        data = np.zeros((nrb, nbpr, B, B), H.dtype)
        idx = np.zeros((nrb, nbpr), np.int32)
        for r in range(nrb):
            cols = np.nonzero(keep[r])[0]
            for t, c in enumerate(cols[:nbpr]):
                data[r, t] = blocks[r, c]
                idx[r, t] = c
        return cls(data, idx, n, precision=precision)

    @classmethod
    def from_scipy(cls, H, block_size: int = 128, precision="highest") -> "BSROperator":
        """Build from a scipy.sparse matrix without densifying the whole
        matrix at once (block-row streaming)."""
        import scipy.sparse as sp
        H = sp.csr_matrix(H)
        n = H.shape[0]
        B = block_size
        nrb = -(-n // B)
        ncb = nrb
        # pass 1: which blocks are nonzero
        rows, cols = H.nonzero()
        br = rows // B
        bc = cols // B
        block_ids = {}
        for r, c in zip(br, bc):
            block_ids.setdefault(int(r), set()).add(int(c))
        nbpr = max(1, max((len(v) for v in block_ids.values()), default=1))
        data = np.zeros((nrb, nbpr, B, B), H.dtype)
        idx = np.zeros((nrb, nbpr), np.int32)
        for r in range(nrb):
            cset = sorted(block_ids.get(r, []))
            rl = r * B
            rh = min((r + 1) * B, n)
            strip = H[rl:rh]
            for t, c in enumerate(cset):
                cl = c * B
                ch = min((c + 1) * B, n)
                data[r, t, :rh - rl, :ch - cl] = strip[:, cl:ch].toarray()
                idx[r, t] = c
        return cls(data, idx, n, precision=precision)

    # -- apply ------------------------------------------------------------
    def matvec(self, x):
        flat = x.reshape(-1)
        dtype = jnp.result_type(self.dtype, flat.dtype)
        xp = jnp.zeros(self.n_padded, dtype).at[:self.n].set(flat.astype(dtype))
        yp = _bsr_matvec_xla(self.dataT.astype(dtype), self.idx, xp,
                             precision=self.precision)
        return yp[:self.n].reshape(x.shape)

    def matmat(self, X):
        """Apply to m stacked RHS at once: X (n, m) -> (n, m).

        One gather + one einsum — the block data is fetched once and reused
        across all m columns (the multi-RHS bandwidth ceiling the single-RHS
        path cannot reach)."""
        X = jnp.asarray(X)
        assert X.ndim == 2 and X.shape[0] == self.n, f"bad RHS shape {X.shape}"
        dtype = jnp.result_type(self.dtype, X.dtype)
        npad = self.n_padded
        Xp = jnp.zeros((X.shape[1], npad), dtype).at[:, :self.n].set(
            X.T.astype(dtype))
        Yp = _bsr_matmat_xla(self.dataT.astype(dtype), self.idx, Xp,
                             precision=self.precision)
        return Yp[:, :self.n].T

    def diagonal(self):
        """diag(H): pick the (i, i) entries of the diagonal blocks (block
        rows where idx[r, t] == r), one vectorized gather."""
        nrb, nbpr, B, _ = self.dataT.shape
        is_diag = (self.idx == jnp.arange(nrb, dtype=self.idx.dtype)[:, None])
        # a block's diagonal is transpose-invariant, so dataT serves directly
        blk_diags = self.dataT.reshape(nrb, nbpr, B * B)[
            :, :, jnp.arange(B) * (B + 1)]                      # (nrb, nbpr, B)
        d = jnp.where(is_diag[:, :, None], blk_diags, 0).sum(axis=1)
        return d.reshape(-1)[:self.n]

    def to_dense(self):
        nrb, nbpr, B, _ = self.dataT.shape
        out = np.zeros((self.n_padded, self.n_padded),
                       np.dtype(self.dataT.dtype.name))
        dataT = np.asarray(self.dataT)
        idx = np.asarray(self.idx)
        for r in range(nrb):
            for t in range(nbpr):
                c = idx[r, t]
                out[r * B:(r + 1) * B, c * B:(c + 1) * B] += dataT[r, t].T
        return jnp.asarray(out[:self.n, :self.n])

    def tree_flatten(self):
        return (self.dataT, self.idx), (self.n, self.precision)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        obj.dataT, obj.idx = children
        obj.n, obj.precision = aux
        return obj


@functools.partial(jax.jit, static_argnames=("precision",))
def _bsr_matvec_xla(dataT, idx, xp, precision=None):
    """Gather the needed x blocks, one batched einsum.  Blocks
    arrive per-block TRANSPOSED (the operator's canonical layout); the
    einsum contracts their first in-block axis, so no re-transpose is
    materialized."""
    nrb, nbpr, B, _ = dataT.shape
    xb = xp.reshape(-1, B)            # (ncb, B)
    gathered = xb[idx]                # (nrb, nbpr, B)
    y = jnp.einsum("rtji,rtj->ri", dataT, gathered,
                   preferred_element_type=dataT.dtype,
                   precision=precision)
    return y.reshape(-1)


@functools.partial(jax.jit, static_argnames=("precision",))
def _bsr_matmat_xla(dataT, idx, Xp, precision=None):
    """Multi-RHS apply: Xp (m, npad) -> (m, npad).  The gathered x blocks
    carry the RHS axis, so the contraction is one einsum with full
    block-data reuse over m.  Blocks arrive transposed (see above)."""
    nrb, nbpr, B, _ = dataT.shape
    m = Xp.shape[0]
    Xb = Xp.reshape(m, -1, B)          # (m, ncb, B)
    gathered = Xb[:, idx]              # (m, nrb, nbpr, B)
    y = jnp.einsum("rtji,mrtj->mri", dataT, gathered,
                   preferred_element_type=dataT.dtype,
                   precision=precision)
    return y.reshape(m, -1)


@jax.tree_util.register_pytree_node_class
class BandedOperator(AbstractOperator):
    """Banded operator: H[i, i + offsets[j]] = bands[j, i].

    The matvec is gather-free — each diagonal contributes
    ``bands[j] * x[d_j : d_j + n]`` of a zero-padded x, i.e. static slices
    and elementwise multiplies that XLA fuses into one pass.  The
    natural form for 1-D DVR chains (kinetic + potential) and
    finite-difference Hamiltonians.
    """

    def __init__(self, bands, offsets, n: int):
        self.bands = jnp.asarray(bands)          # (k, n)
        self.offsets = tuple(int(o) for o in offsets)
        self.n = int(n)
        assert self.bands.shape == (len(self.offsets), self.n)

    @classmethod
    def from_dense(cls, H, tol: float = 0.0) -> "BandedOperator":
        H = np.asarray(H)
        n = H.shape[0]
        offsets = []
        bands = []
        for d in range(-(n - 1), n):
            diag = np.diagonal(H, offset=d)
            if np.any(np.abs(diag) > tol):
                offsets.append(d)
                row = np.zeros(n, H.dtype)
                if d >= 0:
                    row[:n - d] = diag
                else:
                    row[-d:] = diag
                bands.append(row)
        return cls(np.stack(bands), offsets, n)

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.bands.dtype

    @property
    def bandwidth(self):
        return max(abs(o) for o in self.offsets)

    def matvec(self, x):
        flat = x.reshape(-1)
        dtype = jnp.result_type(self.dtype, flat.dtype)
        m = self.bandwidth
        xp = jnp.concatenate([jnp.zeros(m, dtype), flat.astype(dtype),
                              jnp.zeros(m, dtype)])
        y = jnp.zeros(self.n, dtype)
        for j, d in enumerate(self.offsets):     # static unroll, XLA fuses
            y = y + self.bands[j].astype(dtype) * \
                jax.lax.dynamic_slice_in_dim(xp, m + d, self.n)
        return y.reshape(x.shape)

    def diagonal(self):
        if 0 in self.offsets:
            return self.bands[self.offsets.index(0)]
        return jnp.zeros(self.n, self.dtype)

    def to_dense(self):
        out = np.zeros((self.n, self.n), np.dtype(self.bands.dtype.name))
        bands = np.asarray(self.bands)
        for j, d in enumerate(self.offsets):
            idx = np.arange(self.n)
            cols = idx + d
            ok = (cols >= 0) & (cols < self.n)
            out[idx[ok], cols[ok]] = bands[j][idx[ok]]
        return jnp.asarray(out)

    def tree_flatten(self):
        return (self.bands,), (self.offsets, self.n)

    @classmethod
    def tree_unflatten(cls, aux, children):
        obj = object.__new__(cls)
        (obj.bands,) = children
        obj.offsets, obj.n = aux
        return obj
