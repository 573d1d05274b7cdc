"""Block-sparse (BSR/block-ELL) operator: construction, matvec oracle,
solver integration (the sparse-Hamiltonian path; SpMV is the north-star
kernel metric, BASELINE.md)."""

import numpy as np
import pytest
import scipy.sparse as sp

from eigensolvers_tpu import JaxVector, inexactLanczosDiagonalization, \
    find_nearest
from eigensolvers_tpu.ops.sparse import BSROperator


def _banded(n, bw=3, seed=0):
    rng = np.random.RandomState(seed)
    d = [rng.rand(n - abs(k)) for k in range(-bw, bw + 1)]
    H = sp.diags(d, offsets=range(-bw, bw + 1)).toarray()
    return (H + H.T) / 2


def test_from_dense_matches():
    H = _banded(200, bw=5)
    op = BSROperator.from_dense(H, block_size=32, drop_tol=0.0)
    rng = np.random.RandomState(1)
    x = rng.rand(200)
    np.testing.assert_allclose(np.asarray(op.matvec(x)), H @ x, atol=1e-11)
    np.testing.assert_allclose(np.asarray(op.to_dense()), H, atol=1e-13)


def test_from_scipy_matches():
    H = sp.csr_matrix(_banded(150, bw=2))
    op = BSROperator.from_scipy(H, block_size=64)
    rng = np.random.RandomState(2)
    x = rng.rand(150)
    np.testing.assert_allclose(np.asarray(op.matvec(x)),
                               H.toarray() @ x, atol=1e-11)


def test_drop_tol_sparsifies():
    H = _banded(128, bw=1)
    dense_blocks = BSROperator.from_dense(H, block_size=32)
    # bandwidth 1 with block 32 → at most 2-3 blocks per row-block kept
    assert dense_blocks.data.shape[1] <= 3


def test_lanczos_on_sparse():
    """Interior eigensolve through the sparse operator path."""
    n = 256
    H = _banded(n, bw=4, seed=3)
    evE = np.linalg.eigvalsh(H)
    target = float(evE[n // 2] + 0.2 * (evE[n // 2 + 1] - evE[n // 2]))
    op = BSROperator.from_dense(H, block_size=64)
    rng = np.random.RandomState(4)
    opts = {"linearSystemArgs": {"linearSolver": "minres", "linearIter": 4000,
                                 "linear_tol": 1e-4,
                                 "errorOnNonConvergence": False}}
    Y0 = JaxVector(rng.rand(n), opts)
    evL, _, st = inexactLanczosDiagonalization(
        op, Y0, target, 20, 8, 1e-7, writeOut=False)
    got = find_nearest(evL, target)[1]
    want = find_nearest(evE, target)[1]
    assert abs(got - want) <= 1e-5


def test_matmat_multi_rhs():
    """Fused multi-RHS apply (block data fetched once, reused over all
    columns) matches column-wise matvecs, including non-divisible n."""
    H = _banded(200, bw=5, seed=7)
    op = BSROperator.from_dense(H, block_size=64)
    rng = np.random.RandomState(8)
    X = rng.rand(200, 5)
    Y = np.asarray(op.matmat(X))
    np.testing.assert_allclose(Y, H @ X, atol=1e-11)
    # generic AbstractOperator.matmat default (vmap of matvec) agrees
    from eigensolvers_tpu.ops.operators import DenseOperator
    np.testing.assert_allclose(np.asarray(DenseOperator(H).matmat(X)),
                               H @ X, atol=1e-11)


def test_as_operator_accepts_scipy_sparse():
    """scipy.sparse input routes through the block-sparse operator — parity
    with the reference accepting any matmul-able H."""
    from eigensolvers_tpu import as_operator
    H = sp.csr_matrix(_banded(100, bw=2, seed=9))
    op = as_operator(H)
    rng = np.random.RandomState(0)
    x = rng.rand(100)
    np.testing.assert_allclose(np.asarray(op.matvec(x)), H @ x, atol=1e-11)


def test_banded_operator():
    """Gather-free banded matvec vs dense oracle, and a Lanczos run on a
    1-D DVR chain (kinetic + potential, the natural banded family)."""
    from eigensolvers_tpu.ops.sparse import BandedOperator
    from eigensolvers_tpu.models.bases import SincInfInf

    b = SincInfInf(SincInfInf.getOptions(N=128, xRange=[-12, 12]))
    H = -b.mat_dx2 + np.diag(b.xi ** 2)
    # truncate to a band (sinc KE decays like 1/k^2)
    bw = 40
    Hb = np.triu(np.tril(H, bw), -bw)
    op = BandedOperator.from_dense(Hb)
    assert op.bandwidth == bw
    rng = np.random.RandomState(0)
    x = rng.rand(128)
    np.testing.assert_allclose(np.asarray(op.matvec(x)), Hb @ x, atol=1e-10)
    np.testing.assert_allclose(np.asarray(op.to_dense()), Hb, atol=1e-13)

    evE = np.linalg.eigvalsh(Hb)
    target = float(evE[6] + 0.3)
    opts = {"linearSystemArgs": {"linearSolver": "minres", "linearIter": 4000,
                                 "linear_tol": 1e-5,
                                 "errorOnNonConvergence": False}}
    Y0 = JaxVector(rng.rand(128), opts)
    evL, _, _ = inexactLanczosDiagonalization(op, Y0, target, 12, 6, 1e-8,
                                              writeOut=False)
    assert abs(find_nearest(evL, target)[1] - evE[6]) <= 1e-6


def test_bsr_precision_option_roundtrip():
    """precision is part of the operator's static (aux) data: it must
    survive pytree flatten/unflatten (jit closures) and reach the einsum
    of the compiled apply."""
    import jax
    H = _banded(256, bw=3, seed=2)
    x = np.random.RandomState(0).rand(256).astype(np.float32)
    for prec in ("default", "high", "highest"):
        op = BSROperator.from_dense(H.astype(np.float32), block_size=128,
                                    precision=prec)
        leaves, treedef = jax.tree_util.tree_flatten(op)
        op2 = jax.tree_util.tree_unflatten(treedef, leaves)
        assert op2.precision == op.precision
        np.testing.assert_allclose(np.asarray(op2.matvec(x)),
                                   H.astype(np.float32) @ x, rtol=2e-4,
                                   atol=1e-3)
        hlo = jax.jit(op2.matvec).lower(x).as_text()
        if prec == "default":
            assert "precision = [HIGH" not in hlo
        else:
            assert f"precision = [{prec.upper()}," in hlo, prec


def _block_sparse_csr(n, B, nbpr, dtype, seed):
    """Random scipy CSR matrix with ``nbpr`` dense BxB blocks per block-row
    (the last block-row/column cut to n when B does not divide n)."""
    rng = np.random.RandomState(seed)
    nrb = -(-n // B)
    H = np.zeros((nrb * B, nrb * B), dtype)
    for r in range(nrb):
        for c in rng.choice(nrb, nbpr, replace=False):
            blk = rng.standard_normal((B, B))
            if np.issubdtype(dtype, np.complexfloating):
                blk = blk + 1j * rng.standard_normal((B, B))
            H[r * B:(r + 1) * B, c * B:(c + 1) * B] = blk
    return sp.csr_matrix(H[:n, :n])


def _rand(shape, dtype, rng):
    x = rng.standard_normal(shape)
    if np.issubdtype(dtype, np.complexfloating):
        x = x + 1j * rng.standard_normal(shape)
    return x.astype(dtype)


@pytest.mark.parametrize("n", [256, 200], ids=["divisible", "ragged"])
@pytest.mark.parametrize("dtype,rtol", [(np.float32, 1e-5),
                                        (np.float64, 1e-12),
                                        (np.complex128, 1e-12)])
def test_bsr_matvec_matches_scipy(n, dtype, rtol):
    """The XLA block-ELL apply against a SciPy CSR oracle, for n divisible
    and not divisible by the block size, one RHS and m stacked RHS."""
    csr = _block_sparse_csr(n, 64, 3, dtype, seed=n)
    op = BSROperator.from_scipy(csr, block_size=64)
    assert op.dtype == dtype and op.n_padded == 256
    rng = np.random.RandomState(1)
    x = _rand(n, dtype, rng)
    X = _rand((n, 4), dtype, rng)
    want = csr.astype(np.complex128) @ x.astype(np.complex128)
    Want = csr.astype(np.complex128) @ X.astype(np.complex128)
    y = np.asarray(op.matvec(x))
    Y = np.asarray(op.matmat(X))
    assert y.dtype == dtype and y.shape == (n,)
    assert Y.dtype == dtype and Y.shape == (n, 4)
    assert np.abs(y - want).max() <= rtol * np.abs(want).max()
    assert np.abs(Y - Want).max() <= rtol * np.abs(Want).max()


def test_vmap_matvec_equals_matmat():
    """Batched shifted solves vmap the single-RHS apply; XLA's batching of
    the gather+einsum must give the fused matmat's result."""
    import jax
    csr = _block_sparse_csr(200, 64, 2, np.float64, seed=5)
    op = BSROperator.from_scipy(csr, block_size=64)
    X = np.random.RandomState(6).standard_normal((200, 6))
    got = np.asarray(jax.vmap(op.matvec, in_axes=1, out_axes=1)(X))
    np.testing.assert_allclose(got, np.asarray(op.matmat(X)), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(got, csr @ X, rtol=1e-12, atol=1e-11)
