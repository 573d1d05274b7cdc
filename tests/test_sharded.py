"""Sharded backend: 1-device vs 8-device equivalence on a virtual CPU mesh.

The multi-device test the reference never had (SURVEY.md §4 "multi-node
testing"): the same seed/problem must produce the same eigenpairs through
the dense backend and through the mesh-sharded backend.
"""

import jax
import numpy as np
import pytest
import scipy.linalg as la

from eigensolvers_tpu import JaxVector, inexactLanczosDiagonalization, \
    feastDiagonalization, find_nearest, select_within_range
from eigensolvers_tpu.parallel import ShardedVector, make_mesh, shard_operator


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 CPU devices"
    return make_mesh(batch=1, shard=8)


@pytest.fixture(scope="module")
def problem():
    n = 96  # divisible by 8
    ev = np.linspace(1, 200, n)
    rng = np.random.RandomState(1212)
    Q = la.qr(rng.rand(n, n))[0]
    A = Q.T @ np.diag(ev) @ Q
    guess = rng.rand(n)
    return A, ev, guess


def _run(A, guess, vec_cls, sigma=30, **kw):
    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 1000, "linear_tol": 1e-4}}
    Y0 = vec_cls(guess, options)
    return inexactLanczosDiagonalization(
        A, Y0, sigma, 6, 4, 1e-6, writeOut=False, **kw)


def test_sharded_matches_dense(problem, mesh):
    A, ev, guess = problem
    evD, uvD, stD = _run(A, guess, JaxVector)
    ShardedVector.set_default_mesh(mesh)
    try:
        Ash = shard_operator(A, mesh)
        evS, uvS, stS = _run(Ash, guess, ShardedVector)
    finally:
        ShardedVector.set_default_mesh(None)
    # Mesh partitioning changes reduction order, so floating-point
    # trajectories differ at roundoff amplified through the inexact solves;
    # the converged eigenvalue must still agree far below eConv, the
    # unconverged Ritz values within the solve tolerance.
    tgtS, tgtD = find_nearest(evS, 30)[1], find_nearest(evD, 30)[1]
    np.testing.assert_allclose(tgtS, tgtD, rtol=1e-8)
    np.testing.assert_allclose(np.sort(evS), np.sort(evD), rtol=1e-3)
    vd = np.asarray(uvD[find_nearest(evD, 30)[0]].array)
    vs = np.asarray(uvS[find_nearest(evS, 30)[0]].array)
    ov = np.vdot(vd, vs)
    np.testing.assert_allclose(abs(ov), 1, rtol=1e-6)
    assert isinstance(uvS[0], ShardedVector)
    assert uvS[0].array.sharding.spec == uvS[0].array.sharding.spec  # sharded array round-trips


def test_sharded_accuracy(problem, mesh):
    A, ev, guess = problem
    ShardedVector.set_default_mesh(mesh)
    try:
        Ash = shard_operator(A, mesh)
        evS, _, stS = _run(Ash, guess, ShardedVector)
    finally:
        ShardedVector.set_default_mesh(None)
    target = find_nearest(evS, 30)[1]
    truth = find_nearest(ev, 30)[1]
    assert abs(target - truth) <= 1e-4
    assert stS["isConverged"]


@pytest.mark.slow
def test_sharded_feast(problem, mesh):
    A, ev, guess = problem
    n = A.shape[0]
    m0 = 6
    # errorOnNonConvergence stays at its default (True): every contour solve
    # must actually converge — the split-complex MINRES path handles the
    # near-real-axis nodes that stagnate restarted GMRES.
    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 2000, "linear_tol": 1e-4}}
    Y0 = np.stack([np.ones(n) * (i + 1) for i in range(m0)], axis=1)
    Y1 = la.qr(Y0, mode="economic")[0]
    ShardedVector.set_default_mesh(mesh)
    try:
        Ash = shard_operator(A, mesh)
        Y = [ShardedVector(Y1[:, i], options, mesh=mesh) for i in range(m0)]
        evF, uvF, st = feastDiagonalization(
            Ash, Y, 8, "legendre", 160.0, 166.0, 1e-8, 20, writeOut=False)
    finally:
        ShardedVector.set_default_mesh(None)
    for target in select_within_range(ev, 160, 166)[0]:
        assert abs(find_nearest(evF, target)[1] - target) <= 1e-4


def test_sharded_arbitrary_length(mesh):
    """A state dimension NOT divisible by the mesh extent is zero-padded
    transparently (PaddedOperator keeps padding lanes exactly zero), and the
    eigenpair matches the dense backend."""
    n = 100  # 100 % 8 != 0
    ev = np.linspace(1, 200, n)
    rng = np.random.RandomState(7)
    Q = la.qr(rng.rand(n, n))[0]
    A = Q.T @ np.diag(ev) @ Q
    guess = rng.rand(n)
    evD, YD, stD = _run(A, guess, JaxVector)
    ShardedVector.set_default_mesh(mesh)
    try:
        evS, YS, stS = _run(A, guess, ShardedVector)
    finally:
        ShardedVector.set_default_mesh(None)
    target = find_nearest(np.asarray(evD), 30)[1]
    got = find_nearest(np.asarray(evS), 30)[1]
    assert abs(got - target) < 1e-8
    # returned vectors carry padding; logical part matches dense, pad is 0
    vS = np.asarray(YS[0].array)
    assert vS.shape[0] == 104
    np.testing.assert_allclose(vS[100:], 0.0, atol=1e-12)
    vD = np.asarray(YD[0].array)
    phase = np.sign(vD @ vS[:100])
    np.testing.assert_allclose(phase * vS[:100], vD, atol=1e-6)


@pytest.mark.slow
def test_sharded_sop_lanczos(mesh):
    """Mesh-sharded state × SoP (Kronecker) operator — the scale axis that
    replaces TTNS compression (SURVEY.md §2.4 item 1): 8-device run must
    match the dense single-device run on a product-basis Hamiltonian."""
    from eigensolvers_tpu import SumOfProductOperator, find_nearest
    rng = np.random.RandomState(3)
    dims = (8, 4, 4)  # n = 128, divisible by the 8-way mesh
    terms = []
    for _ in range(5):
        modes = sorted(rng.choice(3, size=2, replace=False))
        facs = {}
        for d in modes:
            M = rng.rand(dims[d], dims[d]) - 0.5
            facs[int(d)] = (M + M.T) / 2
        terms.append((float(rng.rand() + 0.5), facs))
    op = SumOfProductOperator.from_terms(3, dims, terms)
    Hd = np.asarray(op.to_dense())
    evE = np.linalg.eigvalsh(Hd)
    sigma = float(evE[len(evE) // 2] + 0.01)
    guess = rng.rand(128)

    evD, _, _ = _run(op, guess, JaxVector, sigma=sigma)
    ShardedVector.set_default_mesh(mesh)
    try:
        from eigensolvers_tpu.parallel import shard_operator
        evS, YS, _ = _run(shard_operator(op, mesh), guess, ShardedVector,
                          sigma=sigma)
    finally:
        ShardedVector.set_default_mesh(None)
    want = find_nearest(evE, sigma)[1]
    assert abs(find_nearest(np.asarray(evD), sigma)[1] - want) < 1e-6
    assert abs(find_nearest(np.asarray(evS), sigma)[1] -
               find_nearest(np.asarray(evD), sigma)[1]) < 1e-8


@pytest.mark.slow
def test_batched_solves_use_b_axis(problem):
    """Production FEAST on a (b=2, x=4) mesh: the nk×m0 solve-lane stack must
    actually be distributed over the "b" mesh axis (P("b", "x")), lane counts
    that don't divide b must pad transparently, and the eigenvalues must
    match the dense single-device run (VERDICT r1 item 1)."""
    from jax.sharding import PartitionSpec as P
    A, ev, guess = problem
    n = A.shape[0]
    mesh24 = make_mesh(batch=2, shard=4)
    m0 = 5  # nk*m0 = 4*5 = 20 lanes; also odd m0 exercises lane padding paths
    rng = np.random.RandomState(11)
    G = la.qr(rng.rand(n, m0), mode="economic")[0]
    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 2000, "linear_tol": 1e-6}}

    # the placement hook must produce a P("b", "x")-sharded batch
    ShardedVector.set_default_mesh(mesh24)
    try:
        ref = ShardedVector(G[:, 0], options, mesh=mesh24)
        import jax.numpy as jnp
        B = ShardedVector._place_batch(jnp.zeros((20, n)), ref)
        assert B.sharding.spec == P("b", "x"), B.sharding
        assert ShardedVector._batch_lane_pad(5, ref) == 1
        assert ShardedVector._batch_lane_pad(20, ref) == 0

        # non-divisible lane count end-to-end: 3 lanes over b=2
        Ash = shard_operator(A, mesh24)
        bs = [ShardedVector(G[:, i], options, mesh=mesh24) for i in range(3)]
        xs = ShardedVector.solveBatch(Ash, bs, [30.0, 31.0, 32.0])
        assert len(xs) == 3
        for i, x in enumerate(xs):
            r = np.asarray(A @ np.asarray(x.array)) - \
                (30.0 + i) * np.asarray(x.array)
            assert np.linalg.norm(-r - G[:, i]) < 1e-4 * np.linalg.norm(G[:, i])

        # full FEAST through the b-sharded batch
        Y = [ShardedVector(G[:, i], options, mesh=mesh24) for i in range(m0)]
        evF, _, _ = feastDiagonalization(
            Ash, Y, 8, "legendre", 160.0, 166.0, 1e-8, 20, writeOut=False)
    finally:
        ShardedVector.set_default_mesh(None)
    YD = [JaxVector(G[:, i], options) for i in range(m0)]
    evD, _, _ = feastDiagonalization(
        A, YD, 8, "legendre", 160.0, 166.0, 1e-8, 20, writeOut=False)
    # only the in-window eigenvalues are converged by the FEAST filter;
    # out-of-window Ritz values are solver noise in both runs
    for target in select_within_range(ev, 160, 166)[0]:
        got = find_nearest(np.asarray(evF), target)[1]
        ref_d = find_nearest(np.asarray(evD), target)[1]
        assert abs(got - ref_d) <= 1e-7, (got, ref_d)
        assert abs(got - target) <= 1e-5


def test_batch_chunking(problem):
    """linearSystemArgs["batchChunk"] splits the lane stack into sequential
    chunks (memory control for large n) without changing results."""
    A, ev, guess = problem
    n = A.shape[0]
    rng = np.random.RandomState(13)
    G = la.qr(rng.rand(n, 6), mode="economic")[0]
    base = {"linearSystemArgs": {"linearIter": 2000, "linear_tol": 1e-8}}
    chunked = {"linearSystemArgs": {"linearIter": 2000, "linear_tol": 1e-8,
                                    "batchChunk": 2}}
    sig = [30.0 + i for i in range(6)]
    xs1 = JaxVector.solveBatch(A, [JaxVector(G[:, i], base)
                                   for i in range(6)], sig)
    xs2 = JaxVector.solveBatch(A, [JaxVector(G[:, i], chunked)
                                   for i in range(6)], sig)
    for a, b in zip(xs1, xs2):
        np.testing.assert_allclose(np.asarray(a.array), np.asarray(b.array),
                                   atol=1e-10)

    # split-complex path with chunking
    sigc = [complex(30.0, 0.5 + i) for i in range(5)]
    s1 = JaxVector.solveBatchSplit(A, [JaxVector(G[:, i], base)
                                       for i in range(5)], sigc)
    s2 = JaxVector.solveBatchSplit(A, [JaxVector(G[:, i], chunked)
                                       for i in range(5)], sigc)
    # batch shape changes XLA tiling → per-lane roundings differ at eps and
    # the ill-conditioned shifted solves amplify by kappa; agreement is
    # bounded by the solve tolerance (1e-8 rtol solves, amplified by the
    # shifted-system conditioning), not bitwise
    for a, b in zip(s1, s2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)


def test_sharded_feast_split_complex(mesh):
    """Forced split-complex FEAST through the sharded backend (the default
    route for real operators) — regression for the (2, n)
    Re/Im intermediates, which are raw arrays, not sharded states."""
    n = 96
    ev = np.linspace(1, 200, n)
    rng = np.random.RandomState(5)
    Q = la.qr(rng.rand(n, n))[0]
    A = Q.T @ np.diag(ev) @ Q
    inside = ev[(ev > 60) & (ev < 66)]
    m0 = len(inside) + 2
    G = la.qr(rng.rand(n, m0), mode="economic")[0]
    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 3000, "linear_tol": 1e-6,
        "splitComplex": True}}
    ShardedVector.set_default_mesh(mesh)
    try:
        Y = [ShardedVector(G[:, i], options) for i in range(m0)]
        evF, YF, st = feastDiagonalization(
            A, Y, 8, "legendre", 60.0, 66.0, 1e-8, 20, writeOut=False)
    finally:
        ShardedVector.set_default_mesh(None)
    evF = np.asarray(evF)
    for t in inside:
        assert np.min(np.abs(evF - t)) < 1e-4, (t, evF)
