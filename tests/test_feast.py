"""FEAST on a known-spectrum dense matrix.

Strategy parity: reference unittests/test_feast.py — 100×100 synthetic with
eigenvalues linspace(1, 200), contour [160, 166] containing 3 eigenvalues,
nc=8 legendre, m0=6.  Asserts completeness (every true in-window eigenvalue
found), per-eigenvalue accuracy 1e-4, orthonormality, and eigenvector
overlap at tighter eConv.
"""

import numpy as np
import pytest
import scipy.linalg as la

from eigensolvers_tpu import (
    JaxVector,
    feastDiagonalization,
    find_nearest,
    select_within_range,
)


@pytest.fixture(scope="module")
def problem():
    n = 100
    ev = np.linspace(1, 200, n)
    rng = np.random.RandomState(10)
    Q = la.qr(rng.rand(n, n))[0]
    A = Q.T @ np.diag(ev) @ Q

    m0 = 6
    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 1000, "linear_tol": 1e-2,
        "errorOnNonConvergence": False}}
    Y0 = np.empty((n, m0))
    for i in range(m0):
        Y0[:, i] = np.ones(n) * (i + 1)
    Y1 = la.qr(Y0, mode="economic")[0]
    Y = [JaxVector(Y1[:, i], options) for i in range(m0)]

    evEigh, uvEigh = np.linalg.eigh(A)
    return dict(A=A, Y=Y, rmin=160.0, rmax=166.0, nc=8,
                evEigh=evEigh, uvEigh=uvEigh)


@pytest.fixture(scope="module", params=["batched", "sequential"])
def result(request, problem):
    p = problem
    ev, uv, status = feastDiagonalization(
        p["A"], list(p["Y"]), p["nc"], "legendre", p["rmin"], p["rmax"],
        eConv=1e-10, maxit=20, writeOut=False,
        batchQuadratureSolves=(request.param == "batched"))
    return ev, uv, status


def test_return_types(result):
    ev, uv, status = result
    assert isinstance(ev, np.ndarray)
    assert isinstance(uv, list)
    assert isinstance(uv[0], JaxVector)


def test_completeness(result, problem):
    """Every true eigenvalue inside the contour must be found."""
    ev, _, _ = result
    contour_ev = select_within_range(problem["evEigh"],
                                     problem["rmin"], problem["rmax"])[0]
    assert len(contour_ev) >= 1           # sanity: window non-trivial
    assert len(contour_ev) <= len(ev)
    for target in contour_ev:
        assert abs(find_nearest(ev, target)[1] - target) <= 1e-4


def test_orthonormal(result):
    _, uv, _ = result
    S = JaxVector.overlapMatrix(uv)
    np.testing.assert_allclose(S, np.eye(S.shape[0]), atol=1e-5)


def test_eigenvectors(problem):
    p = problem
    ev, uv, _ = feastDiagonalization(
        p["A"], list(p["Y"]), p["nc"], "legendre", p["rmin"], p["rmax"],
        eConv=1e-12, maxit=40, writeOut=False)
    contour_evs = select_within_range(p["evEigh"], p["rmin"], p["rmax"])[0]
    for target in contour_evs:
        idxE = find_nearest(p["evEigh"], target)[0]
        idxT = find_nearest(ev, target)[0]
        exactVector = p["uvEigh"][:, idxE]
        feastVector = np.asarray(uv[idxT].array)
        ovlp = np.vdot(exactVector, feastVector)
        np.testing.assert_allclose(abs(ovlp), 1, rtol=1e-2)
        np.testing.assert_allclose(exactVector, feastVector * ovlp,
                                   rtol=1e-2, atol=1e-2)


def test_feast_split_complex_matches_complex_path(problem):
    """The split-complex (all-real J-symmetrized MINRES) quadrature path —
    the default route for real symmetric operators — must
    reproduce the complex-arithmetic path's eigenvalues."""
    p = problem

    def with_opts(**kw):
        opts = dict(p["Y"][0].options)
        lsa = dict(opts["linearSystemArgs"])
        lsa.update(linear_tol=1e-8, **kw)
        opts["linearSystemArgs"] = lsa
        return [JaxVector(np.asarray(y.array), opts) for y in p["Y"]]

    # complex-arithmetic leg must be explicit: split-complex is the default
    # for real-symmetric operators on all platforms now.  Restart > n so the
    # complex GMRES is effectively full (restarted GMRES stagnates on these
    # contour-shift spectra — the reason split MINRES is the default).
    evC, _, _ = feastDiagonalization(
        p["A"], with_opts(splitComplex=False, gmresRestart=128,
                          linearIter=4000),
        p["nc"], "legendre",
        p["rmin"], p["rmax"], eConv=1e-10, maxit=20, writeOut=False)
    Ys = with_opts(splitComplex=True)
    evS, _, stS = feastDiagonalization(
        p["A"], Ys, p["nc"], "legendre", p["rmin"], p["rmax"],
        eConv=1e-10, maxit=20, writeOut=False)
    evC = np.sort(np.asarray(evC))
    evS = np.sort(np.asarray(evS))
    inside = p["evEigh"][(p["evEigh"] > p["rmin"]) & (p["evEigh"] < p["rmax"])]
    for t in inside:
        assert np.min(np.abs(evS - t)) < 1e-4
    # paths agree on the in-window eigenvalues
    for t in inside:
        c = evC[np.argmin(np.abs(evC - t))]
        s = evS[np.argmin(np.abs(evS - t))]
        assert abs(c - s) < 1e-6, (c, s)


def test_ritz_warm_start_cuts_solver_iterations(problem):
    """The Ritz warm start x0 = y/(z - ev) is near-exact once y is close to
    an eigenvector — the split-complex MINRES must converge in (strictly,
    substantially) fewer iterations than from a zero guess."""
    from eigensolvers_tpu.ops.linear_solvers import gmres_splitc_batch
    from eigensolvers_tpu.ops.operators import DenseOperator
    p = problem
    lam = float(p["evEigh"][80])
    v = p["uvEigh"][:, 80]
    rng = np.random.RandomState(4)
    # the warm start's initial residual is the EIGENRESIDUAL of y amplified
    # by (A - lam)/(z - lam) — it pays off exactly when y is close to an
    # eigenvector (late FEAST iterations), which is what this models
    noise = rng.rand(len(v)) * 1e-8
    y = v + noise
    y /= np.linalg.norm(y)
    z = complex(lam + 1.0, 2.0)
    op = DenseOperator(np.asarray(p["A"]))

    cold = gmres_splitc_batch(op, y[None, :], [z], rtol=1e-8, maxiter=2000)
    c = 1.0 / (z - lam)
    x0 = np.stack([y * c.real, y * c.imag])[None]        # (1, 2, n)
    warm = gmres_splitc_batch(op, y[None, :], [z], x0s=x0,
                              rtol=1e-8, maxiter=2000)
    assert bool(np.asarray(cold.converged)[0])
    assert bool(np.asarray(warm.converged)[0])
    it_cold = int(np.asarray(cold.iterations)[0])
    it_warm = int(np.asarray(warm.iterations)[0])
    # savings are additive (the digit gap), not multiplicative:
    # MINRES spends a shared spectral lock-in phase first
    assert it_warm < 0.8 * it_cold, (it_warm, it_cold)
    # both solutions solve the complex system
    for res in (cold, warm):
        x = np.asarray(res.x)[0]
        xc = x[0] + 1j * x[1]
        r = z * xc - p["A"] @ xc - y
        assert np.linalg.norm(r) < 1e-6 * np.linalg.norm(y)


def test_feast_warm_start_at_least_as_accurate(problem):
    """FEAST with Ritz warm starts must find the same in-window eigenvalues
    at an accuracy at or below the cold-start floor (the warm solves run 10x
    tighter precisely so the warm path cannot be the less accurate one —
    measured 1.6e-6 warm vs 3.6e-5 cold on this window)."""
    p = problem

    def run(ws):
        ev, _, _ = feastDiagonalization(
            p["A"], list(p["Y"]), p["nc"], "legendre", p["rmin"], p["rmax"],
            eConv=1e-10, maxit=20, writeOut=False, warmStartSolves=ws)
        return np.sort(np.asarray(ev))

    evW, evC = run(True), run(False)
    inside = p["evEigh"][(p["evEigh"] > p["rmin"]) & (p["evEigh"] < p["rmax"])]
    # observability: batched-path runs surface total inner-solver iterations
    _, _, st = feastDiagonalization(
        p["A"], list(p["Y"]), p["nc"], "legendre", p["rmin"], p["rmax"],
        eConv=1e-10, maxit=2, writeOut=False)
    assert st.get("solverIterations", 0) > 0
    errW = max(np.min(np.abs(evW - t)) for t in inside)
    errC = max(np.min(np.abs(evC - t)) for t in inside)
    assert errW < 1e-4, errW
    assert errW <= 1.5 * errC, (errW, errC)


@pytest.mark.slow
def test_feast_numpy_backend_warm_started_batch(problem):
    """The reference-native backend (NumpyVector, scipy solvers) through the
    batched quadrature path with warm starts: exercises the generic
    AbstractVector.solveBatch fallback — including the rtol_scale scoped
    override and raw-array Ritz warm-start wrapping (regression: the bench's
    FEAST CPU baseline crashed on these kwargs)."""
    from eigensolvers_tpu.vectors.numpy_backend import NumpyVector

    p = problem
    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 2000, "linear_tol": 1e-4,
        "linear_atol": 1e-10, "errorOnNonConvergence": False}}
    Y = [NumpyVector(np.asarray(y.array, np.float64), options)
         for y in p["Y"]]
    ev, uv, status = feastDiagonalization(
        p["A"], Y, p["nc"], "legendre", p["rmin"], p["rmax"],
        eConv=1e-8, maxit=20, writeOut=False,
        batchQuadratureSolves=True, warmStartSolves=True)
    # the scoped tolerance override must be restored
    assert options["linearSystemArgs"]["linear_tol"] == 1e-4
    true_in = select_within_range(p["evEigh"], p["rmin"], p["rmax"])[0]
    for target in true_in:
        assert abs(find_nearest(ev, target)[1] - target) <= 1e-4
