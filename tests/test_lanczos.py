"""Single-vector inexact Lanczos on a known-spectrum dense matrix.

Test strategy parity: reference unittests/test_lanczos.py — synthetic
H = Qᵀ Λ Q with Λ = linspace(1, 200), seed 1212, σ=30, L=6, maxit=4,
eConv=1e-6; oracle via numpy eigh.  Assertions: return types, final-basis
orthonormality (atol 1e-5), transformation identity, incremental S/H
extension vs full rebuild (atol 1e-9), eigenvalue within 1e-4 of truth,
eigenvector overlap within rtol 1e-5.
"""

import numpy as np
import pytest
import scipy.linalg as la

from eigensolvers_tpu import (
    JaxVector,
    inexactLanczosDiagonalization,
    diagonalizeHamiltonian,
    lowdinOrthoMatrix,
    find_nearest,
    get_pick_function_close_to_sigma,
)


@pytest.fixture(scope="module")
def problem():
    n = 100
    ev = np.linspace(1, 200, n)
    rng = np.random.RandomState(1212)
    Q = la.qr(rng.rand(n, n))[0]
    A = Q.T @ np.diag(ev) @ Q

    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 1000, "linear_tol": 1e-4}}
    Y0 = JaxVector(rng.rand(n), options)

    evEigh, uvEigh = np.linalg.eigh(A)
    return dict(A=A, Y0=Y0, ev=ev, evEigh=evEigh, uvEigh=uvEigh, sigma=30,
                L=6, maxit=4, eConv=1e-6)


@pytest.fixture(scope="module")
def result(problem):
    p = problem
    pick = get_pick_function_close_to_sigma(p["sigma"])
    ev, uv, status = inexactLanczosDiagonalization(
        p["A"], p["Y0"], p["sigma"], p["L"], p["maxit"], p["eConv"],
        pick=pick, writeOut=False)
    return ev, uv, status


def test_return_types(result):
    ev, uv, status = result
    assert isinstance(ev, np.ndarray)
    assert isinstance(uv, list)
    assert isinstance(uv[0], JaxVector)
    assert isinstance(status, dict)


def test_final_basis_orthonormal(result):
    ev, uv, _ = result
    S = JaxVector.overlapMatrix(uv)
    np.testing.assert_allclose(S, np.eye(S.shape[0]), atol=1e-5)


def test_transformation_matrix(result, problem):
    """uSH^H S uSH = 1."""
    ev, uv, status = result
    assert len(uv) > 1
    S = JaxVector.overlapMatrix(uv)
    Hmat = JaxVector.matrixRepresentation(problem["A"], uv)
    uS = lowdinOrthoMatrix(S, dict(status))[1]
    _, uvv = diagonalizeHamiltonian(uS, Hmat)
    uSH = uS @ uvv
    mat = uSH.conj().T @ S @ uSH
    np.testing.assert_allclose(mat, np.eye(mat.shape[0]), atol=1e-5)


def test_incremental_extension(result, problem):
    """O(m) incremental S/H extension equals the full rebuild."""
    ev, uv, _ = result
    A = problem["A"]
    Sfull = JaxVector.overlapMatrix(uv)
    S1 = JaxVector.overlapMatrix(uv[:-1])
    Sext = JaxVector.extendOverlapMatrix(uv, S1)
    np.testing.assert_allclose(Sext, Sfull, atol=1e-9)

    Hfull = JaxVector.matrixRepresentation(A, uv)
    H1 = JaxVector.matrixRepresentation(A, uv[:-1])
    Hext = JaxVector.extendMatrixRepresentation(A, uv, H1)
    np.testing.assert_allclose(Hext, Hfull, atol=1e-9)


def test_eigenvalue_accuracy(result, problem):
    ev, _, _ = result
    target_value = find_nearest(ev, problem["sigma"])[1]
    closest_value = find_nearest(problem["ev"], problem["sigma"])[1]
    assert abs(target_value - closest_value) <= 1e-4


def test_eigenvector_accuracy(result, problem):
    ev, uv, _ = result
    idxE = find_nearest(problem["evEigh"], problem["sigma"])[0]
    idxT = find_nearest(ev, problem["sigma"])[0]
    exactVector = problem["uvEigh"][:, idxE]
    lanczosVector = np.asarray(uv[idxT].array)

    ovlp = np.vdot(exactVector, lanczosVector)
    np.testing.assert_allclose(abs(ovlp), 1, rtol=1e-5)
    np.testing.assert_allclose(exactVector, lanczosVector * ovlp,
                               rtol=1e-5, atol=1e-4)


def test_converged(result):
    _, _, status = result
    assert status["isConverged"]
    assert status["residual"] <= 1e-6


def test_matrix_representation_chunks_rows(monkeypatch):
    """The stacked-basis operator apply is vectorized over chunks of rows
    when the states are large; the chunked result equals the one-shot
    result (chunk size forced down to 3 rows of a 40-row padded stack)."""
    import jax
    from eigensolvers_tpu.ops.operators import DenseOperator
    from eigensolvers_tpu.vectors import dense
    rng = np.random.RandomState(0)
    n = 24
    A = rng.rand(n, n)
    A = A + A.T
    vecs = [JaxVector(rng.rand(n)) for _ in range(40)]
    V = np.stack([np.asarray(v.array) for v in vecs])
    want = V @ (A @ V.T)
    monkeypatch.setattr(dense, "_APPLY_CHUNK_BYTES", 3 * n * 8)
    jax.clear_caches()
    got = JaxVector.matrixRepresentation(DenseOperator(A), vecs)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    AV = np.asarray(dense._apply_batch(DenseOperator(A),
                                       jax.numpy.asarray(V)))
    np.testing.assert_allclose(AV, V @ A.T, rtol=1e-12)
