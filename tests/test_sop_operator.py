"""SoP (sum-of-products) operator: tensorized matvec vs dense oracle, and
inexact Lanczos on a SoP operator (the backend-genericity analog of the
reference's TTNS tests, unittests/test_lanczosTTNS.py — same random-SoP
strategy, exact oracle via densification).
"""

import numpy as np
import pytest

from eigensolvers_tpu import (
    JaxVector,
    SumOfProductOperator,
    inexactLanczosDiagonalization,
    calculateTarget,
    find_nearest,
)
from eigensolvers_tpu.models.synthetic import random_sop_terms


@pytest.fixture(scope="module")
def sop():
    dims = [3, 2, 3, 3, 3, 5]     # ~810-dim product space (reference scale)
    terms = random_sop_terms(nDim=6, dims=dims, nSum=3, seed=1212)
    op = SumOfProductOperator.from_terms(6, dims, terms)
    H = np.asarray(op.to_dense())
    assert np.allclose(H, H.T.conj())
    evEigh, uvEigh = np.linalg.eigh(H)
    return dict(op=op, H=H, dims=dims, evEigh=evEigh, uvEigh=uvEigh)


def test_matvec_vs_dense(sop):
    rng = np.random.RandomState(0)
    x = rng.rand(*sop["dims"])
    y_sop = np.asarray(sop["op"].matvec(x)).ravel()
    y_dense = sop["H"] @ x.ravel()
    np.testing.assert_allclose(y_sop, y_dense, atol=1e-10)


def test_matvec_chunked(sop):
    """term_chunk path must give identical results."""
    chunked = SumOfProductOperator(sop["op"].factors, term_chunk=2)
    rng = np.random.RandomState(1)
    x = rng.rand(*sop["dims"])
    np.testing.assert_allclose(np.asarray(chunked.matvec(x)).ravel(),
                               sop["H"] @ x.ravel(), atol=1e-10)


@pytest.mark.parametrize("place", [4, 8, 12, 16])
def test_lanczos_on_sop(sop, place):
    """Interior eigenpairs at 4 targets, rel-err ≤ 1e-5 and vector overlap
    (reference tolerances, test_lanczosTTNS.py:118-142)."""
    target = calculateTarget(sop["evEigh"], place)
    rng = np.random.RandomState(7)
    options = {"linearSystemArgs": {
        "linearSolver": "gmres", "linearIter": 3000, "linear_tol": 1e-3}}
    Y0 = JaxVector(rng.rand(*sop["dims"]), options)
    evL, uvL, status = inexactLanczosDiagonalization(
        sop["op"], Y0, target, L=30, maxit=20, eConv=1e-7, writeOut=False)

    target_value = find_nearest(evL, target)[1]
    closest_value = find_nearest(sop["evEigh"], target)[1]
    relError = abs(target_value - closest_value) / abs(closest_value)
    assert relError <= 1e-5

    idxE = find_nearest(sop["evEigh"], target)[0]
    idxT = find_nearest(evL, target)[0]
    vec = np.asarray(uvL[idxT].array).ravel()
    ovlp = np.vdot(vec, sop["uvEigh"][:, idxE])
    np.testing.assert_allclose(abs(ovlp), 1, rtol=1e-5)
    np.testing.assert_allclose(sop["uvEigh"][:, idxE], vec * ovlp,
                               rtol=8e-3, atol=5e-4)


def test_lanczos_preserves_tensor_shape(sop):
    """JaxVector carries the tensor shape through the whole solver."""
    rng = np.random.RandomState(2)
    Y0 = JaxVector(rng.rand(*sop["dims"]))
    target = calculateTarget(sop["evEigh"], 4)
    _, uvL, _ = inexactLanczosDiagonalization(
        sop["op"], Y0, target, L=10, maxit=2, eConv=1e-5, writeOut=False)
    assert uvL[0].array.shape == tuple(sop["dims"])


def test_fuse_sop_terms_matches_unfused(sop):
    """Mode fusion (super-mode coarsening) is exact: fused matvec,
    diagonal, and dense form all match the physical-mode operator."""
    from eigensolvers_tpu.ops.operators import (GroupedSoPOperator,
                                                fuse_sop_terms)
    dims = sop["dims"]
    terms = random_sop_terms(nDim=6, dims=dims, nSum=3, seed=1212)
    fdims, fterms, parts = fuse_sop_terms(dims, terms, target=20)
    assert [d for p in parts for d in p] == list(range(6))
    assert int(np.prod(fdims)) == int(np.prod(dims))
    fop = GroupedSoPOperator.from_terms(len(fdims), fdims, fterms)
    rng = np.random.RandomState(2)
    x = rng.rand(int(np.prod(dims)))
    np.testing.assert_allclose(np.asarray(fop.matvec(x)),
                               sop["H"] @ x, atol=1e-10)
    np.testing.assert_allclose(np.asarray(fop.diagonal()),
                               np.diagonal(sop["H"]), atol=1e-12)


def test_fuse_via_builder_ch3cn():
    """fuse= in the .op builder: CH3CN cut fused to tile-sized super-modes
    agrees with the physical operator (cites reference examples/ttns2_ch3cn.py
    for the production problem this accelerates)."""
    from eigensolvers_tpu.models.molecules import ch3cn_operator
    opA, _, _ = ch3cn_operator(N=5, nModesCut=4)
    opB, _, _ = ch3cn_operator(N=5, nModesCut=4, fuse=128)
    assert opB.dims == (125, 5)
    rng = np.random.RandomState(3)
    x = rng.rand(5 ** 4)
    np.testing.assert_allclose(np.asarray(opB.matvec(x)),
                               np.asarray(opA.matvec(x)), atol=1e-12)
