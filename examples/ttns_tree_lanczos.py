"""Targeted eigensolve with TREE tensor-network states over a branched
topology — the tree counterpart of the MPS example.

Parity: the reference's TTNS examples run over ttns2 ``parseTree``
topologies (reference: unittests/test_lanczosTTNS.py builds a 6-leaf tree);
here the same 6-mode random-SoP problem runs through the in-repo tree
backend with a dense oracle check — first with compressed-Krylov solves,
then with the tree-ALS sweep engine (the reference's production solver
class on trees, ttnsVector.py:169-196), seeded from a tree-DMRG guess.
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
    from eigensolvers_tpu import (SumOfProductOperator, TTNSVector,
                                  inexactLanczosDiagonalization,
                                  calculateTarget, find_nearest, parseTree)
    from eigensolvers_tpu.models.synthetic import random_sop_terms

    # root with two branches; the second branch is itself a 3-node chain
    topo = parseTree([[], [[], [[]]]])
    dims = [3, 2, 3, 3, 3, 5]
    op = SumOfProductOperator.from_terms(
        6, dims, random_sop_terms(6, dims, 3, seed=1212))
    H = np.asarray(op.to_dense())
    ev = np.linalg.eigvalsh(H)
    sigma = float(calculateTarget(ev, 8))

    options = {
        "compressArgs": {"maxD": 60, "eps": 1e-10},
        "linearSystemArgs": {"linearSolver": "minres", "linearIter": 300,
                             "linear_tol": 1e-5, "maxD": 60, "eps": 1e-10},
    }
    Y0 = TTNSVector.random(topo, dims, 8, options, seed=11)
    evL, uv, status = inexactLanczosDiagonalization(
        op, Y0, sigma, 10, 6, 1e-8, writeOut=True)
    got = find_nearest(evL, sigma)[1]
    want = find_nearest(ev, sigma)[1]
    print(f"target sigma      : {sigma:.8f}")
    print(f"tree Lanczos      : {got:.10f}")
    print(f"dense eigh oracle : {want:.10f}")
    print(f"rel. error        : {abs(got - want) / abs(want):.2e}")
    print(f"converged={status['isConverged']}  KSmaxD={status['KSmaxD']}")
    assert status["isConverged"] and abs(got - want) / abs(want) < 1e-5

    # same solve through the tree-ALS sweep engine, DMRG-seeded guess
    from eigensolvers_tpu.vectors.ttns import TTNO
    from eigensolvers_tpu.vectors.ttns_sweeps import tree_dmrg_eigensolve

    als_opts = {
        "compressArgs": {"maxD": 60, "eps": 1e-10},
        "linearSystemArgs": {"method": "als", "nSweep": 12, "convTol": 1e-7,
                             "siteTol": 1e-9, "linearIter": 200,
                             "linear_tol": 1e-5, "maxD": 60, "eps": 1e-10},
    }
    es, xs = tree_dmrg_eigensolve(topo, TTNO.from_sop(topo, op).tensors,
                                  dims, nStates=1, maxD=16, nSweep=8)
    print(f"tree-DMRG ground  : {es[0]:.10f} (oracle {ev[0]:.10f})")
    Y0a = TTNSVector(xs[0], als_opts, topo=topo)
    evA, _, stA = inexactLanczosDiagonalization(
        op, Y0a, sigma, 10, 6, 1e-8, writeOut=False)
    gotA = find_nearest(evA, sigma)[1]
    print(f"tree-ALS Lanczos  : {gotA:.10f}  rel. error "
          f"{abs(gotA - want) / abs(want):.2e}  converged={stA['isConverged']}")
    assert abs(gotA - want) / abs(want) < 1e-5
    return 0


if __name__ == "__main__":
    sys.exit(main())
