"""CH3CN production pipeline: coarse-basis DMRG guess → embed → targeted
inexact Lanczos in MPS form at the production basis (42 HO functions/mode,
dense dimension 42^12 ≈ 3e19; reference config examples/ttns2_ch3cn.py:25-34,
maxD=10, zpve 9837.4069 cm-1).

Why targeted: the polynomial force field turns over at large |q|, so the
discretized operator has spurious deep states (≈ -4e5 cm-1) in any basis
large enough to reach the turnover region — a global ground-state search
(DMRG) correctly falls into them.  Shift-and-invert targeting at
sigma ≈ ZPVE suppresses those states by 1/(sigma - lambda) and converges to
the physical interior state, which is exactly the reference's production
workflow (and why this framework's headline algorithm exists).

Run: python examples/ch3cn_targeted_lanczos.py [N_guess] [N_prod] [maxD]

Cost note: at the full production basis (N_prod=42, maxD=10) one two-site
ALS matvec is ~1-2 GFLOP (W-bond 24, two open 42-dim physical indices), so
a converged run is a multi-hour single-node computation — same class as the
reference's production TTNS sweeps.  The default reduced settings
demonstrate the pipeline within minutes; scale N_prod/maxD/sweep budgets
for production accuracy.
"""


# allow running directly from a checkout
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys
import time

import numpy as np


def embed_mps(tensors, n_new):
    """Zero-pad each site tensor's physical dimension to ``n_new`` (HO-basis
    states keep their identity across basis-set sizes, so padding IS the
    exact embedding)."""
    out = []
    for t in tensors:
        Dl, n, Dr = t.shape
        tt = np.zeros((Dl, n_new, Dr), t.dtype)
        tt[:, :n, :] = t
        out.append(tt)
    return out


def main():
    import jax
    # host-NumPy tensor networks: keep JAX off the GPU and its memory
    jax.config.update("jax_platforms", "cpu")
    from eigensolvers_tpu import inexactLanczosDiagonalization, find_nearest
    from eigensolvers_tpu.models.molecules import ch3cn_operator
    from eigensolvers_tpu.utils.units import au2unit
    from eigensolvers_tpu.vectors.mps import MPO, MPSVector
    from eigensolvers_tpu.vectors.mps_sweeps import dmrg_eigensolve

    N_guess = int(sys.argv[1]) if len(sys.argv) > 1 else 8
    N_prod = int(sys.argv[2]) if len(sys.argv) > 2 else 12
    maxD = int(sys.argv[3]) if len(sys.argv) > 3 else 10

    # 1) coarse-basis DMRG ground state (small basis cannot reach the
    #    turnover region → safe global search)
    t0 = time.time()
    op_g, _, _ = ch3cn_operator(N=N_guess)
    mpo_g = MPO.from_sop_compressed(op_g)
    es, xs = dmrg_eigensolve(mpo_g.tensors, [N_guess] * 12, nStates=1,
                             maxD=8, nSweep=5, convTol=1e-8, seed=1)
    sigma = float(es[0])
    print(f"guess (N={N_guess} DMRG): "
          f"{float(au2unit(sigma, 'cm-1')):.4f} cm-1 [{time.time() - t0:.0f}s]")

    # 2) production-basis operator
    t1 = time.time()
    op_p, _, _ = ch3cn_operator(N=N_prod)
    mpo_p = MPO.from_sop_compressed(op_p)
    print(f"N={N_prod} MPO bonds "
          f"{[t.shape[0] for t in mpo_p.tensors]} [{time.time() - t1:.0f}s]")

    # 3) targeted inexact Lanczos with ALS inner sweeps at the production
    #    basis, seeded by the embedded coarse state
    opts = {"compressArgs": {"maxD": maxD, "eps": 1e-10},
            "linearSystemArgs": {"linearSolver": "minres", "method": "als",
                                 "nSweep": 2, "convTol": 1e-4,
                                 "siteTol": 1e-6, "linearIter": 120,
                                 "linear_tol": 1e-3,
                                 "maxD": maxD, "eps": 1e-10}}
    Y0 = MPSVector(embed_mps(xs[0], N_prod), opts).normalize()
    t2 = time.time()
    ev, uv, status = inexactLanczosDiagonalization(
        mpo_p, Y0, sigma, L=4, maxit=2, eConv=1e-6, writeOut=True)
    zpve = float(au2unit(find_nearest(ev, sigma)[1], "cm-1"))
    print(f"N={N_prod} targeted ZPVE: {zpve:.4f} cm-1 "
          f"[reference production value 9837.4069]  "
          f"converged={status['isConverged']} [{time.time() - t2:.0f}s]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
