"""CH3CN production-basis ladder: targeted inexact Lanczos at N per mode
for N in {14, 28, 42}, maxD=10 — the reference's flagship documented workload
(reference: examples/ttns2_ch3cn.py:25-34, production zpve 9837.4069 cm-1 at
N=42/mode, maxD=10; dense dimension 42^12 ~ 3e19).

The ladder embeds each converged state as the guess for the next basis size
(HO-basis states keep their identity across basis sizes, so zero-padding the
MPS physical dimension IS the exact embedding), which makes the expensive
N=42 run start from a nearly-converged state.  Each rung:

  * runs targeted inexact Lanczos (shift-and-invert at sigma from the coarse
    DMRG guess) with per-iteration backend-neutral checkpoints
    (``saveEachIteration`` -> utils/checkpointing, async C++ writer),
  * appends one JSON line to ``artifacts/ch3cn_production.jsonl`` (zpve,
    error vs the reference production value, wall time, bond dims),
  * persists the converged MPS (``artifacts/ch3cn_state_N{N}.npz``) so a
    restarted run resumes the ladder instead of recomputing it.

Run:  python examples/ch3cn_production.py [N ...]      (default 14 28 42)
Env:  CH3CN_MAXD (default 10), CH3CN_MAXIT (default 2), CH3CN_L (default 4)
"""

# allow running directly from a checkout
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import json
import os
import sys
import time

import numpy as np

REF_ZPVE_CM1 = 9837.4069       # reference: examples/ttns2_ch3cn.py:25-34
ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts")
LOG = os.path.join(ART, "ch3cn_production.jsonl")


def embed_mps(tensors, n_new):
    """Zero-pad each site tensor's physical dimension to ``n_new``."""
    out = []
    for t in tensors:
        Dl, n, Dr = t.shape
        tt = np.zeros((Dl, n_new, Dr), t.dtype)
        tt[:, :min(n, n_new), :] = t[:, :min(n, n_new), :]
        out.append(tt)
    return out


def _done_rungs():
    rungs = {}
    if os.path.exists(LOG):
        for line in open(LOG):
            try:
                d = json.loads(line)
                rungs[int(d["N"])] = d
            except Exception:
                continue
    return rungs


def _state_path(N):
    return os.path.join(ART, f"ch3cn_state_N{N}.npz")


def main():
    import jax
    # host-NumPy tensor networks: keep JAX off the GPU and its memory
    jax.config.update("jax_platforms", "cpu")
    from eigensolvers_tpu import inexactLanczosDiagonalization, find_nearest
    from eigensolvers_tpu.models.molecules import ch3cn_operator
    from eigensolvers_tpu.utils.units import au2unit
    from eigensolvers_tpu.vectors.mps import MPO, MPSVector
    from eigensolvers_tpu.vectors.mps_sweeps import dmrg_eigensolve

    Ns = [int(a) for a in sys.argv[1:]] or [14, 28, 42]
    maxD = int(os.environ.get("CH3CN_MAXD", "10"))
    maxit = int(os.environ.get("CH3CN_MAXIT", "2"))
    L = int(os.environ.get("CH3CN_L", "4"))
    os.makedirs(ART, exist_ok=True)
    done = _done_rungs()

    # coarse-basis DMRG guess (small basis cannot reach the PES turnover
    # region, so the global ground-state search is safe; see
    # examples/ch3cn_targeted_lanczos.py for the full rationale)
    N_guess = 8
    t0 = time.time()
    op_g, _, _ = ch3cn_operator(N=N_guess)
    mpo_g = MPO.from_sop_compressed(op_g)
    es, xs = dmrg_eigensolve(mpo_g.tensors, [N_guess] * 12, nStates=1,
                             maxD=8, nSweep=5, convTol=1e-8, seed=1)
    sigma = float(es[0])
    print(f"guess (N={N_guess} DMRG): {float(au2unit(sigma, 'cm-1')):.4f} "
          f"cm-1 [{time.time() - t0:.0f}s]", flush=True)

    opts = {"compressArgs": {"maxD": maxD, "eps": 1e-10},
            # final-fit budget: the reference fits at maxD=L*MAX_D
            # (ttns2_ch3cn.py:37) — keeps returned Ritz vectors orthonormal
            "stateFittingArgs": {"maxD": L * maxD, "eps": 1e-10},
            "linearSystemArgs": {"linearSolver": "minres", "method": "als",
                                 "nSweep": 2, "convTol": 1e-4,
                                 "siteTol": 1e-6, "linearIter": 120,
                                 "linear_tol": 1e-3,
                                 "maxD": maxD, "eps": 1e-10}}

    prev_tensors = xs[0]
    # resume: pick up the largest already-completed rung's state
    for N in sorted(done):
        if N in Ns and os.path.exists(_state_path(N)):
            z = np.load(_state_path(N))
            prev_tensors = [z[f"t{i}"] for i in range(12)]
            print(f"resuming ladder from completed N={N}", flush=True)

    for N in Ns:
        if N in done:
            print(f"N={N}: already done "
                  f"(zpve {done[N]['zpve_cm1']:.4f} cm-1), skipping",
                  flush=True)
            continue
        t1 = time.time()
        op_p, _, _ = ch3cn_operator(N=N)
        mpo_p = MPO.from_sop_compressed(op_p)
        bonds = [t.shape[0] for t in mpo_p.tensors]
        print(f"N={N} MPO bonds {bonds} [{time.time() - t1:.0f}s]",
              flush=True)

        Y0 = MPSVector(embed_mps(prev_tensors, N), opts).normalize()
        ckpt = os.path.join(ART, f"ch3cn_ckpt_N{N}")
        t2 = time.time()
        # state-follow the embedded rung guess with maxOvlp (reference
        # workflow: maxOvlp tracking after a DMRG early-stop guess,
        # ttns2_ch3cn.py:107-113) — the tracked state cannot flip onto a
        # different root between N rungs even if another eigenvalue drifts
        # closer to sigma in the larger basis
        from eigensolvers_tpu import get_pick_function_maxOvlp
        ev, uv, status = inexactLanczosDiagonalization(
            mpo_p, Y0, sigma, L=L, maxit=maxit, eConv=1e-6,
            pick=get_pick_function_maxOvlp(Y0),
            writeOut=True, saveEachIteration=True, saveDir=ckpt,
            outFileName=os.path.join(ART, f"iterations_ch3cn_N{N}.out"),
            summaryFileName=os.path.join(ART, f"summary_ch3cn_N{N}.out"))
        wall = time.time() - t2
        e_au = float(find_nearest(ev, sigma)[1])
        zpve = float(au2unit(e_au, "cm-1"))
        rec = {"N": N, "maxD": maxD, "L": L, "maxit": maxit,
               "zpve_cm1": round(zpve, 4),
               "err_vs_ref_cm1": round(zpve - REF_ZPVE_CM1, 4),
               "ref_cm1": REF_ZPVE_CM1,
               "converged": bool(status.get("isConverged")),
               "wall_s": round(wall, 1),
               "mpo_bonds": bonds,
               "state_maxD": int(max(
                   t.shape[0] for t in uv[0].tensors))}
        with open(LOG, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"N={N} targeted ZPVE: {zpve:.4f} cm-1 "
              f"(ref {REF_ZPVE_CM1}, err {zpve - REF_ZPVE_CM1:+.4f}) "
              f"converged={rec['converged']} [{wall:.0f}s]", flush=True)

        prev_tensors = [np.asarray(t) for t in uv[0].tensors]
        np.savez(_state_path(N),
                 **{f"t{i}": t for i, t in enumerate(prev_tensors)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
