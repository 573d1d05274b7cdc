"""CH3CN production-basis bond-dimension ladder: variational ZPVE vs maxD.

The targeted-Lanczos production run (examples/ch3cn_production.py) converges
the N=42/mode chain at maxD=10 to ~0.07 cm-1 ABOVE the reference's production
value (reference: examples/ttns2_ch3cn.py:25-34, zpve 9837.4069 cm-1 at
maxD=10 on a TTNS tree) — the chain-vs-tree expressiveness gap at equal bond
dimension.  Both numbers are variational upper bounds, so the gap closes from
above by raising maxD: this ladder re-optimizes the converged N=42 state by
two-site DMRG at increasing maxD, seeded rung-to-rung, until the chain energy
drops BELOW the reference's published production value.

Artifacts: one JSON line per rung appended to
``artifacts/ch3cn_production.jsonl`` with ``"kind": "maxd_ladder"``; the
per-rung states in ``artifacts/ch3cn_state_N42_D{maxD}.npz`` (resumable).

Run:  python examples/ch3cn_maxd_ladder.py [maxD ...]   (default 10 12 14 16)
Env:  CH3CN_N (default 42), CH3CN_SWEEPS (default 8)
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


def _done_rungs(N):
    rungs = {}
    if os.path.exists(LOG):
        for line in open(LOG):
            try:
                d = json.loads(line)
                if d.get("kind") == "maxd_ladder" and int(d["N"]) == N:
                    rungs[int(d["maxD"])] = d
            except Exception:
                continue
    return rungs


def _state_path(N, D):
    return os.path.join(ART, f"ch3cn_state_N{N}_D{D}.npz")


def main():
    import jax
    # host-NumPy tensor networks: keep JAX off the GPU and its memory
    jax.config.update("jax_platforms", "cpu")
    from eigensolvers_tpu.models.molecules import ch3cn_operator
    from eigensolvers_tpu.utils.units import au2unit
    from eigensolvers_tpu.vectors.mps import MPO
    from eigensolvers_tpu.vectors.mps_sweeps import dmrg_eigensolve

    Ds = [int(a) for a in sys.argv[1:]] or [10, 12, 14, 16]
    N = int(os.environ.get("CH3CN_N", "42"))
    nSweep = int(os.environ.get("CH3CN_SWEEPS", "8"))
    os.makedirs(ART, exist_ok=True)
    done = _done_rungs(N)

    t0 = time.time()
    op, _, _ = ch3cn_operator(N=N)
    mpo = MPO.from_sop_compressed(op)
    print(f"N={N} MPO bonds {[t.shape[0] for t in mpo.tensors]} "
          f"[{time.time() - t0:.0f}s]", flush=True)

    # seed: the targeted-Lanczos production state (maxD=10), or the largest
    # already-completed ladder rung
    seed_path = os.path.join(ART, f"ch3cn_state_N{N}.npz")
    x0 = None
    if os.path.exists(seed_path):
        z = np.load(seed_path)
        x0 = [z[f"t{i}"].astype(np.float64) for i in range(12)]
        print(f"seeded from production Lanczos state {seed_path}", flush=True)
    for D in sorted(done):
        if os.path.exists(_state_path(N, D)):
            z = np.load(_state_path(N, D))
            x0 = [z[f"t{i}"] for i in range(12)]
            print(f"resuming ladder from completed maxD={D}", flush=True)

    for D in Ds:
        if D in done:
            print(f"maxD={D}: already done "
                  f"(zpve {done[D]['zpve_cm1']:.4f} cm-1), skipping",
                  flush=True)
            continue
        t1 = time.time()
        es, xs = dmrg_eigensolve(mpo.tensors, [N] * 12, x0=x0, nStates=1,
                                 maxD=D, nSweep=nSweep, convTol=1e-11, seed=1)
        wall = time.time() - t1
        zpve = float(au2unit(float(es[0]), "cm-1"))
        rec = {"kind": "maxd_ladder", "N": N, "maxD": D, "nSweep": nSweep,
               "zpve_cm1": round(zpve, 4),
               "err_vs_ref_cm1": round(zpve - REF_ZPVE_CM1, 4),
               "ref_cm1": REF_ZPVE_CM1,
               "beats_reference": bool(zpve < REF_ZPVE_CM1),
               "wall_s": round(wall, 1),
               "state_maxD": int(max(t.shape[0] for t in xs[0]))}
        with open(LOG, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"maxD={D}: ZPVE {zpve:.4f} cm-1 "
              f"(ref {REF_ZPVE_CM1}, err {zpve - REF_ZPVE_CM1:+.4f}, "
              f"beats_reference={rec['beats_reference']}) [{wall:.0f}s]",
              flush=True)
        x0 = [np.asarray(t) for t in xs[0]]
        np.savez(_state_path(N, D), **{f"t{i}": t for i, t in enumerate(x0)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
