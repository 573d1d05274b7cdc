"""CH3CN N=42: HO-FBR vs HO-DVR representation check.

The production chain runs (examples/ch3cn_production.py, FBR) converge
~0.07 cm-1 ABOVE the reference's production ZPVE and do NOT move with maxD
(10 -> 16 identical to 4 decimals: artifacts/ch3cn_production.jsonl
maxd_ladder rungs) — so the offset is an operator-level representation
difference, not bond truncation.  Hypothesis: the reference's HO-DVR grid
(quadrature-approximate polynomial integrals at N=42) vs our default
quadrature-exact FBR matrices.  This script builds the SAME Hamiltonian in
HO-DVR, re-optimizes the converged FBR state by DMRG at maxD=10, and logs
the DVR ZPVE against the reference value 9837.4069 cm-1
(reference: examples/ttns2_ch3cn.py:25-34).

Appends a {"kind": "representation", ...} line to
artifacts/ch3cn_production.jsonl.
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

REF_ZPVE_CM1 = 9837.4069
ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts")
LOG = os.path.join(ART, "ch3cn_production.jsonl")


def main():
    import jax
    # host-NumPy tensor networks: keep JAX off the GPU and its memory
    jax.config.update("jax_platforms", "cpu")
    from eigensolvers_tpu.models.molecules import ch3cn_operator
    from eigensolvers_tpu.utils.units import au2unit
    from eigensolvers_tpu.vectors.mps import MPO
    from eigensolvers_tpu.vectors.mps_sweeps import dmrg_eigensolve

    N = int(os.environ.get("CH3CN_N", "42"))
    maxD = int(os.environ.get("CH3CN_MAXD", "10"))
    rep = os.environ.get("CH3CN_REP", "dvr")

    t0 = time.time()
    op, _, _ = ch3cn_operator(N=N, representation=rep)
    mpo = MPO.from_sop_compressed(op)
    print(f"N={N} rep={rep} MPO bonds {[t.shape[0] for t in mpo.tensors]} "
          f"[{time.time() - t0:.0f}s]", flush=True)

    seed_path = os.path.join(ART, f"ch3cn_state_N{N}.npz")
    x0 = None
    if os.path.exists(seed_path):
        z = np.load(seed_path)
        x0 = [z[f"t{i}"].astype(np.float64) for i in range(12)]
        print(f"seeded from FBR production state {seed_path}", flush=True)

    t1 = time.time()
    es, xs = dmrg_eigensolve(mpo.tensors, [N] * 12, x0=x0, nStates=1,
                             maxD=maxD, nSweep=12, convTol=1e-11, seed=1)
    wall = time.time() - t1
    zpve = float(au2unit(float(es[0]), "cm-1"))
    rec = {"kind": "representation", "representation": rep, "N": N,
           "maxD": maxD,
           "zpve_cm1": round(zpve, 4),
           "err_vs_ref_cm1": round(zpve - REF_ZPVE_CM1, 4),
           "ref_cm1": REF_ZPVE_CM1, "wall_s": round(wall, 1)}
    with open(LOG, "a") as f:
        f.write(json.dumps(rec) + "\n")
    print(f"rep={rep} N={N} maxD={maxD}: ZPVE {zpve:.4f} cm-1 "
          f"(ref {REF_ZPVE_CM1}, err {zpve - REF_ZPVE_CM1:+.4f}) "
          f"[{wall:.0f}s]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
