"""CH3CN FLAGSHIP: targeted *excited state* at the production basis.

The reference's headline run is block inexact Lanczos at
sigma = zpve + 360 cm-1 on the 12-mode CH3CN Hamiltonian at N=42 per mode,
maxD=10, L=10, maxit=20 on the production tree topology (reference:
examples/ttns2_ch3cn.py:24-34,124-127 with eConv=1e-4, N_BLOCK=1;
examples/ttns2_ch3cn_Block.py:24-31 with eConv=1e-6, N_BLOCK=2).  The
target region holds the doubly degenerate nu8 (CCN bend) fundamental pair,
which is why the block variant tracks 2 states.

Pipeline (ladder in N with exact embedding — rung-to-rung seeding):
  1. First rung: tree-DMRG computes the ground state + the 2 lowest
     excited states (deflation); the excited pair is the block guess and
     es[0] pins the rung's zpve (reference: eigenStateComputations guess,
     ttns2_ch3cn_Block.py:93-100).
  2. Block inexact Lanczos at sigma = zpve_N + 360 cm-1 with compressed
     tree-ALS inner solves, L=10, maxit=20.
  3. Next rung: both block states embed exactly into the larger basis
     (HO-basis identity: per-mode zero padding) and re-converge.
Final-fit bond budget: stateFittingArgs maxD = L*maxD, the reference's own
production fitting budget (ttns2_ch3cn.py:37 bondAdaptFit maxD=L*MAX_D),
so the returned Ritz vectors stay orthonormal.

Run:  python examples/ch3cn_excited_production.py [N ...]  (default 12 24 42)
Env:  CH3CN_MAXD (10), CH3CN_L (10), CH3CN_MAXIT (20), CH3CN_ECONV (1e-6),
      CH3CN_NBLOCK (2), CH3CN_NSWEEP (2: inner ALS sweeps/solve)
Artifacts: appends {"kind": "excited", ...} to artifacts/ch3cn_production.jsonl;
per-rung block states in artifacts/ch3cn_tree_excited_N{N}_b{i}.npz.
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

REF_ZPVE_CM1 = 9837.4069          # reference: examples/ttns2_ch3cn.py:28
TARGET_CM = 360.0                 # reference: examples/ttns2_ch3cn.py:27
ROOT = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
ART = os.path.join(ROOT, "artifacts")
LOG = os.path.join(ART, "ch3cn_production.jsonl")


def _records():
    recs = []
    if os.path.exists(LOG):
        for line in open(LOG):
            try:
                recs.append(json.loads(line))
            except Exception:
                continue
    return recs


def _zpve_cm1(N, recs):
    """Rung zpve from the committed tree-ZPVE ladder (same basis => the
    360 cm-1 offset rides on cancelling basis error, as in the reference's
    target+zpve construction)."""
    for d in recs:
        if d.get("topology") == "tree" and d.get("kind") is None \
                and int(d.get("N", -1)) == N:
            return float(d["zpve_cm1"])
    return None


def _state_path(N, i):
    return os.path.join(ART, f"ch3cn_tree_excited_N{N}_b{i}.npz")


def main():
    import jax
    # host-NumPy tensor networks: keep JAX off the GPU and its memory
    jax.config.update("jax_platforms", "cpu")
    from eigensolvers_tpu import inexactLanczosDiagonalization
    from eigensolvers_tpu.models.molecules import ch3cn_tree_operator
    from eigensolvers_tpu.utils.units import au2unit, unit2au
    from eigensolvers_tpu.vectors.ttns import (
        TTNO, TTNSVector, ttns_embed_physical)
    from eigensolvers_tpu.vectors.ttns_sweeps import tree_dmrg_eigensolve

    Ns = [int(a) for a in sys.argv[1:]] or [12, 24, 42]
    maxD = int(os.environ.get("CH3CN_MAXD", "10"))
    L = int(os.environ.get("CH3CN_L", "10"))
    maxit = int(os.environ.get("CH3CN_MAXIT", "20"))
    eConv = float(os.environ.get("CH3CN_ECONV", "1e-6"))
    nBlock = int(os.environ.get("CH3CN_NBLOCK", "2"))
    nSweep = int(os.environ.get("CH3CN_NSWEEP", "2"))
    EPS = 1e-10
    os.makedirs(ART, exist_ok=True)
    recs = _records()
    done = {int(d["N"]): d for d in recs if d.get("kind") == "excited"}

    opts = {"compressArgs": {"maxD": maxD, "eps": EPS},
            # final-fit budget: the reference's bondAdaptFit maxD=L*MAX_D
            # (ttns2_ch3cn.py:37) — keeps the returned Ritz vectors
            # orthonormal instead of losing ~2% norm at maxD
            "stateFittingArgs": {"maxD": L * maxD, "eps": EPS},
            "linearSystemArgs": {"linearSolver": "minres", "method": "als",
                                 "nSweep": nSweep, "convTol": 1e-4,
                                 "siteTol": 1e-6, "linearIter": 120,
                                 "linear_tol": 1e-3,
                                 "maxD": maxD, "eps": EPS}}

    prev_states, prev_N = None, None
    for N in sorted(done):
        if N in Ns and all(os.path.exists(_state_path(N, i))
                           for i in range(nBlock)):
            prev_states = []
            for i in range(nBlock):
                z = np.load(_state_path(N, i))
                prev_states.append([z[f"t{j}"] for j in range(len(z.files))])
            prev_N = N
            print(f"resuming excited ladder from completed N={N}", flush=True)

    parts = None
    for N in Ns:
        if N in done:
            d = done[N]
            print(f"excited N={N}: already done "
                  f"(excitations {d['excitation_cm1']} cm-1), skipping",
                  flush=True)
            continue
        t1 = time.time()
        op, topo, parts, _ = ch3cn_tree_operator(N=N)
        print(f"excited N={N} operator built [{time.time() - t1:.0f}s]",
              flush=True)
        zpve = _zpve_cm1(N, recs)

        if prev_states is None:
            # first rung: DMRG ground + 2 excited states (the nu8 pair)
            t0 = time.time()
            ttno = TTNO.from_sop_compressed(topo, op)
            dims = [int(N ** len(p)) for p in parts]
            es, xs = tree_dmrg_eigensolve(topo, ttno.tensors, dims,
                                          nStates=nBlock + 1, maxD=maxD,
                                          nSweep=8, convTol=1e-9, seed=1)
            if zpve is None:
                zpve = float(au2unit(es[0], "cm-1"))
            exc = [float(au2unit(e, "cm-1")) - zpve for e in es[1:]]
            print(f"DMRG N={N}: zpve {zpve:.4f} cm-1, excited guesses "
                  f"{np.round(exc, 2)} cm-1 [{time.time() - t0:.0f}s]",
                  flush=True)
            guess_tensors = xs[1:nBlock + 1]
        else:
            guess_tensors = [ttns_embed_physical(s, parts, prev_N, N)
                             for s in prev_states]
        assert zpve is not None, \
            f"no tree zpve artifact for N={N}; run ch3cn_tree_production first"

        # ladder seeds live at the KRYLOV bond: the stored fitted states
        # carry the L*maxD fit bond, and matrixRepresentation on a
        # bond-100 tree guess materializes (100*opBond)^3 intermediates
        # (measured: 130 GB OOM at N=24) — compress first, the Krylov
        # iteration runs at maxD anyway
        guesses = [TTNSVector(ts, opts, topo=topo).normalize().compress()
                   for ts in guess_tensors]
        if len(guesses) > 1:
            # embedding preserves orthogonality exactly, but the DMRG pair
            # is only orthogonal to its deflation tolerance — tidy it
            guesses = TTNSVector.orthogonalize(guesses)
            assert len(guesses) == nBlock, "guess set collapsed"
        guesses = [g.normalize() for g in guesses]

        sigma = float(unit2au(zpve + TARGET_CM, "cm-1"))
        t2 = time.time()
        ev, uv, status = inexactLanczosDiagonalization(
            op, guesses, sigma, L=L, maxit=maxit, eConv=eConv,
            checkFitTol=1e-4,
            eShift=float(unit2au(zpve, "cm-1")), convertUnit="cm-1",
            writeOut=True,
            outFileName=os.path.join(ART, f"iterations_ch3cn_excited_N{N}.out"),
            summaryFileName=os.path.join(ART, f"summary_ch3cn_excited_N{N}.out"))
        wall = time.time() - t2

        order = np.argsort(np.abs(np.asarray(ev) - sigma))[:nBlock]
        ev_b = np.sort(np.real(np.asarray(ev)[order]))
        ev_cm1 = [float(au2unit(e, "cm-1")) for e in ev_b]
        excitation = [round(e - zpve, 4) for e in ev_cm1]
        rec = {"kind": "excited", "topology": "tree", "N": N, "maxD": maxD,
               "L": L, "maxit": maxit, "eConv": eConv, "nBlock": nBlock,
               "target_cm1": TARGET_CM,
               "zpve_cm1": round(zpve, 4),
               "ev_cm1": [round(e, 4) for e in ev_cm1],
               "excitation_cm1": excitation,
               "converged": bool(status.get("isConverged")),
               "residual": float(status.get("residual", np.nan)),
               "cumIter": int(status.get("cumIter", -1)),
               "wall_s": round(wall, 1),
               "state_maxD": int(max(v.maxD for v in uv[:nBlock]))}
        with open(LOG, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"excited N={N}: excitations {excitation} cm-1 "
              f"(target {TARGET_CM}) converged={rec['converged']} "
              f"residual={rec['residual']:.2e} cumIter={rec['cumIter']} "
              f"[{wall:.0f}s]", flush=True)

        prev_states = [[np.asarray(t) for t in uv[i].tensors]
                       for i in range(min(nBlock, len(uv)))]
        prev_N = N
        for i, ts in enumerate(prev_states):
            np.savez(_state_path(N, i),
                     **{f"t{j}": t for j, t in enumerate(ts)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
