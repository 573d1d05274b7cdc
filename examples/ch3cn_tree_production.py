"""CH3CN production run on the reference's actual TREE topology: targeted
inexact Lanczos with tree-ALS inner sweeps at N per mode, on the 15-node
production tree with fused 2-mode leaves (reference:
examples/ttns2_ch3cn_Block.py:62-76; production zpve 9837.4069 cm-1 at
N=42, maxD=10 — examples/ttns2_ch3cn.py:25-34).

This is the topology-faithful counterpart of the MPS-chain ladder
(examples/ch3cn_production.py): at equal maxD a chain carries less
entanglement across the mode partition than the reference's tree, so the
tree run is the apples-to-apples accuracy comparison.

Ladder: coarse tree-DMRG guess at N_guess, then targeted Lanczos rungs at
increasing N with exact state embedding between rungs (HO-basis identity:
zero-padding each physical index; fused leaves embed via the (i, j) ->
i*N + j product-index scatter, NOT flat zero padding).

Run:  python examples/ch3cn_tree_production.py [N ...]    (default 12 24 42)
Env:  CH3CN_MAXD (default 10), CH3CN_MAXIT (default 2), CH3CN_L (default 4)
Artifacts: appends to artifacts/ch3cn_production.jsonl with
"topology": "tree"; per-rung states in artifacts/ch3cn_tree_state_N{N}.npz.
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


def embed_tree(tensors, parts, n_old, n_new):
    """Exact TTNS embedding between HO basis sizes (lives in the package:
    eigensolvers_tpu.vectors.ttns.ttns_embed_physical)."""
    from eigensolvers_tpu.vectors.ttns import ttns_embed_physical
    return ttns_embed_physical(tensors, parts, n_old, n_new)


def _done_rungs():
    rungs = {}
    if os.path.exists(LOG):
        for line in open(LOG):
            try:
                d = json.loads(line)
                if d.get("topology") == "tree" and d.get("kind") is None \
                        and not d.get("depth_confirm"):
                    rungs[int(d["N"])] = d
            except Exception:
                continue
    return rungs


def _state_path(N):
    return os.path.join(ART, f"ch3cn_tree_state_N{N}.npz")


def main():
    import jax
    # host-NumPy tensor networks: keep JAX off the GPU and its memory
    jax.config.update("jax_platforms", "cpu")
    from eigensolvers_tpu import inexactLanczosDiagonalization, find_nearest
    from eigensolvers_tpu.models.molecules import ch3cn_tree_operator
    from eigensolvers_tpu.utils.units import au2unit
    from eigensolvers_tpu.vectors.ttns import TTNSVector
    from eigensolvers_tpu.vectors.ttns_sweeps import tree_dmrg_eigensolve

    Ns = [int(a) for a in sys.argv[1:]] or [12, 24, 42]
    maxD = int(os.environ.get("CH3CN_MAXD", "10"))
    maxit = int(os.environ.get("CH3CN_MAXIT", "2"))
    L = int(os.environ.get("CH3CN_L", "4"))
    os.makedirs(ART, exist_ok=True)
    done = _done_rungs()

    # coarse-basis tree-DMRG guess (production tree, small N: the basis
    # cannot reach the PES turnover, so the global search is safe — same
    # rationale as the chain ladder)
    N_guess = 6
    t0 = time.time()
    op_g, topo, parts, _ = ch3cn_tree_operator(N=N_guess)
    from eigensolvers_tpu.vectors.ttns import TTNO
    ttno_g = TTNO.from_sop_compressed(topo, op_g)
    dims_g = [int(N_guess ** len(p)) for p in parts]
    es, xs = tree_dmrg_eigensolve(topo, ttno_g.tensors, dims_g, nStates=1,
                                  maxD=8, nSweep=6, convTol=1e-9, seed=1)
    sigma = float(es[0])
    print(f"guess (tree N={N_guess} DMRG): "
          f"{float(au2unit(sigma, 'cm-1')):.4f} cm-1 "
          f"[{time.time() - t0:.0f}s]", flush=True)

    opts = {"compressArgs": {"maxD": maxD, "eps": 1e-10},
            # final-fit budget: the reference fits at maxD=L*MAX_D
            # (ttns2_ch3cn.py:37)
            "stateFittingArgs": {"maxD": L * maxD, "eps": 1e-10},
            "linearSystemArgs": {"linearSolver": "minres", "method": "als",
                                 "nSweep": 2, "convTol": 1e-4,
                                 "siteTol": 1e-6, "linearIter": 120,
                                 "linear_tol": 1e-3,
                                 "maxD": maxD, "eps": 1e-10}}

    prev_tensors, prev_N = xs[0], N_guess
    for N in sorted(done):
        if N in Ns and os.path.exists(_state_path(N)):
            z = np.load(_state_path(N))
            prev_tensors = [z[f"t{i}"] for i in range(len(topo))]
            prev_N = N
            print(f"resuming tree ladder from completed N={N}", flush=True)

    # CH3CN_DEPTH_CONFIRM=1: re-run completed rungs at the CURRENT L/maxit
    # from their committed states — the "reference iteration depth" gate
    # (the reference pins L=10, maxit=20; the original ladder rows were
    # measured at L=4, maxit=2).  Appends a {"depth_confirm": true} row
    # instead of skipping.
    depth_confirm = os.environ.get("CH3CN_DEPTH_CONFIRM") == "1"
    for N in Ns:
        if N in done and not depth_confirm:
            print(f"tree N={N}: already done "
                  f"(zpve {done[N]['zpve_cm1']:.4f} cm-1), skipping",
                  flush=True)
            continue
        t1 = time.time()
        op_p, topo_p, parts_p, _ = ch3cn_tree_operator(N=N)
        print(f"tree N={N} operator built [{time.time() - t1:.0f}s]",
              flush=True)

        if depth_confirm and N in done and os.path.exists(_state_path(N)):
            # re-converge this rung AT ITS OWN BASIS from its committed
            # state (embedding only goes small -> large; the resume loop
            # above may have advanced prev_N past this rung)
            z = np.load(_state_path(N))
            guess_tensors = [z[f"t{i}"] for i in range(len(topo))]
        else:
            guess_tensors = embed_tree(prev_tensors, parts, prev_N, N)
        Y0 = TTNSVector(guess_tensors, opts, topo=topo_p).normalize()
        t2 = time.time()
        ev, uv, status = inexactLanczosDiagonalization(
            op_p, Y0, sigma, L=L, maxit=maxit, eConv=1e-6,
            writeOut=True,
            outFileName=os.path.join(ART, f"iterations_ch3cn_tree_N{N}.out"),
            summaryFileName=os.path.join(ART, f"summary_ch3cn_tree_N{N}.out"))
        wall = time.time() - t2
        e_au = float(find_nearest(ev, sigma)[1])
        zpve = float(au2unit(e_au, "cm-1"))
        rec = {"N": N, "topology": "tree", "maxD": maxD, "L": L,
               "maxit": maxit,
               **({"depth_confirm": True} if depth_confirm else {}),
               "zpve_cm1": round(zpve, 4),
               "err_vs_ref_cm1": round(zpve - REF_ZPVE_CM1, 4),
               "ref_cm1": REF_ZPVE_CM1,
               "converged": bool(status.get("isConverged")),
               "wall_s": round(wall, 1),
               "state_maxD": int(max(t.shape[0] for t in uv[0].tensors))}
        with open(LOG, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(f"tree N={N} targeted ZPVE: {zpve:.4f} cm-1 "
              f"(ref {REF_ZPVE_CM1}, err {zpve - REF_ZPVE_CM1:+.4f}) "
              f"converged={rec['converged']} [{wall:.0f}s]", flush=True)

        prev_tensors = [np.asarray(t) for t in uv[0].tensors]
        prev_N = N
        np.savez(_state_path(N),
                 **{f"t{i}": t for i, t in enumerate(prev_tensors)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
