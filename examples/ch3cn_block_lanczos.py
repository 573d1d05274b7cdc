"""CH3CN block inexact Lanczos: 2-block DMRG-seeded interior eigensolve in
compressed MPS form — the production configuration of the reference's
block-Lanczos CH3CN example (reference: examples/ttns2_ch3cn_Block.py:24-31 —
MAX_D=10, N_BLOCK=2, target 360 cm-1 above the zpve 9837.4069, L=10,
maxit=20, eConv=1e-6, EPS=5e-9, DMRG guesses via eigenStateComputations).

Pipeline (same as the reference):
  1. DMRG computes the N_BLOCK lowest interior-adjacent states as the block
     guess (reference: ttns2_ch3cn_Block.py:93-100).
  2. Block inexact Lanczos targets sigma = zpve + 360 cm-1 with compressed
     sweep solves, eShift/convertUnit reporting in cm-1.
  3. Final Krylov states are checkpointed (reference saves
     finalLanczosTNSs/*.h5, ttns2_ch3cn_Block.py:115-125) — here via the
     backend-neutral checkpoint writer, WITH true resume support.

Run: python examples/ch3cn_block_lanczos.py [N] [maxD] [L] [maxit]
Defaults (N=10, maxD=8, L=6, maxit=3) demonstrate the pipeline in minutes;
the production setting is N=42, maxD=10, L=10, maxit=20.
"""

# allow running directly from a checkout
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys
import time

import numpy as np


def main():
    import jax
    # host-NumPy tensor networks: keep JAX off the GPU and its memory
    jax.config.update("jax_platforms", "cpu")
    from eigensolvers_tpu import inexactLanczosDiagonalization
    from eigensolvers_tpu.models.molecules import ch3cn_operator
    from eigensolvers_tpu.utils.checkpointing import save_checkpoint
    from eigensolvers_tpu.utils.units import au2unit, unit2au
    from eigensolvers_tpu.vectors.mps import MPO, MPSVector
    from eigensolvers_tpu.vectors.mps_sweeps import dmrg_eigensolve

    N = int(sys.argv[1]) if len(sys.argv) > 1 else 10
    maxD = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    L = int(sys.argv[3]) if len(sys.argv) > 3 else 6
    maxit = int(sys.argv[4]) if len(sys.argv) > 4 else 3
    N_BLOCK = 2                          # reference ttns2_ch3cn_Block.py:25
    TARGET_CM = 360.0                    # reference ttns2_ch3cn_Block.py:26
    ECONV = 1e-6
    EPS = 5e-9

    t0 = time.time()
    op, _, _ = ch3cn_operator(N=N)
    mpo = MPO.from_sop_compressed(op)
    print(f"# CH3CN N={N}: MPO bonds {[t.shape[0] for t in mpo.tensors]} "
          f"[{time.time() - t0:.0f}s]")

    # 1) DMRG block guess (reference: eigenStateComputations with
    #    nStates=N_BLOCK, ttns2_ch3cn_Block.py:93-100)
    t1 = time.time()
    es, xs = dmrg_eigensolve(mpo.tensors, [N] * 12, nStates=N_BLOCK,
                             maxD=maxD, nSweep=4, convTol=1e-8, seed=898989)
    zpve = float(au2unit(es[0], "cm-1"))
    guesses_cm1 = [f"{float(au2unit(e, 'cm-1')):.2f}" for e in es]
    print(f"# DMRG guesses: {guesses_cm1}"
          f" cm-1 (zpve {zpve:.4f}; production reference 9837.4069)"
          f" [{time.time() - t1:.0f}s]")

    # 2) block inexact Lanczos at sigma = zpve + 360 cm-1
    opts = {"compressArgs": {"maxD": maxD, "eps": EPS},
            "linearSystemArgs": {"method": "als", "nSweep": 3,
                                 "convTol": 5e-2, "siteTol": 1e-4,
                                 "linearIter": 150, "linear_tol": 1e-2,
                                 "maxD": maxD, "eps": EPS}}
    guess = [MPSVector([t.copy() for t in x], opts) for x in xs]
    sigma = float(es[0] + unit2au(TARGET_CM, "cm-1"))
    t2 = time.time()
    ev, uv, status = inexactLanczosDiagonalization(
        op, guess, sigma, L, maxit, ECONV, checkFitTol=1e-3,
        eShift=float(es[0]), convertUnit="cm-1", writeOut=True)
    print(f"# block Lanczos [{time.time() - t2:.0f}s] "
          f"converged={status['isConverged']} "
          f"cumIter={status['cumIter']}")
    rel = np.asarray([float(au2unit(e, "cm-1")) for e in ev]) - zpve
    print(f"# eigenvalues - zpve (cm-1): {np.round(rel, 2)} "
          f"(target {TARGET_CM})")

    # 3) checkpoint the final block states (reference: finalLanczosTNSs/)
    save_checkpoint("finalLanczosMPSs", "final", uv, status,
                    eigenvalues=np.asarray(ev))
    print("# saved final states to finalLanczosMPSs/")
    return 0


if __name__ == "__main__":
    sys.exit(main())
