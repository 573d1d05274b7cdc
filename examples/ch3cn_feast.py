"""FEAST on compressed CH3CN: contour-integration window solve in MPS form —
the production configuration of the reference's FEAST TTNS example
(reference: examples/feast_ttns2_ch3cn.py:119 — random orthogonal tree
guesses, legendre quadrature, window given in cm-1 above the zpve,
eShift/convertUnit reporting).

The compressed backend has ``hasExactAddition=False``, so every quadrature
node runs the TWO conjugate solves (z and z̄) combined with conjugate
coefficients (Polizzi eq. 12; reference feast.py:93-101) — the example
exercises exactly the production code path the reference uses on trees.

Window selection: a short DMRG pass locates the low-lying states, then the
FEAST window is placed around the first excited multiplet; the example
cross-checks the FEAST eigenvalues against the DMRG energies.

The contour solves run as two-site ALS sweeps (``method="als"``) — the
same sweep-solver class the reference's production FEAST uses
(``LinearSystem`` sweeps, reference feast_ttns2_ch3cn.py:97-99); the
compressed-Krylov alternative (bicgstab) is ~10x slower per solve here.

Run: python examples/ch3cn_feast.py [N] [nModes] [maxD]
Defaults (N=6, nModes=5, maxD=16) run in ~2 minutes; the production setting
is N=42, all 12 modes.
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
    from eigensolvers_tpu import feastDiagonalization, select_within_range
    from eigensolvers_tpu.models.molecules import ch3cn_operator
    from eigensolvers_tpu.utils.units import au2unit, unit2au
    from eigensolvers_tpu.vectors.mps import MPO, MPSVector
    from eigensolvers_tpu.vectors.mps_sweeps import dmrg_eigensolve

    N = int(sys.argv[1]) if len(sys.argv) > 1 else 6
    nModes = int(sys.argv[2]) if len(sys.argv) > 2 else 5
    maxD = int(sys.argv[3]) if len(sys.argv) > 3 else 16
    M0 = 4                               # reference N_SUBSPACE=4
    NC = 4                               # quadrature nodes (half-contour)
    ECONV = 1e-5
    MAXIT = 4

    t0 = time.time()
    op, _, _ = ch3cn_operator(N=N, nModesCut=nModes)
    mpo = MPO.from_sop_compressed(op)
    dims = [N] * nModes
    print(f"# CH3CN N={N} modes={nModes}: MPO bonds "
          f"{[t.shape[0] for t in mpo.tensors]} [{time.time() - t0:.0f}s]")

    # locate the window: DMRG for the lowest states (guess generation, the
    # role eigenStateComputations fills in the reference)
    t1 = time.time()
    es, _ = dmrg_eigensolve(mpo.tensors, dims, nStates=4, maxD=maxD,
                            nSweep=6, convTol=1e-9, seed=20)
    zpve = float(es[0])
    excit = [float(au2unit(e - zpve, "cm-1")) for e in es]
    print(f"# DMRG states (cm-1 above zpve): {np.round(excit, 2)} "
          f"[{time.time() - t1:.0f}s]")

    # window around the first excited multiplet, in cm-1 above the zpve
    # (reference: ev_min/ev_max = unit2au(Emin/Emax + zpve), feast_ttns2:116-117)
    e_lo_cm = excit[1] - 40.0
    e_hi_cm = (excit[3] + excit[1]) / 2 if len(excit) > 3 else excit[1] + 80.0
    eMin = zpve + float(unit2au(e_lo_cm, "cm-1"))
    eMax = zpve + float(unit2au(e_hi_cm, "cm-1"))
    truth = select_within_range(np.asarray(es), eMin, eMax)[0]
    print(f"# window [{e_lo_cm:.1f}, {e_hi_cm:.1f}] cm-1 above zpve: "
          f"{len(truth)} DMRG states inside")

    # random orthogonal compressed guesses (reference: setRandom +
    # orthogonalize, feast_ttns2_ch3cn.py:104-113)
    opts = {"compressArgs": {"maxD": maxD, "eps": 1e-10},
            "linearSystemArgs": {"method": "als", "nSweep": 6,
                                 "convTol": 1e-5, "siteTol": 1e-6,
                                 "linearIter": 150, "linear_tol": 1e-4,
                                 "maxD": maxD, "eps": 1e-10}}
    Y = MPSVector.orthogonalize(
        [MPSVector.random(dims, maxD=8, options=opts, seed=20 + i)
         for i in range(M0)])

    t2 = time.time()
    ev, uv, status = feastDiagonalization(
        op, Y, NC, "legendre", eMin, eMax, ECONV, MAXIT,
        eShift=zpve, convertUnit="cm-1", writeOut=True)
    got = np.sort(select_within_range(np.asarray(ev), eMin, eMax)[0])
    got_cm = [float(au2unit(e - zpve, "cm-1")) for e in got]
    print(f"# FEAST [{time.time() - t2:.0f}s] found {len(got)} in window: "
          f"{np.round(got_cm, 3)} cm-1 above zpve "
          f"(2-solve path: flagAddition={status['flagAddition']})")
    for t in truth:
        err_cm = float(au2unit(min(abs(got - t)), "cm-1")) if len(got) else 9e9
        print(f"#   vs DMRG {float(au2unit(t - zpve, 'cm-1')):9.3f}: "
              f"|err| = {err_cm:.2e} cm-1")
    return 0


if __name__ == "__main__":
    sys.exit(main())
