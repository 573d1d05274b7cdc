"""Spectrum slicing: every eigenpair in a wide interval via load-balanced
FEAST windows + batched inverse-iteration polish.

The reference computes a few eigenpairs per run (one FEAST window,
reference feast.py; one Lanczos target, inexact_Lanczos.py); this is the
scale-out layer for "all levels in an energy range": a KPM density estimate
(one Chebyshev recurrence) sizes and load-balances the windows, each window
runs batched-contour FEAST, merged pairs are polished to machine precision.
"""

# allow running directly from a checkout
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys

import numpy as np


def main():
    import jax
    if "--cpu" in _sys.argv:
        jax.config.update("jax_platforms", "cpu")
    from eigensolvers_tpu import spectrumSlicingDiagonalization
    from eigensolvers_tpu.models.synthetic import known_spectrum_matrix

    n = 400
    H, ev = known_spectrum_matrix(n, eigenvalues=np.linspace(1, 2 * n, n),
                                  seed=10)
    H = np.asarray(H)
    eMin, eMax = 200.25, 320.25
    exact = ev[(ev >= eMin) & (ev <= eMax)]
    print(f"interval [{eMin}, {eMax}]: {len(exact)} true eigenvalues")

    ev_s, vec_s, st = spectrumSlicingDiagonalization(
        H, eMin, eMax, nc=8, eConv=1e-8, maxit=12, seed=3)

    print(f"windows: {len(st['windows'])}  "
          f"(KPM estimated total {st['estimated_total']:.1f})")
    for w in st["windows"]:
        lo, hi = w["window"]
        print(f"  [{lo:8.3f}, {hi:8.3f}]  est {w['estimated']:5.1f}  "
              f"m0 {w['m0']:3d}  found {w['found']}")
    print(f"found {st['found_total']} / {len(exact)}  "
          f"(dropped {st['dropped_spurious']} spurious)")
    print(f"max |ev err|: {np.abs(ev_s - exact).max():.2e}   "
          f"max residual: {st['residuals'].max():.2e}")
    print(f"converged: {st['isConverged']} "
          f"(residual-certified: {st['residual_certified']})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
