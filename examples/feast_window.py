"""FEAST window search on a dense known-spectrum matrix.

Parity: reference feast.py __main__ demo (window [160,166], nc=8 legendre).
"""


# allow running directly from a checkout
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import sys

import numpy as np
import scipy.linalg as la


def main():
    import jax
    if "--cpu" in _sys.argv:
        jax.config.update("jax_platforms", "cpu")
    from eigensolvers_tpu import (JaxVector, feastDiagonalization,
                                  select_within_range)
    from eigensolvers_tpu.models.synthetic import known_spectrum_matrix

    n, m0 = 100, 6
    H, ev = known_spectrum_matrix(n, eigenvalues=np.linspace(1, 200, n),
                                  seed=10)
    ev_min, ev_max = 160.0, 166.0
    options = {"linearSystemArgs": {
        "linearSolver": "gcrotmk", "linearIter": 1000, "linear_tol": 1e-2,
        "errorOnNonConvergence": False}}
    Y0 = np.stack([np.ones(n) * (i + 1) for i in range(m0)], axis=1)
    Y1 = la.qr(Y0, mode="economic")[0]
    Y = [JaxVector(Y1[:, i], options) for i in range(m0)]

    print("--- actual eigenvalues",
          select_within_range(ev, ev_min, ev_max)[0], "---\n")
    efeast, ufeast, status = feastDiagonalization(
        H, Y, 8, "legendre", ev_min, ev_max, 1e-6, 10, writeOut=True)
    print("\n--- feast eigenvalues",
          np.sort(select_within_range(efeast, ev_min, ev_max)[0]), "---")
    print("converged:", status["isConverged"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
