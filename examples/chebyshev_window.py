"""Chebyshev-filtered window search — the solve-free alternative to FEAST.

Same window/problem as examples/feast_window.py, but the rational contour
filter (one shifted linear solve per quadrature node) is replaced by a
Jackson-damped Chebyshev polynomial of the operator: each outer iteration is
one jitted chain of batched matvecs — no linear solves anywhere.  Framework
extension beyond the reference (which has only solve-based algorithms).
"""


# allow running directly from a checkout
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import numpy as np
import scipy.linalg as la


def main():
    import jax
    if "--cpu" in _sys.argv:
        jax.config.update("jax_platforms", "cpu")
    from eigensolvers_tpu import (JaxVector, chebyshevFilteredDiagonalization,
                                  select_within_range)
    from eigensolvers_tpu.models.synthetic import known_spectrum_matrix

    n, m0 = 100, 6
    H, ev = known_spectrum_matrix(n, eigenvalues=np.linspace(1, 200, n),
                                  seed=10)
    ev_min, ev_max = 160.0, 166.0
    Y0 = la.qr(np.random.RandomState(3).rand(n, m0), mode="economic")[0]
    Y = [JaxVector(Y0[:, i], {}) for i in range(m0)]

    print("--- actual eigenvalues",
          select_within_range(ev, ev_min, ev_max)[0], "---\n")
    evC, uvC, status = chebyshevFilteredDiagonalization(
        H, Y, 150, ev_min, ev_max, 1e-10, 40, writeOut=True)
    print("\n--- chebyshev eigenvalues",
          np.sort(select_within_range(np.asarray(evC), ev_min, ev_max)[0]),
          "---")
    print("converged:", status["isConverged"],
          "| outer iterations:", status["outerIter"] + 1,
          "| filter degree:", status["degree"],
          "| estimated spectral bounds:",
          tuple(round(x, 2) for x in status["specBounds"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
