"""State-following on the sinc-DVR harmonic oscillator: follow a specific
eigenstate by overlap instead of energy distance.

Parity: reference examples/stateFollowingHO.py.
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
    from eigensolvers_tpu import (JaxVector, inexactLanczosDiagonalization,
                                  find_nearest, get_pick_function_maxOvlp)
    from eigensolvers_tpu.models.bases import SincInfInf

    N = 45
    sinc = SincInfInf(SincInfInf.getOptions(N=N, xRange=[-10, 10]))
    H = -sinc.mat_dx2 + np.diag(sinc.xi ** 2)   # eigenvalues 1, 3, 5, ...
    evE, uvE = np.linalg.eigh(H)

    sigma = 13.1
    idx = find_nearest(evE, sigma)[0]
    options = {"linearSystemArgs": {
        "linearSolver": "minres", "linearIter": 30000, "linear_tol": 1e-4}}
    # follow the SECOND-nearest state (past the nearer root)
    ref = JaxVector(uvE[:, idx + 1], options)
    pick = get_pick_function_maxOvlp(ref)

    rng = np.random.RandomState(13)
    Y0 = JaxVector(rng.rand(N), options)
    ev, uv, status = inexactLanczosDiagonalization(
        H, Y0, sigma, L=16, maxit=200, eConv=1e-10, pick=pick, writeOut=True)

    print(f"followed state energy : {ev[0]:.10f}")
    print(f"reference energy      : {evE[idx + 1]:.10f}")
    print(f"converged             : {status['isConverged']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
