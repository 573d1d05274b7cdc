"""Dense targeted eigensolve — the framework's hello-world driver.

Parity: reference examples/driver_numpyVector.py (small and larger configs).
Run: python examples/driver_dense.py [--large] [--cpu]
"""


# allow running directly from a checkout
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import sys
import time

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--large", action="store_true",
                    help="n=2500 config (reference 'largerDenserSpetra')")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: JAX's default backend)")
    args = ap.parse_args()

    if args.cpu:
        import jax
        jax.config.update("jax_platforms", "cpu")

    from eigensolvers_tpu import (JaxVector, inexactLanczosDiagonalization,
                                  find_nearest)
    from eigensolvers_tpu.models.synthetic import known_spectrum_matrix

    if args.large:
        n, spread, target, maxit, L, eConv = 2500, 1400, 1290, 20, 50, 1e-10
        iters = 8000
    else:
        n, spread, target, maxit, L, eConv = 100, 300, 30, 4, 6, 1e-8
        iters = 1000

    H, ev = known_spectrum_matrix(n, eigenvalues=np.linspace(1, spread, n),
                                  seed=10)
    options = {"linearSystemArgs": {
        "linearSolver": "minres", "linearIter": iters, "linear_tol": 1e-4,
        "errorOnNonConvergence": False}}
    rng = np.random.RandomState(0)
    Y0 = JaxVector(rng.rand(n), options)

    t0 = time.time()
    lf, xf, status = inexactLanczosDiagonalization(
        H, Y0, target, L, maxit, eConv, writeOut=True)
    t1 = time.time()

    print(f"{'Eigenvalue nearest to sigma':50} :: {find_nearest(lf, target)[1]:.8f}")
    print(f"{'Actual eigenvalue nearest to sigma':50} :: {find_nearest(ev, target)[1]:.8f}")
    print(f"{'Time taken (in sec)':50} :: {t1 - t0:.2f}")
    print(f"{'Converged':50} :: {status['isConverged']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
