"""Pyrazine 4-mode vibronic model from the MCTDH operator file: targeted
Lanczos on an interior vibronic state (dense-feasible cut) with energies
reported in eV.

Parity: the role of the reference's TTNS example drivers
(examples/ttns2_ch3cn.py family) on the in-repo pyr4+.op model.
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
                                  find_nearest)
    from eigensolvers_tpu.models.molecules import pyrazine4_operator
    from eigensolvers_tpu.utils.units import au2unit

    op, spec, bases = pyrazine4_operator(N=5)
    print(f"model: {spec.title}")
    print(f"modes: {spec.mode_labels}, terms: {len(spec.terms)}, "
          f"dim: {op.shape[0]}")

    H = np.asarray(op.to_dense())
    evE = np.linalg.eigvalsh(H)
    sigma = float(evE[6] + 0.25 * (evE[7] - evE[6]))

    rng = np.random.RandomState(11)
    options = {"linearSystemArgs": {
        "linearSolver": "gmres", "linearIter": 3000, "linear_tol": 1e-3,
        "errorOnNonConvergence": False}}
    Y0 = JaxVector(rng.rand(*[b.N for b in bases]), options)
    ev, uv, status = inexactLanczosDiagonalization(
        op, Y0, sigma, L=20, maxit=10, eConv=1e-8, writeOut=True,
        convertUnit="ev")

    got = find_nearest(ev, sigma)[1]
    print(f"target state: {float(au2unit(got, 'ev')):.6f} eV "
          f"(exact {float(au2unit(find_nearest(evE, sigma)[1], 'ev')):.6f} eV)")
    print("converged:", status["isConverged"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
