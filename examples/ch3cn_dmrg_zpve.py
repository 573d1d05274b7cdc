"""CH3CN 12-mode zero-point energy by two-site DMRG — the production-scale
configuration (dense dimension 42^12 ≈ 3e19; reference zpve 9837.4069 cm-1,
examples/ttns2_ch3cn.py:25-34).

Pipeline: MCTDH .op file → grouped SoP operator → bond-compressed MPO →
DMRG eigensweep at modest bond dimension.
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
    from eigensolvers_tpu.models.molecules import ch3cn_operator
    from eigensolvers_tpu.vectors.mps import MPO
    from eigensolvers_tpu.vectors.mps_sweeps import dmrg_eigensolve
    from eigensolvers_tpu.utils.units import au2unit

    N = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    maxD = int(sys.argv[2]) if len(sys.argv) > 2 else 10

    t0 = time.time()
    op, spec, bases = ch3cn_operator(N=N)
    print(f"operator: 12 modes x {N} points, {len(spec.terms)} terms, "
          f"dense dim {float(N)**12:.2e}")
    mpo = MPO.from_sop_compressed(op)
    print(f"MPO bonds: {[t.shape[0] for t in mpo.tensors]} "
          f"({time.time() - t0:.0f}s)")

    t1 = time.time()
    es, xs = dmrg_eigensolve(mpo.tensors, [N] * 12, nStates=1, maxD=maxD,
                             nSweep=10, convTol=1e-10, seed=1)
    zpve = float(au2unit(es[0], "cm-1"))
    print(f"ZPVE (maxD={maxD}): {zpve:.4f} cm-1   "
          f"[reference production value 9837.4069]   "
          f"({time.time() - t1:.0f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
