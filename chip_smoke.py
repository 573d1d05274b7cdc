"""Smoke run of the eigensolvers on one NVIDIA GPU, through the public
entry points, at sizes past the card's L2 cache.

    python chip_smoke.py          # P0-P3 on one card
    python chip_smoke.py --four   # P4 only: the sharded path on four cards

Phases (one process; each phase prints one JSON line with its compile and
run seconds split apart, each error beside the tolerance it is held to,
and the card's name and power limit):

* P0 device — JAX's first device is a GPU, or the script exits non-zero.
* P1 dense window — ``known_spectrum_matrix(n=8192)`` (exact oracle):
  ``feastDiagonalization`` and ``chebyshevFilteredDiagonalization`` in f32
  find every eigenvalue of a 5-eigenvalue window to 1e-4 absolute;
  ``inexactLanczosDiagonalization`` in f64 matches the eigenvalue nearest
  sigma to 1e-8 relative.
* P2 CH3CN sum-of-products, 7-mode N=12 cut (35,831,808 states): the f64
  apply against a host NumPy f64 grouped apply (1e-12 relative); the f32
  apply, unfused and ``fuse=256``, within 3x the host-f32 error floor;
  f64 Lanczos near the cut's ZPVE, certified by the host f64 residual
  ||Hx - lambda x|| / |lambda| <= 1e-6.
* P3 block-ELL SpMV, n=65536, B=128, 8 blocks per row (268 MB of f32
  blocks): one RHS and m=16 against a SciPy CSR oracle, f32 (1e-5) and
  f64 (1e-12); the chained apply's bytes/s.
* P4 (``--four`` only) — ``__graft_entry__.dryrun_multichip(4)``: a sharded
  fused Krylov step and a sharded FEAST solve on a ("b", "x") mesh over four
  cards, compared with the same problem on one card; the per-step
  collective counts of the GPU partitioner.

Any failed check raises and the script exits non-zero.  The last line of
standard output is ``{"ok": true, "device": {"platform": ..., "kind": ...,
"count": ...}}``.  Importing this module touches no JAX backend.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from eigensolvers_tpu.utils.device import (configure_compile_cache,
                                           gpu_cards, require_gpu)
from eigensolvers_tpu.utils.profiling import CompileClock, PhaseTimer

ROOT = os.path.dirname(os.path.abspath(__file__))

#: HBM bandwidth of one H100 SXM (NVIDIA data sheet), the roofline for the
#: block-ELL apply's bytes/s.
H100_HBM_BYTES_PER_S = 3.35e12


def run_phase(name, fn, card, **kwargs):
    """Run one phase: ``fn(timer, **kwargs)`` returns ``(checks, info)``
    where ``checks`` maps a name to ``(error, tolerance)``.  Prints the
    phase line and raises ``AssertionError`` if any error exceeds its
    tolerance (NaN included).  Host oracle work inside ``timer.phase(
    "oracle")`` is reported apart from the run time."""
    timer = PhaseTimer()
    t0 = time.perf_counter()
    with CompileClock() as cc:
        checks, info = fn(timer, **kwargs)
    wall = time.perf_counter() - t0
    oracle_s = timer.summary().get("oracle", {}).get("seconds", 0.0)
    line = {"phase": name, "compile_s": cc.seconds,
            "run_s": wall - cc.seconds - oracle_s, "oracle_s": oracle_s,
            "checks": {k: {"err": float(e), "tol": float(t)}
                       for k, (e, t) in checks.items()},
            **info, "card": card}
    print(json.dumps(line), flush=True)
    failed = [k for k, (e, t) in checks.items() if not float(e) <= float(t)]
    if failed:
        raise AssertionError(f"{name}: checks failed: {failed}")
    return line


def device_record(devices) -> dict:
    """The device as JAX reports it: platform, kind, count."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def final_line(devices) -> str:
    """The script's last line."""
    return json.dumps({"ok": True, "device": device_record(devices)})


# -- P1 ------------------------------------------------------------------------
def dense_window_problem(n):
    """H = Q^T diag(1..n) Q, a 5-eigenvalue window in the middle of the
    spectrum (edges 0.75 inside the first/last and 0.25 short of the
    neighbours outside), and a sigma inside the window."""
    from eigensolvers_tpu.models.synthetic import known_spectrum_matrix
    H64, ev = known_spectrum_matrix(
        n, eigenvalues=np.linspace(1.0, float(n), n), seed=10)
    mid = n // 2
    eMin, eMax = ev[mid - 1] + 0.25, ev[mid + 4] + 0.75
    sigma = ev[mid + 2] + 0.3
    return np.asarray(H64), ev, float(eMin), float(eMax), float(sigma)


def p1_dense_window(timer, n=8192):
    import scipy.linalg as la
    from eigensolvers_tpu import (JaxVector, as_operator,
                                  chebyshevFilteredDiagonalization,
                                  feastDiagonalization,
                                  inexactLanczosDiagonalization,
                                  select_within_range)

    m0 = 10
    with timer.phase("oracle"):
        H64, ev, eMin, eMax, sigma = dense_window_problem(n)
        truth = select_within_range(ev, eMin, eMax)[0]
        Yg = la.qr(np.random.RandomState(3).rand(n, m0),
                   mode="economic")[0]
    H32 = as_operator(H64.astype(np.float32))

    def window_err(evs):
        got = np.sort(select_within_range(np.asarray(evs), eMin, eMax)[0])
        if len(got) < len(truth):
            return np.inf
        return max(np.min(np.abs(got - t)) for t in truth)

    feast_args = {"linearSolver": "minres", "linearIter": 10000,
                  "linear_tol": 1e-5, "errorOnNonConvergence": False,
                  "escalateIter": 0}
    walls = {}
    t0 = time.perf_counter()
    Y = [JaxVector(Yg[:, i].astype(np.float32),
                   {"linearSystemArgs": dict(feast_args)}) for i in range(m0)]
    evF, _, stF = feastDiagonalization(H32, Y, 8, "legendre", eMin, eMax,
                                       1e-6, 12, writeOut=False)
    walls["feast_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    Y = [JaxVector(Yg[:, i].astype(np.float32), {}) for i in range(m0)]
    evC, _, stC = chebyshevFilteredDiagonalization(
        H32, Y, None, eMin, eMax, 1e-6, 30,
        specBounds=(float(ev[0]) - 1.0, float(ev[-1]) + 1.0),
        writeOut=False)
    walls["chebyshev_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    lz_args = {"linearSolver": "minres", "linearIter": 8000,
               "linear_tol": 1e-8, "errorOnNonConvergence": False}
    guess = np.random.RandomState(4).rand(n)
    evL, _, stL = inexactLanczosDiagonalization(
        as_operator(H64), JaxVector(guess, {"linearSystemArgs": lz_args}),
        sigma, 12, 6, 1e-11, writeOut=False)
    walls["lanczos_s"] = time.perf_counter() - t0
    lam = evL[np.argmin(np.abs(evL - sigma))]
    want = ev[np.argmin(np.abs(ev - sigma))]

    checks = {"feast_f32_abs": (window_err(evF), 1e-4),
              "chebyshev_f32_abs": (window_err(evC), 1e-4),
              "lanczos_f64_rel": (abs(lam - want) / abs(want), 1e-8)}
    info = {"n": n, "window": [eMin, eMax], "n_in_window": len(truth),
            "feast_iters": int(stF["outerIter"]) + 1,
            "chebyshev_degree": int(stC["degree"]),
            "lanczos_iters": int(stL["outerIter"]) + 1,
            "wall_with_compile": walls}
    return checks, info


# -- P2 ------------------------------------------------------------------------
def host_sop_apply(op, x, dtype=np.float64):
    """Independent host NumPy grouped apply of a GroupedSoPOperator: every
    product term contracted mode by mode with ``np.tensordot``."""
    groups = [(modes, [np.asarray(f).astype(dtype) for f in facs])
              for modes, facs in op.groups]
    xt = np.asarray(x, dtype).reshape(op.dims)
    y = np.asarray(op.id_coeff, dtype) * xt
    for modes, facs in groups:
        for s in range(facs[0].shape[0]):
            xb = xt
            for mode, f in zip(modes, facs):
                xb = np.moveaxis(np.tensordot(f[s], xb, axes=([1], [mode])),
                                 0, mode)
            y += xb
    return y.reshape(-1)


def chain_seconds(op, method, x, K, reps=3):
    """Best-of-``reps`` seconds per apply in a jitted chain of ``K``
    dependent ``op.<method>`` applies (each normalized), ended by
    block_until_ready.  The operator is an argument of the jitted chain,
    not a closure, so its arrays are not baked into the program."""
    import jax
    import jax.numpy as jnp

    @jax.jit
    def chain(op, v):
        def body(i, v):
            v = getattr(op, method)(v)
            return v / jnp.max(jnp.abs(v))
        return jax.lax.fori_loop(0, K, body, v)

    jax.block_until_ready(chain(op, x))
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(chain(op, x))
        best = min(best, time.perf_counter() - t0)
    return best / K


#: ZPVE of the CH3CN 7-mode cut (cm-1): converged to 0.003 cm-1 between
#: N=6 and N=8 by a SciPy ``eigsh`` of the same operator on a CPU.
CH3CN_CUT7_ZPVE_CM = 7697.353
#: Lanczos target: 2.6 cm-1 above that ZPVE (the next state is ~905 above).
P2_SIGMA_CM = 7700.0


def p2_ch3cn_sop(timer, N=12, cut=7):
    import jax
    import jax.numpy as jnp
    from eigensolvers_tpu import JaxVector, inexactLanczosDiagonalization
    from eigensolvers_tpu.models.molecules import ch3cn_operator
    from eigensolvers_tpu.utils.units import au2unit, unit2au

    op64, _, _ = ch3cn_operator(N=N, nModesCut=cut, dtype=np.float64)
    op32, _, _ = ch3cn_operator(N=N, nModesCut=cut, dtype=np.float32)
    op32f, _, _ = ch3cn_operator(N=N, nModesCut=cut, dtype=np.float32,
                                 fuse=256)
    n = op64.shape[0]
    x = np.random.RandomState(2).rand(n)
    y64 = np.asarray(jax.jit(op64.matvec)(jnp.asarray(x)))
    x32 = jnp.asarray(x.astype(np.float32))
    y32 = np.asarray(jax.jit(op32.matvec)(x32)).astype(np.float64)
    y32f = np.asarray(jax.jit(op32f.matvec)(x32)).astype(np.float64)
    with timer.phase("oracle"):
        h64 = host_sop_apply(op64, x)
        h32 = host_sop_apply(op64, x.astype(np.float32), np.float32)
    scale = np.abs(h64).max()
    floor32 = np.abs(h32.astype(np.float64) - h64).max()
    checks = {
        "apply_f64_rel": (np.abs(y64 - h64).max() / scale, 1e-12),
        "apply_f32_over_host_floor": (np.abs(y32 - h64).max(), 3 * floor32),
        "apply_f32_fused_over_host_floor": (np.abs(y32f - h64).max(),
                                            3 * floor32),
    }
    del y64, y32, y32f, h32
    K = 10
    t_unfused = chain_seconds(op32, "matvec", x32, K)
    t_fused = chain_seconds(op32f, "matvec", x32, K)
    info = {"n": n, "f32_host_floor_abs": float(floor32),
            "apply_f32_ms": t_unfused * 1e3,
            "apply_f32_fuse256_ms": t_fused * 1e3}
    sigma = float(unit2au(P2_SIGMA_CM, "cm-1"))
    opts = {"linearSystemArgs": {
        "linearSolver": "minres", "linearIter": 4000, "linear_tol": 1e-6,
        "preconditioner": "jacobi", "errorOnNonConvergence": False}}
    guess = np.random.RandomState(5).rand(n)
    t0 = time.perf_counter()
    evL, uvL, stL = inexactLanczosDiagonalization(
        op64, JaxVector(guess, opts), sigma, 6, 4, 1e-10, writeOut=False)
    info["lanczos_wall_with_compile_s"] = time.perf_counter() - t0
    i = int(np.argmin(np.abs(evL - sigma)))
    lam = float(evL[i])
    v = np.asarray(uvL[i].array, np.float64)
    with timer.phase("oracle"):
        v = v / np.linalg.norm(v)
        res = np.linalg.norm(host_sop_apply(op64, v) - lam * v)
    checks["lanczos_residual_rel"] = (res / abs(lam), 1e-6)
    info.update({"lanczos_ev_cm": float(au2unit(lam, "cm-1")),
                 "zpve_ref_cm": CH3CN_CUT7_ZPVE_CM,
                 "lanczos_iters": int(stL["outerIter"]) + 1})
    return checks, info


# -- P3 ------------------------------------------------------------------------
def block_ell_problem(n, B, nbpr, seed=0):
    """Random signed block-ELL data (f64; the signs make a TF32 product
    show as a ~1e-4 relative error), sorted distinct block columns per
    row, and the equivalent SciPy CSR matrix."""
    import scipy.sparse as sp
    nrb = n // B
    rng = np.random.RandomState(seed)
    data = rng.standard_normal((nrb, nbpr, B, B))
    idx = np.stack([np.sort(rng.choice(nrb, nbpr, replace=False))
                    for _ in range(nrb)]).astype(np.int32)
    # (r, t, i, j) -> row r*B + i, col idx[r, t]*B + j
    rows = np.broadcast_to((np.arange(nrb)[:, None, None, None] * B
                            + np.arange(B)[None, None, :, None]),
                           data.shape).reshape(-1)
    cols = np.broadcast_to((idx[:, :, None, None] * B
                            + np.arange(B)[None, None, None, :]),
                           data.shape).reshape(-1)
    csr = sp.csr_matrix((data.reshape(-1), (rows, cols)), shape=(n, n))
    return data, idx, csr


def p3_block_ell(timer, n=65536, B=128, nbpr=8, m=16):
    import jax.numpy as jnp
    from eigensolvers_tpu.ops.sparse import BSROperator

    with timer.phase("oracle"):
        data, idx, csr = block_ell_problem(n, B, nbpr)
        rng = np.random.RandomState(1)
        x = rng.standard_normal(n)
        X = rng.standard_normal((n, m))
        y_ref = csr @ x
        Y_ref = csr @ X

    def rel(a, ref):
        return np.abs(np.asarray(a, np.float64) - ref).max() / \
            np.abs(ref).max()

    checks, info = {}, {"n": n, "B": B, "nbpr": nbpr, "m": m}
    for name, dtype, tol in (("f32", np.float32, 1e-5),
                             ("f64", np.float64, 1e-12)):
        op = BSROperator(data.astype(dtype), idx, n)
        xd, Xd = jnp.asarray(x.astype(dtype)), jnp.asarray(X.astype(dtype))
        checks[f"matvec_{name}_rel"] = (rel(op.matvec(xd), y_ref), tol)
        checks[f"matmat_{name}_rel"] = (rel(op.matmat(Xd), Y_ref), tol)
        if dtype == np.float32:
            data_bytes = op.dataT.size * 4
            t1 = chain_seconds(op, "matvec", xd, 200)
            tm = chain_seconds(op, "matmat", Xd, 50)
            info.update({
                "matvec_f32_us": t1 * 1e6,
                "matvec_f32_hbm_share": data_bytes / t1
                / H100_HBM_BYTES_PER_S,
                "matmat_f32_us": tm * 1e6,
                "matmat_f32_hbm_share": data_bytes / tm
                / H100_HBM_BYTES_PER_S})
            for prec in ("high", "default"):
                opp = BSROperator(data.astype(dtype), idx, n, precision=prec)
                info[f"matvec_f32_{prec}_rel_err"] = rel(opp.matvec(xd),
                                                        y_ref)
        del op
    return checks, info


# -- P4 ------------------------------------------------------------------------
def p4_four_cards(timer):
    import jax
    import __graft_entry__ as ge

    n_devices = 4
    devices = jax.devices()
    assert len(devices) >= n_devices, \
        f"--four needs {n_devices} devices, JAX sees {len(devices)}"
    got = ge.dryrun_multichip(n_devices)
    ref = ge.dryrun_multichip(n_devices, devices=devices[:1])
    # tolerances of the two-process CPU comparison (tests/test_multihost.py)
    checks = {
        "new_vectors_abs": (np.abs(got["new_vectors"]
                                   - ref["new_vectors"]).max(), 1e-8),
        "h_cols_abs": (np.abs(got["h_cols"] - ref["h_cols"]).max(), 1e-7),
        "s_cols_abs": (np.abs(got["s_cols"] - ref["s_cols"]).max(), 1e-8),
        "feast_ev_abs": (np.abs(got["feast_ev"] - ref["feast_ev"]).max()
                         if len(got["feast_ev"]) == len(ref["feast_ev"]) > 0
                         else np.inf, 1e-8),
    }
    report = ge.weak_scaling(n_devices, reps=3)
    counts = {kind: {str(d): {k: row[k] for k in ge._COLLECTIVE_KINDS
                              + ("in_loop", "wall_ms")}
                     for d, row in rows.items()}
              for kind, rows in report.items()}
    return checks, {"collectives_per_step": counts}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card sharded phase (P4)")
    args = ap.parse_args(argv)

    import jax
    try:
        devices = require_gpu()
    except RuntimeError as e:
        print(f"P0 device: {e}", file=sys.stderr)
        return 2
    jax.config.update("jax_enable_x64", True)
    configure_compile_cache(ROOT)
    cards = gpu_cards()
    card = "; ".join(cards)
    print(json.dumps({"phase": "P0 device", **device_record(devices),
                      "card": card}), flush=True)

    if args.four:
        run_phase("P4 four cards", p4_four_cards, card)
        n_used = 4
    else:
        run_phase("P1 dense window", p1_dense_window, card)
        run_phase("P2 CH3CN SoP", p2_ch3cn_sop, card)
        run_phase("P3 block-ELL SpMV", p3_block_ell, card)
        n_used = 1
    for line in cards:
        print(line)
    print(final_line(devices[:n_used]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
