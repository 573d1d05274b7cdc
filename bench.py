"""Benchmark suite: the eigensolvers on one GPU against the
reference-native (NumPy/SciPy CPU) stack, across the metrics declared in
BASELINE.md.

The reference publishes no performance numbers (BASELINE.md), so this suite
*establishes* the framework's numbers with the reference's correctness
tolerances as the gate — every metric asserts the computed answer against an
exact oracle before it is recorded.

    python bench.py

runs every bench below, in order, in this one process, on the GPU; it
refuses any other backend.  Each metric is one JSON line tagged with the
device (platform, device_kind, device_count) and the card's name and power
limit.  A bench that raises ends the run with a non-zero exit code.

Metrics:

  * dense2048_interior_lanczos_wall — wall to eigenvalue convergence,
                            fused-step Lanczos f32 vs NumpyVector+gcrotmk
                            f64 (the headline; runs last).
  * feast_window_wall_s   — FEAST window solve to convergence (n=2048,
                            nc=8, m0=10), J-symmetrized split-complex
                            batched MINRES (f32).  Baseline: NumpyVector +
                            exact direct solves ("pardiso"), f64.
  * chebyshev_window_wall_s — the same window by the polynomial filter.
  * bsr_spmv_gflops       — block-ELL SpMV, single RHS (f32, n=16384,
                            B=128, 8 blocks/row); extras carry GB/s and
                            Gnnz/s.  Baseline: SciPy CSR matvec (the stack
                            under the reference's H@x, numpyVector.py:152).
  * bsr_spmm_m16_gflops   — same matrix, 16 stacked RHS through the fused
                            matmat.  Baseline: SciPy CSR @ X.
  * sop_ch3cn_gflops      — CH3CN 6-mode N=14 cut (dim 7.5M), tile-fused
                            grouped SoP apply; USEFUL GFLOP/s.  Baseline:
                            the same grouped apply in NumPy einsum.

CPU baselines are measured once and cached in .bench_baselines.json keyed by
problem config + host.  Device timings are dependency-chained and end in
``block_until_ready``; compilation is excluded (a warm-up call runs first).
"""

import json
import os
import platform
import time

import numpy as np

from eigensolvers_tpu.utils.device import (configure_compile_cache,
                                           gpu_cards, require_gpu)

ROOT = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(ROOT, ".bench_baselines.json")

#: device tags carried by every record (set by main)
_DEVICE = {}


def emit(metric, value, unit, vs_baseline, **extras):
    rec = {"metric": metric, "value": float(value), "unit": unit,
           "vs_baseline": float(vs_baseline), **extras, **_DEVICE}
    print(json.dumps(rec), flush=True)


# -- baseline cache -----------------------------------------------------------
def _load_cache():
    if os.path.exists(CACHE):
        with open(CACHE) as f:
            return json.load(f)
    return {}


def baseline(name, key, fn):
    """Measured-once CPU baseline, keyed by config+host."""
    cache = _load_cache()
    ent = cache.get(name)
    full_key = f"{key}-{platform.node()}"
    if ent and ent.get("key") == full_key:
        return float(ent["value"])
    val = float(fn())
    cache[name] = {"key": full_key, "value": val}
    with open(CACHE, "w") as f:
        json.dump(cache, f, indent=1)
    return val


# -- problem builders ---------------------------------------------------------
def _bsr_problem():
    import scipy.sparse as sp
    n, B, nbpr = 16384, 128, 8
    nrb = n // B
    rng = np.random.RandomState(0)
    data = rng.rand(nrb, nbpr, B, B).astype(np.float32)
    idx = np.zeros((nrb, nbpr), np.int32)
    for r in range(nrb):
        idx[r] = np.sort(rng.choice(nrb, nbpr, replace=False))
    # scipy CSR equivalent for the baseline + oracle
    rows = np.repeat(np.arange(nrb) * B, nbpr * B * B) \
        + np.tile(np.repeat(np.arange(B), B), nrb * nbpr)
    cols = (np.repeat(idx.reshape(-1), B * B) * B
            + np.tile(np.arange(B), nrb * nbpr * B))
    csr = sp.csr_matrix((data.reshape(-1), (rows, cols)), shape=(n, n))
    return n, B, nbpr, data, idx, csr


def _chain_time(chain_fn, x0, iters, inner):
    """Dependency-chained wall time per inner step, best of ``iters`` chain
    calls, each ended by block_until_ready (compile + first run not
    timed)."""
    import jax
    r = jax.block_until_ready(chain_fn(x0))
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        r = jax.block_until_ready(chain_fn(r))
        best = min(best, time.perf_counter() - t0)
    return best / inner


# -- metric 1+2: block-ELL SpMV / SpMM ---------------------------------------
def bench_bsr():
    import jax
    import jax.numpy as jnp
    from eigensolvers_tpu.ops.sparse import BSROperator

    n, B, nbpr, data, idx, csr = _bsr_problem()
    nnz = data.size
    flops1 = 2 * nnz
    op = BSROperator(data, idx, n)
    rng = np.random.RandomState(1)
    x = jnp.asarray(rng.rand(n).astype(np.float32))
    X = jnp.asarray(rng.rand(n, 16).astype(np.float32))

    # correctness gates against the f32 CSR product on max-relative error,
    # so a silent precision regression (e.g. a TF32 product) fails loudly
    y_csr = csr @ np.asarray(x)
    Y_csr = csr @ np.asarray(X)
    err1 = np.abs(np.asarray(op.matvec(x)) - y_csr).max() / np.abs(y_csr).max()
    errm = np.abs(np.asarray(op.matmat(X)) - Y_csr).max() / np.abs(Y_csr).max()
    assert err1 < 3e-5, f"SpMV precision regression: rel err {err1:.2e}"
    assert errm < 3e-5, f"SpMM precision regression: rel err {errm:.2e}"

    K = 400

    @jax.jit
    def chain1(v):
        def body(i, v):
            v = op.matvec(v)
            return v / jnp.max(jnp.abs(v))
        return jax.lax.fori_loop(0, K, body, v)

    Km = 100

    @jax.jit
    def chain16(V):
        def body(i, V):
            V = op.matmat(V)
            return V / jnp.max(jnp.abs(V))
        return jax.lax.fori_loop(0, Km, body, V)

    dt1 = _chain_time(chain1, x, 3, K)
    dt16 = _chain_time(chain16, X, 3, Km)

    def cpu1():
        v = np.asarray(x, np.float32)
        t0 = time.perf_counter()
        for _ in range(20):
            v = csr @ v
            v /= np.abs(v).max()
        return (time.perf_counter() - t0) / 20

    def cpu16():
        V = np.asarray(X, np.float32)
        t0 = time.perf_counter()
        for _ in range(10):
            V = csr @ V
            V /= np.abs(V).max()
        return (time.perf_counter() - t0) / 10

    key = f"{n}-{B}-{nbpr}"
    b1 = baseline("bsr_spmv", key, cpu1)
    b16 = baseline("bsr_spmm16", key, cpu16)

    gbps = nnz * 4 / dt1 / 1e9
    emit("bsr_spmv_gflops", flops1 / dt1 / 1e9, "GFLOP/s",
         (flops1 / dt1) / (flops1 / b1),
         gbps=gbps, gnnz_s=nnz / dt1 / 1e9)
    emit("bsr_spmm_m16_gflops", 16 * flops1 / dt16 / 1e9, "GFLOP/s",
         (16 * flops1 / dt16) / (16 * flops1 / b16),
         note="fused matmat: block data fetched once per 16-RHS batch")


# -- metric 3: SoP apply ------------------------------------------------------
def bench_sop():
    import jax
    import jax.numpy as jnp
    from eigensolvers_tpu.models.molecules import ch3cn_operator

    N, CUT = 14, 6
    op, _, _ = ch3cn_operator(N=N, nModesCut=CUT, dtype=np.float32, fuse=256)
    opu, _, _ = ch3cn_operator(N=N, nModesCut=CUT, dtype=np.float64)
    n = op.shape[0]
    # USEFUL flops: the physical-mode grouped apply
    uflops = 2 * n
    for modes, facs in opu.groups:
        S_g = facs[0].shape[0]
        for f in facs:
            uflops += 2 * S_g * f.shape[1] * n

    rng = np.random.RandomState(2)
    x_np = rng.rand(n).astype(np.float32)
    x = jnp.asarray(x_np)

    # host-numpy physical-mode apply: correctness oracle AND the CPU baseline
    groups_np = [(m, [np.asarray(f) for f in facs]) for m, facs in opu.groups]
    idc_np = float(np.asarray(opu.id_coeff))
    dims_np = opu.dims

    def np_apply(xt, fdtype=np.float64):
        y = np.asarray(idc_np, fdtype) * xt
        for modes, facs in groups_np:
            S_g = facs[0].shape[0]
            xb = np.broadcast_to(xt, (S_g,) + dims_np)
            for mode, f in zip(modes, facs):
                xb = np.moveaxis(xb, mode + 1, -1)
                xb = np.einsum("sij,s...j->s...i", f.astype(fdtype), xb)
                xb = np.moveaxis(xb, -1, mode + 1)
            y = y + xb.sum(axis=0)
        return y

    # correctness gate: the CH3CN apply cancels ~1e3-magnitude mode-chain
    # intermediates down to O(1) outputs, so ANY f32 application has a
    # ~1e-3 forward-error floor (measured identically on the unfused f32
    # path).  The gate therefore asserts the tile-FUSION adds no error
    # beyond the intrinsic f32 floor, against the f64 host oracle.
    y32 = np.asarray(op.matvec(x))
    # the two host-side oracle applies are expensive at dim 7.5M — cache
    # them on disk keyed by config (the input is seeded, so they are
    # deterministic across runs)
    ocache = os.path.join(ROOT, f".bench_sop_oracle_{N}_{CUT}.npz")
    if os.path.exists(ocache):
        z = np.load(ocache)
        y64, y32h = z["y64"], z["y32h"]
    else:
        y64 = np_apply(np.asarray(x_np, np.float64).reshape(dims_np)
                       ).reshape(-1)
        y32h = np_apply(np.asarray(x_np, np.float32).reshape(dims_np),
                        fdtype=np.float32).reshape(-1)
        np.savez(ocache, y64=y64, y32h=y32h)
    err_fused = np.max(np.abs(y32 - y64))
    err_f32 = np.max(np.abs(y32h.astype(np.float64) - y64))
    assert err_fused < 3 * err_f32 + 1e-10, \
        f"fusion degrades accuracy: {err_fused:.2e} vs f32 floor {err_f32:.2e}"

    K = 20

    @jax.jit
    def chain(v):
        def body(i, v):
            v = op.matvec(v)
            return v / jnp.max(jnp.abs(v))
        return jax.lax.fori_loop(0, K, body, v)

    dt = _chain_time(chain, x, 3, K)

    def cpu_apply():
        # reference-native path: grouped einsum apply in NumPy (f64, like
        # the reference's operatornD SoP application)
        xt = np.asarray(x_np, np.float64).reshape(dims_np)
        t0 = time.perf_counter()
        for _ in range(2):
            xt = np_apply(xt)
            xt = xt / np.abs(xt).max()
        return (time.perf_counter() - t0) / 2

    b = baseline("sop_ch3cn_apply", f"{N}-{CUT}", cpu_apply)
    emit("sop_ch3cn_gflops", uflops / dt / 1e9, "GFLOP/s",
         (uflops / dt) / (uflops / b),
         apply_ms=dt * 1e3,
         note="useful-FLOP basis; tile-fused super-modes (fuse=256)")


# -- metric 4: FEAST window ---------------------------------------------------
def _feast_problem():
    from eigensolvers_tpu.models.synthetic import known_spectrum_matrix
    n = 2048
    H64, ev = known_spectrum_matrix(n, eigenvalues=np.linspace(1, float(n), n),
                                    seed=10)
    return n, np.asarray(H64), ev, 1000.25, 1004.75


def bench_feast():
    import scipy.linalg as la
    from eigensolvers_tpu import (JaxVector, feastDiagonalization,
                                  select_within_range, as_operator)

    n, H64, ev, eMin, eMax = _feast_problem()
    m0, nc = 10, 8
    truth = select_within_range(ev, eMin, eMax)[0]
    rng = np.random.RandomState(3)
    Yg = la.qr(rng.rand(n, m0), mode="economic")[0]

    def run(vec_cls, H, dtype, ls_args, maxit=8, check=True):
        Y = [vec_cls(Yg[:, i].astype(dtype),
                     {"linearSystemArgs": dict(ls_args)}) for i in range(m0)]
        t0 = time.perf_counter()
        evF, _, st = feastDiagonalization(H, Y, nc, "legendre", eMin, eMax,
                                          1e-6, maxit, writeOut=False)
        dt = time.perf_counter() - t0
        if not check:
            return dt
        got = np.sort(select_within_range(np.asarray(evF), eMin, eMax)[0])
        errs = [min(abs(got - t)) for t in truth] if len(got) else [9e9]
        assert len(got) >= len(truth) and max(errs) < 1e-4, \
            f"FEAST incorrect: found {len(got)}, maxerr {max(errs):.2e}"
        return dt

    H32 = as_operator(H64.astype(np.float32))
    # escalateIter 0: lane-level escalation (the default, escalateIter=3)
    # drives every near-axis contour lane to full convergence — the right
    # default for standalone solves, but FEAST's f64 Rayleigh-Ritz carry
    # averages per-lane residual noise down anyway, so here it costs wall
    # time for no accuracy gain (oracle-gated below); the bench exercises
    # the documented minimum-wall configuration
    ours_args = {"linearSolver": "minres", "linearIter": 2500,
                 "linear_tol": 1e-5, "errorOnNonConvergence": False,
                 "escalateIter": 0}
    # warm/compile only: TWO outer iterations — the auto warm-start policy
    # alternates cold and warm program variants (separate compiles), and a
    # 1-iteration warmup would leave the warm variant compiling inside the
    # timed run
    run(JaxVector, H32, np.float32, ours_args, maxit=2, check=False)
    t_ours = run(JaxVector, H32, np.float32, ours_args)

    def cpu_feast():
        from eigensolvers_tpu.vectors.numpy_backend import NumpyVector
        return run(NumpyVector, H64, np.float64,
                   {"linearSolver": "pardiso",
                    "errorOnNonConvergence": False}, maxit=6)

    t_base = baseline("feast_window", f"{n}-{m0}-{nc}", cpu_feast)
    emit("feast_window_wall_s", t_ours, "s", t_base / t_ours,
         note="split-complex batched MINRES f32 vs reference-native "
              "NumpyVector+exact-direct f64")


# -- metric 4b: Chebyshev window (solve-free) ---------------------------------
def bench_chebyshev():
    """Same window task as metric 4, solved by the polynomial filter —
    no linear solves, one jitted batched-matvec chain per outer iteration.
    Shares the feast_window CPU baseline (identical task), so vs_baseline is
    directly comparable with feast_window_wall_s."""
    import scipy.linalg as la
    from eigensolvers_tpu import (JaxVector, select_within_range,
                                  as_operator,
                                  chebyshevFilteredDiagonalization)

    n, H64, ev, eMin, eMax = _feast_problem()
    m0 = 10
    truth = select_within_range(ev, eMin, eMax)[0]
    rng = np.random.RandomState(3)
    Yg = la.qr(rng.rand(n, m0), mode="economic")[0]
    H32 = as_operator(H64.astype(np.float32))
    bounds = (float(ev[0]) - 1.0, float(ev[-1]) + 1.0)

    used_degree = {}

    def run():
        Y = [JaxVector(Yg[:, i].astype(np.float32), {}) for i in range(m0)]
        t0 = time.perf_counter()
        evC, _, st = chebyshevFilteredDiagonalization(
            H32, Y, None, eMin, eMax, 1e-6, 30, specBounds=bounds,
            writeOut=False)
        dt = time.perf_counter() - t0
        used_degree["d"] = int(st["degree"])
        used_degree["iters"] = int(st["outerIter"]) + 1
        got = np.sort(select_within_range(np.asarray(evC), eMin, eMax)[0])
        errs = [min(abs(got - t)) for t in truth] if len(got) else [9e9]
        assert len(got) >= len(truth) and max(errs) < 1e-4, \
            f"Chebyshev incorrect: found {len(got)}, maxerr {max(errs):.2e}"
        return dt

    run()                                   # warm/compile
    t_ours = min(run(), run())
    cache = _load_cache()
    ent = cache.get("feast_window")
    t_base = float(ent["value"]) if ent else float("nan")
    emit("chebyshev_window_wall_s", t_ours, "s", t_base / t_ours,
         degree=used_degree.get("d"), iters=used_degree.get("iters"),
         note="fused single-program filtered subspace iteration (whole "
              "solve = one XLA while_loop + one fetch), adaptive degree, "
              "f32 filter/f64 on-device RR + one f64 polish; same task "
              "and CPU baseline as feast_window_wall_s")


# -- headline: dense-2048 interior Lanczos ------------------------------------
def bench_lanczos_headline():
    import jax
    from eigensolvers_tpu import JaxVector, as_operator, calculateTarget
    from eigensolvers_tpu.models.synthetic import known_spectrum_matrix
    from eigensolvers_tpu.solvers.fast_lanczos import \
        fastLanczosDiagonalization
    from eigensolvers_tpu import inexactLanczosDiagonalization

    N, TARGET_INDEX, L, MAXIT, ECONV = 2048, 1316, 30, 10, 1e-6
    H64, ev = known_spectrum_matrix(N, eigenvalues=np.linspace(1, 1400, N),
                                    seed=10, dtype=np.float64)
    sigma = float(calculateTarget(ev, TARGET_INDEX))
    rng = np.random.RandomState(3)
    guess = rng.rand(N)
    truth = float(ev[np.argmin(np.abs(np.asarray(ev) - sigma))])

    def nearest(evs, x):
        evs = np.asarray(evs)
        return float(evs[np.argmin(np.abs(evs - x))])

    def cpu_run():
        from eigensolvers_tpu.vectors.numpy_backend import NumpyVector
        Y0 = NumpyVector(np.asarray(guess, np.float64),
                         {"linearSystemArgs": {
                             "linearSolver": "gcrotmk", "linearIter": 8000,
                             "linear_tol": 1e-4, "linear_atol": 1e-4,
                             "errorOnNonConvergence": False}})
        t0 = time.perf_counter()
        evL, _, _ = inexactLanczosDiagonalization(
            np.asarray(H64), Y0, sigma, L, MAXIT, ECONV, writeOut=False)
        dt = time.perf_counter() - t0
        assert abs(nearest(evL, sigma) - truth) < 1e-3
        return dt

    t_base = baseline("dense2048_lanczos",
                      f"{N}-{L}-{MAXIT}-{ECONV}", cpu_run)

    H32 = as_operator(np.asarray(H64).astype(np.float32))
    jax.block_until_ready(H32.mat)
    opts = {"linearSystemArgs": {
        "linearSolver": "minres", "linearIter": 8000, "linear_tol": 1e-4,
        "linear_atol": 1e-4, "errorOnNonConvergence": False}}

    def device_run():
        Y0 = JaxVector(np.asarray(guess, np.float32), opts)
        t0 = time.perf_counter()
        evL, _, _ = fastLanczosDiagonalization(H32, Y0, sigma, L, MAXIT,
                                               ECONV)
        dt = time.perf_counter() - t0
        assert abs(nearest(evL, sigma) - truth) < 1e-2
        return dt

    device_run()                    # compile
    walls = [device_run() for _ in range(3)]
    emit("dense2048_interior_lanczos_wall", min(walls), "s",
         t_base / min(walls), spread_s=sorted(walls))


#: every bench, in the order they run (the headline last)
BENCHES = [bench_feast, bench_chebyshev, bench_bsr, bench_sop,
           bench_lanczos_headline]


def main() -> int:
    import jax
    devices = require_gpu()
    jax.config.update("jax_enable_x64", True)
    configure_compile_cache(ROOT)
    _DEVICE.update({"platform": devices[0].platform,
                    "device_kind": devices[0].device_kind,
                    "device_count": len(devices),
                    "card": "; ".join(gpu_cards())})
    for bench in BENCHES:
        t0 = time.perf_counter()
        bench()
        print(f"# {bench.__name__}: {time.perf_counter() - t0:.1f}s",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
