"""Chebyshev-filtered subspace iteration — the polynomial (solve-free)
window eigensolver.

Framework extension beyond the reference (which has only the two
solve-based algorithms, inexact Lanczos + FEAST): the rational contour
filter of FEAST (reference: feast.py:126-244) is replaced by a damped
Chebyshev polynomial approximation of the window indicator function
1_{[eMin,eMax]}(H).  Each outer iteration is then a pure chain of
operator applications — no inner linear solves at all — which is the
shape accelerators like best: the whole degree-d filter application over
the m0 subspace vectors is ONE jitted `lax.fori_loop` whose body is a
single batched matvec (a matmul for dense/BSR operators, the Kronecker
apply for SoP), with zero host round trips.

Algorithm (Zhou, Saad, Tiago & Chelikowsky, J. Comput. Phys. 219, 172
(2006) for the filtered-subspace-iteration scheme; Jackson damping after
Weiße et al., Rev. Mod. Phys. 78, 275 (2006) — both public-literature
techniques):

  repeat:  W <- p_d(H) Y   (Chebyshev recurrence, Jackson-damped window
                            indicator on the spectral interval [a, b])
           Rayleigh-Ritz in span(W): Löwdin + projected eigh
           Y <- Ritz vectors; converge on the in-window eigenvalue
           residual exactly like FEAST

The convergence machinery (Löwdin orthogonalization with lindep-driven
subspace shrink, nearest-matching of reference eigenvalues, residual
restricted to the window, status dict, two-file reporting) deliberately
mirrors `feastDiagonalization` so the two window solvers are drop-in
replacements for each other.

When to prefer it over FEAST: whenever matvecs are cheap relative to
solves — wide windows, well-separated spectra, or operators whose shifted
systems are ill-conditioned (contour nodes near the real axis).  FEAST
remains stronger for very narrow windows deep inside a dense spectrum
(the rational filter's resolution is set by the contour, not by a
polynomial degree).
"""

from __future__ import annotations

import math
import time
import warnings
from typing import List, Optional, Sequence

import numpy as np

from ..utils.status import feast_status
from ..utils.subspace import (
    eigenvalueResidual,
    lowdinOrthoMatrix,
    diagonalizeHamiltonian,
)
from ..utils.reporting import FeastReporter
from ..utils.profiling import PhaseTimer

__all__ = [
    "chebyshevFilteredDiagonalization",
    "chebyshev_window_coefficients",
    "estimate_spectral_bounds",
]


def chebyshev_window_coefficients(degree: int, a: float, b: float,
                                  eMin: float, eMax: float,
                                  jackson: bool = True) -> np.ndarray:
    """Chebyshev expansion coefficients of the window indicator.

    Expands 1_{[eMin,eMax]} on the spectral interval [a, b] (mapped to
    t in [-1, 1]) in Chebyshev polynomials T_k, k = 0..degree:

        c_0 = (theta_lo_hi span)/pi,   c_k = 2 (sin k*th_hi - sin k*th_lo)/(k pi)

    with th = acos(t) and optional Jackson damping factors g_k (kills the
    Gibbs oscillation of the truncated series; essential for a filter —
    undamped lobes outside the window re-amplify unwanted eigenvectors).
    """
    if not (a < eMin < eMax < b):
        raise ValueError(
            f"window [{eMin}, {eMax}] must lie strictly inside the "
            f"spectral interval [{a}, {b}]")
    c = (a + b) * 0.5
    h = (b - a) * 0.5
    t_lo = (eMin - c) / h
    t_hi = (eMax - c) / h
    th_hi = math.acos(t_lo)          # acos is decreasing: t_lo -> larger angle
    th_lo = math.acos(t_hi)
    k = np.arange(1, degree + 1, dtype=np.float64)
    coeffs = np.empty(degree + 1)
    coeffs[0] = (th_hi - th_lo) / math.pi
    coeffs[1:] = 2.0 * (np.sin(k * th_hi) - np.sin(k * th_lo)) / (k * math.pi)
    if jackson:
        d1 = degree + 1
        g = ((d1 - k + 1) * np.cos(math.pi * k / d1)
             + np.sin(math.pi * k / d1) / math.tan(math.pi / d1)) / d1
        coeffs[1:] *= g
    return coeffs


def estimate_spectral_bounds(op, n: int, iters: int = 30, seed: int = 0,
                             dtype=np.float64):
    """Safe [a, b] enclosing the spectrum of the Hermitian ``op`` via a short
    Lanczos run (host-orchestrated; ``iters`` matvecs) with the standard
    residual-based safety margin b_est + ||r|| (Zhou & Li, upper-bound
    lemma)."""
    import jax
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    v = jnp.asarray(rng.rand(n).astype(dtype))
    v = v / jnp.linalg.norm(v)
    alphas, betas = [], []
    v_prev = jnp.zeros_like(v)
    beta = 0.0
    mv = jax.jit(op.matvec)
    for _ in range(iters):
        w = mv(v)
        alpha = float(jnp.vdot(v, w).real)
        w = w - alpha * v - beta * v_prev
        alphas.append(alpha)
        new_beta = float(jnp.linalg.norm(w))
        if new_beta < 1e-12:
            beta = 0.0
            break
        v_prev, v, beta = v, w / new_beta, new_beta
        betas.append(new_beta)
    T = np.diag(alphas)
    for i, b_ in enumerate(betas[:len(alphas) - 1]):
        T[i, i + 1] = T[i + 1, i] = b_
    ritz = np.linalg.eigvalsh(T)
    margin = betas[-1] if betas else 0.0
    return float(ritz[0] - margin), float(ritz[-1] + margin)


def _filter_kernel_impl(op, W, cf, c, h):
    import jax
    import jax.numpy as jnp

    def scaled_apply(X):
        return (jax.vmap(op.matvec)(X) - c * X) / h

    def body(k, carry):
        Tkm1, Tk, acc = carry
        Tkp1 = 2.0 * scaled_apply(Tk) - Tkm1
        return Tk, Tkp1, acc + cf[k + 2] * Tkp1

    T0 = W
    T1 = scaled_apply(W)
    acc = cf[0] * T0 + cf[1] * T1
    _, _, acc = jax.lax.fori_loop(0, cf.shape[0] - 2, body, (T0, T1, acc))
    # normalize in-program (one fused kernel, no extra host sync)
    nrm = jnp.linalg.norm(acc, axis=1, keepdims=True)
    return acc / jnp.where(nrm > 0, nrm, 1.0)


def _filter_rr_kernel_impl(op, W, cf, c, h):
    """Filter + Rayleigh-Ritz assembly in ONE device program: returns
    (W_filtered, packed) with packed = stack([S, Hm]) so the host fetches a
    single small (2, m0, m0) array per outer iteration instead of separate
    S/Hm/W fetches."""
    import jax
    import jax.numpy as jnp

    Wf = _filter_kernel_impl(op, W, cf, c, h)
    hi = jax.lax.Precision.HIGHEST
    # mixed precision (same design as the split path): filter at the state
    # dtype, subspace assembly promoted to f64 when x64 is live (f32
    # products are exact in f64; only the reduction rounds) — trace-time
    # dtype selection, so jit specializes per input dtype
    x64 = jnp.zeros((), jnp.float64).dtype == np.float64
    if x64:
        rr = jnp.complex128 if jnp.iscomplexobj(Wf) else jnp.float64
        Wrr = Wf.astype(rr)
    else:
        Wrr = Wf
    AW = jax.vmap(op.matvec)(Wrr)
    S = jnp.matmul(Wrr.conj(), Wrr.T, precision=hi)
    Hm = jnp.matmul(Wrr.conj(), AW.T, precision=hi)
    Hm = 0.5 * (Hm + Hm.conj().T)
    return Wf, jnp.stack([S, Hm])


_FILTER_KERNEL = None
_FILTER_RR_KERNEL = None
_APPLY_STACK = None


def _filter_stack(op, W, coeffs, a, b):
    """Normalized p_d(op) @ W for the stacked subspace W (m0, n) — one
    jitted three-term Chebyshev recurrence; the loop body is a single
    batched matvec.  Operators are jax pytrees, so one compilation serves
    every outer iteration (and every problem of the same shapes)."""
    import jax
    import jax.numpy as jnp

    global _FILTER_KERNEL
    if _FILTER_KERNEL is None:
        _FILTER_KERNEL = jax.jit(_filter_kernel_impl)
    cf = jnp.asarray(coeffs, W.dtype)
    c = jnp.asarray((a + b) * 0.5, W.dtype)
    h = jnp.asarray((b - a) * 0.5, W.dtype)
    return _FILTER_KERNEL(op, W, cf, c, h)


def _filter_rr(op, W, coeffs, a, b):
    """Fused filter + subspace assembly (see _filter_rr_kernel_impl):
    returns (W_filtered on device, S and Hm as ONE fetched numpy array)."""
    import jax
    import jax.numpy as jnp

    global _FILTER_RR_KERNEL
    if _FILTER_RR_KERNEL is None:
        _FILTER_RR_KERNEL = jax.jit(_filter_rr_kernel_impl)
    cf = jnp.asarray(coeffs, W.dtype)
    c = jnp.asarray((a + b) * 0.5, W.dtype)
    h = jnp.asarray((b - a) * 0.5, W.dtype)
    Wf, packed = _FILTER_RR_KERNEL(op, W, cf, c, h)
    SH = np.asarray(packed)                     # single host fetch
    return Wf, SH[0], SH[1]


def _fused_window_impl(op, W, cf, c, h, eMin, eMax, eConv, maxit):
    """The WHOLE filtered-subspace iteration as one device program: a
    `lax.while_loop` whose body is filter -> f64 Rayleigh-Ritz (on-device
    m0 x m0 eigh, regularized Löwdin) -> basis rotation -> windowed
    eigenvalue-change residual.  Zero per-iteration host syncs; the caller
    fetches (W, ev, residual, iters) ONCE, where the loop path fetches
    once or more per iteration."""
    import jax
    import jax.numpy as jnp

    hi = jax.lax.Precision.HIGHEST
    f64 = jnp.complex128 if jnp.iscomplexobj(W) else jnp.float64
    m0 = W.shape[0]
    # replenishment pool: repeated f32 filtering kills subspace directions
    # whose filter gain ratio decays below the f32 floor (measured: at
    # unlucky degrees S loses rank by iteration 3-4, and CLAMPED Löwdin
    # then amplifies the dead directions into junk Ritz vectors that
    # displace real states).  Dead directions are hard-DROPPED (zeroed)
    # and their rows replaced with deterministic pseudo-random vectors so
    # the subspace keeps m0 useful dimensions.
    key = jax.random.key(1234)
    R0 = jax.random.normal(key, W.shape, W.dtype)
    R0 = R0 / jnp.linalg.norm(R0, axis=1, keepdims=True)

    def rr_round(Wc):
        Wf = _filter_kernel_impl(op, Wc, cf, c, h)
        Wrr = Wf.astype(f64)
        AW = jax.vmap(op.matvec)(Wrr)
        S = jnp.matmul(Wrr.conj(), Wrr.T, precision=hi)
        Hm = jnp.matmul(Wrr.conj(), AW.T, precision=hi)
        Hm = 0.5 * (Hm + Hm.conj().T)
        s, U = jnp.linalg.eigh(S)
        alive = (s.real > 1e-8)[None, :]
        X = jnp.where(alive, U / jnp.sqrt(jnp.maximum(s.real, 1e-12)), 0.0)
        Ht = X.conj().T @ Hm @ X
        Ht = 0.5 * (Ht + Ht.conj().T)
        ev, V = jnp.linalg.eigh(Ht)
        uSH = X @ V
        Wn = jnp.matmul(uSH.T, Wrr, precision=hi)
        nrm = jnp.linalg.norm(Wn, axis=1, keepdims=True)
        dead = nrm < 0.5          # unit rows expected; dropped dims ~ 0
        Wn = jnp.where(dead, R0.astype(f64), Wn / jnp.where(nrm > 0, nrm, 1.0))
        # dead rows carry ev=0 from the zeroed Löwdin columns; move them
        # to a finite out-of-window sentinel so the residual mask never
        # counts them (inf would make |ev - ref| nan when both are dead)
        sentinel = jnp.abs(c) + 1e3 * jnp.abs(h) + 1e6
        ev = jnp.where(dead[:, 0], sentinel, ev.real)
        return Wn.astype(W.dtype), ev

    def window_residual(ev, ref):
        # eigenvalueResidual restricted to [eMin, eMax] (fixed-size masked
        # form; ev and ref are same-length sorted eigh outputs)
        m = (ev >= eMin) & (ev <= eMax)
        num = jnp.sum(jnp.where(m, jnp.abs(ev - ref), 0.0))
        den = jnp.sum(jnp.where(m, jnp.abs(ev), 0.0))
        num_all = jnp.sum(jnp.abs(ev - ref))
        den_all = jnp.sum(jnp.abs(ev))
        use_all = ~jnp.any(m)
        return jnp.where(use_all, num_all / jnp.maximum(den_all, 1e-300),
                         num / jnp.maximum(den, 1e-300))

    W1, ev1 = rr_round(W)

    def cond(carry):
        Wc, ev_ref, res, it = carry
        return (res >= eConv) & (it < maxit)

    def body(carry):
        Wc, ev_ref, _, it = carry
        Wn, ev = rr_round(Wc)
        return Wn, ev, window_residual(ev, ev_ref), it + 1

    Wout, ev, res, iters = jax.lax.while_loop(
        cond, body, (W1, ev1, jnp.asarray(jnp.inf, jnp.float64),
                     jnp.asarray(1, jnp.int32)))

    # Terminal polish, still in-program: residual-enriched f64 Rayleigh-
    # Ritz.  The converged f32 filter subspace carries a systematic
    # ~1e-2-angle error (deterministic f32 fixed point) that floors the
    # Ritz values at ~2-4e-4; the residual vectors R = A W - lambda W are
    # exactly orthogonal to the Ritz subspace and span its first-order
    # error direction, so an f64 RR on [W; R] removes the floor at the
    # cost of 4*m0 f64 matvecs per round — vs a full f64 filter pass
    # (degree f64 matvecs).  TWO rounds: each removes the current
    # first-order error (on the 2048-dense bench window: 2.1e-4 after one
    # round, over the 1e-4 gate; the second round clears it).  Selection back to m0 states: the
    # enriched Ritz vectors with the largest old-subspace content.
    # Enrichment round [W; R^]: R spans the first-order subspace error, so
    # one f64 RR over the doubled span removes the current error floor
    # quadratically.  TWO safety rules keep the round junk-free under
    # static shapes:
    #   * a residual row whose pre-normalization norm is below
    #     1e-8 * max(1, |lam|) is ZEROED, not normalized — normalizing a
    #     machine-precision residual amplifies rounding noise into a
    #     vector whose Rayleigh quotient clusters at the spectral
    #     centroid (measured: junk values landing inside the window and
    #     displacing real states);
    #   * zero rows make S2 eigenvalues exactly 0 (R is exactly
    #     orthogonal to the Ritz basis W), so the Löwdin threshold has no
    #     gray zone: columns below 1e-8 are dropped outright (weighted to
    #     zero), never amplified by the clamp.
    # Selection back to m0: largest old-subspace content (the m0
    # perturbative continuations carry weight ~1, junk carries ~0).
    def enrich(Wcur):
        Wrr = Wcur.astype(f64)
        AW = jax.vmap(op.matvec)(Wrr)
        lam = jnp.sum(Wrr.conj() * AW, axis=1).real / \
            jnp.maximum(jnp.sum(Wrr.conj() * Wrr, axis=1).real, 1e-300)
        R = AW - lam[:, None] * Wrr
        Rn = jnp.linalg.norm(R, axis=1, keepdims=True)
        floor = 1e-8 * jnp.maximum(1.0, jnp.abs(lam))[:, None]
        healthy = Rn > floor
        R = jnp.where(healthy, R / jnp.where(Rn > 0, Rn, 1.0), 0.0)
        B = jnp.concatenate([Wrr, R], axis=0)              # (2 m0, n)
        AB = jnp.concatenate([AW, jax.vmap(op.matvec)(R)], axis=0)
        S2 = jnp.matmul(B.conj(), B.T, precision=hi)
        H2 = jnp.matmul(B.conj(), AB.T, precision=hi)
        H2 = 0.5 * (H2 + H2.conj().T)
        s2, U2 = jnp.linalg.eigh(S2)
        X2 = U2 / jnp.sqrt(jnp.maximum(s2.real, 1e-12))[None, :]
        X2 = jnp.where((s2.real > 1e-8)[None, :], X2, 0.0)
        Ht2 = X2.conj().T @ H2 @ X2
        ev2, V2 = jnp.linalg.eigh(0.5 * (Ht2 + Ht2.conj().T))
        uSH2 = X2 @ V2                                     # (2 m0, 2 m0)
        weight = jnp.sum(jnp.abs(uSH2[:m0, :]) ** 2, axis=0)
        _, keep = jax.lax.top_k(weight, m0)
        keep = jnp.sort(keep)
        ev_out = ev2.real[keep]
        order = jnp.argsort(ev_out)
        ev_out = ev_out[order]
        Wsel = jnp.matmul(uSH2[:, keep[order]].T, B, precision=hi)
        nrm = jnp.linalg.norm(Wsel, axis=1, keepdims=True)
        Wsel = Wsel / jnp.where(nrm > 0, nrm, 1.0)
        return Wsel, ev_out

    # ONE round only: a second round computes residuals of near-converged
    # states, whose normalized directions are noise-dominated and MIX
    # error back in (measured: round 2 degrades 1001.0000 -> 1000.9983 on
    # the bench window).  One safeguarded round takes the f32 floor
    # (~3e-4) to ~1e-5-grade eigenvalues.
    Wsel, ev_out = enrich(Wout)
    # per-state residual certificate ||A w - lambda w|| (m0 extra f64
    # matvecs): a stable-but-WRONG filter fixed point converges the
    # eigenvalue-change residual while the vector residuals stay O(1)
    # (observed at a near-threshold degree) — the certificate makes that
    # failure mode visible to the caller instead of silent
    AWs = jax.vmap(op.matvec)(Wsel.astype(f64))
    vec_res = jnp.linalg.norm(AWs - ev_out[:, None] * Wsel.astype(f64),
                              axis=1)
    return Wsel, ev_out, res, iters, vec_res


_FUSED_WINDOW = None


def adaptive_degree(a: float, b: float, eMin: float, eMax: float,
                    dmin: int = 200, dmax: int = 8000) -> int:
    """Filter degree from the spectral span / window width ratio.

    The Jackson-damped indicator's transition width is ~pi*(b-a)/d, so the
    minimum discriminating degree is ~pi*(b-a)/width.  Measured on the
    2048-dense bench window (fused path): degrees right AT the threshold
    are fragile — 1184 leaves a 2e-4 f32 floor on edge states and 1400
    hits a wrong stable fixed point outright, while 1600-1800 converge in
    5 iterations to 1e-5..1e-6 post-enrichment at ~0.2 s device time.
    The 3.5*(span/width) anchor (~1.1x the pi threshold) buys margin at
    linear-in-d cost — still far cheaper end-to-end than running at 2x-3x
    the threshold with fewer iterations under the old fetch-per-iteration
    layout.  Occasional degree-specific collapses (the on-device Löwdin
    cannot resolve the ill-conditioned early-iteration overlap that a
    very sharp filter produces from random guesses) are caught by the
    vector-residual certificate and retried at an escalated degree by
    the fused driver."""
    width = max(float(eMax) - float(eMin), 1e-300)
    d = int(round(3.5 * (float(b) - float(a)) / width))
    return int(np.clip(d, dmin, dmax))


def chebyshevFilteredDiagonalization(
        A, Y: List, degree: Optional[int], eMin: float, eMax: float,
        eConv: float, maxit: int,
        specBounds: Optional[Sequence[float]] = None,
        jackson: bool = True,
        writeOut: bool = True, eShift: float = 0.0, convertUnit: str = "au",
        outFileName: Optional[str] = None, summaryFileName: Optional[str] = None,
        status: Optional[dict] = None):
    """All eigenpairs of the Hermitian ``A`` inside [eMin, eMax] by
    Chebyshev-filtered subspace iteration (see module docstring).

    Same call/return shape as :func:`feastDiagonalization`: ``(ev, Y,
    status)`` with the FEAST status keys; ``degree`` replaces FEAST's
    ``nc``/``quad`` (pass ``None`` for the measured-optimum adaptive
    degree, :func:`adaptive_degree`).  ``Y`` must be an array-backed backend (JaxVector /
    ShardedVector / NumpyVector — the polynomial filter is a dense-subspace
    method; compressed backends should use FEAST, whose per-solve
    truncation is what makes them inexact-friendly).

    :param specBounds: (a, b) enclosing the FULL spectrum; estimated with a
        short Lanczos run when None.
    """
    import jax
    import jax.numpy as jnp

    vec_cls = type(Y[0])
    if not hasattr(Y[0], "array"):
        raise TypeError(
            "chebyshevFilteredDiagonalization needs an array-backed "
            f"backend, got {vec_cls.__name__}; use feastDiagonalization "
            "for compressed backends")
    options = Y[0].options
    mesh = getattr(Y[0], "mesh", None)
    m0 = len(Y)
    n = len(np.ravel(np.asarray(Y[0].array)))

    # backend coercion: ShardedVector pads/row-shards, JaxVector device-puts
    op = vec_cls._as_operator(A, Y[0]) if hasattr(vec_cls, "_as_operator") \
        else A

    if specBounds is None:
        specBounds = estimate_spectral_bounds(
            op, n, dtype=np.result_type(Y[0].dtype, np.float32))
    a, b = float(specBounds[0]), float(specBounds[1])
    # keep the window strictly inside the interval even for user bounds
    pad = 1e-3 * (b - a)
    a = min(a, eMin - pad)
    b = max(b, eMax + pad)
    adaptive = degree is None
    if adaptive:
        degree = adaptive_degree(a, b, eMin, eMax)
    coeffs = chebyshev_window_coefficients(degree, a, b, eMin, eMax, jackson)

    status = feast_status(status, Y)
    status["degree"] = degree
    status["specBounds"] = (a, b)
    printObj = FeastReporter(Y, degree, "chebyshev", eMin, eMax, eConv,
                             maxit, status.get("writeOut", writeOut), eShift,
                             convertUnit, status, outFileName,
                             summaryFileName)
    printObj.fileHeader()

    W = jnp.stack([jnp.ravel(jnp.asarray(y.array)) for y in Y])
    N_SUBSPACE = m0
    ev = np.full(m0, np.nan)
    ref_ev = None
    timer = PhaseTimer()

    # Mixed precision policy (see _filter_rr_kernel_impl): the filter
    # recurrence stays at the state dtype (the hot cost — `degree`
    # matvecs), the S/Hm assembly promotes to f64 on-device (f32 products
    # are exact in f64; an all-f32 assembly floors the Rayleigh-Ritz
    # eigenvalues at ~6e-4 for ||H||~10^3, above the 1e-4 correctness
    # gate).  ptype marks the polish dtype for the terminal upcast
    # iteration below.
    ptype = None
    if jnp.zeros((), jnp.float64).dtype == np.float64:       # x64 on
        ptype = np.complex128 if jnp.iscomplexobj(W) else np.float64

    if not printObj.writeOut:
        # FUSED fast path: the entire subspace iteration is one device
        # program (see _fused_window_impl) — the per-iteration reporting
        # hooks are the only reason to run the host loop below, so any
        # writeOut=False call takes this path.  One fetch for the whole
        # iteration history instead of one per iteration.
        global _FUSED_WINDOW
        if _FUSED_WINDOW is None:
            _FUSED_WINDOW = jax.jit(_fused_window_impl)
        # certificate-gated degree escalation: at occasional degrees the
        # sharp filter makes the first iterations' overlap too
        # ill-conditioned for the on-device Löwdin and the loop settles
        # on a wrong stable fixed point; the in-program vector-residual
        # certificate detects it (in-window state at O(operator-scale)
        # residual) and the run retries at 1.4x the degree
        degree_try = degree
        for attempt in range(3):
            coeffs_try = (coeffs if degree_try == degree else
                          chebyshev_window_coefficients(
                              degree_try, a, b, eMin, eMax, jackson))
            cf = jnp.asarray(coeffs_try, W.dtype)
            cc = jnp.asarray((a + b) * 0.5, W.dtype)
            hh = jnp.asarray((b - a) * 0.5, W.dtype)
            with timer.phase("fused_window"):
                Wd, ev_d, res_d, it_d, vres_d = _FUSED_WINDOW(
                    op, W, cf, cc, hh,
                    jnp.asarray(eMin, jnp.float64),
                    jnp.asarray(eMax, jnp.float64),
                    jnp.asarray(eConv, jnp.float64),
                    jnp.asarray(maxit, jnp.int32))
                packed = np.asarray(jnp.concatenate(
                    [ev_d, res_d[None].astype(jnp.float64),
                     it_d[None].astype(jnp.float64),
                     vres_d.astype(jnp.float64)]))   # ONE small fetch
            ev = packed[:m0]
            residual = float(packed[m0])
            iters = int(packed[m0 + 1])
            vec_res = packed[m0 + 2:]
            scale = max(abs(a), abs(b))
            bad = (ev >= eMin) & (ev <= eMax) & (vec_res > 0.05 * scale)
            if not bad.any():
                break
            if not adaptive or attempt == 2:
                warnings.warn(
                    f"chebyshev window: {int(bad.sum())} in-window "
                    f"state(s) carry O(1) vector residuals "
                    f"(max {float(vec_res[bad].max()):.2e}) — wrong "
                    f"filter fixed point; increase degree")
                break
            degree_try = int(round(degree_try * 1.4))
            warnings.warn(
                f"chebyshev window: certificate failed at degree "
                f"{int(degree_try / 1.4)}; retrying at {degree_try}")
        status["outerIter"] = iters - 1
        status["quadrature"] = degree_try
        status["degree"] = degree_try
        status["residual"] = residual
        status["vecResiduals"] = vec_res
        status["isConverged"] = bool(residual < eConv) and not bad.any()
        W = Wd
        status["runTime"] = time.time() - status["startTime"]
        if not status["isConverged"]:
            warnings.warn(
                f"chebyshev window not converged in {iters} iterations "
                f"(residual {residual:.2e})")
        status["timers"] = timer.summary()
        printObj.close()
        rows = [np.asarray(W[i]) for i in range(W.shape[0])]
        if mesh is not None:
            out = [vec_cls(r, options, mesh=mesh) for r in rows]
        else:
            out = [vec_cls(r, options) for r in rows]
        return ev, out, status

    for it in range(maxit):
        status["outerIter"] = it
        status["quadrature"] = degree      # reporter's per-iteration counter

        with timer.phase("filter_rr"):
            # fused filter + RR assembly, ONE small host fetch per
            # iteration
            W, Smat, Hmat = _filter_rr(op, W, coeffs, a, b)

        printObj.writeFile("iteration", status)
        printObj.writeFile("overlap", Smat)

        status, uS = lowdinOrthoMatrix(Smat, status)
        ev, uv = diagonalizeHamiltonian(uS, Hmat, printObj)
        uSH = uS @ uv
        # stacked basis transformation: Y_j = sum_i uSH[i, j] W_i
        W = jnp.matmul(jnp.asarray(uSH.T, W.dtype), W,
                       precision=jax.lax.Precision.HIGHEST)

        if it != 0:
            if len(ref_ev) > len(ev):
                indices = np.argmin(np.abs(ref_ev[:, None] - ev[None, :]),
                                    axis=0)
                ref_ev = ref_ev[indices]
            elif len(ref_ev) < len(ev):
                raise RuntimeError(f"{ref_ev=} but {ev=}. Enlarged space?")
            residual = eigenvalueResidual(ev, ref_ev, [eMin, eMax])
            status["runTime"] = time.time() - status["startTime"]
            status["residual"] = residual
            printObj.writeFile("summary", ev, residual, status)
            if residual < eConv:
                if ptype is not None and W.dtype != ptype:
                    # mixed-precision polish: the f32 filter is
                    # deterministic, so its fixed point carries a
                    # systematic ~2.5e-4 span error (measured, ||H||~10^3)
                    # that more f32 iterations cannot reduce.  Upcast the
                    # carry and run ONE f64 filter+RR iteration — `degree`
                    # promoted matvecs, paid once at convergence.
                    W = W.astype(ptype)
                    ref_ev = ev
                    N_SUBSPACE = W.shape[0]
                    continue
                status["isConverged"] = True
                break

        if N_SUBSPACE != W.shape[0]:
            warnings.warn(
                f"Alert! Got {N_SUBSPACE - W.shape[0]} dependent vectors")
        N_SUBSPACE = W.shape[0]
        ref_ev = ev

    status["timers"] = timer.summary()
    printObj.writeFile("results", ev)
    printObj.fileFooter()
    printObj.close()

    rows = [np.asarray(W[i]) for i in range(W.shape[0])]
    if mesh is not None:
        out = [vec_cls(r, options, mesh=mesh) for r in rows]
    else:
        out = [vec_cls(r, options) for r in rows]
    return ev, out, status


def _apply_stack(op, W):
    import jax

    global _APPLY_STACK
    if _APPLY_STACK is None:
        _APPLY_STACK = jax.jit(lambda op, X: jax.vmap(op.matvec)(X))
    return _APPLY_STACK(op, W)
