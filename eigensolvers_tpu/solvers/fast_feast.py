"""Fused FEAST outer iteration — the whole rational-filter application as
ONE jitted XLA program per iteration.

The generic batched path (`solvers/feast.py::_filtered_subspace_batched`)
already runs all nk x m0 contour solves in one device computation
(reference counterpart: the quadrature x subspace double loop,
reference feast.py:189-200), but it still performs O(nk*m0) EAGER device
ops around it per outer iteration: lane stacking (`jnp.stack` over 40
ravels), slice-wrapping each solution back into a vector object, and one
separate kernel + host transfer each for the quadrature accumulation,
overlap matrix, subspace Hamiltonian, and basis rotation — each one a
dispatch and, for the small matrices, a host synchronization.

This module fuses, per outer iteration, into a single program:

  1. the previous iteration's Rayleigh-Ritz basis rotation
     Y = C @ Ybase   (C = (uS uv)^T from the host eigh — so
     `basisTransformation` costs zero extra dispatches),
  2. lane tiling B[(k,i)] = Y[i] and the Ritz warm-start seeds
     x0[(k,i)] = Y[i] / (z_k - ev_i)  (solvers/feast.py::_ritz_warm_starts),
  3. the batched split-complex J-MINRES contour solves
     (ops/linear_solvers.py::_splitc_batch_jit),
  4. the quadrature accumulation  Q_i = sum_k Re[mult_k x_{k,i}],
  5. subspace assembly  S = Q Q^T,  Hm = Q (A Q)^T.

The host then does exactly what the generic loop does with (S, Hm):
Löwdin + projected eigh + convergence/shrink logic (all m0 x m0, LAPACK),
fetched in ONE transfer.  Per outer iteration the device traffic is one
program dispatch + one small-matrix fetch instead of ~10^2 round trips.

Semantics are identical to the generic path; `solvers/feast.py` routes
here when eligible (plain dense `JaxVector` subspace, real symmetric
operator, split-complex solves — `_use_split_complex`) and falls back
otherwise (complex/Hermitian operators, compressed backends, sharded
meshes, exact-solve oracle runs, lane chunking).
"""

from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp

from ..ops.linear_solvers import _splitc_batch_jit

__all__ = ["feast_filter_program"]


@functools.partial(jax.jit, static_argnames=("maxiter", "precond", "warm",
                                             "escalate"))
def feast_filter_program(op, Ybase, C, sig_re, sig_im, mult_re, mult_im,
                         ritz_ev, rtol, atol, maxiter, precond=None,
                         warm=False, escalate=3):
    """One fused FEAST iteration: basis rotation + contour solves +
    quadrature accumulation + subspace assembly.

    Parameters
    ----------
    op : AbstractOperator pytree (real symmetric)
    Ybase : (mb, n) real — the previous filtered subspace (or the initial
        guesses on the first iteration)
    C : (m0, mb) real — Rayleigh-Ritz rotation; identity on the first
        iteration.  Y = C @ Ybase is the current subspace.
    sig_re, sig_im : (nk,) contour node components (z_k = sig_re + i sig_im)
    mult_re, mult_im : (nk,) quadrature multipliers
        -0.5 w_k r (e cos(theta_k) + i sin(theta_k))
    ritz_ev : (m0,) previous Ritz values (used only when ``warm``)
    rtol, atol : solve tolerances (traced scalars — the inexact-FEAST
        schedule changes rtol per iteration without recompiling)
    maxiter, precond : static solver controls
    warm : static — seed solves with x0_{k,i} = Y_i / (z_k - ev_i)

    Returns (Q, S, Hm, resnorms, iterations, converged) — Q (m0, n) stays
    on device as the next iteration's Ybase.

    Mixed precision BY DESIGN: the contour solves (the hot cost — O(nk*m0)
    Krylov iterations of operator matvecs) run at the SOLVE dtype
    (``sig_re.dtype``, f32 for f32 states), while the basis rotation,
    quadrature accumulation, and S/Hm subspace assembly run at the CARRY
    dtype (``Ybase.dtype``, f64 under x64).  An all-f32 outer iteration
    stalls at ~1e-3 eigenvalue error (the f32 Rayleigh-Ritz floor on
    ||H||~10^3 spectra); carrying the filtered subspace in f64 lets the
    Rayleigh-Ritz step average the independent f32 solve errors down to
    ~1e-6 — the f32 solves act as inexact-FEAST noise, exactly the
    inexactness contract the algorithm is built on.  These small (m0, n)
    f64 contractions cost ~nothing next to the solves.

    ALL matmuls pin HIGHEST precision: a default-precision f32 matmul may
    run in TF32 on NVIDIA GPUs (10-bit mantissa, ~1e-3 relative per
    product), far above the eigenvalue tolerances FEAST is asked for.
    """
    hi = jax.lax.Precision.HIGHEST
    sdtype = sig_re.dtype                                # solve dtype (f32)
    Y = jnp.matmul(C, Ybase, precision=hi)               # (m0, n) carry dtype
    m0, n = Y.shape
    nk = sig_re.shape[0]
    Ys = Y.astype(sdtype)
    B = jnp.tile(Ys, (nk, 1))                            # lane (k, i), k major
    sre = jnp.repeat(sig_re, m0)
    sim = jnp.repeat(sig_im, m0)
    if warm:
        # Ritz warm starts (split re/im): 1/(z_k - ev_i), guarded when a
        # real contour node sits on a Ritz value
        dre = sig_re[:, None] - ritz_ev[None, :]         # (nk, m0)
        dim = jnp.broadcast_to(sig_im[:, None], dre.shape)
        den = dre * dre + dim * dim
        ok = den > 1e-24
        den = jnp.where(ok, den, 1.0)
        cre = jnp.where(ok, dre / den, 0.0).reshape(-1)  # Re 1/d
        cim = jnp.where(ok, -dim / den, 0.0).reshape(-1)  # Im 1/d
        X0 = jnp.concatenate([B * cre[:, None], B * cim[:, None]], axis=1)
    else:
        X0 = jnp.zeros((nk * m0, 2 * n), B.dtype)
    res = _splitc_batch_jit(op, B, sre, sim, X0, rtol, atol, 1.0,
                            maxiter, precond=precond, escalate=escalate)
    X = res.x                                            # (nk*m0, 2, n)
    Xr = X[:, 0, :].reshape(nk, m0, n)
    Xi = X[:, 1, :].reshape(nk, m0, n)
    # Q_i = sum_k Re[mult_k (Xr + i Xi)] — all-real contraction at the
    # carry dtype (mult_* arrive in carry dtype, promoting the f32 X)
    Q = (jnp.tensordot(mult_re, Xr, axes=([0], [0]), precision=hi)
         - jnp.tensordot(mult_im, Xi, axes=([0], [0]), precision=hi))
    S = jnp.matmul(Q, Q.T, precision=hi)
    Hm = jnp.matmul(Q, jax.vmap(op.matvec)(Q).T, precision=hi)
    return Q, S, Hm, res.resnorm, res.iterations, res.converged


def fused_eligible(typeClass, A, Y, use_split):
    """Fused-loop eligibility (see module docstring for the exclusions)."""
    from ..vectors.dense import JaxVector
    if typeClass is not JaxVector or not use_split:
        return False
    opts = Y[0].options.get("linearSystemArgs", {})
    if opts.get("batchChunk"):
        return False                # memory-bounded lane chunking requested
    if opts.get("linearSolver") in ("exact", "pardiso"):
        return False
    return True
