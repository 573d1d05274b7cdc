"""Jitted Krylov linear solvers for shifted systems (sigma*I - H) x = b.

These replace the compiled SciPy solvers of the reference
(minres/gcrotmk/spsolve, reference: numpyVector.py:161-171) with jitted device
implementations:

* :func:`minres` — Hermitian (possibly indefinite) shifted solves; the default
  solver, a ``lax.while_loop`` around the operator matvec so the whole solve
  is one XLA computation (no host round-trips per iteration).
* :func:`gmres` — restarted GMRES for general/complex shifts (the role of the
  reference's ``gcrotmk``); each restart cycle is a fixed-shape Arnoldi
  build ((m, n) matmuls) followed by a small least-squares
  solve.
* :func:`solve_exact` — dense direct solve; the honest name for the
  reference's ``"pardiso"`` option (which actually called SuperLU,
  reference: numpyVector.py:164-171).  Kept for oracle tests (FEAST Fortran
  golden data).

All solvers are batchable: ``vmap`` over (sigma, b) turns FEAST's
quadrature×subspace double loop (reference: feast.py:189-200) into one
batched device computation.

Optional Jacobi preconditioning (``precond="jacobi"``): M is built from
diag(sigma*I - H) when the operator exposes ``diagonal()`` — absolute-value
Jacobi for MINRES (M must be SPD for an indefinite system), plain right
Jacobi for GMRES.  One elementwise multiply per iteration for an often-large cut in
iteration count on diagonally dominant Hamiltonians (DVR kinetic+potential,
SoP molecular operators).

Stopping criterion: ||r|| <= max(rtol*||b||, atol).  The outer eigensolvers
depend on *inexactness semantics* (loose inner tolerances), not on bitwise
solver equality with SciPy (SURVEY.md §7 "hard parts"), so the criterion
matches the reference's tolerance scale, not its internals.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .operators import AbstractOperator

#: All solver-internal contractions (Lanczos/Arnoldi inner products, basis
#: updates) run at true-f32 precision: a default-precision f32 dot_general
#: may multiply in TF32 on NVIDIA GPUs (10-bit mantissa, ~1e-3 relative per
#: product), which caps the attainable residual of the recurrences far
#: above the f32 tolerance scale the eigensolvers request.  The operator matvec itself already pins its own precision
#: (ops/operators.py::resolve_precision).
_HI = jax.lax.Precision.HIGHEST


def _vdot(a, b):
    return jnp.vdot(a, b, precision=_HI)


class SolveResult(NamedTuple):
    x: jax.Array
    resnorm: jax.Array      # final ||b - A x||
    iterations: jax.Array   # matvec-level iteration count
    converged: jax.Array    # bool


def _shifted_matvec(op: AbstractOperator, sigma, gf_sign):
    """A(x) = gf_sign * (sigma*x - H x);  gf_sign=+1 is the Green's function
    (sigma - H), -1 the reverse (H - sigma) (reference: numpyVector.py:151-154)."""
    def matvec(x):
        return gf_sign * (sigma * x - op.matvec(x))
    return matvec


# ----------------------------------------------------------------------------
# MINRES (Paige & Saunders) — Hermitian, possibly indefinite
# ----------------------------------------------------------------------------
def _minres_fixed(matvec, b, x0, rtol, atol, maxiter, psolve=None):
    """MINRES (Paige & Saunders); with ``psolve`` (an SPD M applied as a
    callable) this is standard preconditioned MINRES: the Lanczos vectors are
    M-orthogonal and phibar tracks the M^{-1}-norm of the residual.  Since
    that norm can stop short of the true-2-norm contract
    ||r|| <= max(rtol*||b||, atol), preconditioned runs add warm-restart
    continuation rounds (tightening the inner tolerance 10x per round) until
    the true residual satisfies it or the iteration budget is spent."""
    dtype = jnp.result_type(b.dtype, x0.dtype)
    b = b.astype(dtype)
    x0 = x0.astype(dtype)
    rdtype = jnp.zeros((), dtype).real.dtype

    preconditioned = psolve is not None
    if psolve is None:
        psolve = lambda r: r

    zero_r = jnp.zeros((), rdtype)

    def core(x0c, tol_m, it0):
        """One MINRES sweep from x0c with M-norm tolerance tol_m; iteration
        counter starts at it0 and is bounded by the global maxiter."""
        r1 = b - matvec(x0c)
        y0 = psolve(r1)
        beta1 = jnp.sqrt(jnp.maximum(jnp.real(_vdot(r1, y0)), 0.0))
        init = dict(
            x=x0c, r1=r1, r2=r1, y=y0,
            w=jnp.zeros_like(b), w2=jnp.zeros_like(b),
            oldb=zero_r, beta=beta1, dbar=zero_r, epsln=zero_r,
            phibar=beta1, cs=-jnp.ones((), rdtype), sn=zero_r,
            itn=jnp.asarray(it0, jnp.int32),
        )

        def cond(c):
            return (c["itn"] < maxiter) & (c["phibar"] > tol_m) & \
                (c["beta"] > 0)

        return jax.lax.while_loop(cond, _body, init)

    tol_abs = jnp.maximum(
        rtol * jnp.sqrt(jnp.maximum(jnp.real(_vdot(b, psolve(b))), 0.0)),
        atol)

    def _body(c):
        itn = c["itn"] + 1
        s = 1.0 / c["beta"]
        v = s * c["y"]
        y = matvec(v)
        # The b_{k-1} correction applies from each sweep's SECOND iteration on
        # (oldb is exactly 0 only on a sweep's first step) — gating on the
        # global itn would corrupt the first step of warm-restart sweeps.
        y = jnp.where(c["oldb"] > 0, 1.0, 0.0) * (-(c["beta"] / jnp.where(c["oldb"] > 0, c["oldb"], 1.0)) * c["r1"]) + y
        alfa = jnp.real(_vdot(v, y))
        y = y - (alfa / c["beta"]) * c["r2"]
        r1, r2 = c["r2"], y
        my = psolve(y)
        oldb = c["beta"]
        beta = jnp.sqrt(jnp.maximum(jnp.real(_vdot(y, my)), 0.0))

        # Plane rotations (QR of the tridiagonal)
        oldeps = c["epsln"]
        delta = c["cs"] * c["dbar"] + c["sn"] * alfa
        gbar = c["sn"] * c["dbar"] - c["cs"] * alfa
        epsln = c["sn"] * beta
        dbar = -c["cs"] * beta
        gamma = jnp.sqrt(gbar * gbar + beta * beta)
        gamma = jnp.maximum(gamma, jnp.finfo(rdtype).eps)
        cs = gbar / gamma
        sn = beta / gamma
        phi = cs * c["phibar"]
        phibar = sn * c["phibar"]

        w1 = c["w2"]
        w2 = c["w"]
        w = (v - oldeps * w1 - delta * w2) / gamma
        x = c["x"] + phi * w
        return dict(x=x, r1=r1, r2=r2, y=my, w=w, w2=w2, oldb=oldb, beta=beta,
                    dbar=dbar, epsln=epsln, phibar=phibar, cs=cs, sn=sn, itn=itn)

    out = core(x0, tol_abs, 0)
    if not preconditioned:
        return SolveResult(out["x"], out["phibar"], out["itn"],
                           out["phibar"] <= tol_abs)

    # Continuation rounds against the true-2-norm contract.
    tol_true = jnp.maximum(rtol * jnp.linalg.norm(b), atol)
    rnorm0 = jnp.linalg.norm(b - matvec(out["x"]))

    def ocond(c):
        x, itn, tol_m, rnorm, rounds = c
        # rounds cap guards against Lanczos breakdown (beta = 0) stagnation
        return (rnorm > tol_true) & (itn < maxiter) & (rounds < 8)

    def obody(c):
        x, itn, tol_m, _, rounds = c
        tol_m = 0.1 * tol_m
        o = core(x, tol_m, itn)
        rnorm = jnp.linalg.norm(b - matvec(o["x"]))
        return o["x"], o["itn"], tol_m, rnorm, rounds + 1

    x, itn, _, rnorm, _ = jax.lax.while_loop(
        ocond, obody,
        (out["x"], out["itn"], tol_abs, rnorm0, jnp.zeros((), jnp.int32)))
    return SolveResult(x, rnorm, itn, rnorm <= tol_true)


# ----------------------------------------------------------------------------
# Restarted GMRES — general (non-Hermitian / complex-shifted) systems
# ----------------------------------------------------------------------------
def _gmres_fixed(matvec, b, x0, rtol, atol, restart, maxiter, psolve=None):
    if psolve is None:
        psolve = lambda z: z
    n = b.shape[0]
    dtype = jnp.result_type(b.dtype, x0.dtype)
    b = b.astype(dtype)
    x0 = x0.astype(dtype)
    rdtype = jnp.zeros((), dtype).real.dtype
    tiny = jnp.asarray(jnp.finfo(rdtype).tiny, rdtype)
    tol_abs = jnp.maximum(rtol * jnp.linalg.norm(b), atol)

    def cycle(x):
        """One restart cycle: build a `restart`-step Arnoldi basis with CGS2
        reorthogonalization (two (m, n) matmuls per step, not m
        sequential dots), with the Hessenberg QR maintained incrementally by
        Givens rotations (numerically honest at f32; the earlier ridge-
        regularized normal equations squared the projected conditioning)."""
        r = b - matvec(x)
        beta = jnp.linalg.norm(r)
        V = jnp.zeros((restart + 1, n), dtype)
        V = V.at[0].set(r / jnp.where(beta > tiny, beta, 1.0))
        R = jnp.zeros((restart + 1, restart), dtype)   # upper-triangular factor
        givens = jnp.zeros((restart, 2), dtype)        # (c_j, s_j) per column
        g = jnp.zeros((restart + 1,), dtype).at[0].set(
            beta.astype(dtype))                        # rotated rhs beta*e1

        def arnoldi(j, carry):
            V, R, givens, g = carry
            w = matvec(psolve(V[j]))
            mask = (jnp.arange(restart + 1) <= j).astype(dtype)
            h1 = jnp.matmul(V.conj(), w, precision=_HI) * mask
            w = w - jnp.matmul(V.T, h1, precision=_HI)
            h2 = jnp.matmul(V.conj(), w, precision=_HI) * mask  # second CGS pass
            w = w - jnp.matmul(V.T, h2, precision=_HI)
            h = h1 + h2
            hnext = jnp.linalg.norm(w)
            ok = hnext > tiny
            V = V.at[j + 1].set(jnp.where(ok, 1.0, 0.0) * w /
                                jnp.where(ok, hnext, 1.0))
            h = h.at[j + 1].set(hnext.astype(dtype))

            # apply the previous rotations to the new column
            def rot(i, h):
                c, s = givens[i, 0], givens[i, 1]
                hi, hi1 = h[i], h[i + 1]
                return h.at[i].set(c.conj() * hi + s.conj() * hi1) \
                        .at[i + 1].set(-s * hi + c * hi1)
            h = jax.lax.fori_loop(0, j, rot, h)
            # new rotation zeroing h[j+1]
            denom = jnp.sqrt(jnp.abs(h[j]) ** 2 + jnp.abs(h[j + 1]) ** 2)
            safe = denom > tiny
            cj = jnp.where(safe, h[j] / jnp.where(safe, denom, 1.0), 1.0)
            sj = jnp.where(safe, h[j + 1] / jnp.where(safe, denom, 1.0), 0.0)
            givens = givens.at[j, 0].set(cj).at[j, 1].set(sj)
            h = h.at[j].set(denom.astype(dtype)).at[j + 1].set(0.0)
            gj = g[j]
            g = g.at[j].set(cj.conj() * gj).at[j + 1].set(-sj * gj)
            R = R.at[:, j].set(h)
            return V, R, givens, g

        V, R, givens, g = jax.lax.fori_loop(0, restart, arnoldi,
                                            (V, R, givens, g))
        # back substitution on the triangular R (zero diagonals from happy
        # breakdown contribute y_j = 0)
        idx = jnp.arange(restart)

        def back(k, y):
            i = restart - 1 - k
            s = g[i] - jnp.dot(jnp.where(idx > i, R[i, :restart], 0), y,
                               precision=_HI)
            dii = R[i, i]
            ok = jnp.abs(dii) > tiny
            return y.at[i].set(jnp.where(ok, s / jnp.where(ok, dii, 1.0), 0.0))

        y = jax.lax.fori_loop(0, restart, back, jnp.zeros((restart,), dtype))
        x = x + psolve(jnp.matmul(V[:restart].T, y, precision=_HI))
        rnorm = jnp.linalg.norm(b - matvec(x))
        return x, rnorm

    r0 = jnp.linalg.norm(b - matvec(x0))
    ncycles_max = jnp.asarray(-(-maxiter // restart), jnp.int32)

    def cond(c):
        x, rnorm, i = c
        return (i < ncycles_max) & (rnorm > tol_abs)

    def body(c):
        x, rnorm, i = c
        x, rnorm = cycle(x)
        return x, rnorm, i + 1

    x, rnorm, ncyc = jax.lax.while_loop(cond, body, (x0, r0, jnp.zeros((), jnp.int32)))
    return SolveResult(x, rnorm, ncyc * restart, rnorm <= tol_abs)


# ----------------------------------------------------------------------------
# Jacobi preconditioners for the shifted system A = gf_sign*(sigma*I - H)
# ----------------------------------------------------------------------------
def _jacobi_spd(op, sigma, gf_sign):
    """SPD (absolute-value) Jacobi for MINRES: M = 1/max(|diag(A)|, floor).
    Returns None when the operator has no cheap diagonal."""
    d = op.diagonal()
    if d is None:
        return None
    dA = jnp.abs(gf_sign * (sigma - d)).real
    floor = 1e-8 * jnp.maximum(jnp.max(dA), 1.0)
    m = 1.0 / jnp.maximum(dA, floor)
    return lambda r: (m * r.reshape(-1)).reshape(r.shape)


def _jacobi_right(op, sigma, gf_sign, dtype):
    """Right Jacobi for GMRES: z = r / diag(A), guarded near diag(A) = 0
    (entries within floor of zero fall back to identity)."""
    d = op.diagonal()
    if d is None:
        return None
    dA = (gf_sign * (sigma - d.astype(dtype))).astype(dtype)
    mag = jnp.abs(dA)
    floor = 1e-8 * jnp.maximum(jnp.max(mag), 1.0)
    safe = jnp.where(mag > floor, dA, 1.0)
    return lambda r: (r.reshape(-1) / safe).reshape(r.shape)


def _resolve_precond(precond, kind, op, sigma, gf_sign, dtype=None):
    if precond in (None, "none"):
        return None
    if precond != "jacobi":
        raise ValueError(
            f"unknown preconditioner {precond!r}; available: jacobi")
    if kind == "minres":
        return _jacobi_spd(op, sigma, gf_sign)
    return _jacobi_right(op, sigma, gf_sign, dtype)


# ----------------------------------------------------------------------------
# public, jitted entry points
# ----------------------------------------------------------------------------
@functools.partial(jax.jit, static_argnames=("maxiter", "precond"))
def _minres_jit(op, b, sigma, x0, rtol, atol, gf_sign, maxiter, precond=None):
    psolve = _resolve_precond(precond, "minres", op, sigma, gf_sign)
    return _minres_fixed(_shifted_matvec(op, sigma, gf_sign), b, x0, rtol,
                         atol, maxiter, psolve=psolve)


@functools.partial(jax.jit, static_argnames=("restart", "maxiter", "precond"))
def _gmres_jit(op, b, sigma, x0, rtol, atol, gf_sign, restart, maxiter,
               precond=None):
    psolve = _resolve_precond(precond, "gmres", op, sigma, gf_sign, b.dtype)
    return _gmres_fixed(_shifted_matvec(op, sigma, gf_sign), b, x0, rtol, atol,
                        restart, maxiter, psolve=psolve)


@functools.partial(jax.jit, static_argnames=("maxiter", "precond"))
def _minres_batch_jit(op, bs, sigmas, x0s, rtol, atol, gf_sign, maxiter,
                      precond=None):
    def f(b, s, x0):
        psolve = _resolve_precond(precond, "minres", op, s, gf_sign)
        return _minres_fixed(_shifted_matvec(op, s, gf_sign), b, x0,
                             rtol, atol, maxiter, psolve=psolve)
    return jax.vmap(f)(bs, sigmas, x0s)


def _lane_sharded_mesh(B):
    """Mesh of a lane-stacked array sharded ONLY over the batch axis "b"
    (P("b", ...Nones)).  This is the pattern where every lane group is fully
    device-local, so the solve needs zero collectives; any state-axis
    sharding returns None (the GSPMD route handles cross-"x" schedules)."""
    sh = getattr(B, "sharding", None)
    if not isinstance(sh, jax.sharding.NamedSharding):
        return None
    mesh = sh.mesh
    if isinstance(mesh, jax.sharding.AbstractMesh):
        return None
    extents = dict(mesh.shape)
    spec = tuple(sh.spec) + (None,) * (B.ndim - len(tuple(sh.spec)))

    def extent(s):
        if s is None:
            return 1
        axes = s if isinstance(s, tuple) else (s,)
        e = 1
        for a in axes:
            e *= extents.get(a, 1)
        return e

    # state axes sharded non-trivially -> GSPMD handles the cross-"x" schedule
    if not spec or spec[0] != "b" or any(extent(s) > 1 for s in spec[1:]):
        return None
    if extents.get("b", 1) <= 1:
        return None
    return mesh


@functools.lru_cache(maxsize=None)
def _minres_batch_local_fn(mesh, maxiter, precond, gf_sign):
    """shard_map batched MINRES for a P("b", None)-sharded lane stack: each
    device runs a fully LOCAL while_loop over its own lanes — no cross-device
    termination reduce per iteration (the one collective GSPMD must insert
    for a global while condition), no collectives at all.  The explicit
    minimal schedule for embarrassingly-parallel shifted solves
    (SURVEY.md §2.4 item 2)."""
    from jax.sharding import PartitionSpec as P

    lane = P("b")
    stack = P("b", None)

    @jax.jit
    def run(op, B, sig, X0, rtol, atol):
        @functools.partial(
            jax.shard_map, mesh=mesh,
            in_specs=(P(), stack, lane, stack, P(), P()),
            out_specs=SolveResult(x=stack, resnorm=lane, iterations=lane,
                                  converged=lane),
            # loop-carry scalars start replicated and become lane-varying in
            # the body; there is no communication to validate here (that is
            # the point of this schedule), so the vma check is off
            check_vma=False)
        def local(opl, Bl, sl, X0l, rt, at):
            def f(b, s, x0):
                psolve = _resolve_precond(precond, "minres", opl, s, gf_sign)
                return _minres_fixed(_shifted_matvec(opl, s, gf_sign), b, x0,
                                     rt, at, maxiter, psolve=psolve)
            return jax.vmap(f)(Bl, sl, X0l)

        return local(op, B, sig, X0, jnp.asarray(rtol), jnp.asarray(atol))

    return run


@functools.partial(jax.jit, static_argnames=("restart", "maxiter", "precond"))
def _gmres_batch_jit(op, bs, sigmas, x0s, rtol, atol, gf_sign, restart,
                     maxiter, precond=None):
    def f(b, s, x0):
        psolve = _resolve_precond(precond, "gmres", op, s, gf_sign, bs.dtype)
        return _gmres_fixed(_shifted_matvec(op, s, gf_sign), b, x0,
                            rtol, atol, restart, maxiter, psolve=psolve)
    return jax.vmap(f)(bs, sigmas, x0s)


def minres(op, b, sigma, x0=None, rtol=1e-4, atol=0.0, maxiter=1000,
           reverseGF=False, precond=None) -> SolveResult:
    """Hermitian shifted solve (sigma*I - H) x = b via MINRES
    (``precond="jacobi"`` for absolute-value Jacobi preconditioning)."""
    x0 = jnp.zeros_like(b) if x0 is None else x0
    return _minres_jit(op, b, sigma, x0, rtol, atol,
                       -1.0 if reverseGF else 1.0, maxiter, precond=precond)


def gmres(op, b, sigma, x0=None, rtol=1e-4, atol=0.0, restart=30,
          maxiter=1000, reverseGF=False, precond=None) -> SolveResult:
    """General shifted solve via restarted GMRES (handles complex sigma;
    ``precond="jacobi"`` for right Jacobi preconditioning)."""
    dtype = jnp.result_type(b.dtype, jnp.asarray(sigma).dtype, op.dtype)
    b = b.astype(dtype)
    x0 = jnp.zeros_like(b) if x0 is None else x0.astype(dtype)
    return _gmres_jit(op, b, jnp.asarray(sigma, dtype), x0, rtol, atol,
                      -1.0 if reverseGF else 1.0, restart, maxiter,
                      precond=precond)


def minres_batch(op, bs, sigmas, x0s=None, rtol=1e-4, atol=0.0, maxiter=1000,
                 reverseGF=False, precond=None) -> SolveResult:
    """Batched MINRES over leading axis of (bs, sigmas).

    When ``bs`` is sharded over a mesh's "b" axis only (lanes distributed,
    state local — the FEAST/block-Lanczos placement), the solve routes
    through an explicit shard_map schedule with a device-LOCAL while loop:
    zero collectives, instead of GSPMD's per-iteration global termination
    reduce."""
    x0s = jnp.zeros_like(bs) if x0s is None else x0s
    gf_sign = -1.0 if reverseGF else 1.0
    sig = jnp.asarray(sigmas)
    mesh = _lane_sharded_mesh(bs)
    if mesh is not None and bs.shape[0] % dict(mesh.shape)["b"] == 0:
        fn = _minres_batch_local_fn(mesh, maxiter, precond, gf_sign)
        return fn(op, bs, sig, x0s, rtol, atol)
    return _minres_batch_jit(op, bs, sig, x0s, rtol, atol,
                             gf_sign, maxiter, precond=precond)


def gmres_batch(op, bs, sigmas, x0s=None, rtol=1e-4, atol=0.0, restart=30,
                maxiter=1000, reverseGF=False, precond=None) -> SolveResult:
    """Batched GMRES over leading axis of (bs, sigmas); used for FEAST's
    quadrature-node solves."""
    sigmas = jnp.asarray(sigmas)
    dtype = jnp.result_type(bs.dtype, sigmas.dtype, op.dtype)
    bs = bs.astype(dtype)
    x0s = jnp.zeros_like(bs) if x0s is None else x0s.astype(dtype)
    return _gmres_batch_jit(op, bs, sigmas.astype(dtype), x0s, rtol, atol,
                            -1.0 if reverseGF else 1.0, restart, maxiter,
                            precond=precond)


@jax.jit
def _solve_exact_jit(mat, b, sigma, gf_sign):
    n = mat.shape[0]
    dtype = jnp.result_type(mat.dtype, b.dtype, sigma.dtype)
    A = gf_sign * (sigma * jnp.eye(n, dtype=dtype) - mat.astype(dtype))
    return jnp.linalg.solve(A, b.astype(dtype))


def solve_exact(op, b, sigma, reverseGF=False) -> SolveResult:
    """Exact dense solve of (sigma*I - H) x = b; oracle/test path
    (the reference's misnamed "pardiso" option, numpyVector.py:164-171)."""
    from .operators import PaddedOperator
    if isinstance(op, PaddedOperator):
        # Solve on the logical block (the zero-embedded block makes
        # sigma*I - H_pad singular at sigma == 0) and re-pad.
        n = op.op.shape[0]
        inner = solve_exact(op.op, b[:n], sigma, reverseGF=reverseGF)
        x = jnp.concatenate(
            [inner.x, jnp.zeros(op.n_pad - n, inner.x.dtype)])
        return SolveResult(x, inner.resnorm, inner.iterations,
                           inner.converged)
    mat = op.to_dense()
    x = _solve_exact_jit(mat, b, _sigma_array(sigma, mat.dtype, b.dtype),
                         -1.0 if reverseGF else 1.0)
    return SolveResult(x, jnp.zeros((), jnp.float64), jnp.ones((), jnp.int32),
                       jnp.asarray(True))


def _sigma_array(sigma, *operand_dtypes):
    """Shift scalar at the precision of the operands: complex64 shifts on
    f32 data, complex128 on f64; real shifts stay real."""
    width = max(jnp.dtype(jnp.result_type(d)).itemsize
                for d in operand_dtypes)
    # cast in numpy BEFORE the device transfer: a weak c128 scalar would
    # otherwise promote an f32 problem to c128 on the device
    if np.iscomplexobj(sigma) and np.imag(sigma) != 0:
        return jnp.asarray(
            np.asarray(sigma, np.complex64 if width <= 4 else np.complex128))
    return jnp.asarray(
        np.asarray(np.real(sigma), np.float32 if width <= 4 else np.float64))


@jax.jit
def _solve_exact_multi_jit(mat, B, sigma, gf_sign):
    """One factorization of (sigma*I - H), all RHS columns at once."""
    n = mat.shape[0]
    dtype = jnp.result_type(mat.dtype, B.dtype, sigma.dtype)
    A = gf_sign * (sigma * jnp.eye(n, dtype=dtype) - mat.astype(dtype))
    return jnp.linalg.solve(A, B.T.astype(dtype)).T


def solve_exact_batch(op, B, sigmas, reverseGF=False):
    """Exact dense solves of (sigma_k*I - H) x_k = b_k for a lane stack
    B (nlanes, n).  Lanes sharing a shift share ONE factorization with a
    multi-RHS triangular solve (FEAST's nk x m0 lane layout repeats each
    contour node m0 times; the per-lane loop would refactorize m0 times
    per node — reference counterpart: the per-solve spsolve calls at
    numpyVector.py:164-171).  Returns a list of SolveResult."""
    from .operators import PaddedOperator
    sig = np.asarray(sigmas).ravel()
    if isinstance(op, PaddedOperator):
        n = op.op.shape[0]
        inner = solve_exact_batch(op.op, B[:, :n], sigmas,
                                  reverseGF=reverseGF)
        pad = jnp.zeros(op.n_pad - n, inner[0].x.dtype)
        return [SolveResult(jnp.concatenate([r.x, pad]), r.resnorm,
                            r.iterations, r.converged) for r in inner]
    mat = op.to_dense()
    gf = -1.0 if reverseGF else 1.0
    xs = [None] * len(sig)
    for s in sorted(set(sig.tolist()), key=lambda z: (np.real(z), np.imag(z))):
        lanes = np.nonzero(sig == s)[0]
        X = _solve_exact_multi_jit(mat, B[jnp.asarray(lanes)],
                                   _sigma_array(s, mat.dtype, B.dtype), gf)
        for j, lane in enumerate(lanes):
            xs[int(lane)] = X[j]
    zero = jnp.zeros((), jnp.float64)
    one = jnp.ones((), jnp.int32)
    true = jnp.asarray(True)
    return [SolveResult(x, zero, one, true) for x in xs]


# ----------------------------------------------------------------------------
# Split-complex shifted solves — the all-real path for FEAST's complex
# contour shifts (SURVEY.md §7 "complex shifted solves").  For real symmetric
# H and sigma = a + ib the 2x2 real
# block form of (sigma I - H) x = b,
#     A_blk = [[aI - H, -bI], [bI, aI - H]],
# is non-symmetric (restarted GMRES stagnates: its spectrum
# {sigma-lam} ∪ {conj(sigma)-lam} encircles 0), but J A_blk with
# J = diag(I, -I) IS symmetric indefinite with eigenvalues
# ±sqrt((a-lam)^2 + b^2) — condition ~ |sigma - lam|, NOT squared — so
# all-real MINRES applies with the same conditioning as a complex solve
# (f32-viable; the quadratic (aI-H)^2 + b^2 alternative squares kappa and
# stagnates at f32 roundoff).  ||J r|| = ||r||, so the MINRES residual is
# exactly the complex-system residual and the stopping contract carries over.
# ----------------------------------------------------------------------------
def _jsym_block_matvec(op, a, bimag, n):
    """(J A_blk) u for u = [xr; xi]: rows (A1 xr - b xi, -b xr - A1 xi) with
    A1 = aI - H.  The two H applications per iteration run as ONE batched
    apply over the stacked (2, n) halves — under the outer lane vmap that
    is a single matmat, so H streams from HBM once per iteration instead
    of twice (the solve is bandwidth-bound on the operator fetch)."""
    def mv(u):
        U = u.reshape(2, n)
        A1 = a * U - jax.vmap(op.matvec)(U)          # rows: (A1 xr, A1 xi)
        return jnp.concatenate([A1[0] - bimag * U[1],
                                -bimag * U[0] - A1[1]])
    return mv


def _jacobi_jsym(op, a, bimag, n):
    """SPD (absolute-value) Jacobi for the J-symmetrized block system:
    |diag| = sqrt((a - d)^2 + b^2) on both halves."""
    d = op.diagonal()
    if d is None:
        return None
    m = jnp.sqrt((a - d) ** 2 + bimag * bimag)
    floor = 1e-8 * jnp.maximum(jnp.max(m), 1.0)
    minv = 1.0 / jnp.maximum(m, floor)
    minv2 = jnp.concatenate([minv, minv])
    return lambda r: minv2 * r


@functools.partial(jax.jit, static_argnames=("maxiter", "precond",
                                             "escalate"))
def _splitc_batch_jit(op, bs, sig_re, sig_im, x0s, rtol, atol, gf_sign,
                      maxiter, precond=None, escalate=3):
    n = bs.shape[-1]
    # attainable-floor clamp: an f32 MINRES cannot resolve residuals at the
    # roundoff scale — a warm-tightened rtol below ~25*eps would only burn
    # the full budget and report non-convergence at the floor (VERDICT r3
    # weak #3: the adaptive inexact-FEAST schedule requested 1e-10 from f32
    # solves).  The Rayleigh-Ritz f64 carry averages the residual-floor
    # noise down, so clamping here does not limit the outer accuracy.
    rtol = jnp.maximum(jnp.asarray(rtol),
                       25.0 * np.finfo(np.dtype(bs.dtype)).eps)

    def f(b, a, bi, x0):
        if precond in (None, "none"):
            psolve = None
        elif precond == "jacobi":
            psolve = _jacobi_jsym(op, a, bi, n)
        else:
            raise ValueError(
                f"unknown preconditioner {precond!r}; available: jacobi")
        # rhs = J [b; 0] = [b; 0]; solution u = [Re x, Im x].  The inner
        # system is always the +1-signed (sigma*I - H); a caller warm start
        # guesses the gf_sign-signed solution, so flip it to match (x0 is
        # the full split guess [Re x0; Im x0], length 2n).
        rhs = jnp.concatenate([b, jnp.zeros_like(b)])
        mv = _jsym_block_matvec(op, a, bi, n)
        x0i = gf_sign * x0
        # warm-start guard: early FEAST iterations seed x0 = Y/(z - ev)
        # from UNCONVERGED Ritz data, which can inflate ||rhs - A x0|| far
        # above ||rhs|| (measured 8.7e-1 stagnation residuals on unit RHS)
        # — per lane, fall back to the zero start when the seed is worse
        # than no seed.
        r0 = jnp.linalg.norm(rhs - mv(x0i))
        keep = (r0 <= jnp.linalg.norm(rhs)).astype(x0i.dtype)
        res = _minres_fixed(mv, rhs, keep * x0i, rtol, atol, maxiter,
                            psolve=psolve)
        if escalate:
            # lane-level iteration boost: lanes that exhausted maxiter
            # continue (warm-restarted from their current iterate) with an
            # extended budget; converged lanes' while_loop exits at entry,
            # so under the vmap the boost only iterates where it helps.
            # The near-real-axis contour nodes need ~1.6x the budget the
            # mid-contour nodes need (kappa ~ 1/|Im z|); a flat maxiter
            # either starves them or overpays everywhere else.
            res2 = _minres_fixed(mv, rhs, res.x, rtol, atol,
                                 int(escalate) * maxiter, psolve=psolve)
            res = SolveResult(res2.x, res2.resnorm,
                              res.iterations + res2.iterations,
                              res2.converged)
        x = gf_sign * res.x
        return SolveResult(x.reshape(2, n), res.resnorm, res.iterations,
                           res.converged)
    return jax.vmap(f)(bs, sig_re, sig_im, x0s)


def gmres_splitc_batch(op, bs_real, sigmas, x0s=None, rtol=1e-4, atol=0.0,
                       restart=30, maxiter=1000, reverseGF=False,
                       precond=None, escalate=3) -> SolveResult:
    """Batched complex-shifted solves of a REAL symmetric operator without
    any complex dtype on device (J-symmetrized real-block MINRES; see module
    comment above).  ``bs_real`` (nlanes, n) real right-hand sides;
    ``sigmas`` complex.  ``x0s`` warm starts: real (nlanes, n) (imaginary
    half seeded zero) or full split guesses (nlanes, 2, n) / (nlanes, 2n);
    a per-lane guard falls back to the zero start when a seed is worse than
    none.  ``escalate``: unconverged lanes continue warm-restarted with up
    to ``escalate * maxiter`` extra iterations (0 disables) — the
    near-real-axis FEAST nodes legitimately need more iterations than the
    rest of the contour, and under the vmap the boost only iterates on
    lanes that still need it.  Returns SolveResult with x of shape
    (nlanes, 2, n) = (Re x, Im x).  ``restart`` is accepted for signature
    parity and ignored (MINRES is a short recurrence)."""
    bs_real = jnp.asarray(bs_real)
    nl, n = bs_real.shape
    sig = np.asarray(sigmas, np.complex128)
    rdtype = bs_real.dtype
    if x0s is None:
        X0 = jnp.zeros((nl, 2 * n), rdtype)
    else:
        X0 = jnp.asarray(x0s)
        if X0.ndim == 2 and X0.shape[1] == n:    # real guess, zero imag half
            X0 = jnp.concatenate([X0, jnp.zeros_like(X0)], axis=1)
        else:
            X0 = X0.reshape(nl, 2 * n)
    return _splitc_batch_jit(
        op, bs_real, jnp.asarray(sig.real, rdtype),
        jnp.asarray(sig.imag, rdtype), X0.astype(rdtype), rtol, atol,
        -1.0 if reverseGF else 1.0, maxiter, precond=precond,
        escalate=int(escalate))
