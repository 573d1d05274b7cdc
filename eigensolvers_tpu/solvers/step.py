"""Fused, jittable Krylov-step kernels — the compiled heart of the solver.

One ``block_krylov_step`` call performs, entirely on device in one XLA
program: the nBlock inexact shifted solves (vmapped MINRES over the batch
axis), CGS2 orthogonalization of the new vectors against the stacked basis
and each other, and the new overlap/Hamiltonian columns.  This is the
"training step" of this framework: under a ("b", "x") mesh the solves
batch over "b" (dp analog) and the state dimension shards over "x"
(tensor/sequence-parallel analog); inner products psum over "x"
(SURVEY.md §2.4).

Used by the multi-chip dry-run (``__graft_entry__.dryrun_multichip``), the
benchmark, and as the building block for fully-fused solver variants.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..ops.linear_solvers import (_HI, _gmres_fixed, _minres_fixed,
                                  _resolve_precond, _shifted_matvec)


class KrylovStepResult(NamedTuple):
    new_vectors: jax.Array   # (nBlock, n) orthonormalized Krylov vectors
    h_cols: jax.Array        # (nBlock, m+nBlock) new H columns (padded basis)
    s_cols: jax.Array        # (nBlock, m+nBlock) new S columns
    solve_resnorms: jax.Array  # (nBlock,)
    lindep_flags: jax.Array    # (nBlock,) True where orthogonalization collapsed


@functools.partial(jax.jit, static_argnames=("maxiter", "solver", "precond",
                                              "restart"))
def block_krylov_step(op, V, nvec, seeds, sigma, rtol, maxiter=200,
                      lindep=1e-14, solver="minres", precond=None,
                      restart=30):
    """One block-Lanczos Krylov step, fused.

    :param op: operator pytree (Hermitian)
    :param V: (M, n) stacked basis buffer, rows >= nvec zero.  Valid rows
        MUST be mutually orthonormal (the Krylov iteration maintains this
        invariant); classical Gram-Schmidt projections against a
        non-orthonormal set do not orthogonalize.
    :param nvec: number of valid rows in V (traced scalar)
    :param seeds: (nBlock, n) right-hand sides (the latest block vectors)
    :param sigma: shift (complex shifts require ``solver="gmres"`` and a
        complex-dtype basis buffer)
    :param solver: inner shifted solver — "minres" (Hermitian system, the
        default) or "gmres" (general/complex shifts)
    :param precond: None or "jacobi" (same option surface as the general
        driver's linearSystemArgs["preconditioner"])
    :param restart: GMRES restart length (ignored by minres)
    :returns: :class:`KrylovStepResult`; new vectors are zero rows where
        linear dependence was detected.
    """
    M, n = V.shape
    nBlock = seeds.shape[0]

    matvec = _shifted_matvec(op, sigma, 1.0)
    psolve = _resolve_precond(precond, solver, op, sigma, 1.0, seeds.dtype)

    def solve_one(b):
        if solver == "minres":
            res = _minres_fixed(matvec, b, jnp.zeros_like(b), rtol, 0.0,
                                maxiter, psolve=psolve)
        elif solver == "gmres":
            res = _gmres_fixed(matvec, b, jnp.zeros_like(b), rtol, 0.0,
                               restart, maxiter, psolve=psolve)
        else:
            raise ValueError(f"unknown solver {solver!r}")
        nrm = jnp.linalg.norm(res.x)
        x = res.x / jnp.where(nrm > 0, nrm, 1.0)
        return x, res.resnorm

    xs, resnorms = jax.vmap(solve_one)(seeds)

    # Orthogonalize the block vectors against the basis and each other —
    # batched collective schedule: the per-vector unrolled CGS2 loop cost
    # 3 all-reduces PER block vector on a state-sharded mesh (2 projection
    # matmuls + 1 norm); here ALL nBlock vectors project against the basis
    # in ONE (M, nBlock) matmul per CGS pass (2 all-reduces total,
    # independent of nBlock), and the mutual orthonormalization runs as a
    # masked CholQR on the replicated (nBlock, nBlock) Gram matrix — one
    # all-reduce for the Gram, then only local small-matrix arithmetic.
    # Same semantics: the Cholesky pivot d_i is exactly the squared norm of
    # x_i orthogonalized against the basis AND the previous block vectors,
    # so the lindep test (d_i > lindep -> else zero row + flag) matches the
    # sequential path's ``nrm2 > lindep``.
    row_ids = jnp.arange(M)
    mask = (row_ids < nvec).astype(V.dtype)
    X = xs.astype(V.dtype)
    # ALL matmuls pin HIGHEST precision: a default-precision f32 matmul may
    # run in TF32 on NVIDIA GPUs (~1e-3 relative per product), which the
    # CholQR Gram cannot afford (its conditioning is the square of the basis
    # conditioning).
    for _ in range(2):                     # CGS2 against the existing basis
        Hproj = jnp.matmul(V.conj(), X.T, precision=_HI) * mask[:, None]
        X = X - jnp.matmul(V.T, Hproj, precision=_HI).T   # one all-reduce
    G = jnp.matmul(X.conj(), X.T, precision=_HI)   # (nBlock, nBlock): one AR

    # masked Cholesky G = L L^H with lindep pivots skipped (replicated)
    L = jnp.zeros((nBlock, nBlock), V.dtype)
    oks = []
    for i in range(nBlock):
        d = jnp.real(G[i, i])
        for k in range(i):
            d = d - jnp.abs(L[i, k]) ** 2
        ok = d > lindep
        oks.append(ok)
        lii = jnp.sqrt(jnp.where(ok, d, 1.0)).astype(V.dtype)
        L = L.at[i, i].set(jnp.where(ok, lii, 1.0))
        for j in range(i + 1, nBlock):
            s = G[j, i]
            for k in range(i):
                s = s - L[j, k] * L[i, k].conj()
            L = L.at[j, i].set(jnp.where(ok, s / L[i, i], 0.0))
    lindep_flags = jnp.stack([~o for o in oks])

    # W = L^{-1} X by forward substitution (local: L replicated, X sharded)
    rows = []
    for i in range(nBlock):
        w = X[i]
        for k in range(i):
            w = w - L[i, k] * rows[k]
        w = w / L[i, i]
        rows.append(jnp.where(oks[i], 1.0, 0.0) * w)
    newV = jnp.stack(rows)

    # insert the new rows into the padded basis (local select ops)
    Vwork = V
    nv = nvec
    for i in range(nBlock):
        Vwork = jnp.where((row_ids == nv)[:, None], newV[i][None, :], Vwork)
        nv = nv + jnp.where(oks[i], 1, 0)

    # New S/H columns against the extended basis (padded length M), both
    # column families through ONE stacked matmul (one all-reduce):
    # s_cols[i, j] = <v_j | w_i>, h_cols[i, j] = <v_j | H w_i>
    AV = jax.vmap(op.matvec)(newV)
    C = jnp.matmul(Vwork.conj(), jnp.concatenate([newV, AV], axis=0).T,
                   precision=_HI)                              # (M, 2*nBlock)
    s_cols = C[:, :nBlock].T
    h_cols = C[:, nBlock:].T
    return KrylovStepResult(newV, h_cols, s_cols, resnorms, lindep_flags)
