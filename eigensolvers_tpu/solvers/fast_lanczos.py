"""Fused inexact-Lanczos driver — the latency-optimized dense/sharded path.

Same algorithm and convergence semantics as
:func:`~eigensolvers_tpu.solvers.lanczos.inexactLanczosDiagonalization`, but
the per-iteration work (nBlock shifted solves, orthogonalization, new S/H
columns) runs as ONE jitted device program
(:func:`~eigensolvers_tpu.solvers.step.block_krylov_step`) against a
persistent padded basis buffer, and only the small m-sized subspace columns
cross the host boundary: 2 host round trips per Krylov iteration instead
of ~15 tiny host-synced ops.

Differences from the list-based driver (documented, none affect the
convergence contract):
  * orthogonalization is conjugated CGS2 instead of the reference-quirk
    non-conjugated MGS (identical for real data up to roundoff);
  * the basis buffer is preallocated at ``nBlock*(L-1)+nBlock`` rows padded
    to a power of two — no dynamic shapes;
  * pick functions are supported through lazy basis-row proxies whose
    ``vdot`` against a reference state is computed as ONE batched device
    dot per (iteration, reference) — state-following (maxOvlp) runs at
    fused-path speed.

Returns the same (ev, vectors, status) triple; vectors come back as backend
vectors reconstructed from the basis buffer.
"""

from __future__ import annotations

import functools
import time
import warnings
from typing import List, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.operators import as_operator
from ..utils.status import lanczos_status
from ..utils.subspace import (
    basisTransformation,
    diagonalizeHamiltonian,
    lowdinOrthoMatrix,
)
from ..utils.profiling import PhaseTimer
from ..utils.reporting import LanczosReporter
from ..utils import checkpointing
from ..vectors.abstract import AbstractVector
from ..vectors.dense import JaxVector, _pad_rows
from .step import block_krylov_step
from ..ops.linear_solvers import _HI
from .lanczos import analyzeStatus, checkConvergence


@jax.jit
def _pack_step_outputs(out):
    """Pack the step's host-bound small outputs into ONE array so a single
    device->host transfer carries them (each fetch is a host
    synchronization)."""
    dtype = out.h_cols.dtype
    return jnp.concatenate(
        [out.h_cols, out.s_cols,
         out.solve_resnorms[:, None].astype(dtype),
         out.lindep_flags[:, None].astype(dtype)], axis=1)


@jax.jit
def _restart_kernel(V, coeffs):
    """New guesses from Ritz coefficients: (nBlock, n) = coeffs^T V,
    normalized."""
    G = jnp.matmul(coeffs.T, V, precision=_HI)
    nrm = jnp.linalg.norm(G, axis=1, keepdims=True)
    return G / jnp.where(nrm > 0, nrm, 1.0)


@functools.partial(jax.jit, static_argnames=("conj",))
def _ovlp_col_kernel(V, r, conj=True):
    """<v_j | r> (or the non-conjugated dot) for all stacked basis rows —
    one device dot."""
    return jnp.matmul(V.conj() if conj else V, r, precision=_HI)


def _row_proxies(V, nvec):
    """Lazy stand-ins for the Krylov basis list, for pick functions
    (which only use ``vdot`` — both reference pick families do,
    reference: util_funcs.py:305-344): the overlap column against each
    distinct reference vector is computed once on device and cached."""
    # cache value holds a reference to the keyed object so its id cannot be
    # reused by a new object while the entry is alive (CPython id-reuse
    # aliasing)
    cache = {}

    class _Row:
        __slots__ = ("i",)

        def __init__(self, i):
            self.i = i

        def vdot(self, other, conjugate: bool = True):
            key = (id(other), conjugate)
            if key not in cache:
                arr = jnp.asarray(np.asarray(other.array).ravel())
                cache[key] = (other, np.asarray(
                    _ovlp_col_kernel(V, arr, conj=conjugate)))
            val = cache[key][1][self.i]
            return complex(val) if np.iscomplexobj(val) else float(val)

    return [_Row(i) for i in range(nvec)]


@jax.jit
def _guess_block_kernel(op, G):
    """<g_i | H g_j> for stacked guesses G (k, n) — one device program."""
    return jnp.matmul(G.conj(), jax.vmap(op.matvec)(G).T,
                      precision=_HI)


@jax.jit
def _restart_block_kernel(op, V, coeffs):
    """Fused restart: new normalized guesses G = coeffs^T V and their
    projected H block, returned together (one transfer for the block; G
    stays on device)."""
    G = jnp.matmul(coeffs.T, V, precision=_HI)
    nrm = jnp.linalg.norm(G, axis=1, keepdims=True)
    G = G / jnp.where(nrm > 0, nrm, 1.0)
    return G, jnp.matmul(G.conj(), jax.vmap(op.matvec)(G).T, precision=_HI)


def fastLanczosDiagonalization(
        H, v0: Union[AbstractVector, List[AbstractVector], np.ndarray],
        sigma, L, maxit, eConv,
        Hsolve=None, status=None, pick=None,
        rtol: Optional[float] = None, solve_maxiter: Optional[int] = None,
        writeOut=False, eShift=0.0, convertUnit="au",
        outFileName=None, summaryFileName=None,
        saveEachIteration=False, saveDir="saveKrylov",
        checkFitTol=1e-7):
    """Fused-path inexact shift-and-invert (block) Lanczos.

    Accepts JaxVector(s) (options read from the first guess) or a raw
    (nBlock, n) / (n,) array.  See module docstring for the deltas vs the
    general driver.  Reporting (``writeOut`` — default off on this
    latency-optimized path), per-iteration checkpointing
    (``saveEachIteration``), complex/general shifts (routed through the
    fused GMRES kernel) and ``linearSystemArgs["preconditioner"]`` carry the
    same semantics as
    :func:`~eigensolvers_tpu.solvers.lanczos.inexactLanczosDiagonalization`.
    """
    # -- normalize inputs ----------------------------------------------------
    if isinstance(v0, AbstractVector):
        v0 = [v0]
    if isinstance(v0, (list, tuple)):
        options = getattr(v0[0], "options", {}) or {}
        guesses = np.stack([np.asarray(v.array).ravel() for v in v0])
        # round-trip the backend type: sharded callers get ShardedVector
        # results (sharding/options semantics preserved)
        vec_cls = type(v0[0])
        vec_mesh = getattr(v0[0], "mesh", None)
    else:
        options = {}
        arr = np.asarray(v0)
        guesses = arr[None, :] if arr.ndim == 1 else arr
        vec_cls = JaxVector
        vec_mesh = None
    nBlock, n = guesses.shape
    opts = options.get("linearSystemArgs", {})
    rtol = rtol if rtol is not None else opts.get("linear_tol", 1e-4)
    solve_maxiter = solve_maxiter if solve_maxiter is not None else \
        opts.get("linearIter", 1000)

    # honor the vector class's operator coercion so padded ShardedVector
    # states (length rounded up to the mesh extent) get PaddedOperator
    # reconciliation exactly like the general driver
    if isinstance(v0, (list, tuple)) and hasattr(type(v0[0]), "_as_operator"):
        _coerce = lambda h: type(v0[0])._as_operator(h, v0[0])
    else:
        _coerce = as_operator
    op = _coerce(Hsolve if Hsolve is not None else H)
    opH = _coerce(H)
    # complex shifts upcast the basis buffer and route through the fused
    # GMRES kernel (same solver-selection rule as JaxVector._solve_opts:
    # MINRES needs a Hermitian system, so it requires a real shift)
    sigma_complex = np.iscomplexobj(np.asarray(sigma))
    dtype = np.result_type(np.dtype(op.dtype), guesses.dtype,
                           np.asarray(sigma).dtype if sigma_complex
                           else np.dtype(np.float32))
    solver = opts.get("linearSolver", "minres")
    solver = {"gcrotmk": "gmres", "pardiso": "exact"}.get(solver, solver)
    if solver not in ("minres", "gmres"):
        raise ValueError(
            f"fused driver supports linearSolver minres/gmres (alias "
            f"gcrotmk), got {solver!r}")
    if sigma_complex:
        solver = "gmres"
    elif solver == "gmres":
        # Hermitian system with a real shift: MINRES is the optimal short
        # recurrence (same routing as the general driver)
        solver = "minres"
    precond = opts.get("preconditioner")
    restart = opts.get("gmresRestart", 30)

    # orthonormalize guesses via the contract whole-set QR (one device QR;
    # reference: abstractVector.py:112 / util_funcs.py:170-194)
    gset = JaxVector.orthogonalize(
        [JaxVector(np.asarray(g, dtype=dtype), options) for g in guesses])
    if len(gset) < nBlock:
        raise RuntimeError(
            f"only {len(gset)} of {nBlock} guess vectors are linearly "
            f"independent")
    guesses = np.ascontiguousarray(
        np.stack([np.asarray(g.array).ravel() for g in gset]), dtype=dtype)

    M_needed = nBlock * L
    M = _pad_rows(M_needed)
    V = jnp.zeros((M, n), dtype)
    V = V.at[:nBlock].set(guesses)
    nvec = nBlock

    Smat = np.eye(nBlock, dtype=dtype)
    # initial H block <v_i|H|v_j>: one device program, one transfer
    Hmat = np.asarray(_guess_block_kernel(opH, jnp.asarray(guesses)))

    class _StatusGuess:
        hasExactAddition = True
    status = lanczos_status(status, _StatusGuess(), nBlock)

    # reporter hook (same two-file output as the general driver); the header
    # reads solver settings from a representative guess vector
    if pick is None:
        from ..utils.subspace import get_pick_function_close_to_sigma
        report_pick = get_pick_function_close_to_sigma(sigma)
    else:
        report_pick = pick
    printObj = LanczosReporter(
        JaxVector(guesses[0], options), sigma, L, maxit, eConv, checkFitTol,
        status.get("writeOut", writeOut), eShift, convertUnit, report_pick,
        status, outFileName, summaryFileName)
    printObj.fileHeader()

    timer = PhaseTimer()
    ev = np.full(nBlock, np.nan)
    uSH = None
    continueIteration = True
    sig = jnp.asarray(sigma, dtype)
    rt = jnp.asarray(rtol, dtype)

    # Speculative pipelining: JAX dispatch is async, so the NEXT Krylov step
    # is enqueued before the host blocks on the current step's small-output
    # transfer — the device computes step i+1 while the host does step i's
    # subspace bookkeeping.  Step i+1 only needs V_{i+1} (device) and the new
    # rows as seeds, both available without a fetch; if step i converges or
    # hits lindep, the speculative result is simply dropped (semantics
    # identical to the sequential loop).
    spec = None  # (out, nvec it was dispatched for, V it read)
    for outerIter in range(maxit):
        status["outerIter"] = outerIter
        status["KSmaxD"] = [0]
        for innerIter in range(1, L):
            status["innerIter"] = innerIter
            status["cumIter"] += 1

            with timer.phase("fused_step"):
                if spec is not None and spec[1] == nvec:
                    out = spec[0]
                else:
                    seeds = jax.lax.dynamic_slice_in_dim(
                        V, nvec - nBlock, nBlock, axis=0)
                    out = block_krylov_step(op, V, jnp.asarray(nvec), seeds,
                                            sig, rt, maxiter=solve_maxiter,
                                            solver=solver, precond=precond,
                                            restart=restart)
                spec = None
                packed_dev = _pack_step_outputs(out)
                V_next = jax.lax.dynamic_update_slice_in_dim(
                    V, out.new_vectors, nvec, axis=0)
                if innerIter + 1 < L:
                    out2 = block_krylov_step(
                        op, V_next, jnp.asarray(nvec + nBlock),
                        out.new_vectors, sig, rt, maxiter=solve_maxiter,
                        solver=solver, precond=precond, restart=restart)
                    spec = (out2, nvec + nBlock, V_next)
                packed = np.asarray(packed_dev)  # ONE transfer, overlapped
                Mtot = out.h_cols.shape[1]
                h_cols = packed[:, :Mtot]
                s_cols = packed[:, Mtot:2 * Mtot]
                resnorms = packed[:, 2 * Mtot].real
                lindep_flags = packed[:, 2 * Mtot + 1].real > 0.5

            # solves are on normalized seeds; resnorm is absolute vs ||b||=1
            status["solveResidualMax"] = max(
                float(np.max(resnorms)), status.get("solveResidualMax", 0.0))
            if np.any(lindep_flags):
                status["lindep"] = True
                spec = None
                warnings.warn(
                    f"Linear dependency in fused step at iteration "
                    f"{outerIter}/{innerIter}; stopping with current basis")
                break

            # accept new vectors: extend S/H from the fused columns
            with timer.phase("subspace_update"):
                V = V_next
                mtot = nvec + nBlock
                Snew = np.zeros((mtot, mtot), dtype=s_cols.dtype)
                Snew[:nvec, :nvec] = Smat[:nvec, :nvec] if Smat.shape[0] >= nvec \
                    else Smat
                Hnew = np.zeros((mtot, mtot), dtype=h_cols.dtype)
                Hnew[:nvec, :nvec] = Hmat[:nvec, :nvec] if Hmat.shape[0] >= nvec \
                    else Hmat
                for i in range(nBlock):
                    m_i = nvec + i + 1
                    Snew[:m_i, nvec + i] = s_cols[i, :m_i]
                    Snew[nvec + i, :m_i] = s_cols[i, :m_i].conj()
                    Snew[nvec + i, nvec + i] = s_cols[i, nvec + i].real
                    Hnew[:m_i, nvec + i] = h_cols[i, :m_i]
                    Hnew[nvec + i, :m_i] = h_cols[i, :m_i].conj()
                Smat, Hmat = Snew, Hnew
                nvec = mtot

            printObj.writeFile("iteration", status)
            printObj.writeFile("overlap", Smat)

            with timer.phase("diagonalize"):
                status, uS = lowdinOrthoMatrix(Smat.astype(np.float64)
                                               if not np.iscomplexobj(Smat)
                                               else Smat.astype(np.complex128),
                                               status)
                ev, uv = diagonalizeHamiltonian(uS, Hmat.astype(uS.dtype))
                uSH = uS @ uv
                if pick is None:
                    idx = np.argsort(np.abs(ev - sigma))
                else:
                    idx = pick(uSH, _row_proxies(V, uSH.shape[0]), ev)
                ev = ev[idx]
                uSH = uSH[:, idx]

            status = checkConvergence(ev, eConv, status, printObj)
            continueIteration = analyzeStatus(status, maxit, L)

            if saveEachIteration:
                # backend-neutral checkpoint of the live basis (opt-in; one
                # device->host transfer of the valid rows)
                rows = np.asarray(V[:nvec])
                Ylist_ckpt = [JaxVector(rows[i], options)
                              for i in range(nvec)]
                checkpointing.save_checkpoint(
                    saveDir, status["cumIter"], Ylist_ckpt, status,
                    eigencoefficients=uSH, eigenvalues=ev)

            if not continueIteration:
                break
        if status.get("lindep") or not continueIteration:
            break
        # restart from the first nBlock Ritz vectors (one device call, one
        # transfer for the small projected block; G stays on device)
        spec = None  # speculation read the pre-restart basis — drop it
        with timer.phase("restart"):
            coeffs = np.zeros((M, nBlock), dtype=dtype)
            coeffs[:nvec, :] = uSH[:, :nBlock].astype(dtype)
            G, Hblk = _restart_block_kernel(opH, V, jnp.asarray(coeffs))
            V = jnp.zeros((M, n), dtype).at[:nBlock].set(G)
            nvec = nBlock
            Smat = np.eye(nBlock, dtype=dtype)
            Hmat = np.asarray(Hblk)
            # uSH referred to the pre-restart basis; if the next sweep aborts
            # before producing a new one (e.g. first-iteration lindep), the
            # finalize falls back to the restart guesses — which ARE the
            # previous sweep's Ritz vectors (the stale-variable failure the
            # reference has at inexact_Lanczos.py:358, SURVEY.md §7).
            uSH = None

    # materialize Ritz vectors (one device call)
    with timer.phase("finalize"):
        k = uSH.shape[1] if uSH is not None else nBlock
        coeffs = np.zeros((M, k), dtype=dtype)
        if uSH is not None:
            coeffs[:nvec, :] = uSH.astype(dtype)
        else:
            coeffs[:nvec, :nvec] = np.eye(nvec, dtype=dtype)
        R = np.asarray(_restart_kernel(V, jnp.asarray(coeffs)))
    if vec_mesh is not None:
        vectors = [vec_cls(R[i], options, mesh=vec_mesh) for i in range(k)]
    else:
        vectors = [vec_cls(R[i], options) for i in range(k)]
    status["timers"] = timer.summary()
    status["runTime"] = time.time() - status["startTime"]
    printObj.writeFile("results", ev)
    printObj.fileFooter()
    printObj.close()
    return ev, vectors, status
