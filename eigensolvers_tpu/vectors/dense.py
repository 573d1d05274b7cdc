"""JaxVector — the dense JAX backend of the AbstractVector contract.

Role parity with the reference's dense backend (reference: numpyVector.py),
re-designed for XLA:

* every heavy operation is a jitted, statically-shaped device computation;
* subspace assembly (overlap / operator matrices) is formulated as (m, n)
  matmuls instead of m^2 host-looped dots
  (reference: numpyVector.py:180-203 loops vdots);
* Gram-Schmidt orthogonalization is a ``lax.scan`` over a padded, stacked
  basis (one device program instead of m Python-level dot/axpy pairs);
* shifted solves dispatch to the jitted Krylov solvers in
  :mod:`eigensolvers_tpu.ops.linear_solvers`, with a batched path used by
  block Lanczos and FEAST.

Basis stacks are zero-padded to power-of-two row counts so the growing Krylov
space hits only O(log m) distinct compiled shapes.

The small m×m matrices are returned as host numpy arrays: the projected
eigenproblems are solved redundantly on host (LAPACK), which is the right
place for ~100×100 problems (SURVEY.md §2.4 item 3).
"""

from __future__ import annotations

import functools
import warnings
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .abstract import AbstractVector, LINDEP_DEFAULT_VALUE
from ..config import normalize_options
from ..ops.operators import as_operator
from ..ops import linear_solvers as ls

#: Subspace-algebra contractions (overlap/operator matrices, Gram-Schmidt
#: dots, linear combinations) run at true-f32 precision: a default-precision
#: f32 dot may run in TF32 on NVIDIA GPUs (~1e-3 relative per product),
#: which the Rayleigh-Ritz and lindep thresholds cannot afford.  Same convention as the operator
#: matvec (ops/operators.py::resolve_precision, default "highest").
_HI = jax.lax.Precision.HIGHEST


def _pad_rows(m: int) -> int:
    """Zero-pad row count: next power of two >= max(m, 32).

    The growing Krylov basis then hits very few distinct compiled shapes
    (32, 64, 128, ...), so a growing basis compiles O(log m) programs, not
    m.  The wasted rows are zeros (self-guarded in the kernels).
    """
    p = 32
    while p < m:
        p *= 2
    return p


# ----------------------------------------------------------------------------
# jitted collective kernels (stacked-basis formulations)
# ----------------------------------------------------------------------------
@jax.jit
def _overlap_kernel(V):
    """S = V V^H for stacked rows V (m, n)."""
    return jnp.matmul(V.conj(), V.T, precision=_HI)


#: Input bytes per vectorized chunk when the operator is applied to every
#: row of a stacked basis: a vmap over all rows would hold the operator's
#: intermediates for every row at once (for a sum-of-products operator,
#: terms x rows x n elements), which does not fit on one device once a
#: state is hundreds of MB.
_APPLY_CHUNK_BYTES = 256 * 2**20


def _apply_rows(op, V):
    """op applied to every row of V (m, n), vectorized over chunks of rows
    that hold at most ``_APPLY_CHUNK_BYTES`` of input (all rows at once for
    small states)."""
    row_bytes = V[0].size * V.dtype.itemsize
    chunk = max(1, min(V.shape[0], _APPLY_CHUNK_BYTES // max(row_bytes, 1)))
    return jax.lax.map(op.matvec, V, batch_size=chunk)


@jax.jit
def _apply_batch(op, V):
    return _apply_rows(op, V)


@jax.jit
def _matrep_kernel(op, V):
    AV = _apply_rows(op, V)
    return jnp.matmul(V.conj(), AV.T, precision=_HI)


@jax.jit
def _lincomb_kernel(V, coeffs):
    return jnp.matmul(coeffs, V, precision=_HI)


@jax.jit
def _lincomb_batch_kernel(V, C):
    # V (m, n) basis stack, C (m, k) coefficients -> (k, n) combined stack
    return jnp.matmul(C.T, V, precision=_HI)


@jax.jit
def _norm_kernel(x):
    return jnp.linalg.norm(x.ravel())


@jax.jit
def _normalize_kernel(x):
    return x / jnp.linalg.norm(x.ravel())


@functools.partial(jax.jit, static_argnames=("conj",))
def _vdot_kernel(a, b, conj=True):
    if conj:
        return jnp.vdot(a.ravel(), b.ravel(), precision=_HI)
    return jnp.dot(a.ravel(), b.ravel(), precision=_HI)


@jax.jit
def _ext_col_kernel(V, w):
    """col_i = <v_i | w> for stacked rows V."""
    return jnp.matmul(V.conj(), w, precision=_HI)


@jax.jit
def _ext_col_op_kernel(op, V, w):
    """col_i = <v_i | H w>."""
    return jnp.matmul(V.conj(), op.matvec(w), precision=_HI)


@jax.jit
def _quad_accum_kernel(S, mults):
    """Re[ sum_k mults[k] * S[k, i, :] ] — the FEAST quadrature
    accumulation as one contraction (S: (nk, m0, n) complex)."""
    return jnp.real(jnp.tensordot(mults, S, axes=([0], [0]), precision=_HI))


@jax.jit
def _quad_accum_split_kernel(S, mre, mim):
    """Split-complex FEAST accumulation: S (nk, m0, 2, n) real with
    S[..., 0, :] = Re(x), S[..., 1, :] = Im(x); out[i] =
    sum_k Re(mult_k)*Re(x_ki) - Im(mult_k)*Im(x_ki) — all-real arithmetic
    (no complex dtype touches the device)."""
    return (jnp.tensordot(mre, S[:, :, 0, :], axes=([0], [0]), precision=_HI)
            - jnp.tensordot(mim, S[:, :, 1, :], axes=([0], [0]), precision=_HI))


@jax.jit
def _mgs_kernel(x, Q):
    """Sequential (modified) Gram-Schmidt of x against stacked rows Q.

    For real data the dots are non-conjugated — a deliberate reproduction of
    the reference quirk (reference: numpyVector.py:133-140; SURVEY.md §7),
    which is identical to standard GS there.  For complex data that quirk is
    mathematically wrong (it does not orthogonalize against the Hermitian
    inner product; the reference has no complex coverage), so complex inputs
    use conjugated dots.  Zero padding rows are self-guarded.

    Returns (x_orth, innerprod) with innerprod = <x, x> (Hermitian for
    complex, plain for real — both real-valued for the lindep test).
    """
    complex_data = jnp.iscomplexobj(x) or jnp.iscomplexobj(Q)

    def step(x, q):
        if complex_data:
            term1 = jnp.vdot(q.ravel(), x.ravel(), precision=_HI)
            term2 = jnp.vdot(q.ravel(), q.ravel(), precision=_HI).real
        else:
            term1 = jnp.dot(x.ravel(), q.ravel(), precision=_HI)
            term2 = jnp.dot(q.ravel(), q.ravel(), precision=_HI)
        denom = jnp.where(jnp.abs(term2) > 0, term2, 1.0)
        x = x - (term1 / denom) * q
        return x, None

    x, _ = jax.lax.scan(step, x, Q)
    if complex_data:
        innerprod = jnp.vdot(x.ravel(), x.ravel(), precision=_HI).real
    else:
        innerprod = jnp.dot(x.ravel(), x.ravel(), precision=_HI)
    return x, innerprod


class JaxVector(AbstractVector):
    """Dense state vector backed by a jnp array (any tensor shape; treated as
    a flat vector by the inner products)."""

    def __init__(self, array, options: Optional[dict] = None):
        self.array = jnp.asarray(array)
        options = normalize_options(options)
        # Same option surface and defaults as the reference dense backend
        # (reference: numpyVector.py:29-36).
        opt = dict(options.get("linearSystemArgs", {}))
        opt.setdefault("linearSolver", "minres")
        opt.setdefault("linearIter", 1000)
        opt.setdefault("linear_tol", 1e-4)
        opt.setdefault("linear_atol", 1e-4)
        opt.setdefault("gmresRestart", 30)
        # Optional inner-solve preconditioning (None | "jacobi"); a framework
        # extension — the reference's scipy solvers were run unpreconditioned.
        opt.setdefault("preconditioner", None)
        # Reference escalates solver non-convergence warnings to errors
        # (reference: numpyVector.py:175-177).
        opt.setdefault("errorOnNonConvergence", True)
        options["linearSystemArgs"] = opt
        self.options = options

    # -- properties ---------------------------------------------------------
    @property
    def hasExactAddition(self) -> bool:
        return True

    @property
    def dtype(self):
        return np.dtype(self.array.dtype)

    @property
    def maxD(self) -> int:
        return 0  # uncompressed

    @property
    def size(self) -> int:
        return self.array.size

    @property
    def shape(self):
        return self.array.shape

    # -- scalar ops ---------------------------------------------------------
    def __mul__(self, other):
        return type(self)(self.array * other, self.options)

    def __rmul__(self, other):
        return type(self)(self.array * other, self.options)

    def __truediv__(self, other):
        return type(self)(self.array / other, self.options)

    def __imul__(self, other):
        self.array = self.array * other
        return self

    def __itruediv__(self, other):
        self.array = self.array / other
        return self

    def __len__(self) -> int:
        return int(self.array.size)

    def normalize(self) -> "JaxVector":
        self.array = _normalize_kernel(self.array)
        return self

    def norm(self) -> float:
        return float(_norm_kernel(self.array))

    def real(self) -> "JaxVector":
        return type(self)(jnp.real(self.array), self.options)

    def conjugate(self) -> "JaxVector":
        return type(self)(jnp.conj(self.array), self.options)

    def vdot(self, other, conjugate: bool = True):
        val = _vdot_kernel(self.array, other.array, conj=conjugate)
        return complex(val) if jnp.iscomplexobj(val) else float(val)

    def copy(self) -> "JaxVector":
        return type(self)(self.array, self.options)  # jnp arrays are immutable

    @classmethod
    def _as_operator(cls, H, ref: "JaxVector"):
        """Coerce H for application to ``ref``-shaped vectors.  Subclasses
        (ShardedVector) override to reconcile padding/sharding."""
        return as_operator(H)

    def applyOp(self, operator) -> "JaxVector":
        op = self._as_operator(operator, self)
        return type(self)(op.matvec(self.array), self.options)

    def compress(self) -> "JaxVector":
        return self

    def to_state_dict(self) -> dict:
        return {"kind": np.asarray("dense"), "array": np.asarray(self.array)}

    @classmethod
    def from_state_dict(cls, state: dict, options=None):
        return cls(state["array"], options)

    # -- stacked-basis helpers ----------------------------------------------
    @classmethod
    def _place_batch(cls, B, ref: "JaxVector", state_axis: int = 1):
        """Placement hook for a stacked (nlanes, n) solve batch.  The dense
        backend leaves it where it is; the sharded backend distributes lanes
        over the mesh's "b" axis (solve-batch parallelism, SURVEY.md §2.4
        item 2).  ``state_axis`` names the axis carrying the state dimension
        (2 for split-complex (nlanes, 2, n) stacks)."""
        return B

    @classmethod
    def _batch_lane_pad(cls, nlanes: int, ref: "JaxVector") -> int:
        """Zero lanes to append so the batch divides the mesh's "b" extent
        (0 for the dense backend).  Padding lanes have b = 0, so their solves
        terminate immediately and contribute nothing."""
        return 0

    @staticmethod
    def _stack(vectors: List["JaxVector"], pad_to: Optional[int] = None):
        m = len(vectors)
        dtype = np.result_type(*[v.dtype for v in vectors])
        V = jnp.stack([v.array.ravel().astype(dtype) for v in vectors])
        if pad_to is not None and pad_to > m:
            V = jnp.concatenate(
                [V, jnp.zeros((pad_to - m, V.shape[1]), V.dtype)])
        return V

    # -- collective ops -----------------------------------------------------
    @classmethod
    def linearCombination(cls, vectors: List["JaxVector"], coeffs) -> "JaxVector":
        assert len(vectors) == len(coeffs)
        V = cls._stack(vectors)
        c = jnp.asarray(coeffs, dtype=np.result_type(V.dtype, np.asarray(coeffs).dtype))
        out = _lincomb_kernel(V.astype(c.dtype), c)
        return cls(out.reshape(vectors[0].array.shape), vectors[0].options)

    @classmethod
    def linearCombinationBatch(cls, vectors: List["JaxVector"],
                               coeffs) -> List["JaxVector"]:
        """All k combinations of an (m, k) coefficient matrix in ONE device
        matmul instead of k separate kernel dispatches — the fast path
        under basisTransformation's 2-D case (FEAST's per-iteration subspace
        rotation, reference feast.py:215)."""
        coeffs = np.asarray(coeffs)
        assert coeffs.ndim == 2 and len(vectors) == coeffs.shape[0]
        V = cls._stack(vectors)
        C = jnp.asarray(coeffs, dtype=np.result_type(V.dtype, coeffs.dtype))
        out = _lincomb_batch_kernel(V.astype(C.dtype), C)
        shape = vectors[0].array.shape
        return [cls(out[j].reshape(shape), vectors[0].options)
                for j in range(out.shape[0])]

    @classmethod
    def orthogonalize(cls, xs: List["JaxVector"],
                      lindep=LINDEP_DEFAULT_VALUE) -> List["JaxVector"]:
        """Orthonormalize the whole set (contract method,
        reference: abstractVector.py:112, util_funcs.py:170-194 `_qr`):
        one device QR of the stacked (n, m) tall matrix; columns whose
        residual against the preceding ones has squared norm <= ``lindep``
        are dropped (rank-revealed by |diag R|, then re-factored so the
        returned set is exactly orthonormal)."""
        keep = list(range(len(xs)))
        shape = xs[0].array.shape
        for _ in range(len(xs)):  # ≥1 drop per pass → terminates
            V = cls._stack([xs[i] for i in keep])
            Q, R = jnp.linalg.qr(V.T, mode="reduced")
            d = np.abs(np.asarray(jnp.diagonal(R)))
            ok = d * d > lindep
            if ok.all():
                Qh = Q.T
                return [cls(Qh[j].reshape(shape), xs[keep[j]].options)
                        for j in range(len(keep))]
            keep = [keep[j] for j in range(len(keep)) if ok[j]]
            if not keep:
                return []
        return []  # pragma: no cover

    @classmethod
    def orthogonalize_against_set(cls, x: "JaxVector", qs: List["JaxVector"],
                                  lindep=LINDEP_DEFAULT_VALUE):
        Q = cls._stack(qs, pad_to=_pad_rows(len(qs)))
        # promote, never demote: casting a complex x to a real basis dtype
        # would silently drop its imaginary part (the reference's GS runs in
        # numpy's promoted dtype, numpyVector.py:121-145)
        dtype = jnp.result_type(x.array.dtype, Q.dtype)
        arr, innerprod = _mgs_kernel(x.array.ravel().astype(dtype),
                                     Q.astype(dtype))
        innerprod = complex(innerprod).real if jnp.iscomplexobj(innerprod) \
            else float(innerprod)
        if innerprod > lindep:
            arr = arr / jnp.sqrt(innerprod)
            return cls(arr.reshape(x.array.shape), x.options)
        return None

    @classmethod
    def overlapMatrix(cls, vectors: List["JaxVector"]) -> np.ndarray:
        m = len(vectors)
        V = cls._stack(vectors, pad_to=_pad_rows(m))
        S = np.asarray(_overlap_kernel(V))[:m, :m]
        return S

    @classmethod
    def matrixRepresentation(cls, operator, vectors: List["JaxVector"]) -> np.ndarray:
        m = len(vectors)
        op = cls._as_operator(operator, vectors[0])
        V = cls._stack(vectors, pad_to=_pad_rows(m))
        M = np.asarray(_matrep_kernel(op, V))[:m, :m]
        return M

    @classmethod
    def extendOverlapMatrix(cls, vectors: List["JaxVector"], overlap: np.ndarray) -> np.ndarray:
        m = len(vectors)
        V = cls._stack(vectors, pad_to=_pad_rows(m))
        col = np.asarray(_ext_col_kernel(V, V[m - 1]))[:m]  # col_i = <v_i | v_new>
        overlap = np.append(overlap, col[None, :-1].conj(), axis=0)
        overlap = np.append(overlap, col[:, None], axis=1)
        return overlap

    @classmethod
    def extendMatrixRepresentation(cls, operator, vectors: List["JaxVector"],
                                   opMat: np.ndarray) -> np.ndarray:
        m = len(vectors)
        op = cls._as_operator(operator, vectors[0])
        V = cls._stack(vectors, pad_to=_pad_rows(m))
        ket = vectors[-1].array.ravel().astype(V.dtype)
        col = np.asarray(_ext_col_op_kernel(op, V, ket))[:m]  # <v_i | A v_new>
        opMat = np.append(opMat, col[None, :-1].conj(), axis=0)
        opMat = np.append(opMat, col[:, None], axis=1)
        return opMat

    @classmethod
    def _accumulate_quadrature(cls, sols, mults, m0: int):
        """FEAST fast path: Q[i] = Re Σ_k mults[k] * sols[k*m0+i], all in one
        jitted contraction instead of nk×m0 scale/add device calls."""
        S = jnp.stack([s.array.ravel() for s in sols])
        nk = len(mults)
        out = _quad_accum_kernel(S.reshape(nk, m0, -1), jnp.asarray(mults))
        shape = sols[0].array.shape
        return [cls(out[i].reshape(shape), sols[0].options) for i in range(m0)]

    @classmethod
    def _accumulate_quadrature_split(cls, sols, mults, m0: int, options=None):
        """FEAST fast path for split-complex solves: sols are raw (2, n)
        Re/Im-stacked device arrays (NOT backend vectors — a (2, n) array is
        not a valid sharded state, so wrapping is deferred to the final real
        (n,) accumulants).

        The f64 quadrature multipliers DELIBERATELY promote the accumulated
        subspace to f64 (mixed-precision design, shared with the fused loop
        — solvers/fast_feast.py): the f32 contour solves act as
        inexact-FEAST noise that the f64 Rayleigh-Ritz step averages down;
        an all-f32 outer iteration stalls at ~1e-3 eigenvalue error."""
        S = jnp.stack(sols)                               # (nk*m0, 2, n)
        nk = len(mults)
        mults = np.asarray(mults)
        out = _quad_accum_split_kernel(
            S.reshape(nk, m0, 2, -1),
            jnp.asarray(mults.real), jnp.asarray(mults.imag))
        return [cls(out[i], options) for i in range(m0)]

    @classmethod
    def solveBatchSplit(cls, H, bs: List["JaxVector"], sigmas, x0s=None,
                        reverseGF: bool = False, rtol_scale: float = 1.0,
                        report: Optional[dict] = None):
        """Batched complex-shifted solves of a REAL operator without any
        complex dtype on device (split-complex 2x2 real-block GMRES; the
        all-real path for FEAST contour shifts).  ``x0s`` warm starts: a
        list of vectors with real (n,) arrays, or a raw (nlanes, 2, n)
        split-guess stack (Re, Im — e.g. FEAST's Ritz warm starts).
        A caller-passed ``report`` dict accumulates "iterations" (summed
        matvec-level counts over all lanes) for observability.
        Returns vectors whose array is (2, n) = (Re x, Im x)."""
        opts = bs[0].options["linearSystemArgs"]
        chunk = opts.get("batchChunk")
        if chunk and len(bs) > chunk:
            # lane chunking bounds the solver working set (~8 MINRES work
            # vectors per lane) for large n; chunks run sequentially
            out = []
            for i in range(0, len(bs), chunk):
                out.extend(cls.solveBatchSplit(
                    H, bs[i:i + chunk], sigmas[i:i + chunk],
                    x0s=None if x0s is None else x0s[i:i + chunk],
                    reverseGF=reverseGF, rtol_scale=rtol_scale,
                    report=report))
            return out
        op = cls._as_operator(H, bs[0])
        nl = len(bs)
        B = jnp.stack([b.array.ravel() for b in bs])
        assert not jnp.iscomplexobj(B), "split solves need real RHS"
        if x0s is None:
            X0 = None
        elif isinstance(x0s, (list, tuple)):
            X0 = jnp.stack([x.array for x in x0s])
        else:
            X0 = jnp.asarray(x0s)
        sig = list(sigmas)
        pad = cls._batch_lane_pad(nl, bs[0])
        if pad:
            B = jnp.concatenate([B, jnp.zeros((pad,) + B.shape[1:], B.dtype)])
            sig = sig + [sig[0]] * pad
            if X0 is not None:
                X0 = jnp.concatenate(
                    [X0, jnp.zeros((pad,) + X0.shape[1:], X0.dtype)])
        B = cls._place_batch(B, bs[0])
        if X0 is not None:
            X0 = cls._place_batch(X0, bs[0],
                                  state_axis=2 if X0.ndim == 3 else 1)
        res = ls.gmres_splitc_batch(
            op, B, sig, x0s=X0,
            rtol=opts["linear_tol"] * rtol_scale,
            atol=opts["linear_atol"] * rtol_scale,
            restart=opts["gmresRestart"], maxiter=opts["linearIter"],
            reverseGF=reverseGF, precond=opts.get("preconditioner"),
            escalate=int(opts.get("escalateIter", 3)))
        conv_a, resn_a, its_a = jax.device_get(
            (res.converged, res.resnorm, res.iterations))
        if report is not None:
            report["iterations"] = report.get("iterations", 0) + \
                int(np.sum(its_a[:nl]))
        for k, ok in enumerate(conv_a[:nl]):
            if not bool(ok):
                msg = (f"Batched split solver lane {k} did not converge: "
                       f"residual {float(resn_a[k]):.3e} after "
                       f"{int(its_a[k])} iterations")
                if opts.get("errorOnNonConvergence", True):
                    raise RuntimeError(msg)
                warnings.warn(msg)
        return list(res.x)[:nl]

    # -- linear solves ------------------------------------------------------
    @staticmethod
    def _solve_dtype(op, sigma, *vec_dtypes):
        """Solve dtype: the DATA (operator/vector) dtype decides precision;
        the shift only decides complexness (weak-scalar rule — a Python
        complex sigma must not upcast an f32 problem to c128)."""
        base = np.result_type(np.dtype(op.dtype), *vec_dtypes)
        if np.iscomplexobj(np.asarray(sigma)):
            return np.result_type(base, np.complex64)
        return base

    @staticmethod
    def _solve_opts(b: "JaxVector", sigma, opType):
        opts = b.options["linearSystemArgs"]
        solver = opts["linearSolver"]
        aliases = {"gcrotmk": "gmres", "pardiso": "exact"}
        solver = aliases.get(solver, solver)
        hermitian = opType in ("her", "pos") and \
            not np.iscomplexobj(np.asarray(sigma))
        # MINRES requires a Hermitian system; a complex shift or a declared
        # general operator must fall through to GMRES.
        if solver == "minres" and not hermitian:
            solver = "gmres"
        # Conversely, restarted GMRES stagnates on strongly indefinite
        # Hermitian systems (the role the reference fills with recycled-Krylov
        # gcrotmk).  For Hermitian systems with a real shift, MINRES is the
        # optimal short-recurrence method — route there; the contract is the
        # stopping tolerance, not the solver internals (SURVEY.md §7
        # "inexactness semantics").
        if solver == "gmres" and hermitian:
            solver = "minres"
        return solver, opts

    @classmethod
    def _split_single(cls, op, b, sigma, x0, opts, reverseGF):
        """One complex-shifted solve of a real symmetric operator via the
        J-symmetrized real-block MINRES (one batch lane), recombined to a
        complex result.  Same routing rationale as the batched FEAST path:
        restarted GMRES stagnates on these spectra; the split MINRES has
        conditioning ~|sigma-lam|."""
        B = b.array.ravel()[None, :]
        X0 = None if x0 is None else jnp.real(x0.array).ravel()[None, :]
        res = ls.gmres_splitc_batch(
            op, B, [complex(sigma)], x0s=X0,
            rtol=opts["linear_tol"], atol=opts["linear_atol"],
            maxiter=opts["linearIter"], reverseGF=reverseGF,
            precond=opts.get("preconditioner"),
            escalate=int(opts.get("escalateIter", 3)))
        conv, resnorm, iters = jax.device_get(
            (res.converged[0], res.resnorm[0], res.iterations[0]))
        if not bool(conv):
            msg = (f"Iterative solver splitc-minres did not converge: "
                   f"residual {float(resnorm):.3e} after "
                   f"{int(iters)} iterations")
            if opts.get("errorOnNonConvergence", True):
                raise RuntimeError(msg)
            warnings.warn(msg)
        x = res.x[0, 0] + 1j * res.x[0, 1]
        return cls(x.reshape(b.array.shape), b.options)

    @classmethod
    def _want_split(cls, op, b, sigma, opts):
        """Split-complex single-solve eligibility: complex shift, real
        operator and RHS (the framework's operators are Hermitian by the
        solver contract, so real means symmetric); exact solves bypass;
        linearSystemArgs["splitComplex"] overrides."""
        if not np.iscomplexobj(np.asarray(sigma)):
            return False
        if np.iscomplexobj(np.zeros((), dtype=b.dtype)) or \
                np.iscomplexobj(np.zeros((), dtype=np.dtype(op.dtype))):
            return False
        if opts.get("linearSolver") in ("exact", "pardiso"):
            return False
        forced = opts.get("splitComplex")
        if forced is not None:
            return bool(forced)
        return True

    @classmethod
    def solve(cls, H, b: "JaxVector", sigma, x0=None, opType: str = "her",
              reverseGF: bool = False) -> "JaxVector":
        """(sigma*I - H) x = b, inexactly (reference: numpyVector.py:147-178)."""
        solver, opts = cls._solve_opts(b, sigma, opType)
        op = cls._as_operator(H, b)
        if cls._want_split(op, b, sigma, opts):
            return cls._split_single(op, b, sigma, x0, opts, reverseGF)
        dtype = cls._solve_dtype(op, sigma, b.dtype)
        barr = b.array.ravel().astype(dtype)
        x0arr = None if x0 is None else x0.array.ravel().astype(dtype)

        if solver == "exact":
            res = ls.solve_exact(op, barr, sigma, reverseGF=reverseGF)
        elif solver == "minres":
            res = ls.minres(op, barr, sigma, x0=x0arr,
                            rtol=opts["linear_tol"], atol=opts["linear_atol"],
                            maxiter=opts["linearIter"], reverseGF=reverseGF,
                            precond=opts.get("preconditioner"))
        elif solver == "gmres":
            res = ls.gmres(op, barr, sigma, x0=x0arr,
                           rtol=opts["linear_tol"], atol=opts["linear_atol"],
                           restart=opts["gmresRestart"],
                           maxiter=opts["linearIter"], reverseGF=reverseGF,
                           precond=opts.get("preconditioner"))
        else:
            raise ValueError(
                f"unknown linearSolver {solver!r}; available: minres, gmres "
                f"(alias gcrotmk), exact (alias pardiso)")

        # one host transfer for the three convergence scalars (each separate
        # fetch is a host synchronization)
        conv, resnorm, iters = jax.device_get(
            (res.converged, res.resnorm, res.iterations))
        if not bool(conv):
            msg = (f"Iterative solver {solver} did not converge: "
                   f"residual {float(resnorm):.3e} after "
                   f"{int(iters)} iterations")
            if opts.get("errorOnNonConvergence", True):
                raise RuntimeError(msg)
            warnings.warn(msg)
        return cls(res.x.reshape(b.array.shape), b.options)

    @classmethod
    def solveBatch(cls, H, bs: List["JaxVector"], sigmas, x0s=None,
                   opType: str = "her", reverseGF: bool = False,
                   rtol_scale: float = 1.0, report: Optional[dict] = None):
        """Batched shifted solves — one vmapped device computation for all
        (sigma_k, b_k) pairs (block Lanczos / FEAST batching,
        SURVEY.md §2.4 item 2).  Under a ("b", "x") mesh the lanes distribute
        over the "b" axis (see :meth:`_place_batch`);
        ``linearSystemArgs["batchChunk"]`` bounds the number of simultaneous
        lanes for memory control.  A caller-passed ``report`` dict
        accumulates "iterations" (summed over lanes)."""
        solver, opts = cls._solve_opts(bs[0], np.asarray(sigmas), opType)
        chunk = opts.get("batchChunk")
        if chunk and len(bs) > chunk:
            out = []
            for i in range(0, len(bs), chunk):
                out.extend(cls.solveBatch(
                    H, bs[i:i + chunk], sigmas[i:i + chunk],
                    x0s=None if x0s is None else x0s[i:i + chunk],
                    opType=opType, reverseGF=reverseGF,
                    rtol_scale=rtol_scale, report=report))
            return out
        op = cls._as_operator(H, bs[0])
        sig = np.asarray(sigmas)
        dtype = cls._solve_dtype(op, sig, *[b.dtype for b in bs])
        nl = len(bs)
        B = jnp.stack([b.array.ravel().astype(dtype) for b in bs])
        if x0s is None:
            X0 = None
        elif isinstance(x0s, (list, tuple)):
            X0 = jnp.stack([x.array.ravel().astype(dtype) for x in x0s])
        else:                       # raw (nlanes, n) warm-start stack
            X0 = jnp.asarray(x0s).astype(dtype)
        pad = 0 if solver == "exact" else cls._batch_lane_pad(nl, bs[0])
        if pad:
            B = jnp.concatenate([B, jnp.zeros((pad,) + B.shape[1:], B.dtype)])
            sig = np.concatenate([sig.ravel(), np.repeat(sig.ravel()[:1], pad)])
            if X0 is not None:
                X0 = jnp.concatenate(
                    [X0, jnp.zeros((pad,) + X0.shape[1:], X0.dtype)])
        B = cls._place_batch(B, bs[0])
        X0 = None if X0 is None else cls._place_batch(X0, bs[0])

        if solver == "exact":
            outs = ls.solve_exact_batch(op, B, sig, reverseGF=reverseGF)
            xs = [o.x for o in outs]
            conv, resn, its = [list(map(t, a)) for t, a in zip(
                (bool, float, int),
                jax.device_get(([o.converged for o in outs],
                                [o.resnorm for o in outs],
                                [o.iterations for o in outs])))]
        else:
            fn = ls.minres_batch if solver == "minres" else ls.gmres_batch
            kwargs = dict(rtol=opts["linear_tol"] * rtol_scale,
                          atol=opts["linear_atol"] * rtol_scale,
                          maxiter=opts["linearIter"], reverseGF=reverseGF,
                          precond=opts.get("preconditioner"))
            if solver == "gmres":
                kwargs["restart"] = opts["gmresRestart"]
            res = fn(op, B, jnp.asarray(sig, dtype), x0s=X0, **kwargs)
            xs = list(res.x)[:nl]  # drop divisibility-padding lanes
            # fetch the per-lane convergence data in ONE transfer, not 3 per
            # lane (each fetch is a host synchronization)
            conv_a, resn_a, its_a = jax.device_get(
                (res.converged, res.resnorm, res.iterations))
            conv = [bool(c) for c in conv_a[:nl]]
            resn = [float(r) for r in resn_a[:nl]]
            its = [int(i) for i in its_a[:nl]]

        if report is not None:
            report["iterations"] = report.get("iterations", 0) + int(sum(its))
        for k, ok in enumerate(conv):
            if not ok:
                msg = (f"Batched solver {solver} lane {k} did not converge: "
                       f"residual {resn[k]:.3e} after {its[k]} iterations")
                if opts.get("errorOnNonConvergence", True):
                    raise RuntimeError(msg)
                warnings.warn(msg)
        return [cls(x.reshape(bs[k].array.shape), bs[k].options)
                for k, x in enumerate(xs)]
