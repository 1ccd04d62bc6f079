"""Iterative linear solvers as jit-compiled ``lax.while_loop`` programs.

Reference counterpart: the ``LinearSolver`` trait + unpreconditioned
``ConjugateGradient`` (reference: src/linearsolver.rs:6-61) — the library's
single solver, written against ``SparseMatrix::mvp``.  Redesign:

* each solver is a pure function ``solve(A, b, x0) -> (x, SolveInfo)``;
  the whole iteration compiles to one XLA program (no per-iteration host
  round-trips, unlike the reference's per-iter allocations,
  linearsolver.rs:47-49);
* ``A`` may be any sparse format **or** a matvec callable, so the same
  solver code runs single-chip or distributed (dots become psum collectives
  when operands are sharded — SURVEY.md §3.5);
* solvers report iterations/residual (the reference returns ``()`` and hides
  both — SURVEY.md §5 observability gap) and never panic on divergence.

Solver set: CG (reference parity), preconditioned CG, BiCGStab and
restarted GMRES (nonsymmetric), Chebyshev semi-iteration (inner-product-free
— zero collectives per distributed iteration), Jacobi / weighted Jacobi, and
Gauss-Seidel / SOR via a sequential scan sweep (latency-bound on a device;
provided for capability parity per BASELINE.json "Jacobi/Gauss-Seidel/
CG-style").

Dtypes are gated to floats, mirroring the ``FloatType`` bound on the trait
(src/linearsolver.rs:6-10, src/types.rs:70-77).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .types import is_float_dtype

#: float32 contractions below ask for true f32: by default a GPU matmul may
#: run in TF32 (~1e-3 relative error), too coarse for a solver
_HI = jax.lax.Precision.HIGHEST


class SolveInfo(NamedTuple):
    iterations: jax.Array        # iterations actually executed
    residual_norm: jax.Array     # final ‖r‖
    converged: jax.Array         # bool
    residual_history: Optional[jax.Array] = None  # (maxiter,) padded with -1


def _as_matvec(A) -> Callable:
    if callable(A) and not hasattr(A, "shape"):
        return A
    if hasattr(A, "shape"):
        if A.shape[0] != A.shape[1]:
            # reference panics "Matrix is not symmetric" on this guard —
            # which actually tests squareness (linearsolver.rs:30-32)
            raise ValueError(f"solver requires a square matrix, got {A.shape}")
        from .ops import spmv

        return lambda v: spmv(A, v)
    raise TypeError(f"cannot interpret {type(A)} as a linear operator")


def _check_operands(A, b):
    b = jnp.asarray(b)
    if not is_float_dtype(b.dtype):
        raise TypeError(
            f"solvers require a float dtype (FloatType gate), got {b.dtype}")
    if hasattr(A, "shape") and b.shape[0] != A.shape[0]:
        raise ValueError(
            f"dimension mismatch: matrix {A.shape}, rhs {b.shape}")
    return b


def _dot(a, b):
    return jnp.sum(a * b)  # sharded operands → XLA inserts the psum


def _as_matvec_dot(A) -> Callable:
    """v → (A·v, v·(A·v)) — CG's hot pair (ops.spmv_dot: XLA fuses the dot
    into the SpMV as a multi-output reduction, so pᵀAp costs no extra pass
    over memory)."""
    if callable(A) and not hasattr(A, "shape"):
        def mvd(v):
            y = A(v)
            return y, _dot(v, y)

        return mvd
    from .ops import spmv_dot

    return lambda v: spmv_dot(A, v)


# --- Conjugate Gradient ------------------------------------------------------

def cg(A, b, x0=None, *, tol: float = 1e-12, rtol: float = 0.0,
       maxiter: int = 10_000, M=None, record_history: bool = False):
    """Conjugate Gradient (≈ ConjugateGradient::solve,
    src/linearsolver.rs:27-61; defaults tol=1e-12, maxiter=10000 match
    linearsolver.rs:17-24).

    Convergence: ‖r‖ < max(tol, rtol·‖b‖) — the reference uses absolute
    tol only.  ``M``: optional preconditioner (callable z = M(r), or a
    Preconditioner object) → standard PCG.
    """
    b = _check_operands(A, b)
    matvec = _as_matvec(A)
    matvec_dot = _as_matvec_dot(A)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, b.dtype)
    precond = M.apply if hasattr(M, "apply") else M

    threshold = jnp.maximum(jnp.asarray(tol, b.dtype),
                            rtol * jnp.sqrt(_dot(b, b)).astype(b.dtype))
    thresh2 = threshold * threshold

    r0 = b - matvec(x0)
    z0 = precond(r0) if precond is not None else r0
    p0 = z0
    rz0 = _dot(r0, z0)
    rr0 = _dot(r0, r0)
    hist0 = (jnp.full((maxiter,), -1.0, b.dtype) if record_history else None)

    def cond(state):
        _, _, _, _, rr, k, _ = state
        return (k < maxiter) & (rr >= thresh2)

    def body(state):
        x, r, p, rz, rr, k, hist = state
        Ap, pAp = matvec_dot(p)
        # guarded divisions: a breakdown (pAp = 0, e.g. singular/indefinite
        # operator) stalls instead of poisoning the state with NaN — the
        # loop then runs to maxiter and reports converged=False
        alpha = jnp.where(pAp != 0, rz / pAp, 0)       # linearsolver.rs:43-45
        x = x + alpha * p                              # :47
        r = r - alpha * Ap                             # :49
        z = precond(r) if precond is not None else r
        rz_new = _dot(r, z)
        rr_new = _dot(r, r)
        beta = jnp.where(rz != 0, rz_new / rz, 0)      # :56
        p = z + beta * p                               # :58-59
        if hist is not None:
            hist = hist.at[k].set(jnp.sqrt(rr_new))
        return (x, r, p, rz_new, rr_new, k + 1, hist)

    state = (x0, r0, p0, rz0, rr0, jnp.zeros((), jnp.int32), hist0)
    x, r, _, _, rr, k, hist = jax.lax.while_loop(cond, body, state)
    res = jnp.sqrt(rr)
    return x, SolveInfo(iterations=k, residual_norm=res,
                        converged=res < threshold, residual_history=hist)


# --- BiCGStab (nonsymmetric systems) ----------------------------------------

def bicgstab(A, b, x0=None, *, tol: float = 1e-12, rtol: float = 0.0,
             maxiter: int = 10_000, M=None):
    """Biconjugate gradient stabilized — capability extension beyond the
    reference's CG-only solver layer (the ``LinearSolver`` trait is
    solver-shaped but has one impl, SURVEY.md §2 #12)."""
    b = _check_operands(A, b)
    matvec = _as_matvec(A)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, b.dtype)
    precond = (M.apply if hasattr(M, "apply") else M) or (lambda v: v)

    threshold = jnp.maximum(jnp.asarray(tol, b.dtype),
                            rtol * jnp.sqrt(_dot(b, b)).astype(b.dtype))

    r0 = b - matvec(x0)
    rhat = r0
    state = dict(x=x0, r=r0, p=r0, v=jnp.zeros_like(b),
                 rho=_dot(rhat, r0), alpha=jnp.ones((), b.dtype),
                 omega=jnp.ones((), b.dtype), k=jnp.zeros((), jnp.int32),
                 rr=_dot(r0, r0))

    def cond(s):
        return (s["k"] < maxiter) & (jnp.sqrt(s["rr"]) >= threshold)

    def body(s):
        phat = precond(s["p"])
        v = matvec(phat)
        rv = _dot(rhat, v)
        alpha = jnp.where(rv != 0, s["rho"] / rv, 0)
        h = s["x"] + alpha * phat
        sres = s["r"] - alpha * v
        shat = precond(sres)
        t = matvec(shat)
        tt = _dot(t, t)
        omega = jnp.where(tt > 0, _dot(t, sres) / tt, 0.0)
        x = h + omega * shat
        r = sres - omega * t
        rho_new = _dot(rhat, r)
        beta = jnp.where(
            (s["rho"] != 0) & (omega != 0),
            (rho_new / s["rho"]) * (alpha / omega), 0)
        p = r + beta * (s["p"] - omega * v)
        return dict(x=x, r=r, p=p, v=v, rho=rho_new, alpha=alpha,
                    omega=omega, k=s["k"] + 1, rr=_dot(r, r))

    out = jax.lax.while_loop(cond, body, state)
    res = jnp.sqrt(out["rr"])
    return out["x"], SolveInfo(iterations=out["k"], residual_norm=res,
                               converged=res < threshold)


# --- GMRES(restart) ----------------------------------------------------------

def gmres(A, b, x0=None, *, tol: float = 1e-12, rtol: float = 0.0,
          restart: int = 30, maxiter: int = 10_000, M=None):
    """Restarted GMRES — capability extension for nonsymmetric systems (the
    reference's ``LinearSolver`` trait has only CG, src/linearsolver.rs:12).

    Structure: the Arnoldi cycle is a ``lax.fori_loop`` over a
    *static* restart window (Krylov basis V: (restart+1, n) fixed shape),
    Givens rotations maintain the QR of the Hessenberg matrix so the
    residual norm is available every step without solving; converged steps
    freeze (identity updates) instead of exiting early, keeping shapes
    static under jit.  ``maxiter`` counts total inner iterations.
    """
    b = _check_operands(A, b)
    matvec = _as_matvec(A)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, b.dtype)
    precond = (M.apply if hasattr(M, "apply") else M) or (lambda v: v)
    n = b.shape[0]
    m = int(restart)
    dt = b.dtype

    threshold = jnp.maximum(jnp.asarray(tol, dt),
                            rtol * jnp.sqrt(_dot(b, b)).astype(dt))
    n_cycles = max(-(-int(maxiter) // m), 1)

    def arnoldi_step(j, carry):
        V, H, cs, sn, g, active, steps = carry
        w = matvec(precond(V[j]))
        # modified Gram-Schmidt against all basis vectors (rows > j are zero)
        # HIGHEST: a float32 contraction may otherwise run in TF32
        h = jnp.dot(V, w, precision=_HI)            # (m+1,) projections
        mask = (jnp.arange(m + 1) <= j)
        h = jnp.where(mask, h, 0)
        w = w - jnp.dot(V.T, h, precision=_HI)
        h_next = jnp.sqrt(_dot(w, w))
        v_next = jnp.where(h_next > 0, w / jnp.where(h_next > 0, h_next, 1), 0)
        # apply previous Givens rotations to the new column
        def rot(i, hcol):
            hi, hi1 = hcol[i], hcol[i + 1]
            return hcol.at[i].set(cs[i] * hi + sn[i] * hi1) \
                       .at[i + 1].set(-sn[i] * hi + cs[i] * hi1)
        hcol = h.at[j + 1].set(h_next)
        hcol = jax.lax.fori_loop(0, j, rot, hcol)
        # new rotation zeroing hcol[j+1]
        denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
        c_j = jnp.where(denom > 0, hcol[j] / jnp.where(denom > 0, denom, 1), 1.0)
        s_j = jnp.where(denom > 0, hcol[j + 1] / jnp.where(denom > 0, denom, 1), 0.0)
        hcol = hcol.at[j].set(c_j * hcol[j] + s_j * hcol[j + 1]).at[j + 1].set(0.0)
        g_j = g[j]
        new_g = g.at[j].set(c_j * g_j).at[j + 1].set(-s_j * g_j)
        still = active & (jnp.abs(new_g[j + 1]) >= threshold) & (h_next > 0)
        # frozen step → identity column (diag 1) so back-substitution yields 0
        eye_col = jnp.zeros((m + 1,), dt).at[j].set(1.0)
        V = V.at[j + 1].set(jnp.where(active, v_next, 0))
        H = H.at[:, j].set(jnp.where(active, hcol, eye_col))
        cs = cs.at[j].set(jnp.where(active, c_j, 1.0))
        sn = sn.at[j].set(jnp.where(active, s_j, 0.0))
        g = jnp.where(active, new_g, g)
        return (V, H, cs, sn, g, still, steps + active.astype(jnp.int32))

    def cycle(state):
        x, res, k, _ = state
        r = b - matvec(x)
        beta = jnp.sqrt(_dot(r, r))
        V0 = jnp.zeros((m + 1, n), dt).at[0].set(
            jnp.where(beta > 0, r / jnp.where(beta > 0, beta, 1), 0))
        H0 = jnp.zeros((m + 1, m), dt)
        g0 = jnp.zeros((m + 1,), dt).at[0].set(beta)
        carry = (V0, H0, jnp.ones((m,), dt), jnp.zeros((m,), dt), g0,
                 beta >= threshold, jnp.zeros((), jnp.int32))
        V, H, cs, sn, g, _, steps = jax.lax.fori_loop(0, m, arnoldi_step, carry)
        # mask g past the active steps: the first frozen slot carries the
        # final residual, which must not leak into the correction
        g_solve = jnp.where(jnp.arange(m) < steps, g[:m], 0)
        y = jax.scipy.linalg.solve_triangular(H[:m, :m], g_solve, lower=False)
        x = x + precond(jnp.dot(V[:m].T, y, precision=_HI))
        r2 = b - matvec(x)
        res2 = jnp.sqrt(_dot(r2, r2))
        return (x, res2, k + m, res2 < threshold)

    def cond(state):
        _, res, k, done = state
        return (k < n_cycles * m) & ~done

    r0 = b - matvec(x0)
    res0 = jnp.sqrt(_dot(r0, r0))
    x, res, k, done = jax.lax.while_loop(
        cond, cycle, (x0, res0, jnp.zeros((), jnp.int32), res0 < threshold))
    return x, SolveInfo(iterations=k, residual_norm=res,
                        converged=res < threshold)


# --- Chebyshev ----------------------------------------------------------------

def chebyshev(A, b, x0=None, *, lambda_min: float, lambda_max: float,
              tol: float = 1e-12, rtol: float = 0.0, maxiter: int = 10_000):
    """Chebyshev semi-iteration for SPD systems with known spectral bounds
    [lambda_min, lambda_max].  No inner products at all — on a device mesh
    that means *zero collectives per iteration* (only the SpMV halo
    exchange), the cheapest distributed smoother available."""
    b = _check_operands(A, b)
    matvec = _as_matvec(A)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, b.dtype)
    theta = (lambda_max + lambda_min) / 2.0
    delta = (lambda_max - lambda_min) / 2.0
    sigma1 = theta / delta

    threshold = jnp.maximum(jnp.asarray(tol, b.dtype),
                            rtol * jnp.sqrt(_dot(b, b)).astype(b.dtype))

    def cond(s):
        return (s["k"] < maxiter) & (s["rr"] >= threshold * threshold)

    def body(s):
        r = b - matvec(s["x"])
        rho_new = jnp.where(s["k"] == 0, 1.0 / sigma1,
                            1.0 / (2.0 * sigma1 - s["rho"]))
        d = jnp.where(s["k"] == 0, r / theta,
                      rho_new * s["rho"] * s["d"] + (2.0 * rho_new / delta) * r)
        x = s["x"] + d
        return dict(x=x, d=d, rho=rho_new, k=s["k"] + 1, rr=_dot(r, r))

    state = dict(x=x0, d=jnp.zeros_like(b), rho=jnp.asarray(sigma1, b.dtype),
                 k=jnp.zeros((), jnp.int32),
                 rr=jnp.asarray(jnp.inf, b.dtype))
    out = jax.lax.while_loop(cond, body, state)
    res = jnp.sqrt(out["rr"])
    return out["x"], SolveInfo(iterations=out["k"], residual_norm=res,
                               converged=res < threshold)


# --- Jacobi ------------------------------------------------------------------

def jacobi(A, b, x0=None, *, tol: float = 1e-12, rtol: float = 0.0,
           maxiter: int = 10_000, omega: float = 1.0):
    """(Weighted) Jacobi iteration: x ← x + ω D⁻¹ (b − A x)."""
    b = _check_operands(A, b)
    matvec = _as_matvec(A)
    if not hasattr(A, "to_csr"):
        raise TypeError("jacobi needs a sparse format (for its diagonal)")
    d = A.to_csr().diagonal().astype(b.dtype)
    dinv = jnp.where(d != 0, 1.0 / d, 0.0)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, b.dtype)

    threshold = jnp.maximum(jnp.asarray(tol, b.dtype),
                            rtol * jnp.sqrt(_dot(b, b)).astype(b.dtype))

    def cond(s):
        x, rr, k = s
        return (k < maxiter) & (rr >= threshold * threshold)

    def body(s):
        x, _, k = s
        r = b - matvec(x)
        x = x + omega * dinv * r
        return (x, _dot(r, r), k + 1)

    x, rr, k = jax.lax.while_loop(
        cond, body, (x0, jnp.asarray(jnp.inf, b.dtype), jnp.zeros((), jnp.int32)))
    res = jnp.sqrt(rr)
    return x, SolveInfo(iterations=k, residual_norm=res,
                        converged=res < threshold)


# --- Gauss-Seidel / SOR ------------------------------------------------------

def sor(A, b, x0=None, *, tol: float = 1e-12, rtol: float = 0.0,
        maxiter: int = 1_000, omega: float = 1.0):
    """Successive over-relaxation (ω = 1 → Gauss-Seidel).

    Each sweep is a sequential ``lax.scan`` over rows in ELL layout — the
    update for row i reads already-updated x entries.  This is inherently
    latency-bound on a device (one row per step); it exists for
    capability parity and as a smoother.  Prefer ``jacobi``/``cg`` for speed.
    """
    b = _check_operands(A, b)
    if not hasattr(A, "to_ell"):
        raise TypeError("sor needs a sparse format")
    ell = A.to_ell()
    n = ell.shape[0]
    cols = ell.cols[:n].astype(jnp.int32)
    vals = ell.vals[:n].astype(b.dtype)
    k_slots = jnp.arange(ell.n_cols_per_row, dtype=jnp.int32)
    valid = k_slots[None, :] < ell.row_nnz[:n, None].astype(jnp.int32)
    vals = jnp.where(valid, vals, 0)
    diag = A.to_csr().diagonal().astype(b.dtype)
    dinv = jnp.where(diag != 0, 1.0 / diag, 0.0)
    x0 = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, b.dtype)

    threshold = jnp.maximum(jnp.asarray(tol, b.dtype),
                            rtol * jnp.sqrt(_dot(b, b)).astype(b.dtype))
    from .ops import spmv

    def sweep(x):
        def row_update(x, i):
            row_cols = cols[i]
            row_vals = vals[i]
            s = jnp.sum(row_vals * x[row_cols])          # includes a_ii x_i
            xi = x[i]
            s = s - diag[i] * xi                          # off-diagonal sum
            new_xi = (1 - omega) * xi + omega * dinv[i] * (b[i] - s)
            return x.at[i].set(new_xi), None

        x, _ = jax.lax.scan(row_update, x, jnp.arange(n))
        return x

    def cond(s):
        x, rr, k = s
        return (k < maxiter) & (rr >= threshold * threshold)

    def body(s):
        x, _, k = s
        x = sweep(x)
        r = b - spmv(A, x)
        return (x, _dot(r, r), k + 1)

    x, rr, k = jax.lax.while_loop(
        cond, body, (x0, jnp.asarray(jnp.inf, b.dtype), jnp.zeros((), jnp.int32)))
    res = jnp.sqrt(rr)
    return x, SolveInfo(iterations=k, residual_norm=res,
                        converged=res < threshold)


def gauss_seidel(A, b, x0=None, **kw):
    return sor(A, b, x0, omega=1.0, **kw)


# --- mixed-precision iterative refinement ------------------------------------

def refine(A, b, x0=None, *, tol: float = 1e-8, rtol: float = 0.0,
           max_outer: int = 40, inner=cg, inner_rtol: float = 1e-2,
           inner_maxiter: int = 4000, low_dtype=jnp.float32,
           A_low=None, M=None):
    """Mixed-precision iterative refinement: high-precision (b.dtype,
    typically f64) residuals steer low-precision (f32) inner solves.

    Rationale: f64 arithmetic runs at a fraction of the f32 rate and moves
    twice the bytes, but refinement only needs ONE f64 SpMV per outer step
    (r = b − Ax) while the thousands of inner iterations run at f32 speed.  Classic Wilkinson iterative refinement; reaches
    residuals far below f32 stagnation (the f64 capability the reference
    gets for free from Rust generics, src/types.rs:70-77 + the f64 golden
    CG test src/lib.rs:37-52).

    ``inner``: any solver from this module with the (A, b, tol/rtol/
    maxiter, M) signature.  ``A_low``: optional pre-cast low-precision
    operator (defaults to ``A.astype(low_dtype)``).  Each outer step solves
    A d = r in low precision to a ``inner_rtol`` relative reduction and
    applies x += d in high precision.

    Returns (x, SolveInfo) where ``iterations`` counts TOTAL inner
    iterations and ``residual_history`` records per-outer ‖r‖.
    """
    b = _check_operands(A, b)
    hi = b.dtype
    matvec = _as_matvec(A)
    if A_low is None:
        A_low = A.astype(low_dtype) if hasattr(A, "astype") else A
    x = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, hi)

    threshold = float(max(tol, rtol * float(jnp.linalg.norm(b))))
    hist = []
    total_inner = 0
    prev_norm = np.inf
    stalled = 0
    for _ in range(max_outer):
        r = b - matvec(x)                       # ONE high-precision SpMV
        rnorm = float(jnp.linalg.norm(r))       # host sync per outer (cheap)
        hist.append(rnorm)
        if rnorm <= threshold:
            break
        if rnorm >= 0.5 * prev_norm:
            stalled += 1
            if stalled >= 2:                    # refinement no longer gaining
                break
        else:
            stalled = 0
        prev_norm = rnorm
        # scale the correction system so f32 sees O(1) magnitudes
        r_low = (r / rnorm).astype(low_dtype)
        d, info = inner(A_low, r_low, tol=0.0, rtol=inner_rtol,
                        maxiter=inner_maxiter, M=M)
        total_inner += int(info.iterations)
        x = x + d.astype(hi) * rnorm
    rnorm = float(jnp.linalg.norm(b - matvec(x)))
    return x, SolveInfo(
        iterations=jnp.asarray(total_inner, jnp.int32),
        residual_norm=jnp.asarray(rnorm, hi),
        converged=jnp.asarray(rnorm <= threshold),
        residual_history=jnp.asarray(hist, hi))


def refine_host(A_high, b, x0=None, *, tol: float = 1e-8, rtol: float = 0.0,
                max_outer: int = 40, inner=cg, A_low=None,
                inner_rtol: float = 1e-2, inner_maxiter: int = 4000,
                low_dtype=jnp.float32, M=None):
    """Iterative refinement with the HIGH-precision half on the host.

    ``refine`` above needs f64 device arrays (``with
    jax.enable_x64(True):``).  This variant keeps the device in f32:
    the outer residual r = b − A x runs as a host numpy/scipy **float64**
    SpMV (the reference's f64 capability, src/types.rs:70-77 + the f64
    golden CG at src/lib.rs:37-52), while the thousands of inner iterations
    run in f32 on the device.  The f64 work per outer step is one sparse
    matvec — cheap on host; the device never sees an f64 array.

    ``A_high``: scipy sparse matrix / numpy array / callable v → A·v in
    float64.  ``A_low``: the frozen device matrix for inner solves
    (required).  Returns (x: numpy float64, SolveInfo) with ``iterations``
    counting total inner iterations.
    """
    if A_low is None:
        raise ValueError("refine_host needs A_low, the f32 device operator")
    matvec = A_high if (callable(A_high) and not hasattr(A_high, "shape")) \
        else (lambda v: A_high @ v)
    b = np.asarray(b, np.float64)
    x = (np.zeros_like(b) if x0 is None
         else np.asarray(x0, np.float64).copy())
    threshold = float(max(tol, rtol * np.linalg.norm(b)))
    hist = []
    total_inner = 0
    prev_norm = np.inf
    stalled = 0
    for _ in range(max_outer):
        r = b - matvec(x)                       # host f64 SpMV
        rnorm = float(np.linalg.norm(r))
        hist.append(rnorm)
        if rnorm <= threshold:
            break
        if rnorm >= 0.5 * prev_norm:
            stalled += 1
            if stalled >= 2:                    # refinement no longer gaining
                break
        else:
            stalled = 0
        prev_norm = rnorm
        # scale the correction system so f32 sees O(1) magnitudes
        r_low = jnp.asarray((r / rnorm).astype(jnp.dtype(low_dtype)))
        d, info = inner(A_low, r_low, tol=0.0, rtol=inner_rtol,
                        maxiter=inner_maxiter, M=M)
        total_inner += int(info.iterations)
        x = x + np.asarray(d, np.float64) * rnorm
    rnorm = float(np.linalg.norm(b - matvec(x)))
    return x, SolveInfo(
        iterations=jnp.asarray(total_inner, jnp.int32),
        residual_norm=jnp.asarray(rnorm, jnp.float32),
        converged=jnp.asarray(rnorm <= threshold),
        residual_history=jnp.asarray(np.asarray(hist, np.float32)))


# --- preconditioners ---------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class JacobiPreconditioner:
    """M⁻¹ = D⁻¹ — the cheapest useful preconditioner."""

    dinv: jax.Array

    @classmethod
    def from_matrix(cls, A) -> "JacobiPreconditioner":
        d = A.to_csr().diagonal()
        return cls(dinv=jnp.where(d != 0, 1.0 / d, 0.0))

    def apply(self, r):
        return self.dinv.astype(r.dtype) * r


@dataclasses.dataclass(frozen=True)
class BlockJacobiPreconditioner:
    """M⁻¹ = blockdiag(A₀₀⁻¹, A₁₁⁻¹, …) over contiguous ``block_size``-row
    blocks.

    The block diagonal is densified once at construction
    (one batched scatter), inverted with one batched ``linalg.inv``, and
    each application is a single (n_blocks, bs, bs) × (n_blocks, bs)
    batched matmul, no triangular solves.  Structurally-empty
    diagonal positions get a unit pivot so the inverse exists for matrices
    with empty rows."""

    blocks_inv: jax.Array  # (n_blocks, bs, bs)
    n: int

    @classmethod
    def from_matrix(cls, A, block_size: int = 64) -> "BlockJacobiPreconditioner":
        coo = A.to_csr().to_coo()
        n = A.shape[0]
        bs = block_size
        nb = -(-n // bs)
        r = coo.rows.astype(jnp.int32)
        c = coo.cols.astype(jnp.int32)
        in_blk = (r // bs == c // bs) & (r < n)
        bi = jnp.where(in_blk, r // bs, nb)  # out-of-block → dropped
        blocks = jnp.zeros((nb, bs, bs), coo.vals.dtype)
        blocks = blocks.at[bi, r % bs, c % bs].add(
            jnp.where(in_blk, coo.vals, 0), mode="drop")
        # unit pivot for structurally-empty diagonal slots (incl. the padded
        # tail rows of the last block)
        diag = jnp.diagonal(blocks, axis1=1, axis2=2)
        fix = jnp.where(diag == 0, 1.0, 0.0).astype(blocks.dtype)
        blocks = blocks + fix[:, :, None] * jnp.eye(bs, dtype=blocks.dtype)
        # jnp.linalg.inv's own products already run at HIGHEST precision
        return cls(blocks_inv=jnp.linalg.inv(blocks), n=n)

    def apply(self, r):
        bs = self.blocks_inv.shape[1]
        nb = self.blocks_inv.shape[0]
        rp = jnp.pad(r, (0, nb * bs - self.n)).reshape(nb, bs)
        z = jnp.einsum("bij,bj->bi", self.blocks_inv.astype(r.dtype), rp,
                       precision=_HI)
        return z.reshape(-1)[: self.n]


# --- class-style API parity with the reference trait -------------------------

@dataclasses.dataclass
class ConjugateGradient:
    """Object-style wrapper matching the reference's struct + Default
    (src/linearsolver.rs:12-24: tol=1e-12, iter_max=10000)."""

    tol: float = 1e-12
    iter_max: int = 10_000

    def solve(self, mat, b, x=None):
        """Returns the solution (the reference mutates x in place and
        returns (); we return (x, info) — info was invisible there)."""
        return cg(mat, jnp.asarray(b), x0=x, tol=self.tol, maxiter=self.iter_max)


@dataclasses.dataclass
class Jacobi:
    tol: float = 1e-12
    iter_max: int = 10_000
    omega: float = 1.0

    def solve(self, mat, b, x=None):
        return jacobi(mat, jnp.asarray(b), x0=x, tol=self.tol,
                      maxiter=self.iter_max, omega=self.omega)


@dataclasses.dataclass
class BiCGStab:
    tol: float = 1e-12
    iter_max: int = 10_000

    def solve(self, mat, b, x=None):
        return bicgstab(mat, jnp.asarray(b), x0=x, tol=self.tol,
                        maxiter=self.iter_max)


@dataclasses.dataclass
class GMRES:
    tol: float = 1e-12
    iter_max: int = 10_000
    restart: int = 30

    def solve(self, mat, b, x=None):
        return gmres(mat, jnp.asarray(b), x0=x, tol=self.tol,
                     maxiter=self.iter_max, restart=self.restart)
