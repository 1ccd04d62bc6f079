"""Solver suite.  Golden anchor: check_cg (reference src/lib.rs:37-52) —
CG on A=[[4,1],[1,3]], b=[1,2], x0=[2,1] converges to x=[1/11, 7/11];
the reference asserts floor(x0·1e4)/1e4 == 0.0909."""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import sparsemat_tpu as smt
from sparsemat_tpu import solvers


def golden_system():
    A = smt.from_dense(np.array([[4.0, 1.0], [1.0, 3.0]], np.float64))
    b = jnp.array([1.0, 2.0], jnp.float64)
    x0 = jnp.array([2.0, 1.0], jnp.float64)
    return A, b, x0


def poisson2d(n, dtype=np.float64):
    m = n * n
    lap = sp.diags(
        [4.0 * np.ones(m), -np.ones(m - 1), -np.ones(m - 1),
         -np.ones(m - n), -np.ones(m - n)],
        [0, 1, -1, n, -n], format="csr").astype(dtype)
    # zero the wrap-around couplings at row boundaries
    lil = lap.tolil()
    for k in range(1, n):
        lil[k * n, k * n - 1] = 0
        lil[k * n - 1, k * n] = 0
    out = lil.tocsr()
    out.eliminate_zeros()
    return out


def test_cg_golden():
    A, b, x0 = golden_system()
    x, info = solvers.cg(A, b, x0)
    # the reference's exact assertion (src/lib.rs:51)
    assert np.floor(float(x[0]) * 10000) / 10000 == 0.0909
    np.testing.assert_allclose(np.asarray(x), [1 / 11, 7 / 11], atol=1e-10)
    assert bool(info.converged)
    assert int(info.iterations) <= 10  # 2×2 SPD: converges in ≤2 in exact arithmetic


def test_cg_class_api_defaults():
    # defaults mirror linearsolver.rs:17-24
    cgobj = smt.ConjugateGradient()
    assert cgobj.tol == 1e-12
    assert cgobj.iter_max == 10_000
    A, b, x0 = golden_system()
    x, info = cgobj.solve(A, b, x0)
    np.testing.assert_allclose(np.asarray(x), [1 / 11, 7 / 11], atol=1e-10)


def test_cg_poisson_f64():
    # BASELINE config 3 (scaled down): 2D 5-point Poisson, f64, 1e-8 residual
    lap = poisson2d(24)
    A = smt.CSR.from_scipy(lap, index_dtype=jnp.int32)
    rng = np.random.default_rng(7)
    x_true = rng.standard_normal(lap.shape[0])
    b = jnp.asarray(lap @ x_true)
    x, info = solvers.cg(A, b, tol=1e-8)
    assert bool(info.converged)
    assert float(info.residual_norm) < 1e-8
    np.testing.assert_allclose(np.asarray(x), x_true, atol=1e-6)


def test_cg_matvec_callable():
    # solver accepts a raw matvec closure (needed by the distributed layer)
    lap = poisson2d(8)
    dense = jnp.asarray(lap.toarray())
    b = jnp.ones(lap.shape[0])
    x, info = solvers.cg(lambda v: dense @ v, b, tol=1e-10)
    np.testing.assert_allclose(np.asarray(dense @ x), np.asarray(b), atol=1e-8)


def test_pcg_jacobi_preconditioner():
    lap = poisson2d(16)
    # scale rows to make Jacobi preconditioning actually matter
    d = sp.diags(np.linspace(1, 100, lap.shape[0]))
    mat = (d @ lap @ d).tocsr()
    A = smt.CSR.from_scipy(mat)
    b = jnp.ones(mat.shape[0])
    M = smt.JacobiPreconditioner.from_matrix(A)
    x_p, info_p = solvers.cg(A, b, tol=1e-10, M=M)
    x_n, info_n = solvers.cg(A, b, tol=1e-10)
    assert bool(info_p.converged)
    np.testing.assert_allclose(np.asarray(mat @ np.asarray(x_p)), 1.0, atol=1e-7)
    assert int(info_p.iterations) < int(info_n.iterations)


def test_cg_residual_history():
    A, b, x0 = golden_system()
    x, info = solvers.cg(A, b, x0, maxiter=50, record_history=True)
    hist = np.asarray(info.residual_history)
    assert hist.shape == (50,)
    used = hist[hist >= 0]
    assert used.size == int(info.iterations)
    assert used[-1] < 1e-12


def test_jacobi():
    lap = poisson2d(8)
    A = smt.CSR.from_scipy(lap)
    b = jnp.ones(lap.shape[0])
    x, info = solvers.jacobi(A, b, tol=1e-9, maxiter=20_000)
    assert bool(info.converged)
    np.testing.assert_allclose(np.asarray(lap @ np.asarray(x)), 1.0, atol=1e-6)


def test_gauss_seidel():
    lap = poisson2d(6)
    A = smt.CSR.from_scipy(lap)
    b = jnp.ones(lap.shape[0])
    x, info = solvers.gauss_seidel(A, b, tol=1e-9, maxiter=2_000)
    assert bool(info.converged)
    np.testing.assert_allclose(np.asarray(lap @ np.asarray(x)), 1.0, atol=1e-6)
    # SOR with ω≈1.5 should beat plain GS on Poisson
    _, info_sor = solvers.sor(A, b, tol=1e-9, maxiter=2_000, omega=1.5)
    assert int(info_sor.iterations) < int(info.iterations)


def test_bicgstab_nonsymmetric():
    rng = np.random.default_rng(3)
    n = 80
    m = sp.random(n, n, density=0.1, random_state=rng, format="csr")
    m = m + sp.diags(10.0 * np.ones(n))  # diagonally dominant
    A = smt.CSR.from_scipy(m)
    b = jnp.asarray(rng.standard_normal(n))
    x, info = solvers.bicgstab(A, b, tol=1e-10)
    assert bool(info.converged)
    np.testing.assert_allclose(np.asarray(m @ np.asarray(x)), np.asarray(b), atol=1e-7)


def test_solver_guards():
    rect = smt.from_dense(np.ones((2, 3)))
    with pytest.raises(ValueError, match="square"):
        solvers.cg(rect, jnp.ones(2))
    A, b, _ = golden_system()
    with pytest.raises(ValueError, match="mismatch"):
        solvers.cg(A, jnp.ones(5))
    with pytest.raises(TypeError, match="float"):
        solvers.cg(A, jnp.array([1, 2], jnp.int32))


def test_divergence_reports_not_raises():
    # singular, inconsistent system: CG stagnates; must report converged=False
    # with a finite residual, not panic or NaN-poison the state
    # (reference would just spin to iter_max with no report at all)
    A = smt.from_dense(np.array([[1.0, 0.0], [0.0, 0.0]], np.float64))
    x, info = solvers.cg(A, jnp.array([0.0, 1.0]), maxiter=5, tol=1e-30)
    assert not bool(info.converged)
    assert int(info.iterations) == 5
    assert np.isfinite(float(info.residual_norm))


def test_block_jacobi_preconditioner():
    # PCG with block-Jacobi must converge in fewer iterations than plain CG
    lap = poisson2d(20).astype(np.float32)
    dense = lap.toarray()
    A = smt.CSR.from_scipy(lap)
    b = np.ones(400, np.float32)
    x_plain, info_plain = smt.solvers.cg(A, b, tol=1e-6)
    M = smt.BlockJacobiPreconditioner.from_matrix(A, block_size=64)
    x_pc, info_pc = smt.solvers.cg(A, b, tol=1e-6, M=M)
    assert bool(info_pc.converged)
    assert int(info_pc.iterations) < int(info_plain.iterations)
    ref = np.linalg.solve(dense.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(np.asarray(x_pc), ref, atol=5e-2)


def test_block_jacobi_empty_rows_and_tail():
    # block inverse must exist with structurally-empty rows + ragged tail
    n = 70
    d = np.zeros((n, n), np.float32)
    for i in range(0, n, 2):
        d[i, i] = 2.0 + i % 3
    import scipy.sparse as sp
    A = smt.CSR.from_scipy(sp.csr_matrix(d))
    M = smt.BlockJacobiPreconditioner.from_matrix(A, block_size=32)
    r = np.arange(n, dtype=np.float32)
    z = np.asarray(M.apply(jnp.asarray(r)))
    expect = np.where(np.diag(d) != 0, r / np.where(np.diag(d) == 0, 1, np.diag(d)), r)
    np.testing.assert_allclose(z, expect, rtol=1e-5)


def test_cg_poisson2d_f64_tight_residual():
    # BASELINE config 3 (scaled for CI): 2D 5-point Poisson, f64, CG to
    # 1e-8 absolute residual, preconditioned to keep CI time bounded
    lap = poisson2d(96)  # 9216 rows, f64
    A = smt.CSR.from_scipy(lap)
    b = np.ones(lap.shape[0], np.float64)
    M = smt.BlockJacobiPreconditioner.from_matrix(A, block_size=96)
    x, info = smt.solvers.cg(A, b, tol=1e-8, maxiter=20_000, M=M)
    assert bool(info.converged)
    r = b - lap @ np.asarray(x)
    assert np.linalg.norm(r) < 1e-7


def test_jacobi_poisson2d_f64():
    # Jacobi on the same operator (diagonally dominant -> converges)
    lap = poisson2d(24)
    A = smt.CSR.from_scipy(lap)
    b = np.ones(lap.shape[0], np.float64)
    x, info = smt.solvers.jacobi(A, b, tol=1e-8, maxiter=50_000)
    assert bool(info.converged)
    assert np.linalg.norm(b - lap @ np.asarray(x)) < 1e-6


def test_refine_mixed_precision_reaches_f64_residual():
    """Iterative refinement (f64 outer / f32 inner) reaches residuals far
    below f32 stagnation — one route to BASELINE config 3."""
    lap = poisson2d(48)                      # 2304 rows, cond ~ 1e3
    A = smt.CSR.from_scipy(lap)              # f64 storage
    b = jnp.ones((lap.shape[0],), jnp.float64)
    x, info = solvers.refine(A, b, tol=1e-10, inner_maxiter=3000)
    assert bool(info.converged), float(info.residual_norm)
    assert float(info.residual_norm) <= 1e-10
    res = np.asarray(lap @ np.asarray(x) - np.asarray(b))
    assert np.linalg.norm(res) <= 2e-10
    # inner work happened in f32 (iterations counted), outers recorded
    assert int(info.iterations) > 0
    assert info.residual_history.shape[0] >= 2


def test_refine_low_precision_operator_is_f32():
    lap = poisson2d(12)
    A = smt.CSR.from_scipy(lap)
    A32 = A.astype(np.float32)
    assert A32.data.dtype == jnp.float32
    assert A32.indices.dtype == A.indices.dtype  # indices untouched
    b = jnp.ones((lap.shape[0],), jnp.float64)
    x, info = solvers.refine(A, b, tol=1e-9, A_low=A32)
    assert bool(info.converged)


def test_refine_host_f64_outer_on_host():
    """refine_host: the f64 half runs in host numpy (no jax_enable_x64
    needed), the f32 inner CG on the device — the guaranteed-deliverable
    form of the reference's f64 CG capability (src/linearsolver.rs:27-61,
    f64 golden test src/lib.rs:37-52)."""
    lap = poisson2d(48)                      # scipy f64 on host
    A32 = smt.CSR.from_scipy(lap.astype(np.float32))
    b = np.ones(lap.shape[0])
    x, info = solvers.refine_host(lap, b, A_low=A32, tol=1e-10,
                                  inner_maxiter=3000)
    assert bool(info.converged), float(info.residual_norm)
    assert isinstance(x, np.ndarray) and x.dtype == np.float64
    assert np.linalg.norm(b - lap @ x) <= 2e-10
    assert int(info.iterations) > 0


def test_refine_host_accepts_callable():
    lap = poisson2d(24)
    A32 = smt.CSR.from_scipy(lap.astype(np.float32))
    b = np.ones(lap.shape[0])
    x, info = solvers.refine_host(lambda v: lap @ v, b, A_low=A32,
                                  tol=1e-9)
    assert bool(info.converged)
    assert np.linalg.norm(b - lap @ x) <= 2e-9
