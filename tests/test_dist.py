"""Distribution layer tests on the 8-virtual-device CPU mesh (conftest sets
xla_force_host_platform_device_count=8) — the multi-chip codepaths the
reference's SparseMatPar never finished (src/sparsemat_par.rs:37-68)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import sparsemat_tpu as smt
from sparsemat_tpu import parallel, solvers


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8, "conftest must provide 8 cpu devices"
    return parallel.make_mesh(8)


def poisson1d(n, dtype=np.float64):
    return sp.diags([2.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1)],
                    [0, 1, -1], format="csr").astype(dtype)


def random_banded(n, offsets, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    return sp.diags([rng.standard_normal(n - abs(o)).astype(dtype) for o in offsets],
                    offsets, shape=(n, n), format="csr")


def test_dist_dia_spmv_halo(mesh8):
    # halo-exchange path: offsets ≪ rows_per_block
    mat = random_banded(240, [-3, -1, 0, 1, 3])
    A = smt.CSR.from_scipy(mat).to_dia()
    dA = parallel.distribute_dia(A, mesh8)
    assert dA.n_blocks == 8
    x = np.random.default_rng(1).standard_normal(240).astype(np.float32)
    xs = dA.padded_vector(x, mesh8)
    y = dA.unpad(dA.matvec(xs, mesh8))
    np.testing.assert_allclose(np.asarray(y), mat @ x, rtol=2e-5)


def test_dist_dia_spmv_uneven_rows(mesh8):
    # 237 rows over 8 blocks → padding rows in the last block
    mat = random_banded(237, [-2, 0, 2])
    A = smt.CSR.from_scipy(mat).to_dia()
    dA = parallel.distribute_dia(A, mesh8)
    x = np.random.default_rng(2).standard_normal(237).astype(np.float32)
    y = dA.unpad(dA.matvec(dA.padded_vector(x, mesh8), mesh8))
    np.testing.assert_allclose(np.asarray(y), mat @ x, rtol=2e-5)


def test_dist_dia_spmv_allgather_fallback(mesh8):
    # halo wider than rows_per_block (16) → all-gather path
    mat = random_banded(128, [-40, 0, 40])
    A = smt.CSR.from_scipy(mat).to_dia()
    dA = parallel.distribute_dia(A, mesh8)
    assert dA.halo > dA.rows_per_block
    x = np.random.default_rng(3).standard_normal(128).astype(np.float32)
    y = dA.unpad(dA.matvec(dA.padded_vector(x, mesh8), mesh8))
    np.testing.assert_allclose(np.asarray(y), mat @ x, rtol=2e-5)


@pytest.mark.parametrize("format", ["csr", "ell"])
def test_dist_csr_ell_spmv(mesh8, format):
    rng = np.random.default_rng(4)
    mat = sp.random(300, 300, density=0.05, random_state=rng, format="csr",
                    dtype=np.float64)
    A = smt.CSR.from_scipy(mat)
    dA = parallel.distribute_csr(A, mesh8, format=format)
    x = rng.standard_normal(300)
    y = dA.unpad(dA.matvec(dA.padded_vector(x, mesh8), mesh8))
    np.testing.assert_allclose(np.asarray(y), mat @ x, rtol=1e-10)


def test_dist_spmv_under_jit(mesh8):
    # the dist matvec must compose with jit (it is the CG building block)
    mat = random_banded(240, [-1, 0, 1])
    dA = parallel.distribute_dia(smt.CSR.from_scipy(mat).to_dia(), mesh8)
    x = np.random.default_rng(5).standard_normal(240).astype(np.float32)
    xs = dA.padded_vector(x, mesh8)
    f = jax.jit(lambda m, v: m.matvec(v, mesh8))
    y = f(dA, xs)
    np.testing.assert_allclose(np.asarray(dA.unpad(y)), mat @ x, rtol=2e-5)


def test_distributed_cg_poisson(mesh8):
    # BASELINE config 5 scaled down: distributed CG on a stencil matrix,
    # halo exchange inside the matvec, psum-reduced dots via GSPMD
    n = 4096
    mat = poisson1d(n)
    A = smt.CSR.from_scipy(mat).to_dia()
    dA = parallel.distribute_dia(A, mesh8)
    rng = np.random.default_rng(6)
    x_true = rng.standard_normal(n)
    b = mat @ x_true
    bs = dA.padded_vector(b, mesh8)
    x, info = solvers.cg(lambda v: dA.matvec(v, mesh8), bs, tol=1e-10,
                         maxiter=20000)
    assert bool(info.converged)
    np.testing.assert_allclose(np.asarray(dA.unpad(x)), x_true, atol=1e-6)


def test_distributed_matches_single_device(mesh8):
    # mesh-shape invariance: 1-block and 8-block results agree bit-for-bit
    # (deterministic reduction order within each block; SURVEY §5 race-detection
    # stand-in: determinism tests per mesh shape)
    mat = random_banded(240, [-5, -1, 0, 1, 5], dtype=np.float32)
    A = smt.CSR.from_scipy(mat).to_dia()
    x = np.random.default_rng(7).standard_normal(240).astype(np.float32)
    mesh1 = parallel.make_mesh(1)
    d1 = parallel.distribute_dia(A, mesh1)
    y1 = np.asarray(d1.unpad(d1.matvec(d1.padded_vector(x, mesh1), mesh1)))
    d8 = parallel.distribute_dia(A, mesh8)
    y8 = np.asarray(d8.unpad(d8.matvec(d8.padded_vector(x, mesh8), mesh8)))
    np.testing.assert_array_equal(y1, y8)


def test_dist_slab_spmv_halo(mesh8):
    # scattered band: halo window exchange, matches scipy
    rng = np.random.default_rng(11)
    n, k, band = 4096, 9, 300
    rows = np.repeat(np.arange(n), k)
    cols = np.clip(rows + rng.integers(-band, band + 1, size=n * k), 0, n - 1)
    m = sp.csr_matrix((rng.standard_normal(n * k).astype(np.float32),
                       (rows, cols)), shape=(n, n))
    m.sum_duplicates()
    dA = parallel.distribute_slab(smt.CSR.from_scipy(m), mesh8, rb=128)
    assert dA.halo_windows >= 1
    x = rng.standard_normal(n).astype(np.float32)
    y = dA.unpad(dA.matvec(dA.padded_vector(x, mesh8), mesh8))
    np.testing.assert_allclose(np.asarray(y), m @ x, atol=1e-3)


def test_dist_slab_uneven_rows(mesh8):
    # n not divisible by mesh: padded tail rows must stay zero
    rng = np.random.default_rng(12)
    n = 4000
    m = sp.random(n, n, density=0.005, format="coo", random_state=3,
                  dtype=np.float32)
    keep = np.abs(m.row - m.col) <= 150
    m = sp.csr_matrix((m.data[keep], (m.row[keep], m.col[keep])), shape=(n, n))
    dA = parallel.distribute_slab(smt.CSR.from_scipy(m), mesh8, rb=128)
    x = rng.standard_normal(n).astype(np.float32)
    y = dA.unpad(dA.matvec(dA.padded_vector(x, mesh8), mesh8))
    np.testing.assert_allclose(np.asarray(y), m @ x, atol=1e-3)


def test_dist_slab_padding_blocks_add_no_halo(mesh8):
    # 3496 rows: 437 rows/device round up to 512 (4 blocks), so the last
    # device holds all-zero padding blocks; they must not widen the halo
    rng = np.random.default_rng(13)
    n = 3496
    m = random_banded(n, (-40, -1, 0, 1, 40), seed=5)
    dA = parallel.distribute_slab(smt.CSR.from_scipy(m), mesh8, rb=128)
    assert dA.padded_rows > n and dA.halo_windows <= 1
    x = rng.standard_normal(n).astype(np.float32)
    y = dA.unpad(dA.matvec(dA.padded_vector(x, mesh8), mesh8))
    np.testing.assert_allclose(np.asarray(y), m @ x, atol=1e-4)


def test_dist_slab_halo_guard(mesh8):
    # span wider than a local shard must refuse with a clear error
    n = 1000
    m = sp.random(n, n, density=0.01, format="csr", random_state=3,
                  dtype=np.float32)
    dA = parallel.distribute_slab(smt.CSR.from_scipy(m), mesh8, rb=128)
    x = dA.padded_vector(np.ones(n, np.float32), mesh8)
    with pytest.raises(ValueError, match="halo"):
        dA.matvec(x, mesh8)


def test_dist_slab_cg(mesh8):
    # distributed PCG-free CG through the slab matvec; psum dots via GSPMD
    n = 8192
    lap = sp.diags([4.0 * np.ones(n), -np.ones(n - 1), -np.ones(n - 1),
                    -np.ones(n - 130), -np.ones(n - 130)],
                   [0, 1, -1, 130, -130], format="csr").astype(np.float32)
    dA = parallel.distribute_slab(smt.CSR.from_scipy(lap), mesh8, rb=128)
    b = np.ones(n, np.float32)
    bs = dA.padded_vector(b, mesh8)
    x, info = solvers.cg(lambda v: dA.matvec(v, mesh8), bs, tol=1e-6,
                         maxiter=500)
    assert bool(info.converged)
    from scipy.sparse.linalg import cg as scipy_cg
    ref, _ = scipy_cg(lap.astype(np.float64), b.astype(np.float64), rtol=1e-9)
    np.testing.assert_allclose(np.asarray(dA.unpad(x)), ref, atol=1e-3)


def _stencil27(n):
    """3D 27-point stencil on an n^3 grid (BASELINE config 5 in miniature)."""
    m = n ** 3
    offs, vals = [], []
    for dz in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                off = dz * n * n + dy * n + dx
                offs.append(off)
                vals.append(26.0 if off == 0 else -1.0)
    diags = [np.full(m - abs(o), v, np.float32) for o, v in zip(offs, vals)]
    return sp.diags(diags, offs, shape=(m, m), format="csr")


def test_dist_cg_stencil27_3d(mesh8):
    # distributed CG on a 3D 27-point stencil: DIA halo exchange, psum dots
    n = 12                      # 1728 rows over 8 devices
    lap = _stencil27(n)
    dA = parallel.distribute_dia(smt.CSR.from_scipy(lap).to_dia(), mesh8)
    b = np.ones(lap.shape[0], np.float32)
    bs = dA.padded_vector(b, mesh8)
    x, info = solvers.cg(lambda v: dA.matvec(v, mesh8), bs, tol=1e-5,
                         maxiter=2000)
    assert bool(info.converged)
    from scipy.sparse.linalg import cg as scipy_cg
    ref, _ = scipy_cg(lap.astype(np.float64), b.astype(np.float64), rtol=1e-8)
    np.testing.assert_allclose(np.asarray(dA.unpad(x)), ref, atol=1e-3)


# --- DistCSRSubset: halo-subset exchange (r2 verdict #9) ----------------------

def test_dist_csr_subset_matches_scipy(mesh8):
    m = random_banded(257, [-40, -3, 0, 3, 40], seed=11).tocsr()
    A = smt.CSR.from_scipy(m)
    dS = parallel.distribute_csr_subset(A, mesh8)
    x = np.random.default_rng(12).standard_normal(257).astype(np.float32)
    xs = dS.padded_vector(x, mesh8)
    y = np.asarray(dS.unpad(dS.matvec(xs, mesh8)))
    ref = m @ x
    np.testing.assert_allclose(y, ref, atol=1e-4 * max(np.abs(ref).max(), 1))


def test_dist_csr_subset_traffic_tracks_boundary(mesh8):
    # banded matrix: each device only needs a halo-wide slice from its two
    # neighbors, so the exchanged payload must be a small fraction of the
    # full all-gather (which moves padded_rows values per device)
    n, halo = 1024, 6
    m = random_banded(n, [-halo, 0, halo], seed=13).tocsr()
    dS = parallel.distribute_csr_subset(smt.CSR.from_scipy(m), mesh8)
    full_gather_bytes = 8 * dS.padded_rows * 4      # what DistCSR moves
    assert max(dS.hop_m) <= halo
    assert dS.exchange_bytes_per_spmv() < full_gather_bytes / 10
    x = np.random.default_rng(14).standard_normal(n).astype(np.float32)
    y = np.asarray(dS.unpad(dS.matvec(dS.padded_vector(x, mesh8), mesh8)))
    ref = m @ x
    np.testing.assert_allclose(y, ref, atol=1e-4 * max(np.abs(ref).max(), 1))


def test_dist_csr_subset_skew_does_not_inflate(mesh8):
    """r4 verdict #8: ONE bad pair must not set the payload for all pairs.
    The per-hop ppermute exchange pads each hop to its own max, so a
    single wide boundary (device 0 reading a big span of device 1's rows)
    inflates one hop only."""
    n = 1024                       # 128 rows/device on the 8-device mesh
    halo = 4
    m = random_banded(n, [-halo, 0, halo], seed=23).tolil()
    # device 0 additionally reads 100 columns owned by device 1
    m[5, 128:228] = 1.0
    m = m.tocsr()
    dS = parallel.distribute_csr_subset(smt.CSR.from_scipy(m), mesh8)
    # banded hops (±1 neighbors) stay halo-sized except the one skewed hop
    assert max(dS.hop_m) >= 100
    assert sorted(dS.hop_m)[-2] <= halo
    # payload ≈ n_dev·(2·halo + skew), far below n_dev²·skew (old padding)
    old_padding_bytes = 8 * 7 * max(dS.hop_m) * 4
    assert dS.exchange_bytes_per_spmv() < old_padding_bytes / 3
    x = np.random.default_rng(24).standard_normal(n).astype(np.float32)
    y = np.asarray(dS.unpad(dS.matvec(dS.padded_vector(x, mesh8), mesh8)))
    ref = m @ x
    np.testing.assert_allclose(y, ref, atol=1e-4 * max(np.abs(ref).max(), 1))


def test_dist_csr_subset_global_scatter_still_correct(mesh8):
    # uniformly scattered columns: subsets degrade gracefully toward the
    # all-gather (correctness must hold regardless)
    rng = np.random.default_rng(15)
    n = 320
    m = sp.coo_matrix((rng.standard_normal(2000).astype(np.float32),
                       (rng.integers(0, n, 2000), rng.integers(0, n, 2000))),
                      shape=(n, n)).tocsr()
    m.sum_duplicates()
    dS = parallel.distribute_csr_subset(smt.CSR.from_scipy(m), mesh8)
    x = rng.standard_normal(n).astype(np.float32)
    y = np.asarray(dS.unpad(dS.matvec(dS.padded_vector(x, mesh8), mesh8)))
    ref = m @ x
    np.testing.assert_allclose(y, ref, atol=1e-4 * max(np.abs(ref).max(), 1))
