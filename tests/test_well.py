"""WELL format + its SpMV (kernels/spmv.py well_spmv_xla), eager and under
jit, against scipy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import sparsemat_tpu as smt
from sparsemat_tpu.kernels.spmv import well_spmv_xla


def cases():
    rng = np.random.default_rng(0)
    yield "random_5pct", sp.random(300, 300, density=0.05, random_state=rng,
                                   format="csr", dtype=np.float32)
    yield "wide_rect", sp.random(64, 1000, density=0.02, random_state=rng,
                                 format="csr", dtype=np.float32)
    yield "tall_rect", sp.random(1000, 64, density=0.02, random_state=rng,
                                 format="csr", dtype=np.float32)
    yield "empty_rows", sp.csr_matrix(
        (np.ones(3, np.float32), ([0, 5, 290], [250, 3, 12])), shape=(300, 300))
    # dense row: forces overflow tiles (slot >= k_tile when capped)
    dense_row = sp.lil_matrix((40, 256), dtype=np.float32)
    dense_row[7, :] = rng.standard_normal(256)
    dense_row[3, 5] = 2.5
    yield "dense_row", dense_row.tocsr()


@pytest.mark.parametrize("name,mat", list(cases()))
def test_well_roundtrip(name, mat):
    well = smt.CSR.from_scipy(mat).to_well()
    np.testing.assert_allclose(
        np.asarray(well.todense()), mat.toarray(), rtol=1e-6)


@pytest.mark.parametrize("name,mat", list(cases()))
def test_well_spmv_xla(name, mat):
    well = smt.CSR.from_scipy(mat).to_well()
    x = np.random.default_rng(1).standard_normal(mat.shape[1]).astype(np.float32)
    y = well_spmv_xla(well, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), mat @ x, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,mat", list(cases()))
def test_well_spmv_pallas_interpret(name, mat):
    well = smt.CSR.from_scipy(mat).to_well()
    x = np.random.default_rng(2).standard_normal(mat.shape[1]).astype(np.float32)
    y = jax.jit(well_spmv_xla)(well, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), mat @ x, rtol=1e-4, atol=1e-5)


def test_well_k_tile_cap_overflow_tiles():
    # a row with 200 entries in one window is impossible (window=128), but
    # k_tile=4 forces overflow tiles even for moderate rows
    rng = np.random.default_rng(3)
    mat = sp.random(64, 128, density=0.2, random_state=rng, format="csr",
                    dtype=np.float32)
    well = smt.CSR.from_scipy(mat).to_well(k_tile=4)
    assert well.k_tile == 4
    x = rng.standard_normal(128).astype(np.float32)
    y = well_spmv_xla(well, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), mat @ x, rtol=1e-4, atol=1e-5)
    y2 = smt.spmv(well, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y2), mat @ x, rtol=1e-4, atol=1e-5)


def test_well_via_dispatch():
    rng = np.random.default_rng(4)
    mat = sp.random(200, 200, density=0.05, random_state=rng, format="csr",
                    dtype=np.float32)
    A = smt.CSR.from_scipy(mat)
    x = rng.standard_normal(200).astype(np.float32)
    y = smt.spmv(A, jnp.asarray(x), method="well")
    np.testing.assert_allclose(np.asarray(y), mat @ x, rtol=1e-4, atol=1e-5)


def test_well_fill_ratio():
    mat = sp.eye(256, format="csr", dtype=np.float32)
    well = smt.CSR.from_scipy(mat).to_well()
    assert well.k_tile == 1
    assert well.fill_ratio() == 1.0


def test_well_chunked_kernel_matches_xla():
    # many tiles per row block and several windows per row: the scatter-add
    # of tile partials into row blocks must sum duplicates
    import scipy.sparse as sp

    rng = np.random.default_rng(42)
    dense = rng.standard_normal((64, 512)).astype(np.float32)
    dense[rng.random((64, 512)) > 0.1] = 0
    w = smt.CSR.from_scipy(sp.csr_matrix(dense)).to_well()
    assert w.n_tiles > 4
    assert np.unique(np.asarray(w.tile_rows)).size < w.n_tiles
    x = rng.standard_normal(512).astype(np.float32)
    y_jit = jax.jit(well_spmv_xla)(w, jnp.asarray(x))
    y_ref = well_spmv_xla(w, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y_jit), np.asarray(y_ref),
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(y_ref), dense @ x, atol=1e-4)


def test_dia_pallas_kernel_edges_interpret():
    # DIA edge handling: offsets wider than 128, a tail that is no multiple
    # of anything, a tiny matrix — the zero-padded x slices must line up
    import scipy.sparse as sp

    rng = np.random.default_rng(3)
    for n, offs in [(5000, (-130, -1, 0, 1, 130)), (3000, (-2, 0, 2)),
                    (1030, (-7, 0, 7)), (9, (-8, 0, 8))]:
        diags = [rng.standard_normal(n - abs(o)).astype(np.float32)
                 for o in offs]
        m = sp.diags(diags, offs, shape=(n, n), format="csr")
        A = smt.CSR.from_scipy(m).to_dia()
        x = rng.standard_normal(n).astype(np.float32)
        y = jax.jit(smt.spmv)(A, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(y), m @ x, atol=1e-4,
                                   err_msg=f"n={n} offs={offs}")
