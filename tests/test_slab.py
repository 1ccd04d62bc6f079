"""SlabELL — slab-windowed ELL for scattered bounded-span rows
(formats/slab.py, kernels/spmv.py slab_spmv_xla)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import sparsemat_tpu as smt
from sparsemat_tpu.formats.slab import SlabELL
from sparsemat_tpu.kernels.spmv import slab_spmv_xla


def scattered_band(n, k, band, seed=0):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n), k)
    cols = np.clip(rows + rng.integers(-band, band + 1, size=n * k), 0, n - 1)
    vals = rng.standard_normal(n * k).astype(np.float32)
    m = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    m.sum_duplicates()
    return m


@pytest.mark.parametrize("n,k,band", [(200, 7, 30), (333, 15, 100), (64, 3, 5)])
def test_slab_roundtrip(n, k, band):
    m = scattered_band(n, k, band)
    sl = smt.CSR.from_scipy(m).to_slab()
    np.testing.assert_allclose(np.asarray(sl.todense()), m.toarray(), rtol=1e-6)
    assert int(sl.n_non_zero_entries()) == m.nnz
    assert sl.slab_windows <= (sl.row_block + 2 * band) // 128 + 2


def test_slab_xla_spmv():
    m = scattered_band(500, 11, 60, seed=1)
    sl = smt.CSR.from_scipy(m).to_slab()
    x = np.random.default_rng(2).standard_normal(500).astype(np.float32)
    y = slab_spmv_xla(sl, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), m @ x, atol=1e-4)


@pytest.mark.parametrize("n,k,band,rb", [(400, 9, 50, 128), (300, 5, 200, 128),
                                         (260, 140, 20, 256)])
def test_slab_pallas_interpret(n, k, band, rb):
    # k=140 exercises tall multi-bucket C; rb=256 the multi-lane-chunk path
    m = scattered_band(n, k, band, seed=3)
    sl = SlabELL.from_csr(smt.CSR.from_scipy(m), rb=rb)
    x = np.random.default_rng(4).standard_normal(n).astype(np.float32)
    y = jax.jit(slab_spmv_xla)(sl, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), m @ x, atol=1e-3)


def test_slab_empty_rows_and_tail_block():
    # empty rows + n not a multiple of the row block
    n = 77
    dense = np.zeros((n, n), np.float32)
    rng = np.random.default_rng(5)
    for i in range(0, n, 3):  # rows 1,2 mod 3 empty
        js = rng.integers(0, n, 4)
        dense[i, js] = rng.standard_normal(len(js))
    m = sp.csr_matrix(dense)
    sl = smt.CSR.from_scipy(m).to_slab()
    x = rng.standard_normal(n).astype(np.float32)
    y = smt.spmv(sl, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), dense @ x, atol=1e-4)
    y2 = slab_spmv_xla(sl, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y2), dense @ x, atol=1e-4)


def test_slab_grid_chunking():
    # 32 row blocks: each block's result lands in its own rows
    m = scattered_band(4096, 5, 20, seed=6)
    sl = SlabELL.from_csr(smt.CSR.from_scipy(m), rb=128)
    assert sl.n_row_blocks == 32
    x = np.random.default_rng(7).standard_normal(4096).astype(np.float32)
    y = jax.jit(slab_spmv_xla)(sl, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(y), m @ x, atol=1e-4)


def test_slab_dispatch_and_checkpoint(tmp_path):
    m = scattered_band(128, 6, 25, seed=8)
    sl = smt.CSR.from_scipy(m).to_slab()
    x = np.random.default_rng(9).standard_normal(128).astype(np.float32)
    y = smt.spmv(sl, x)
    np.testing.assert_allclose(np.asarray(y), m @ x, atol=1e-4)
    from sparsemat_tpu import checkpoint

    p = str(tmp_path / "slab.npz")
    checkpoint.save_matrix(p, sl)
    back = checkpoint.load_matrix(p)
    np.testing.assert_allclose(np.asarray(back.todense()), m.toarray(),
                               rtol=1e-6)


def test_slab_rb_must_be_lane_multiple():
    m = scattered_band(64, 3, 5)
    with pytest.raises(ValueError):
        SlabELL.from_csr(smt.CSR.from_scipy(m), rb=32)


def test_slab_bucket_invariants():
    m = scattered_band(500, 11, 60, seed=1)
    sl = smt.CSR.from_scipy(m).to_slab()
    offs = [o for o, _ in sl.buckets]
    hts = [h for _, h in sl.buckets]
    assert offs == list(np.cumsum([0] + hts[:-1]))
    assert all(h % 8 == 0 for h in hts)
    assert sl.c_total == sum(hts)
    assert sl.vals.shape == (sl.n_row_blocks, sl.c_total, sl.row_block)
