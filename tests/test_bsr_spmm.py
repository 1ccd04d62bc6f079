"""BSR format + block-sparse SpMM (a batched einsum over the stored
blocks, kernels/spmm.py), checked against dense products."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import sparsemat_tpu as smt
from sparsemat_tpu.formats.bsr import BSR
from sparsemat_tpu.kernels.spmm import bsr_spmm_xla


def random_csr(n_rows, n_cols, density, seed=0, block=None):
    rng = np.random.default_rng(seed)
    if block:
        # genuine block structure: activate whole (block × 128) blocks
        br, bc = block
        rb, cb = -(-n_rows // br), -(-n_cols // bc)
        mask = rng.random((rb, cb)) < density
        dense = np.zeros((rb * br, cb * bc), np.float32)
        r, c = np.nonzero(mask)
        for i, j in zip(r, c):
            dense[i * br:(i + 1) * br, j * bc:(j + 1) * bc] = rng.standard_normal(
                (br, bc)).astype(np.float32)
        dense = dense[:n_rows, :n_cols]
    else:
        dense = rng.standard_normal((n_rows, n_cols)).astype(np.float32)
        dense[rng.random((n_rows, n_cols)) >= density] = 0
    return smt.CSR.from_scipy(sp.csr_matrix(dense)), dense


@pytest.mark.parametrize("shape,density", [((64, 96), 0.05), ((40, 200), 0.2),
                                           ((8, 8), 1.0)])
def test_bsr_roundtrip(shape, density):
    csr, dense = random_csr(*shape, density, seed=1)
    bsr = BSR.from_csr(csr)
    np.testing.assert_allclose(np.asarray(bsr.todense()), dense, rtol=1e-6)
    assert int(bsr.n_non_zero_entries()) == int(csr.n_non_zero_entries())
    # through to_coo -> csr and back
    np.testing.assert_allclose(np.asarray(bsr.to_csr().todense()), dense,
                               rtol=1e-6)


@pytest.mark.parametrize("m", [1, 7, 64, 130])
def test_bsr_spmm_xla_vs_dense(m):
    csr, dense = random_csr(72, 150, 0.1, seed=2)
    B = np.random.default_rng(3).standard_normal((150, m)).astype(np.float32)
    y = bsr_spmm_xla(BSR.from_csr(csr), jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(y), dense @ B, atol=1e-4)


@pytest.mark.parametrize("shape,m", [((64, 256), 64), ((100, 300), 129)])
def test_bsr_spmm_pallas_interpret(shape, m):
    csr, dense = random_csr(*shape, 0.15, seed=4, block=(8, 128))
    B = np.random.default_rng(5).standard_normal((shape[1], m)).astype(np.float32)
    y = jax.jit(bsr_spmm_xla)(BSR.from_csr(csr), jnp.asarray(B))
    assert y.shape == (shape[0], m)
    np.testing.assert_allclose(np.asarray(y), dense @ B, atol=1e-3)


def test_bsr_spmm_empty_block_rows():
    # rows 8..15 completely empty — dummy tiles must still zero their output
    csr, dense = random_csr(24, 128, 0.3, seed=6)
    d2 = dense.copy()
    d2[8:16] = 0
    csr2 = smt.CSR.from_scipy(sp.csr_matrix(d2))
    B = np.random.default_rng(7).standard_normal((128, 32)).astype(np.float32)
    y = smt.spmm(BSR.from_csr(csr2), jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(y), d2 @ B, atol=1e-4)
    y2 = bsr_spmm_xla(BSR.from_csr(csr2), jnp.asarray(B))
    np.testing.assert_allclose(np.asarray(y2), d2 @ B, atol=1e-4)


def test_spmm_dispatch_bsr():
    csr, dense = random_csr(32, 140, 0.2, seed=8)
    B = np.random.default_rng(9).standard_normal((140, 16)).astype(np.float32)
    bsr = BSR.from_csr(csr)
    y = smt.spmm(bsr, B)                    # isinstance dispatch
    np.testing.assert_allclose(np.asarray(y), dense @ B, atol=1e-4)
    y2 = smt.spmm(csr, B, method="bsr")     # method dispatch
    np.testing.assert_allclose(np.asarray(y2), dense @ B, atol=1e-4)
    y3 = bsr @ B                            # operator
    np.testing.assert_allclose(np.asarray(y3), dense @ B, atol=1e-4)


def test_bsr_spmv_via_generic():
    csr, dense = random_csr(32, 140, 0.2, seed=10)
    x = np.random.default_rng(11).standard_normal(140).astype(np.float32)
    y = smt.spmv(BSR.from_csr(csr), x)      # generic COO fallback path
    np.testing.assert_allclose(np.asarray(y), dense @ x, atol=1e-4)


def test_bsr_scale_and_ops():
    csr, dense = random_csr(16, 128, 0.4, seed=12)
    bsr = BSR.from_csr(csr)
    np.testing.assert_allclose(np.asarray((bsr * 2.0).todense()), 2 * dense,
                               rtol=1e-6)
    assert bsr.fill_ratio() <= 1.0
    t = smt.transpose(bsr)
    np.testing.assert_allclose(np.asarray(t.todense()), dense.T, rtol=1e-6)


def test_bsr_rejects_misaligned_blocks():
    csr, _ = random_csr(16, 128, 0.4, seed=13)
    with pytest.raises(ValueError):
        BSR.from_csr(csr, br=7, bc=100)


def test_from_csr_device_matches_host_freeze():
    """Device-side freeze (one scatter) must agree with the host freeze
    for every block size, including empty block rows and big br."""
    import scipy.sparse as sp

    rng = np.random.default_rng(11)
    dense = np.zeros((300, 520), np.float32)
    mask = rng.random(dense.shape) < 0.03
    dense[mask] = rng.standard_normal(int(mask.sum())).astype(np.float32)
    dense[40:120] = 0.0  # empty block rows in the middle
    csr = smt.CSR.from_scipy(sp.csr_matrix(dense))
    B = jnp.asarray(rng.standard_normal((520, 17)).astype(np.float32))
    ref = dense @ np.asarray(B)
    for br in (8, 64, 256):
        b_host = smt.BSR.from_csr(csr, br=br, bc=128)
        b_dev = smt.BSR.from_csr_device(csr, br=br, bc=128)
        np.testing.assert_array_equal(np.asarray(b_host.block_rows),
                                      np.asarray(b_dev.block_rows))
        Yh = np.asarray(bsr_spmm_xla(b_host, B))
        Yd = np.asarray(smt.spmm(b_dev, B))
        nrm = max(np.abs(ref).max(), 1e-30)
        assert np.abs(Yh - ref).max() / nrm < 1e-5
        assert np.abs(Yd - ref).max() / nrm < 1e-5


def test_from_csr_device_empty_matrix():
    import scipy.sparse as sp

    csr = smt.CSR.from_scipy(sp.csr_matrix((64, 64), dtype=np.float32))
    b = smt.BSR.from_csr_device(csr)
    B = jnp.ones((64, 8), jnp.float32)
    assert np.abs(np.asarray(smt.spmm(b, B))).max() == 0
