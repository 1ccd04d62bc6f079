"""Checks that mean something only on the GPU: float32 contractions must
stay true float32 there (a GPU matmul may otherwise run in TF32, ~1e-3
relative error).  Marked ``gpu``: skipped on the CPU, called by
``chip_smoke.py`` on the card."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import sparsemat_tpu as smt

pytestmark = pytest.mark.gpu


def test_bsr_spmm_keeps_f32(gpu_device):
    """BSR SpMM at f32 matches the float64 product to 1e-5 (TF32: ~1e-3)."""
    rng = np.random.default_rng(0)
    dense = rng.standard_normal((1024, 1024)).astype(np.float32)
    dense[rng.random(dense.shape) > 0.2] = 0.0
    import scipy.sparse as sp

    A = smt.BSR.from_csr(smt.CSR.from_scipy(sp.csr_matrix(dense)),
                         br=64, bc=128)
    B = rng.standard_normal((1024, 256)).astype(np.float32)
    Y = np.asarray(jax.jit(smt.spmm)(A, jax.device_put(B, gpu_device)),
                   np.float64)
    ref = dense.astype(np.float64) @ B.astype(np.float64)
    assert np.abs(Y - ref).max() / np.abs(ref).max() < 1e-5


def test_inner_products_keep_f32(gpu_device):
    """vectors.inner_prod, the bilinear form and the GMRES projections
    (a (31, n) by (n,) product) at f32 match float64 to 1e-5."""
    rng = np.random.default_rng(1)
    n = 1 << 16
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.standard_normal(n).astype(np.float32)
    got = float(jax.jit(smt.vectors.inner_prod)(a, b))
    ref = float(a.astype(np.float64) @ b.astype(np.float64))
    assert abs(got - ref) / np.linalg.norm(a) / np.linalg.norm(b) < 1e-5
    V = rng.standard_normal((31, n)).astype(np.float32)
    h = np.asarray(jax.jit(lambda v, w: jnp.dot(
        v, w, precision=jax.lax.Precision.HIGHEST))(V, a), np.float64)
    href = V.astype(np.float64) @ a.astype(np.float64)
    assert np.abs(h - href).max() / np.abs(href).max() < 1e-5
