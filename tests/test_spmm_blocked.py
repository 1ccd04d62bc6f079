"""SpMM on the slab layouts: ``spmm`` serves SlabELL and SlabPack through
their CSR view, so the result must match scipy for any RHS width."""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import sparsemat_tpu as smt


def fem_like(n=600, seed=0):
    rng = np.random.default_rng(seed)
    m = sp.random(n, n, 0.02, random_state=seed, format="csr").astype(np.float32)
    # banded-ish: keep entries within a band plus a diagonal
    m = m + sp.eye(n, dtype=np.float32, format="csr")
    m = m.tocsr()
    m.sort_indices()
    return m


@pytest.mark.parametrize("m_rhs", [1, 5, 8, 20])
def test_slab_spmm_blocked_vs_scipy(m_rhs):
    spm = fem_like()
    sl = smt.CSR.from_scipy(spm).to_slab(rb=128)
    rng = np.random.default_rng(1)
    B = rng.standard_normal((spm.shape[1], m_rhs)).astype(np.float32)
    Y = np.asarray(smt.spmm(sl, jnp.asarray(B)))
    ref = spm @ B
    nrm = max(np.abs(ref).max(), 1e-30)
    assert np.abs(Y - ref).max() / nrm < 1e-5


def test_slab_pack_spmm_blocked_vs_scipy():
    spm = fem_like(n=700, seed=3)
    pack = smt.CSR.from_scipy(spm).to_slab_pack(rb=128, n_classes=3)
    rng = np.random.default_rng(2)
    B = rng.standard_normal((spm.shape[1], 9)).astype(np.float32)
    Y = np.asarray(smt.spmm(pack, jnp.asarray(B)))
    ref = spm @ B
    nrm = max(np.abs(ref).max(), 1e-30)
    assert np.abs(Y - ref).max() / nrm < 1e-5
