"""spmv_chain: k chained SpMVs as one ``lax.fori_loop`` program.

The chain is the hot loop of the reference's solver usage of mvp
(reference: src/linearsolver.rs:41-49 runs one mvp per iteration).
"""
import jax
import numpy as np
import pytest
import scipy.sparse as sp
import jax.numpy as jnp

import sparsemat_tpu as smt


def _banded(n, offsets, seed=0, scale=0.05):
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(n - abs(o)).astype(np.float32) * scale
             for o in offsets]
    return sp.diags(diags, offsets, shape=(n, n), format="csr")


@pytest.mark.parametrize("k", [1, 2, 5])
def test_chain_kernel_interpret(k):
    """DIA chain under jit (one compiled loop) vs k scipy matvecs."""
    ms = _banded(300, [-3, -1, 0, 1, 3])
    dia = smt.CSR.from_scipy(ms).to_dia()
    x = np.random.default_rng(1).standard_normal(300).astype(np.float32)
    y = np.asarray(jax.jit(smt.spmv_chain, static_argnums=2)(
        dia, jnp.asarray(x), k))
    ref = x.copy()
    for _ in range(k):
        ref = (ms @ ref).astype(np.float32)
    np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-6)


def test_chain_dispatch_fallback():
    """Every format takes the same lax.fori_loop-of-spmv path."""
    ms = _banded(200, [-2, 0, 2], seed=3)
    csr = smt.CSR.from_scipy(ms)
    x = np.random.default_rng(2).standard_normal(200).astype(np.float32)
    ref = x.copy()
    for _ in range(3):
        ref = (ms @ ref).astype(np.float32)
    for mat in (csr, csr.to_dia(), csr.to_ell()):
        y = np.asarray(smt.spmv_chain(mat, x, 3))
        np.testing.assert_allclose(y, ref, rtol=1e-5, atol=1e-6)
        jaxpr = str(jax.make_jaxpr(lambda v: smt.spmv_chain(mat, v, 3))(x))
        assert "while" in jaxpr or "scan" in jaxpr  # one loop, not k unrolled


def test_chain_requires_square():
    rect = smt.CSR.from_scipy(sp.csr_matrix(np.ones((2, 3), np.float32)))
    with pytest.raises(ValueError):
        smt.spmv_chain(rect, np.zeros(3, np.float32), 2)


def test_chain_low_precision_carry():
    """bf16 operands: the fori_loop carry must be dtype-stable (spmv returns
    the f32 accumulation dtype — regression for the round-2 advisor note)."""
    ms = _banded(64, [-1, 0, 1], seed=5)
    csr = smt.CSR.from_scipy(ms).astype(jnp.bfloat16)
    x = jnp.asarray(np.random.default_rng(7).standard_normal(64), jnp.bfloat16)
    y = np.asarray(smt.spmv_chain(csr, x, 3), np.float32)
    ref = np.asarray(x, np.float32)
    for _ in range(3):
        ref = ms.astype(np.float32) @ ref
    np.testing.assert_allclose(y, ref, rtol=0.15, atol=0.1)
