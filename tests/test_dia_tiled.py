"""DIA SpMV (static shifted slices, ``formats/dia.py``) and the CG inner
pair ``spmv_dot`` on every format.

The cases cover offsets of both signs, offsets wider than 128, pure row
shifts and matrices of a few thousand rows, each against scipy.
"""

import jax
import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import sparsemat_tpu as smt
from sparsemat_tpu.formats.dia import dia_spmv


def banded(n, offs, seed=0):
    rng = np.random.default_rng(seed)
    diags = [rng.standard_normal(n).astype(np.float32) for _ in offs]
    return sp.diags([d[: n - abs(o)] for d, o in zip(diags, offs)], offs,
                    shape=(n, n), format="csr").astype(np.float32)


@pytest.mark.parametrize("n,offs,C", [
    (5000, (-64, -1, 0, 1, 64), 4096),
    (300, (-7, 0, 13), 1024),
    (4096, (-1024, 0, 1024), 1024),
    (2048, (-129, -127, 0, 127, 129), 1024),
])
def test_dia_tiled_vs_scipy(n, offs, C):
    m = banded(n, offs)
    dia = smt.CSR.from_scipy(m).to_dia()
    assert dia.offsets == tuple(sorted(offs))
    rng = np.random.default_rng(1)
    x = rng.standard_normal(n).astype(np.float32)
    # C: a row-chunk length; the product must not depend on where x is cut
    y = np.asarray(jax.jit(dia_spmv)(dia, jnp.asarray(x)))
    ref = m @ x
    err = np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30)
    assert err < 1e-5
    lo = min(C, n) // 2
    np.testing.assert_allclose(y[lo:lo + 8], np.asarray(smt.spmv(dia, x))[lo:lo + 8],
                               rtol=1e-6, atol=1e-6)


def test_dia_holds_one_copy_of_the_diagonals():
    """The frozen DIA carries ``data`` and nothing else on the device: its
    device bytes are n_diags × n_rows values, and scaling touches only
    them."""
    m = banded(1000, (-3, 0, 5), seed=2)
    dia = smt.CSR.from_scipy(m).to_dia()
    leaves = jax.tree_util.tree_leaves(dia)
    assert len(leaves) == 1 and leaves[0].shape == (3, 1000)
    s = dia.scale(3.0)
    np.testing.assert_allclose(np.asarray(s.data), 3.0 * np.asarray(dia.data),
                               rtol=1e-6)
    x = np.random.default_rng(0).standard_normal(1000).astype(np.float32)
    np.testing.assert_allclose(np.asarray(smt.spmv(s, x)), 3.0 * (m @ x),
                               rtol=1e-4, atol=1e-4)


def test_dia_spmv_dot_fused_matches_separate():
    """spmv_dot returns (A x, x·(A x)) equal to the separate spmv + dot
    (the CG hot pair, src/linearsolver.rs:43-45)."""
    n, offs = 5000, (-64, -1, 0, 1, 64)
    m = banded(n, offs)
    dia = smt.CSR.from_scipy(m).to_dia()
    rng = np.random.default_rng(3)
    x = rng.standard_normal(n).astype(np.float32)
    y, d = jax.jit(smt.spmv_dot)(dia, jnp.asarray(x))
    ref_y = m @ x
    assert np.abs(np.asarray(y) - ref_y).max() / np.abs(ref_y).max() < 1e-5
    ref_d = float(x @ ref_y)
    assert abs(float(d) - ref_d) / max(abs(ref_d), 1e-30) < 1e-4
    y2 = np.asarray(smt.spmv(dia, jnp.asarray(x)))
    np.testing.assert_allclose(np.asarray(y), y2, rtol=1e-6,
                               atol=1e-6 * np.abs(y2).max())


FORMATS = {
    "csr": lambda c: c,
    "coo": lambda c: c.to_coo(),
    "dia": lambda c: c.to_dia(),
    "ell": lambda c: c.to_ell(),
    "sell": lambda c: smt.SELL.from_csr(c, slice_height=8),
    "gell": lambda c: c.to_gell(),
    "well": lambda c: c.to_well(),
    "slab": lambda c: c.to_slab(),
    "slab_pack": lambda c: c.to_slab_pack(),
    "slab_stream": lambda c: c.to_slab_stream(),
    "strip": lambda c: c.to_strip(),
    "route": lambda c: c.to_route(),
    "bsr": lambda c: smt.BSR.from_csr(c),
}


def test_spmv_dot_dispatch_all_formats():
    m = banded(800, (-5, 0, 7), seed=4)
    x = np.random.default_rng(5).standard_normal(800).astype(np.float32)
    ref_y = m @ x
    ref_d = float(x @ ref_y)
    for fmt, make in FORMATS.items():
        y, d = smt.spmv_dot(make(smt.CSR.from_scipy(m)), jnp.asarray(x))
        assert np.abs(np.asarray(y) - ref_y).max() / np.abs(ref_y).max() < 1e-5, fmt
        assert abs(float(d) - ref_d) / abs(ref_d) < 1e-4, fmt
