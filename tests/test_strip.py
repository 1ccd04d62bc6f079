"""StripELL — strip-packed window format (formats/strip.py).

Pins the freeze (levels, per-strip windows, class split), the canonical
round-trip and the SpMV (kernels/strip.py) against scipy, incl. explicit stored zeros and non-multiple-of-128 shapes.
Capability parity target: the SpMV loop it replaces,
reference src/sparsematrix.rs:146-158.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import sparsemat_tpu as smt
from sparsemat_tpu.kernels.strip import strip_spmv_xla


def banded_random(n, half_bw, density, seed=0):
    rng = np.random.default_rng(seed)
    m = sp.random(n, n, density, format="coo", dtype=np.float32,
                  random_state=rng)
    keep = np.abs(m.row - m.col) <= half_bw
    return sp.coo_matrix((m.data[keep], (m.row[keep], m.col[keep])),
                         shape=(n, n)).tocsr()


@pytest.mark.parametrize("n,half_bw,density,seed", [
    (3000, 1500, 0.004, 0),
    (1000, 400, 0.02, 1),
    (517, 517, 0.05, 2),     # ragged shape, full-width band
    (130, 40, 0.3, 3),       # dense-ish, 2 blocks
])
def test_strip_vs_scipy(n, half_bw, density, seed):
    m = banded_random(n, half_bw, density, seed)
    st = smt.CSR.from_scipy(m).to_strip()
    assert int(st.n_non_zero_entries()) == m.nnz
    rng = np.random.default_rng(10 + seed)
    x = rng.standard_normal(n).astype(np.float32)
    ref = m @ x
    nrm = max(np.abs(ref).max(), 1e-30)
    y_xla = np.asarray(strip_spmv_xla(st, jnp.asarray(x)))
    assert np.abs(y_xla - ref).max() / nrm < 1e-5
    y_dispatch = np.asarray(smt.spmv(st, jnp.asarray(x)))
    assert np.abs(y_dispatch - ref).max() / nrm < 1e-5


def test_strip_round_trip_and_stored_zeros():
    m = banded_random(800, 300, 0.02, 5).tolil()
    m[3, 10] = 0.0   # explicit stored zero
    m = m.tocsr()
    m.sort_indices()
    st = smt.CSR.from_scipy(m)
    stp = st.to_strip()
    back = stp.to_csr()
    ref = sp.csr_matrix(
        (np.asarray(back.data), np.asarray(back.indices),
         np.asarray(back.host("indptr"))), shape=m.shape)
    assert np.abs((ref - m)).max() == 0.0


def test_strip_rejects_wide_scatter():
    rng = np.random.default_rng(0)
    m = sp.random(400, 20000, 0.01, format="csr", dtype=np.float32,
                  random_state=rng)
    with pytest.raises(ValueError, match="span"):
        smt.CSR.from_scipy(m).to_strip()


def test_strip_traffic_well_below_slab_pack():
    """The point of the format: ~2x less traffic than SlabPack on a
    FEM-like operand (VERDICT r4 #7)."""
    m = banded_random(4000, 1900, 0.012, 7)
    csr = smt.CSR.from_scipy(m)
    strip_b = csr.to_strip().spmv_traffic_bytes()
    slab_b = csr.to_slab_pack().spmv_traffic_bytes()
    assert strip_b < 0.75 * slab_b, (strip_b, slab_b)


def test_auto_format_prefers_strip_for_bounded_span():
    """A bounded-span scattered matrix (StripELL's regime) with skewed
    rows: auto_format picks GELL, the layout that measured fastest on the
    H100 in this regime, and the SpMV matches scipy."""
    from sparsemat_tpu.formats import auto_format

    m = banded_random(2000, 800, 0.01, 9).tolil()
    rng = np.random.default_rng(13)
    for r in range(0, 2000, 8):
        cols = rng.choice(np.arange(max(r - 800, 0), min(r + 800, 2000)),
                          size=200, replace=False)
        m[r, cols] = 0.5
    m = m.tocsr()
    mat = auto_format(smt.CSR.from_scipy(m))
    assert type(mat).__name__ == "GELL"
    # StripELL still freezes this matrix when asked for it explicitly
    assert type(smt.CSR.from_scipy(m).to_strip()).__name__ == "StripELL"
    x = np.random.default_rng(0).standard_normal(2000).astype(np.float32)
    ref = m @ x
    y = np.asarray(smt.spmv(mat, jnp.asarray(x)))
    assert np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30) < 1e-5


def test_strip_ops_through_canonical_views():
    """add/transpose/spgemm reach StripELL through to_coo/to_csr."""
    m = banded_random(600, 200, 0.02, 12)
    st = smt.CSR.from_scipy(m).to_strip()
    t = st.T.to_csr()
    ref_t = m.T.tocsr()
    import scipy.sparse as sp
    back = sp.csr_matrix((np.asarray(t.data), np.asarray(t.indices),
                          np.asarray(t.host("indptr"))), shape=m.T.shape)
    assert np.abs((back - ref_t)).max() < 1e-6
    s2 = (st + smt.CSR.from_scipy(m)).to_csr()
    back2 = sp.csr_matrix((np.asarray(s2.data), np.asarray(s2.indices),
                           np.asarray(s2.host("indptr"))), shape=m.shape)
    assert np.abs((back2 - 2 * m)).max() < 1e-6


@pytest.mark.parametrize("shape,density", [((5000, 900), 0.01),
                                           ((300, 9000), 0.02)])
def test_strip_rectangular_bounded_span(shape, density):
    rng = np.random.default_rng(4)
    m = sp.random(*shape, density=density, format="csr", dtype=np.float32,
                  random_state=rng)
    st = smt.CSR.from_scipy(m).to_strip()
    x = rng.standard_normal(shape[1]).astype(np.float32)
    ref = m @ x
    y = np.asarray(smt.spmv(st, jnp.asarray(x)))
    assert np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-30) < 1e-5
