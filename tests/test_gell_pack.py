"""SlabPack (per-block-class buckets + spill overflow, formats/slab.py) and
GELL (scatter-free gather ladder, formats/gell.py) — formats for
mixed-degree FEM matrices and globally-scattered matrices."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import sparsemat_tpu as smt
from sparsemat_tpu.kernels.spmv import slab_pack_spmv_xla
from sparsemat_tpu.ops.matvec import _gell_spmv


def mixed_degree(n=2000, seed=0):
    """Interleaved light/heavy rows — worst case for lane-max bucket
    padding, guarantees the spill path engages."""
    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for i in range(n):
        deg = 3 if i % 7 else 60
        c = np.clip(i + rng.integers(-300, 301, deg), 0, n - 1)
        rows += [i] * deg
        cols += list(c)
    vals = rng.standard_normal(len(rows))
    m = sp.coo_matrix((vals, (rows, cols)), shape=(n, n)).tocsr()
    m.sum_duplicates()
    return m.astype(np.float32)


def scatter_matrix(n=4000, seed=1):
    rng = np.random.default_rng(seed)
    deg = rng.zipf(2.1, n).clip(1, n // 20)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, src.size)
    vals = rng.standard_normal(src.size)
    m = sp.coo_matrix((vals, (src, dst)), shape=(n, n)).tocsr()
    m.sum_duplicates()
    return m.astype(np.float32)


@pytest.mark.parametrize("spill", [0.0, 0.02])
def test_slab_pack_spmv_matches_scipy(spill):
    m = mixed_degree()
    pk = smt.SlabPack.from_csr(smt.CSR.from_scipy(m), n_classes=6,
                               spill_frac=spill)
    x = np.random.default_rng(3).standard_normal(m.shape[1]).astype(np.float32)
    ref = m @ x
    nrm = np.abs(ref).max()
    y = np.asarray(slab_pack_spmv_xla(pk, jnp.asarray(x)))
    np.testing.assert_allclose(y / nrm, ref / nrm, atol=1e-5)
    y3 = np.asarray(smt.spmv(pk, jnp.asarray(x)))
    np.testing.assert_allclose(y3 / nrm, ref / nrm, atol=1e-5)


def test_slab_pack_cuts_padding_vs_global_slab():
    m = mixed_degree()
    csr = smt.CSR.from_scipy(m)
    global_slab = csr.to_slab()
    pk = csr.to_slab_pack(n_classes=8)
    assert pk.nse < global_slab.nse          # classes must pay for themselves
    assert pk.spmv_traffic_bytes() < global_slab.spmv_traffic_bytes()


def test_slab_pack_roundtrip_and_counts():
    m = mixed_degree(n=1500, seed=4)
    pk = smt.SlabPack.from_csr(smt.CSR.from_scipy(m), n_classes=5,
                               spill_frac=0.02)
    c2 = pk.to_csr()
    m2 = sp.csr_matrix((np.asarray(c2.data), np.asarray(c2.indices),
                        np.asarray(c2.indptr)), shape=pk.shape)
    assert (m2 - m).nnz == 0
    assert int(np.asarray(pk.n_non_zero_entries())) == m.nnz
    # every global block appears exactly once across classes
    ids = sorted(b for ids in pk.block_ids for b in ids)
    assert ids == list(range(-(-m.shape[0] // pk.row_block)))


def test_slab_pack_scale_astype():
    m = mixed_degree(n=1200, seed=5)
    pk = smt.SlabPack.from_csr(smt.CSR.from_scipy(m), spill_frac=0.02)
    x = np.random.default_rng(6).standard_normal(m.shape[1]).astype(np.float32)
    ref = 3.0 * (m @ x)
    y = np.asarray(slab_pack_spmv_xla(pk.scale(3.0), jnp.asarray(x)))
    np.testing.assert_allclose(y, ref, atol=1e-3 * np.abs(ref).max())
    assert pk.astype(jnp.float64).parts[0].vals.dtype == jnp.float64


def test_gell_spmv_matches_scipy():
    m = scatter_matrix()
    g = smt.CSR.from_scipy(m).to_gell()
    x = np.random.default_rng(7).standard_normal(m.shape[1]).astype(np.float32)
    ref = m @ x
    nrm = max(np.abs(ref).max(), 1e-30)
    y = np.asarray(_gell_spmv(g, jnp.asarray(x)))
    np.testing.assert_allclose(y / nrm, ref / nrm, atol=1e-5)
    y2 = np.asarray(smt.spmv(g, jnp.asarray(x)))
    np.testing.assert_allclose(y2 / nrm, ref / nrm, atol=1e-5)


def test_gell_ladder_structure():
    m = scatter_matrix(seed=8)
    g = smt.CSR.from_scipy(m).to_gell()
    # ladder is bounded and covers every entry exactly once
    assert 1 <= g.n_levels <= 8
    assert int(np.asarray(g.n_non_zero_entries())) == m.nnz
    # padding stays moderate on power-law degree distributions
    assert g.nse <= 3 * m.nnz
    c2 = g.to_csr()
    m2 = sp.csr_matrix((np.asarray(c2.data), np.asarray(c2.indices),
                        np.asarray(c2.indptr)), shape=g.shape)
    assert (m2 - m).nnz == 0


def test_gell_spmm_and_empty_rows():
    m = scatter_matrix(n=800, seed=9).tolil()
    m[5] = 0          # empty row
    m = m.tocsr()
    m.eliminate_zeros()
    g = smt.CSR.from_scipy(m.astype(np.float32)).to_gell()
    B = np.random.default_rng(10).standard_normal((800, 5)).astype(np.float32)
    Y = np.asarray(smt.spmm(g, jnp.asarray(B)))
    refY = m @ B
    np.testing.assert_allclose(Y, refY, atol=1e-4 * max(np.abs(refY).max(), 1))


# --- SlabStream: flat chunk stream with exact per-bucket heights --------------

def test_slab_stream_spmv_matches_scipy():
    from sparsemat_tpu.kernels.spmv import slab_stream_spmv_xla
    m = mixed_degree()
    st = smt.SlabStream.from_csr(smt.CSR.from_scipy(m))
    x = np.random.default_rng(20).standard_normal(m.shape[1]).astype(np.float32)
    ref = m @ x
    nrm = np.abs(ref).max()
    y = np.asarray(slab_stream_spmv_xla(st, jnp.asarray(x)))
    np.testing.assert_allclose(y / nrm, ref / nrm, atol=1e-5)
    y3 = np.asarray(smt.spmv(st, jnp.asarray(x)))
    np.testing.assert_allclose(y3 / nrm, ref / nrm, atol=1e-5)


def test_slab_stream_beats_global_padding():
    m = mixed_degree(seed=21)
    csr = smt.CSR.from_scipy(m)
    st = csr.to_slab_stream()
    # exact per-bucket heights ≤ the global-max heights at the same rb
    # (SlabPack may beat either on adversarial mixes — it can also spill)
    assert st.nse <= csr.to_slab().nse
    assert (csr.to_slab_stream(rb=128).nse
            <= smt.SlabPack.from_csr(csr, spill_frac=0.0).nse)


def test_slab_stream_roundtrip_and_counts():
    m = mixed_degree(n=1100, seed=22)
    st = smt.SlabStream.from_csr(smt.CSR.from_scipy(m), rb=128)
    c2 = st.to_csr()
    m2 = sp.csr_matrix((np.asarray(c2.data), np.asarray(c2.indices),
                        np.asarray(c2.indptr)), shape=st.shape)
    assert (m2 - m).nnz == 0
    assert int(np.asarray(st.n_non_zero_entries())) == m.nnz
    x = np.random.default_rng(23).standard_normal(
        m.shape[1]).astype(np.float32)
    y = np.asarray(jax.jit(smt.spmv)(st, jnp.asarray(x)))
    ref = m @ x
    np.testing.assert_allclose(y, ref, atol=1e-4 * np.abs(ref).max())


def test_auto_format_global_scatter_skips_slab_freeze(monkeypatch):
    """auto_format never freezes SlabPack (the unguarded freeze built a
    1.8e9-slot, 13 GB layout on the scircuit surrogate): a global-scatter
    operand goes straight to GELL."""
    import sparsemat_tpu.formats as fmts
    from sparsemat_tpu.formats.slab import SlabPack

    def boom(*a, **k):
        raise AssertionError("SlabPack.from_csr called by auto_format")

    monkeypatch.setattr(SlabPack, "from_csr", boom)
    rng = np.random.default_rng(0)
    m = sp.random(4000, 60000, 0.0005, format="csr", dtype=np.float32,
                  random_state=rng)  # uniform WIDE scatter
    out = fmts.auto_format(smt.CSR.from_scipy(m))
    assert type(out).__name__ == "GELL"


@pytest.mark.parametrize("kind,want", [
    ("stencil", "DIA"), ("uniform_rows", "GELL"), ("mixed_degree", "GELL"),
    ("power_law", "GELL"), ("empty", "CSR")])
def test_auto_format_order(kind, want):
    """DIA → GELL, the order the H100 measurements give (PERF.md)."""
    n = 600
    rng = np.random.default_rng(1)
    if kind == "stencil":
        m = sp.diags([1.0, -2.0, 1.0], [-30, 0, 30], shape=(n, n),
                     format="csr", dtype=np.float32)
    elif kind == "uniform_rows":
        cols = rng.integers(0, n, (n, 6))
        m = sp.csr_matrix((np.ones(n * 6, np.float32),
                           (np.repeat(np.arange(n), 6), cols.ravel())),
                          shape=(n, n))
    elif kind == "mixed_degree":
        m = mixed_degree(n=n)
    elif kind == "power_law":
        m = scatter_matrix(n=n)
    else:
        m = sp.csr_matrix((n, n), dtype=np.float32)
    out = smt.auto_format(smt.CSR.from_scipy(m))
    assert type(out).__name__ == want
    if m.nnz:
        x = rng.standard_normal(n).astype(np.float32)
        ref = m @ x
        np.testing.assert_allclose(np.asarray(smt.spmv(out, x)), ref,
                                   atol=1e-4 * np.abs(ref).max())
