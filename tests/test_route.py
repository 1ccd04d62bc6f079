"""RouteStream (statically-routed scattered SpMV) — freeze, routing-table
correctness, the XLA table replay, dispatch, round-trips.

The scatter regime the format targets is the reference's worst case for
its serial row loop (src/sparsematrix.rs:146-158); correctness is pinned
against scipy on uniformly-scattered and power-law matrices.
"""

import numpy as np
import pytest
import scipy.sparse as sp

import jax.numpy as jnp

import sparsemat_tpu as smt
from sparsemat_tpu.formats.route import RouteStream, _euler_color_128
from sparsemat_tpu.kernels.route import route_spmv_xla


def _rand_scatter(n, dens, seed, with_zero=False):
    m = sp.random(n, n, dens, random_state=seed, format="csr").astype(np.float32)
    m.data = (m.data * 10 - 5).astype(np.float32)
    m = (m + sp.eye(n, dtype=np.float32, format="csr")).tocsr()
    if with_zero:
        m.data[0] = 0.0  # explicitly stored zero
    m.sort_indices()
    return m


def test_edge_coloring_proper():
    rng = np.random.default_rng(0)
    insts, srcs, dsts = [], [], []
    for i in range(3):
        for _ in range(128):
            p = rng.permutation(128)
            insts.append(np.full(128, i))
            srcs.append(np.arange(128))
            dsts.append(p)
    inst = np.concatenate(insts)
    src = np.concatenate(srcs)
    dst = np.concatenate(dsts)
    sh = rng.permutation(inst.size)
    col = _euler_color_128(inst[sh], src[sh], dst[sh])
    a = inst[sh] * 128 * 128 + src[sh] * 128 + col
    b = inst[sh] * 128 * 128 + dst[sh] * 128 + col
    assert np.unique(a).size == a.size
    assert np.unique(b).size == b.size
    assert col.min() >= 0 and col.max() < 128


@pytest.mark.parametrize("n,dens,seed", [
    (300, 0.01, 1),      # small scatter
    (1000, 0.004, 2),    # multiple supertiles/regions
    (257, 0.03, 3),      # non-multiple-of-128 shape
    (64, 0.2, 4),        # dense-ish tiny
])
def test_route_spmv_vs_scipy(n, dens, seed):
    m = _rand_scatter(n, dens, seed)
    rs = smt.CSR.from_scipy(m).to_route()
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(n).astype(np.float32)
    y_ref = m @ x
    nrm = max(np.abs(y_ref).max(), 1e-30)
    y_xla = np.asarray(route_spmv_xla(rs, jnp.asarray(x)))
    assert np.abs(y_xla - y_ref).max() / nrm < 1e-5


def test_route_heavy_rows_zipf():
    # power-law row degrees incl. rows >128 entries (giant-row chunks)
    rng = np.random.default_rng(5)
    n = 700
    deg = np.minimum(rng.zipf(1.7, n), 300)
    src = np.repeat(np.arange(n), deg)
    dst = rng.integers(0, n, src.size)
    v = rng.standard_normal(src.size).astype(np.float32)
    m = sp.coo_matrix((v, (src, dst)), shape=(n, n)).tocsr()
    m.sum_duplicates()
    m.sort_indices()
    rs = smt.CSR.from_scipy(m).to_route()
    x = rng.standard_normal(n).astype(np.float32)
    y_ref = m @ x
    nrm = max(np.abs(y_ref).max(), 1e-30)
    y = np.asarray(route_spmv_xla(rs, jnp.asarray(x)))
    assert np.abs(y - y_ref).max() / nrm < 1e-5


def test_route_round_trip_and_stored_zero():
    m = _rand_scatter(200, 0.02, 7, with_zero=True)
    rs = smt.CSR.from_scipy(m).to_route()
    assert int(np.asarray(rs.n_non_zero_entries())) == m.nnz  # zeros kept
    back = rs.to_csr()
    got = sp.csr_matrix((back.host("data"), back.host("indices"),
                         back.host("indptr")), shape=back.shape)
    # stored zero is dropped by to_csr's canonicalization of *structure*?
    # No: COO keeps slot values; compare structurally on nonzeros
    d = got - m
    assert d.nnz == 0 or np.abs(d.data).max() == 0


def test_route_dispatch_and_rect():
    m = _rand_scatter(300, 0.01, 9)[:, :250].tocsr()
    m.sort_indices()
    rs = smt.CSR.from_scipy(m).to_route()
    x = np.random.default_rng(0).standard_normal(250).astype(np.float32)
    y = np.asarray(smt.spmv(rs, jnp.asarray(x)))   # CPU → XLA oracle path
    y_ref = m @ x
    assert np.abs(y - y_ref).max() / max(np.abs(y_ref).max(), 1e-30) < 1e-5
    # operator surface inherited from SparseFormat
    y2 = np.asarray(rs @ jnp.asarray(x))
    assert np.allclose(y2, y, atol=0)
    s = rs.scale(2.0)
    ys = np.asarray(smt.spmv(s, jnp.asarray(x)))
    assert np.abs(ys - 2 * y_ref).max() / max(np.abs(y_ref).max(), 1e-30) < 1e-5


def test_route_empty_and_tiny():
    m = sp.csr_matrix((5, 7), dtype=np.float32)
    rs = smt.CSR.from_scipy(m).to_route()
    x = np.ones(7, np.float32)
    assert np.allclose(np.asarray(smt.spmv(rs, jnp.asarray(x))), 0)
    m2 = sp.csr_matrix(np.array([[1.0, 0, 2.0], [0, 0, 0], [0, 3.0, 0]],
                                np.float32))
    rs2 = smt.CSR.from_scipy(m2).to_route()
    y = np.asarray(route_spmv_xla(rs2, jnp.asarray(np.array([1, 2, 3],
                                                            np.float32))))
    assert np.allclose(y, [7.0, 0.0, 6.0])
