"""Golden-semantics suite: the reference's own test matrices and expected
values (reference: src/lib.rs:36-231), pinned with float tolerances.

The reference asserts exact f32 equality and insertion-order iteration;
this build declares sorted canonical order and asserts values within
tolerance (SURVEY.md §7d)."""

import jax.numpy as jnp
import numpy as np
import pytest

import sparsemat_tpu as smt


def build_indexlist_matrix(format="coo"):
    """The 3×3 matrix of check_sparsemat_indexlist (src/lib.rs:55-66):
    add_to(0,1,4.2); add_to(1,2,4.12); add_to(2,2,2.12); add_to(1,1,1.12);
    get_mut(1,1)+=1.12; get_mut(0,2)+=0.12; get_mut(0,0)=8.12; set(0,0,7.12).
    Final: (0,0)=7.12 (0,1)=4.2 (0,2)=0.12 (1,1)=2.24 (1,2)=4.12 (2,2)=2.12.
    """
    rows = jnp.array([0, 0, 0, 1, 1, 2], jnp.int32)
    cols = jnp.array([0, 1, 2, 1, 2, 2], jnp.int32)
    vals = jnp.array([7.12, 4.2, 0.12, 2.24, 4.12, 2.12], jnp.float32)
    coo = smt.COO.from_arrays(rows, cols, vals, (3, 3), canonical=True)
    return coo if format == "coo" else getattr(coo, f"to_{format}")()


def build_crs_matrix(format="csr"):
    """The 4×4 matrix of check_sparsemat_crs (src/lib.rs:115-121)."""
    rows = jnp.array([0, 2, 1, 3, 3], jnp.int32)
    cols = jnp.array([1, 2, 2, 2, 3], jnp.int32)
    vals = jnp.array([4.2, 2.12, 4.12, 1.12, 5.12], jnp.float32)
    coo = smt.COO.from_arrays(rows, cols, vals, (4, 4))
    return coo if format == "coo" else getattr(coo, f"to_{format}")()


X3 = jnp.array([2.0, 4.8, 1.2], jnp.float32)
X4 = jnp.array([2.0, 4.8, 1.2, 3.4], jnp.float32)


@pytest.mark.parametrize("format", ["coo", "csr", "ell", "sell"])
def test_spmv_golden_3x3(format):
    # mvp.get(0) == 34.544 (src/lib.rs:80-82)
    mat = build_indexlist_matrix(format)
    y = smt.spmv(mat, X3)
    assert y.shape == (3,)
    np.testing.assert_allclose(
        np.asarray(y), [34.544, 15.696, 2.544], rtol=1e-6)


@pytest.mark.parametrize("format", ["coo", "csr", "ell", "sell"])
def test_spmv_golden_4x4(format):
    # mvp.get(0) == 20.16 (src/lib.rs:150-152)
    mat = build_crs_matrix(format)
    y = smt.spmv(mat, X4)
    np.testing.assert_allclose(np.asarray(y)[0], 20.16, rtol=1e-6)


@pytest.mark.parametrize("format", ["coo", "csr", "ell", "sell"])
def test_density_golden(format):
    # density 6/9 and 5/16 (src/lib.rs:83,153)
    assert float(build_indexlist_matrix(format).density()) == pytest.approx(6 / 9)
    assert float(build_crs_matrix(format).density()) == pytest.approx(5 / 16)


def test_get_point_lookup():
    # sp.get(0,0) == 7.12 after set overwrite (src/lib.rs:65-66)
    mat = build_indexlist_matrix("csr")
    assert mat.get(0, 0) == pytest.approx(7.12, rel=1e-6)
    assert mat[2, 2] == pytest.approx(2.12, rel=1e-6)
    assert mat.get(2, 0) == 0.0


def test_operator_overloads():
    # sum/sub/scale (src/lib.rs:74-79)
    sp = build_indexlist_matrix("csr")
    total = sp + sp
    assert total.get(0, 0) == pytest.approx(14.24, rel=1e-6)
    sub = total - sp
    assert sub.get(0, 0) == pytest.approx(sp.get(0, 0), rel=1e-6)
    mul = sp * 2.0
    assert mul.get(0, 0) == pytest.approx(total.get(0, 0), rel=1e-6)
    # matmul operator == mvp (sparsemat_ops! macro, src/sparsematrix.rs:435-443)
    np.testing.assert_allclose(np.asarray(sp @ X3), np.asarray(sp.mvp(X3)))


def test_spgemm_golden():
    # mp = sp_crs.prod(&sp); mp.get(1,2) == 17.9632 (src/lib.rs:100-102)
    sp = build_indexlist_matrix("coo")
    sp_csr = sp.to_csr()
    mp = smt.spgemm(sp_csr, sp)
    assert mp.get(1, 2) == pytest.approx(17.9632, rel=1e-6)
    # cross-check full product against dense
    dense = np.asarray(sp.todense())
    np.testing.assert_allclose(np.asarray(mp.todense()), dense @ dense, rtol=1e-6)


def test_spgemm_dimension_guard():
    a = smt.COO.from_arrays(jnp.array([0]), jnp.array([1]), jnp.array([1.0]), (2, 3))
    b = smt.COO.from_arrays(jnp.array([0]), jnp.array([1]), jnp.array([1.0]), (2, 3))
    with pytest.raises(smt.DimensionError):
        smt.spgemm(a, b)


def test_cross_format_add():
    # sp.add(&sp_crs) → row 1 doubles: "0 4.48 8.24" (src/lib.rs:104-107)
    sp = build_indexlist_matrix("coo")
    sp_csr = build_indexlist_matrix("csr")
    s = smt.add(sp, sp_csr)
    row1 = np.asarray(s.todense())[1]
    np.testing.assert_allclose(row1, [0.0, 4.48, 8.24], rtol=1e-6)


def test_row_rendering_golden():
    # to_string_row(1) == "0 2.24 4.12 " (src/lib.rs:95-98)
    from sparsemat_tpu.io import to_string_row

    sp = build_indexlist_matrix("csr")
    assert to_string_row(sp, 1) == "0 2.24 4.12 "


def test_transpose_roundtrip():
    sp = build_crs_matrix("csr")
    t = smt.transpose(sp)
    np.testing.assert_allclose(
        np.asarray(t.todense()), np.asarray(sp.todense()).T, rtol=1e-6)
    tt = smt.transpose(t)
    np.testing.assert_allclose(
        np.asarray(tt.todense()), np.asarray(sp.todense()), rtol=1e-6)


def test_is_symmetric():
    sym = smt.from_dense(np.array([[4.0, 1.0], [1.0, 3.0]]))
    asym = smt.from_dense(np.array([[4.0, 1.0], [2.0, 3.0]]))
    assert bool(smt.is_symmetric(sym))
    assert not bool(smt.is_symmetric(asym))


def test_inner_prod_bilinear():
    # lᵀ A r (src/sparsematrix.rs:161-171)
    sp = build_indexlist_matrix("csr")
    l = jnp.array([1.0, 2.0, 3.0], jnp.float32)
    expected = float(np.asarray(l) @ (np.asarray(sp.todense()) @ np.asarray(X3)))
    assert float(sp.inner_prod(l, X3)) == pytest.approx(expected, rel=1e-6)


def test_eye():
    i3 = smt.eye(3)
    np.testing.assert_allclose(np.asarray(i3.todense()), np.eye(3))
    np.testing.assert_allclose(np.asarray(i3 @ X3), np.asarray(X3))


def test_sparsevec_golden():
    # check_sparsevec (src/lib.rs:221-231): insertion-order iter_sparse
    sv = smt.SparseVec.empty(dtype=np.float64)
    sv.set(8, 6.0)
    sv.set(80, 6.4)
    sv.set(55, 8.2)
    sv.set(4, 4.0)
    it = sv.iter_sparse()
    assert next(it) == (8, 6.0)
    assert next(it) == (80, 6.4)
    assert sv.get(4) == 4.0


def test_densevec_semantics():
    # auto-resize get_mut/set (src/densevec.rs:44-49); ops (src/lib.rs:43-48)
    v = smt.DenseVec(dtype=np.float64)
    v.set(0, 1.0)
    v.set(3, 2.0)
    assert v.dim == 4
    assert v.get(1) == 0.0
    v.add_to(1, 0.5)
    assert v.get(1) == 0.5
    with pytest.raises(ValueError):
        smt.DenseVec([1.0]).add(smt.DenseVec([1.0, 2.0]))


def test_csr_column_iter():
    """ColumnIter on the frozen CSR (≈ src/sparsemat_crs.rs:175-191 +
    golden column-order check src/lib.rs:137-143)."""
    import pytest

    from sparsemat_tpu.builder import SparseBuilder

    b = SparseBuilder()
    b.set(0, 1, 2.24)
    b.set(2, 1, 8.0)
    b.set(1, 0, 5.0)
    b.set(0, 2, 4.12)
    csr = b.to_csr()
    with pytest.raises(RuntimeError, match="assemble_column_info"):
        next(csr.iter_col(1))
    csr.assemble_column_info()
    assert [(r, float(v)) for r, v in csr.iter_col(1)] == [
        (0, pytest.approx(2.24)), (2, 8.0)]
    assert list(csr.iter_col(0)) == [(1, 5.0)]
    assert list(csr.iter_col(7)) == []          # out of range: empty
    # row iteration: sorted canonical order; out-of-range empty
    assert [(c, float(v)) for c, v in csr.iter_row(0)] == [
        (1, pytest.approx(2.24)), (2, pytest.approx(4.12))]
    assert list(csr.iter_row(5)) == []          # ≈ src/lib.rs:148-149
