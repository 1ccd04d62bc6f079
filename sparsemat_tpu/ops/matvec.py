"""SpMV / SpMM — the hot loops of the library.

Reference counterpart: the serial row-loop ``mvp``
(reference: src/sparsematrix.rs:146-158) shared by every format via
``iter_row``.  Here the loop nest becomes one of

* a gather + scatter-add over the flat entry stream (COO/CSR path);
* K dense gather-FMA sweeps over an ELL rectangle (regular, no
  data-dependent shapes) — preferred when nnz/row is tight;
* static shifted slices for DIA, which XLA fuses into one pass;
* the per-format formulations in sparsemat_tpu/kernels/ for the windowed,
  strip, routed and block layouts.

Each format has exactly one device path; dispatch picks it by type.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats.coo import COO
from ..formats.csr import CSR
from ..formats.dia import DIA, dia_spmm, dia_spmv
from ..formats.ell import ELL
from ..types import accum_dtype


def _check_dims(mat, x, what="spmv"):
    if x.shape[0] != mat.shape[1]:
        raise ValueError(
            f"{what}: dimension mismatch — matrix is {mat.shape}, operand has "
            f"leading dim {x.shape[0]}")


# --- COO / CSR stream path ---------------------------------------------------

def _stream_spmv(rows, cols, vals, n_rows, x):
    adt = accum_dtype(jnp.result_type(vals.dtype, x.dtype))
    xg = x.at[cols.astype(jnp.int32)].get(mode="fill", fill_value=0)
    prod = vals.astype(adt) * xg.astype(adt)
    y = jnp.zeros((n_rows,), adt)
    # padding entries carry row == n_rows → dropped by scatter semantics
    return y.at[rows.astype(jnp.int32)].add(prod, mode="drop")


def _stream_spmm(rows, cols, vals, n_rows, B):
    adt = accum_dtype(jnp.result_type(vals.dtype, B.dtype))
    Bg = B.at[cols.astype(jnp.int32)].get(mode="fill", fill_value=0)
    prod = vals.astype(adt)[:, None] * Bg.astype(adt)
    y = jnp.zeros((n_rows, B.shape[1]), adt)
    return y.at[rows.astype(jnp.int32)].add(prod, mode="drop")


#: cap on the materialized (nnz, tile) gather of the stream SpMM — the
#: one-shot path would need nnz*m*itemsize bytes, which for pwtk-scale
#: operands (10M nnz × 128 cols) is >5 GB; tiles bound the working set.
_SPMM_GATHER_BUDGET = 1 << 29  # 512 MB


def _stream_spmm_tiled(rows, cols, vals, n_rows, B):
    """Column-tiled stream SpMM: one jitted fori_loop over B-column tiles,
    each tile a (nnz, mt) gather + segment scatter-add.  Peak temp memory
    is nnz*mt*itemsize instead of nnz*m*itemsize."""
    adt = accum_dtype(jnp.result_type(vals.dtype, B.dtype))
    m = B.shape[1]
    nnz = vals.shape[0]
    mt = max(_SPMM_GATHER_BUDGET // (max(nnz, 1) * jnp.dtype(adt).itemsize), 1)
    mt = min(mt, m)
    n_tiles = -(-m // mt)
    if n_tiles <= 1:
        return _stream_spmm(rows, cols, vals, n_rows, B)
    Bp = jnp.pad(B, ((0, 0), (0, n_tiles * mt - m)))
    ri = rows.astype(jnp.int32)
    ci = cols.astype(jnp.int32)
    va = vals.astype(adt)

    def tile(t, Y):
        Bt = jax.lax.dynamic_slice_in_dim(Bp, t * mt, mt, axis=1)
        Bg = Bt.at[ci].get(mode="fill", fill_value=0)
        prod = va[:, None] * Bg.astype(adt)
        yt = jnp.zeros((n_rows, mt), adt)
        yt = yt.at[ri].add(prod, mode="drop")
        return jax.lax.dynamic_update_slice_in_dim(Y, yt, t * mt, axis=1)

    Y = jax.lax.fori_loop(0, n_tiles,  tile,
                          jnp.zeros((n_rows, n_tiles * mt), adt))
    return Y[:, :m]


# --- ELL path ----------------------------------------------------------------

def _ell_spmv(ell: ELL, x):
    adt = accum_dtype(jnp.result_type(ell.vals.dtype, x.dtype))
    xg = x.at[ell.cols.astype(jnp.int32)].get(mode="fill", fill_value=0)
    y = jnp.sum(ell.vals.astype(adt) * xg.astype(adt), axis=1)
    return y[: ell.n_rows]


def _ell_spmm(ell: ELL, B):
    adt = accum_dtype(jnp.result_type(ell.vals.dtype, B.dtype))
    # (n_rows_p, K, m) gather, summed over K — the caller bounds K*m
    Bg = B.at[ell.cols.astype(jnp.int32)].get(mode="fill", fill_value=0)
    y = jnp.sum(ell.vals.astype(adt)[:, :, None] * Bg.astype(adt), axis=1)
    return y[: ell.n_rows]


# --- GELL ladder path (no scatter anywhere: see formats/gell.py) -------------

def _gell_spmv(g, x):
    y = _ell_spmv(g.levels[0], x)
    for lvl, inv in zip(g.levels[1:], g.inv_maps):
        yl = _ell_spmv(lvl, x)
        y = y + yl.at[inv].get(mode="fill", fill_value=0)
    return y


def _gell_spmm(g, B):
    y = _ell_spmm(g.levels[0], B)
    for lvl, inv in zip(g.levels[1:], g.inv_maps):
        yl = _ell_spmm(lvl, B)
        y = y + yl.at[inv].get(mode="fill", fill_value=0)
    return y


# --- public dispatch ---------------------------------------------------------

def spmv(mat, x, *, method: str | None = None) -> jax.Array:
    """y = A @ x.  ``method`` converts first: None (use the format as
    frozen), or one of 'dia', 'strip', 'route', 'slab_stream',
    'slab_pack', 'slab', 'well', 'gell', 'ell'."""
    x = jnp.asarray(x)
    _check_dims(mat, x)
    if isinstance(mat, DIA) or method == "dia":
        return dia_spmv(mat if isinstance(mat, DIA) else mat.to_dia(), x)
    from ..formats.route import RouteStream
    from ..formats.slab import SlabELL, SlabPack, SlabStream
    from ..formats.strip import StripELL
    from ..formats.well import WELL

    if isinstance(mat, StripELL) or method == "strip":
        from ..kernels.strip import strip_spmv_xla

        return strip_spmv_xla(
            mat if isinstance(mat, StripELL) else mat.to_strip(), x)
    if isinstance(mat, RouteStream) or method == "route":
        from ..kernels.route import route_spmv_xla

        return route_spmv_xla(
            mat if isinstance(mat, RouteStream) else mat.to_route(), x)
    if isinstance(mat, SlabStream) or method == "slab_stream":
        from ..kernels.spmv import slab_stream_spmv_xla

        return slab_stream_spmv_xla(
            mat if isinstance(mat, SlabStream) else mat.to_slab_stream(), x)
    if isinstance(mat, SlabPack) or method == "slab_pack":
        from ..kernels.spmv import slab_pack_spmv_xla

        return slab_pack_spmv_xla(
            mat if isinstance(mat, SlabPack) else mat.to_slab_pack(), x)
    if isinstance(mat, SlabELL) or method == "slab":
        from ..kernels.spmv import slab_spmv_xla

        return slab_spmv_xla(
            mat if isinstance(mat, SlabELL) else mat.to_slab(), x)
    if isinstance(mat, WELL) or method == "well":
        from ..kernels.spmv import well_spmv_xla

        return well_spmv_xla(mat if isinstance(mat, WELL) else mat.to_well(), x)
    from ..formats.gell import GELL

    if isinstance(mat, GELL) or method == "gell":
        g = mat if isinstance(mat, GELL) else mat.to_gell()
        return _gell_spmv(g, x)
    if isinstance(mat, ELL) or method == "ell":
        ell = mat if isinstance(mat, ELL) else mat.to_ell()
        return _ell_spmv(ell, x)
    if isinstance(mat, CSR):
        return _stream_spmv(mat.row_ids, mat.indices, mat.data, mat.n_rows, x)
    if isinstance(mat, COO):
        return _stream_spmv(mat.rows, mat.cols, mat.vals, mat.n_rows, x)
    # any other format: canonicalize through COO
    coo = mat.to_coo()
    return _stream_spmv(coo.rows, coo.cols, coo.vals, coo.n_rows, x)


def spmv_dot(mat, x):
    """(A @ x, x·(A @ x)) — the CG inner pair (α = rᵀr / pᵀAp,
    src/linearsolver.rs:43-45)."""
    x = jnp.asarray(x)
    _check_dims(mat, x, "spmv_dot")
    y = spmv(mat, x)
    return y, jnp.sum(x.astype(y.dtype) * y)


def spmv_chain(mat, x, k: int) -> jax.Array:
    """x ← Aᵏ x — k chained SpMVs in one dispatch (square A).

    The building block of power/Richardson/Chebyshev iterations (the
    reference runs mvp in a solver loop, src/linearsolver.rs:41-49): one
    ``lax.fori_loop`` over ``spmv``, compiled as a single program.
    """
    x = jnp.asarray(x)
    _check_dims(mat, x, "spmv_chain")
    if mat.shape[0] != mat.shape[1]:
        raise ValueError(f"spmv_chain needs a square matrix, got {mat.shape}")
    # spmv returns the accumulation dtype (f32 for bf16/f16 inputs) — carry
    # must be dtype-stable across iterations, so promote x up front
    x = x.astype(accum_dtype(jnp.result_type(mat.dtype, x.dtype)))
    return jax.lax.fori_loop(0, k, lambda i, v: spmv(mat, v), x)


def spmm(mat, B, *, method: str | None = None) -> jax.Array:
    """Y = A @ B for dense B of shape (n_cols, m).  ``method`` converts
    first: None (use the format as frozen), 'bsr', 'dia', 'gell' or
    'ell'."""
    B = jnp.asarray(B)
    _check_dims(mat, B, "spmm")
    from ..formats.bsr import BSR

    if isinstance(mat, BSR) or method == "bsr":
        from ..kernels.spmm import bsr_spmm_xla

        bsr = mat if isinstance(mat, BSR) else BSR.from_csr(mat.to_csr())
        return bsr_spmm_xla(bsr, B)
    if isinstance(mat, DIA) or method == "dia":
        dia = mat if isinstance(mat, DIA) else mat.to_dia()
        return dia_spmm(dia, B)
    from ..formats.gell import GELL

    if isinstance(mat, GELL) or method == "gell":
        g = mat if isinstance(mat, GELL) else mat.to_gell()
        return _gell_spmm(g, B)
    if isinstance(mat, ELL) or method == "ell":
        ell = mat if isinstance(mat, ELL) else mat.to_ell()
        return _ell_spmm(ell, B)
    if isinstance(mat, CSR):
        # prefer the regular ELL gather when padding waste is acceptable AND
        # the (n_rows, K, m) gather fits the budget (host-side structure
        # check — unavailable under jit tracing)
        if not isinstance(mat.indptr, jax.core.Tracer):
            nnz = int(mat.host("indptr")[-1])
            ell_slots = mat.max_row_nnz() * mat.n_rows
            if (nnz and ell_slots <= 4 * nnz
                    and ell_slots * B.shape[1] * 4 <= _SPMM_GATHER_BUDGET):
                return _ell_spmm(mat.to_ell(), B)
        return _stream_spmm_tiled(mat.row_ids, mat.indices, mat.data,
                                  mat.n_rows, B)
    if isinstance(mat, COO):
        return _stream_spmm_tiled(mat.rows, mat.cols, mat.vals, mat.n_rows, B)
    # other formats (WELL, SlabELL, SlabPack, ...): canonicalize through CSR
    # so the ELL-vs-stream choice above applies
    return spmm(mat.to_csr(), B)


def rmatvec(mat, y) -> jax.Array:
    """x = Aᵀ @ y without materializing the transpose (scatter by column)."""
    y = jnp.asarray(y)
    if y.shape[0] != mat.shape[0]:
        raise ValueError(f"rmatvec: matrix is {mat.shape}, operand {y.shape}")
    coo = mat.to_coo()
    adt = accum_dtype(jnp.result_type(coo.vals.dtype, y.dtype))
    valid = coo.rows.astype(jnp.int32) < mat.shape[0]
    yg = y.at[coo.rows.astype(jnp.int32)].get(mode="fill", fill_value=0)
    prod = jnp.where(valid, coo.vals.astype(adt) * yg.astype(adt), 0)
    out = jnp.zeros((mat.shape[1],), adt)
    scatter_cols = jnp.where(valid, coo.cols.astype(jnp.int32), mat.shape[1])
    return out.at[scatter_cols].add(prod, mode="drop")
