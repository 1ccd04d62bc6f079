"""ELL (ELLPACK) — the regular padded SpMV/SpMM format.

No reference counterpart: the reference's SpMV is a serial row loop over a
pointer-chase iterator (reference: src/sparsematrix.rs:146-158,
src/indexlist.rs:104-111).  Here every row is padded to ``K = max nnz/row``
entries, so SpMV becomes K vectorized gather-multiply-accumulate sweeps with
static shapes and no data-dependent control flow.  Rows are padded with (col=0, val=0) which is
gather-safe and accumulation-neutral.

For matrices with skewed nnz/row distributions use SELL (sell.py) or the
hybrid dispatch in ops/spmv.py.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import SparseFormat, array_field, register_format, static_field


@register_format
@dataclasses.dataclass(frozen=True)
class ELL(SparseFormat):
    """Frozen ELLPACK matrix.

    ``cols``: (n_rows_padded, K) int — column id per slot (padding = 0);
    ``vals``: (n_rows_padded, K) — value per slot (padding = 0);
    ``row_nnz``: (n_rows_padded,) int — valid slots per row.
    ``n_rows_padded`` is n_rows rounded up to a sublane multiple (8).
    """

    _spmv_read_fields = ("cols", "vals")  # row_nnz is freeze-time bookkeeping

    cols: jax.Array = array_field()
    vals: jax.Array = array_field()
    row_nnz: jax.Array = array_field()
    shape: Tuple[int, int] = static_field()

    ROW_PAD = 8  # float32 sublane count — keeps tiles aligned

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_csr(cls, csr, n_cols_per_row: int | None = None) -> "ELL":
        """Freeze a CSR matrix into ELL.  Host-side (uses concrete max nnz/row
        when ``n_cols_per_row`` is not given); jittable if it is given."""
        if n_cols_per_row is None:
            n_cols_per_row = max(csr.max_row_nnz(), 1)
        k = int(n_cols_per_row)
        n_rows, n_cols = csr.shape
        n_rows_p = -(-n_rows // cls.ROW_PAD) * cls.ROW_PAD
        nse = csr.nse
        row_nnz = csr.row_nnz()
        # slot (i, j) takes CSR entry indptr[i] + j when j < row_nnz[i]
        starts = csr.indptr[:-1]
        j = jnp.arange(k)
        src = starts[:, None].astype(jnp.int32) + j[None, :]
        valid = j[None, :] < row_nnz[:, None].astype(jnp.int32)
        src = jnp.where(valid, src, nse)  # out of range → gather fill
        cols = jnp.where(valid, csr.indices.at[src].get(mode="fill", fill_value=0), 0)
        vals = jnp.where(valid, csr.data.at[src].get(mode="fill", fill_value=0), 0)
        pad_r = n_rows_p - n_rows
        if pad_r:
            cols = jnp.concatenate([cols, jnp.zeros((pad_r, k), cols.dtype)])
            vals = jnp.concatenate([vals, jnp.zeros((pad_r, k), vals.dtype)])
            row_nnz = jnp.concatenate([row_nnz, jnp.zeros((pad_r,), row_nnz.dtype)])
        return cls(cols=cols, vals=vals, row_nnz=row_nnz, shape=csr.shape)

    @classmethod
    def from_coo(cls, coo, n_cols_per_row: int | None = None) -> "ELL":
        from .csr import CSR

        return cls.from_csr(CSR.from_coo(coo), n_cols_per_row=n_cols_per_row)

    # -- canonical views ----------------------------------------------------
    def to_coo(self):
        from .coo import COO

        n_rows, n_cols = self.shape
        n_rows_p, k = self.cols.shape
        idt = self.cols.dtype
        r = jnp.broadcast_to(
            jnp.arange(n_rows_p, dtype=jnp.int32)[:, None], (n_rows_p, k))
        valid = (jnp.arange(k, dtype=jnp.int32)[None, :]
                 < self.row_nnz[:, None].astype(jnp.int32)) & (r < n_rows)
        rows = jnp.where(valid, r, n_rows).reshape(-1).astype(idt)
        cols = jnp.where(valid, self.cols, 0).reshape(-1)
        vals = jnp.where(valid, self.vals, 0).reshape(-1)
        return COO(rows=rows, cols=cols, vals=vals, shape=self.shape, canonical=False)

    def to_csr(self):
        from .csr import CSR

        return CSR.from_coo(self.to_coo().sort())

    def to_ell(self, n_cols_per_row: int | None = None) -> "ELL":
        return self

    # -- structure ----------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(self.cols.shape[0] * self.cols.shape[1])

    @property
    def n_cols_per_row(self) -> int:
        return int(self.cols.shape[1])

    @property
    def index_dtype(self):
        return self.cols.dtype

    @property
    def data(self):
        return self.vals

    def n_non_zero_entries(self):
        return jnp.sum(self.row_nnz[: self.n_rows]).astype(jnp.int32)

    def scale(self, scalar) -> "ELL":
        return dataclasses.replace(self, vals=self.vals * jnp.asarray(scalar, self.vals.dtype))
