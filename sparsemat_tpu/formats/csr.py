"""CSR — the canonical frozen compute format.

Successor of the reference's ``SparseMatCRS``
(reference: src/sparsemat_crs.rs:9-17 — values/columns/offset_rows arrays).
Differences by design:

* rows are always column-sorted (the reference leaves CRS in chain order
  unless ``sort`` was called on the source first, src/sparsemat_crs.rs:24-50);
  sorted order is declared canonical so results are deterministic.
* no incremental ``push`` (the reference's is documented O(n) and "very
  inefficient", src/sparsemat_crs.rs:69-92) — mutation belongs to the
  builder; CSR is immutable.
* ``row_ids`` (the expanded per-entry row index) is precomputed at freeze
  time because the gather/segment-sum SpMV path consumes it every call —
  the moral equivalent of the reference caching column info after
  ``assemble_column_info`` (src/sparsemat_crs.rs:180-191).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import DEFAULT_INDEX_DTYPE
from .base import (
    SparseFormat,
    array_field,
    indptr_to_rows,
    register_format,
    static_field,
)


@register_format
@dataclasses.dataclass(frozen=True)
class CSR(SparseFormat):
    """Frozen compressed-sparse-row matrix.

    ``indptr``: (n_rows+1,) row offsets over the *valid* entries;
    ``indices``: (nse,) column ids (tail padding = 0);
    ``data``: (nse,) values (tail padding = 0);
    ``row_ids``: (nse,) expanded row per entry (tail padding = n_rows).
    Slots in ``[indptr[-1], nse)`` are padding.
    """

    _spmv_read_fields = ("data", "indices", "row_ids")  # stream path skips indptr

    indptr: jax.Array = array_field()
    indices: jax.Array = array_field()
    data: jax.Array = array_field()
    row_ids: jax.Array = array_field()
    shape: Tuple[int, int] = static_field()

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_coo(cls, coo) -> "CSR":
        coo = coo.sort()
        indptr = coo.indptr()
        return cls(indptr=indptr, indices=coo.cols, data=coo.vals,
                   row_ids=coo.rows, shape=coo.shape)

    @classmethod
    def from_arrays(cls, indptr, indices, data, shape) -> "CSR":
        host = {k: v for k, v in
                (("indptr", indptr), ("indices", indices), ("data", data))
                if isinstance(v, np.ndarray)}
        indptr = jnp.asarray(indptr)
        indices = jnp.asarray(indices)
        data = jnp.asarray(data)
        row_ids = indptr_to_rows(indptr, indices.shape[0])
        out = cls(indptr=indptr, indices=indices, data=data,
                  row_ids=row_ids, shape=tuple(shape))
        if "indptr" in host:
            ip = host["indptr"].astype(np.int64)
            n_rows = ip.shape[0] - 1
            rid = np.full(int(indices.shape[0]), n_rows, np.int64)
            rid[: ip[-1]] = np.repeat(np.arange(n_rows), np.diff(ip))
            host["row_ids"] = rid
        if host:
            # match the device dtype (jnp may demote 64-bit under x64-off)
            out._stash_host(**{k: v.astype(getattr(out, k).dtype, copy=False)
                               for k, v in host.items()})
        return out

    @classmethod
    def from_host_coo(cls, rows, cols, vals, shape, *, dtype=None,
                      index_dtype=DEFAULT_INDEX_DTYPE, sum_duplicates=True) -> "CSR":
        """Build canonical CSR from host (numpy) triplets entirely on the
        host — no device compilation.  This is the fast freeze path used by
        the builder and the I/O loaders (device-side ``COO.sort`` exists for
        triplets that already live on-device / under jit)."""
        # keep the caller's integer width — converting 10M-entry arrays to
        # int64 and back costs ~0.5 s of page faults on the bench host
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        if rows.dtype.kind not in "iu":
            rows = rows.astype(np.int64)
        if cols.dtype.kind not in "iu":
            cols = cols.astype(np.int64)
        vals = np.asarray(vals)
        if dtype is not None and vals.dtype != np.dtype(dtype):
            vals = vals.astype(dtype)
        n_rows, n_cols = map(int, shape)
        # already canonical (strictly ascending (row, col) — e.g. files our
        # own writer produced)? skip the lexsort AND the dedup pass
        if rows.size and np.all(
                (rows[1:] > rows[:-1])
                | ((rows[1:] == rows[:-1]) & (cols[1:] > cols[:-1]))):
            sum_duplicates = False
        else:
            order = np.lexsort((cols, rows))
            rows, cols, vals = rows[order], cols[order], vals[order]
        if sum_duplicates and rows.size:
            key_new = np.empty(rows.size, bool)
            key_new[0] = True
            key_new[1:] = (rows[1:] != rows[:-1]) | (cols[1:] != cols[:-1])
            gid = np.cumsum(key_new) - 1
            summed = np.zeros(int(gid[-1]) + 1, vals.dtype)
            np.add.at(summed, gid, vals)
            rows, cols, vals = rows[key_new], cols[key_new], summed
        counts = np.bincount(rows, minlength=n_rows)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(index_dtype)
        cols = cols.astype(index_dtype, copy=False)
        rows = rows.astype(index_dtype, copy=False)
        out = cls(indptr=jnp.asarray(indptr),
                  indices=jnp.asarray(cols),
                  data=jnp.asarray(vals),
                  row_ids=jnp.asarray(rows),
                  shape=(n_rows, n_cols))
        return out._stash_host(
            indptr=indptr.astype(out.indptr.dtype, copy=False),
            indices=cols, data=vals.astype(out.data.dtype, copy=False),
            row_ids=rows)

    @classmethod
    def from_dense(cls, mat, *, index_dtype=DEFAULT_INDEX_DTYPE) -> "CSR":
        from .coo import COO

        return cls.from_coo(COO.from_dense(mat, index_dtype=index_dtype))

    @classmethod
    def from_scipy(cls, sp_mat, *, index_dtype=DEFAULT_INDEX_DTYPE) -> "CSR":
        sp_mat = sp_mat.tocsr()
        sp_mat.sort_indices()
        return cls.from_arrays(
            np.asarray(sp_mat.indptr, index_dtype),
            np.asarray(sp_mat.indices, index_dtype),
            np.asarray(sp_mat.data),
            sp_mat.shape)

    @classmethod
    def eye(cls, dim: int, *, dtype=jnp.float32, index_dtype=DEFAULT_INDEX_DTYPE) -> "CSR":
        """Identity (≈ SparseMatrix::eye, src/sparsematrix.rs:92-98)."""
        idx = jnp.arange(dim, dtype=index_dtype)
        return cls(indptr=jnp.arange(dim + 1, dtype=index_dtype), indices=idx,
                   data=jnp.ones((dim,), dtype), row_ids=idx, shape=(dim, dim))

    # -- canonical views ----------------------------------------------------
    def to_csr(self) -> "CSR":
        return self

    def to_coo(self):
        from .coo import COO

        return COO(rows=self.row_ids, cols=self.indices, vals=self.data,
                   shape=self.shape, canonical=True)

    def to_ell(self, n_cols_per_row: int | None = None):
        from .ell import ELL

        return ELL.from_csr(self, n_cols_per_row=n_cols_per_row)

    def to_sell(self, slice_height: int = 8):
        from .sell import SELL

        return SELL.from_csr(self, slice_height=slice_height)

    # -- structure ----------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(self.indices.shape[0])

    @property
    def index_dtype(self):
        return self.indices.dtype

    def n_non_zero_entries(self):
        return self.indptr[-1].astype(jnp.int32)

    def row_nnz(self):
        """Per-row entry counts."""
        return self.indptr[1:] - self.indptr[:-1]

    def max_row_nnz(self) -> int:
        """Host-side max nnz/row (static; used by ELL conversion & dispatch)."""
        return int(np.diff(self.host("indptr")).max(initial=0))

    def scale(self, scalar) -> "CSR":
        return dataclasses.replace(self, data=self.data * jnp.asarray(scalar, self.data.dtype))

    def diagonal(self) -> jax.Array:
        """Extract the main diagonal (dense) — basis of Jacobi-type solvers."""
        on_diag = (self.row_ids == self.indices.astype(self.row_ids.dtype)) & (
            self.row_ids.astype(jnp.int32) < self.n_rows)
        d = jnp.zeros((self.n_rows,), self.data.dtype)
        return d.at[jnp.where(on_diag, self.row_ids, self.n_rows)].add(
            jnp.where(on_diag, self.data, 0), mode="drop")

    def prune(self, keep_zeros: bool = True) -> "CSR":
        """Host-side compaction (drop tail padding / stored zeros)."""
        return self.to_coo().prune(keep_zeros=keep_zeros).to_csr()

    # -- row access (API parity with iter_row/get_row semantics) ------------
    def get_row_dense(self, i) -> jax.Array:
        """Row i as a dense vector (≈ to_string_row's dense rendering,
        src/sparsematrix.rs:284-301)."""
        start = self.indptr[i]
        nnz = self.indptr[i + 1] - start
        k = jnp.arange(self.nse)
        in_row = (k >= start) & (k < start + nnz)
        out = jnp.zeros((self.n_cols,), self.data.dtype)
        return out.at[jnp.where(in_row, self.indices, self.n_cols)].add(
            jnp.where(in_row, self.data, 0), mode="drop")

    def get_row(self, i):
        """Row i as a SparseVec (≈ SparseMatrix::get_row,
        src/sparsematrix.rs:272-280).  Host-side."""
        from ..vectors import SparseVec

        start = int(self.indptr[i])
        end = int(self.indptr[i + 1])
        return SparseVec(
            indices=np.asarray(self.indices[start:end]),
            vals=np.asarray(self.data[start:end]),
            dim=self.n_cols)

    def iter_row(self, i: int):
        """(col, val) pairs of row i, column-sorted (canonical order — the
        reference's CRS yields chain/insertion order instead,
        src/sparsemat_crs.rs:102-110; sorted order is this library's
        canonical contract).  Out-of-range rows yield nothing, matching the
        reference's empty-iterator behavior (src/sparsemat_crs.rs:107-109).
        Host-side convenience."""
        if i < 0 or i >= self.n_rows:
            return
        indptr = self.host("indptr")
        indices = self.host("indices")
        data = self.host("data")
        for p in range(int(indptr[i]), int(indptr[i + 1])):
            yield int(indices[p]), data[p]

    # -- column view (≈ ColumnIter, src/sparsemat_crs.rs:175-191) ------------
    def assemble_column_info(self) -> "CSR":
        """Build the cached column view (host-side CSC structure).  Must be
        called before ``iter_col`` — the same explicit-assembly contract as
        the reference (src/sparsematrix.rs:344-352: ``iter_col`` errors with
        "use assemble_column_info()" when stale).  CSR is immutable, so the
        view never goes stale once built.  Returns self for chaining."""
        if getattr(self, "_col_info", None) is None:
            indptr = self.host("indptr").astype(np.int64)
            indices = self.host("indices").astype(np.int64)
            data = self.host("data")
            nnz = int(indptr[-1])
            rows = np.repeat(np.arange(self.n_rows, dtype=np.int64),
                             np.diff(indptr))
            order = np.lexsort((rows, indices[:nnz]))
            col_ptr = np.concatenate(
                [[0], np.cumsum(np.bincount(indices[:nnz],
                                            minlength=self.n_cols))])
            object.__setattr__(self, "_col_info",
                               (col_ptr, rows[order], data[:nnz][order]))
        return self

    def iter_col(self, j: int):
        """(row, val) pairs of column j in ascending row order.  Raises
        unless ``assemble_column_info`` was called (≈ the Err path of
        src/sparsemat_indexlist.rs:86-96 / src/sparsematrix.rs:344-352)."""
        info = getattr(self, "_col_info", None)
        if info is None:
            raise RuntimeError(
                "column info is stale — call assemble_column_info() first")
        col_ptr, rows, vals = info
        if j < 0 or j >= self.n_cols:
            return
        for p in range(int(col_ptr[j]), int(col_ptr[j + 1])):
            yield int(rows[p]), vals[p]
