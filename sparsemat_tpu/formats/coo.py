"""COO (coordinate) format — the frozen snapshot of the assembly phase.

Successor of the reference's append-oriented ``SparseMatIndexList``
(reference: src/sparsemat_indexlist.rs:14-21 — flat columns/values arrays plus
a linked-list-in-arrays row index).  A pointer-chase index structure is
hostile to a vector machine, so the frozen COO stores three flat arrays and
derives all structure by sort/scan; incremental mutation lives in
``sparsemat_tpu.builder.SparseBuilder`` (host side) instead.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import DEFAULT_INDEX_DTYPE, check_index_dtype, check_value_dtype
from .base import (
    SparseFormat,
    array_field,
    dedup_sorted_coo,
    register_format,
    rows_to_indptr,
    sort_coo,
    static_field,
)


@register_format
@dataclasses.dataclass(frozen=True)
class COO(SparseFormat):
    """Frozen coordinate-format sparse matrix.

    ``rows``/``cols``/``vals`` are parallel 1-D arrays of static length
    ``nse``; entries with ``row == n_rows`` are tail padding (see
    formats/base.py).  ``canonical=True`` promises row-major column-sorted
    deduplicated order with padding at the tail.
    """

    rows: jax.Array = array_field()
    cols: jax.Array = array_field()
    vals: jax.Array = array_field()
    shape: Tuple[int, int] = static_field()
    canonical: bool = static_field()

    @classmethod
    def from_arrays(cls, rows, cols, vals, shape=None, *, index_dtype=DEFAULT_INDEX_DTYPE,
                    canonical=False):
        rows = jnp.asarray(rows)
        cols = jnp.asarray(cols)
        vals = jnp.asarray(vals)
        if not jnp.issubdtype(rows.dtype, jnp.integer):
            rows = rows.astype(index_dtype)
            cols = cols.astype(index_dtype)
        if shape is None:
            # grow-from-touched-coordinates semantics of the reference
            # (src/sparsemat_indexlist.rs:45-47): shape = (max row+1, max col+1)
            shape = (int(np.asarray(rows).max(initial=-1)) + 1,
                     int(np.asarray(cols).max(initial=-1)) + 1)
        return cls(rows=rows, cols=cols, vals=vals, shape=tuple(shape), canonical=canonical)

    @classmethod
    def from_dense(cls, mat, *, index_dtype=DEFAULT_INDEX_DTYPE):
        mat = np.asarray(mat)
        r, c = np.nonzero(mat)
        return cls.from_arrays(
            jnp.asarray(r, index_dtype), jnp.asarray(c, index_dtype),
            jnp.asarray(mat[r, c]), mat.shape, canonical=True)

    @classmethod
    def eye(cls, dim: int, *, dtype=jnp.float32, index_dtype=DEFAULT_INDEX_DTYPE):
        """Identity matrix (≈ SparseMatrix::eye, src/sparsematrix.rs:92-98)."""
        idx = jnp.arange(dim, dtype=index_dtype)
        return cls(rows=idx, cols=idx, vals=jnp.ones((dim,), dtype),
                   shape=(dim, dim), canonical=True)

    # -- canonical views ----------------------------------------------------
    def to_coo(self) -> "COO":
        return self

    def to_csr(self):
        from .csr import CSR

        return CSR.from_coo(self)

    def to_ell(self, n_cols_per_row: int | None = None):
        from .ell import ELL

        return ELL.from_coo(self, n_cols_per_row=n_cols_per_row)

    def sort(self) -> "COO":
        """Canonicalize: sort row-major/column-sorted and sum duplicates
        (batch equivalent of Sortable::sort, src/sparsematrix.rs:355-366)."""
        if self.canonical:
            return self
        r, c, v = sort_coo(self.rows, self.cols, self.vals, self.shape)
        r, c, v, _ = dedup_sorted_coo(r, c, v, self.shape)
        return COO(rows=r, cols=c, vals=v, shape=self.shape, canonical=True)

    # -- structure ----------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(self.rows.shape[0])

    @property
    def index_dtype(self):
        return self.rows.dtype

    @property
    def data(self):
        return self.vals

    def n_non_zero_entries(self):
        return jnp.sum(self.rows.astype(jnp.int32) < self.n_rows)

    def indptr(self):
        """Row offsets of the canonical order (requires canonical=True)."""
        return rows_to_indptr(self.rows, self.n_rows, self.index_dtype)

    def scale(self, scalar) -> "COO":
        return dataclasses.replace(self, vals=self.vals * jnp.asarray(scalar, self.vals.dtype))

    def prune(self, keep_zeros: bool = True) -> "COO":
        """Host-side compaction: drop tail padding (and optionally stored
        zeros, matching ``prod``'s nonzero-only output,
        src/sparsematrix.rs:204-206).  Not jittable."""
        r = np.asarray(self.rows)
        c = np.asarray(self.cols)
        v = np.asarray(self.vals)
        keep = r < self.n_rows
        if not keep_zeros:
            keep &= v != 0
        return COO(rows=jnp.asarray(r[keep]), cols=jnp.asarray(c[keep]),
                   vals=jnp.asarray(v[keep]), shape=self.shape, canonical=self.canonical)

    def with_padding_to(self, nse: int) -> "COO":
        """Pad structure arrays to a larger static size (capacity growth)."""
        extra = nse - self.nse
        if extra < 0:
            raise ValueError(f"cannot shrink from {self.nse} to {nse}; use prune()")
        if extra == 0:
            return self
        idt = self.index_dtype
        return COO(
            rows=jnp.concatenate([self.rows, jnp.full((extra,), self.n_rows, idt)]),
            cols=jnp.concatenate([self.cols, jnp.zeros((extra,), idt)]),
            vals=jnp.concatenate([self.vals, jnp.zeros((extra,), self.vals.dtype)]),
            shape=self.shape, canonical=self.canonical)
