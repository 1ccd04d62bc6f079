"""DIA (diagonal) format — gather-free SpMV for banded/stencil matrices.

No reference counterpart (the reference's one SpMV is a serial row loop,
src/sparsematrix.rs:146-158).  Banded matrices — tridiagonal systems, 2D/3D
Poisson stencils, the BASELINE bench configs 1/3/5 — store one value per
(diagonal, row).  SpMV becomes

    y[i] = Σ_d  data[d, i] · x[i + offset_d]

which is a handful of *shifted dense reads* and FMAs: no index arrays, no
gather, no scatter — one streaming pass over the diagonals.
This is the format the dispatch layer auto-selects when a frozen matrix is
(mostly) diagonal-structured.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import accum_dtype
from .base import SparseFormat, array_field, register_format, static_field


@register_format
@dataclasses.dataclass(frozen=True)
class DIA(SparseFormat):
    """Frozen diagonal-format matrix.

    ``offsets``: static tuple of diagonal offsets (col - row);
    ``data``: (n_diags, n_rows) — ``data[d, i] = A[i, i + offsets[d]]``
    (slots outside the matrix are 0).
    """

    _spmv_read_fields = ("data",)  # offsets are static metadata

    data: jax.Array = array_field()
    offsets: Tuple[int, ...] = static_field()
    shape: Tuple[int, int] = static_field()

    @classmethod
    def from_csr(cls, csr) -> "DIA":
        """Host-side freeze.  Every distinct (col-row) offset becomes a
        diagonal — use ``diagonal_count`` first to check suitability."""
        n_rows, n_cols = csr.shape
        rows = csr.host("row_ids")
        cols = csr.host("indices")
        vals = csr.host("data")
        valid = rows < n_rows
        rows, cols, vals = rows[valid], cols[valid], vals[valid]
        offs = np.unique(cols.astype(np.int64) - rows.astype(np.int64))
        data = np.zeros((len(offs), n_rows), vals.dtype)
        d_idx = np.searchsorted(offs, cols.astype(np.int64) - rows)
        data[d_idx, rows] = vals
        return cls(data=jnp.asarray(data), offsets=tuple(int(o) for o in offs),
                   shape=csr.shape)

    @staticmethod
    def diagonal_count(csr) -> int:
        """Number of distinct nonzero diagonals (host-side dispatch metric)."""
        rows = csr.host("row_ids")
        cols = csr.host("indices")
        valid = rows < csr.shape[0]
        return int(np.unique(cols[valid].astype(np.int64)
                             - rows[valid].astype(np.int64)).size)

    # -- canonical views ----------------------------------------------------
    def to_coo(self):
        from .coo import COO

        n_rows, n_cols = self.shape
        nd = len(self.offsets)
        i = jnp.broadcast_to(jnp.arange(n_rows, dtype=jnp.int32)[None, :],
                             (nd, n_rows))
        off = jnp.asarray(self.offsets, jnp.int32)[:, None]
        j = i + off
        in_range = (j >= 0) & (j < n_cols)
        # structural zeros in data are padding (DIA can't distinguish a
        # stored zero from absence — like scipy.sparse.dia_matrix)
        stored = in_range & (self.data != 0)
        rows = jnp.where(stored, i, n_rows).reshape(-1)
        cols = jnp.where(stored, j, 0).reshape(-1)
        vals = jnp.where(stored, self.data, 0).reshape(-1)
        return COO(rows=rows, cols=cols, vals=vals, shape=self.shape,
                   canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    # -- structure ----------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(self.data.shape[0] * self.data.shape[1])

    @property
    def index_dtype(self):
        return jnp.dtype(jnp.int32)

    def n_non_zero_entries(self):
        return jnp.sum(self.data != 0).astype(jnp.int32)

    def scale(self, scalar) -> "DIA":
        s = jnp.asarray(scalar, self.data.dtype)
        return dataclasses.replace(self, data=self.data * s)

    def diagonal(self) -> jax.Array:
        if 0 in self.offsets:
            return self.data[self.offsets.index(0)]
        return jnp.zeros((self.n_rows,), self.data.dtype)


def _pad_extents(dia: DIA):
    n_rows, n_cols = dia.shape
    lo = max(0, -min(dia.offsets)) if dia.offsets else 0
    hi = max(0, max(dia.offsets) + n_rows - n_cols) if dia.offsets else 0
    return lo, hi


def dia_spmv(dia: DIA, x: jax.Array) -> jax.Array:
    """y = A @ x as Σ_d data[d] · x_pad[d+L : d+L+n]  — *static* shifted
    slices of a zero-padded x, so XLA fuses all diagonals into one output
    pass (no scatter, no per-diagonal intermediate).  data is zero outside
    the valid band, so no masking is needed."""
    n_rows, n_cols = dia.shape
    adt = accum_dtype(jnp.result_type(dia.data.dtype, x.dtype))
    L, R = _pad_extents(dia)
    xp = jnp.pad(x.astype(adt), (L, R))
    y = jnp.zeros((n_rows,), adt)
    for d, off in enumerate(dia.offsets):
        start = off + L
        y = y + dia.data[d].astype(adt) * jax.lax.slice_in_dim(xp, start, start + n_rows)
    return y


def dia_spmm(dia: DIA, B: jax.Array) -> jax.Array:
    """Y = A @ B for dense B — same padded-static-slice formulation."""
    n_rows, n_cols = dia.shape
    adt = accum_dtype(jnp.result_type(dia.data.dtype, B.dtype))
    L, R = _pad_extents(dia)
    Bp = jnp.pad(B.astype(adt), ((L, R), (0, 0)))
    y = jnp.zeros((n_rows, B.shape[1]), adt)
    for d, off in enumerate(dia.offsets):
        start = off + L
        y = y + dia.data[d].astype(adt)[:, None] * jax.lax.slice_in_dim(
            Bp, start, start + n_rows, axis=0)
    return y
