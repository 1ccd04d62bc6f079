"""SELL-C-σ (sliced ELLPACK) — padding-efficient layout for skewed rows.

No reference counterpart (the reference has a single serial SpMV loop,
src/sparsematrix.rs:146-158).  ELL pads every row to the global max nnz/row;
for power-law matrices that wastes HBM bandwidth.  SELL-C-σ sorts rows by
nnz within windows of σ rows, groups them into slices of C rows, and pads
only to each slice's own max — the classic SIMD sparse layout (C = 8).

Storage is the *flattened slot stream* (slot_rows / slot_cols / slot_vals)
ordered slice-major, with ``slice_offsets`` marking the slices; the SpMV
treats it as padded COO (padding slots: row = n_rows, col = 0, val = 0).
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
class SELL(SparseFormat):
    slot_rows: jax.Array = array_field()   # (n_slots,) original row id; pad = n_rows
    slot_cols: jax.Array = array_field()   # (n_slots,) column id; pad = 0
    slot_vals: jax.Array = array_field()   # (n_slots,) value; pad = 0
    slice_offsets: jax.Array = array_field()  # (n_slices+1,) slot offset per slice
    shape: Tuple[int, int] = static_field()
    slice_height: int = static_field()

    @classmethod
    def from_csr(cls, csr, slice_height: int = 8, sigma: int | None = None) -> "SELL":
        """Host-side freeze.  ``sigma`` = row-sorting window (defaults to the
        whole matrix, i.e. SELL-C-∞; use a smaller window to keep row
        locality for cache-friendly x gathers)."""
        c = int(slice_height)
        n_rows, n_cols = csr.shape
        indptr = csr.host("indptr")
        indices = csr.host("indices")
        data = csr.host("data")
        nnz_per_row = indptr[1:] - indptr[:-1]

        sigma = n_rows if sigma is None else int(sigma)
        order = np.arange(n_rows)
        for w0 in range(0, n_rows, max(sigma, 1)):
            w1 = min(w0 + sigma, n_rows)
            seg = order[w0:w1]
            order[w0:w1] = seg[np.argsort(-nnz_per_row[seg], kind="stable")]

        n_slices = -(-n_rows // c) if n_rows else 0
        srows, scols, svals, offs = [], [], [], [0]
        for s in range(n_slices):
            rows = order[s * c : (s + 1) * c]
            k = int(nnz_per_row[rows].max(initial=0))
            # slice stored row-major: C rows × k slots
            block_r = np.full((c, k), n_rows, dtype=np.int32)
            block_c = np.zeros((c, k), dtype=np.int32)
            block_v = np.zeros((c, k), dtype=data.dtype)
            for li, r in enumerate(rows):
                n = int(nnz_per_row[r])
                block_r[li, :n] = r
                block_c[li, :n] = indices[indptr[r] : indptr[r] + n]
                block_v[li, :n] = data[indptr[r] : indptr[r] + n]
            srows.append(block_r.reshape(-1))
            scols.append(block_c.reshape(-1))
            svals.append(block_v.reshape(-1))
            offs.append(offs[-1] + c * k)
        cat = lambda xs, dt: (np.concatenate(xs) if xs else np.array([], dt))
        return cls(
            slot_rows=jnp.asarray(cat(srows, np.int32)),
            slot_cols=jnp.asarray(cat(scols, np.int32)),
            slot_vals=jnp.asarray(cat(svals, data.dtype)),
            slice_offsets=jnp.asarray(np.array(offs, np.int32)),
            shape=(n_rows, n_cols),
            slice_height=c,
        )

    # -- canonical views ----------------------------------------------------
    def to_coo(self):
        from .coo import COO

        return COO(rows=self.slot_rows, cols=self.slot_cols, vals=self.slot_vals,
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    def to_ell(self, n_cols_per_row: int | None = None):
        from .ell import ELL

        return ELL.from_csr(self.to_csr(), n_cols_per_row=n_cols_per_row)

    # -- structure ----------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(self.slot_rows.shape[0])

    @property
    def index_dtype(self):
        return self.slot_cols.dtype

    @property
    def data(self):
        return self.slot_vals

    def n_non_zero_entries(self):
        return jnp.sum(self.slot_rows.astype(jnp.int32) < self.n_rows)

    def scale(self, scalar) -> "SELL":
        return dataclasses.replace(
            self, slot_vals=self.slot_vals * jnp.asarray(scalar, self.slot_vals.dtype))

    def padding_ratio(self) -> float:
        """Fraction of slots that are padding (host-side diagnostics)."""
        n = int(np.asarray(self.n_non_zero_entries()))
        return 1.0 - n / max(self.nse, 1)
