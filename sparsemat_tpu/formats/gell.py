"""GELL — gather-ELL ladder: a scatter-free SpMV layout for rows of any
degree distribution, including *globally scattered* matrices.

On an H100 (80GB HBM3, 400 W limit) it is the fastest scattered SpMV the
library has: 169 Gnnz/s
on the fem_217k surrogate and 39.8 on scircuit_171k, ahead of ELL, SELL,
the CSR stream's gather + scatter-add and the window layouts (PERF.md).
It is also the deep-occupancy spill carrier of SlabPack (``overflow``).

GELL arranges the SpMV so that NO scatter ever happens:

* **level 0** is a plain ELL rectangle over ALL rows with a small K chosen
  by a slot-cost model (covers the bulk of a power-law matrix cheaply);
* rows with more than K entries continue into **level ℓ+1**: an ELL over
  only those rows, *compacted*; its result re-joins the output via
  ``y += y_level[inv_map]`` — a GATHER by the static inverse row map
  (destination-enumerated), never a scatter;
* the ladder recurses until every entry is placed (≤ ``MAX_LEVELS``; the
  last level takes K = max remaining count).

Replaces the reference's serial row loop (reference:
src/sparsematrix.rs:146-158) for matrices with no band structure.
Pure XLA: per level one gather of x and one (n, K) FMA + row sum.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import SparseFormat, array_field, register_format, static_field
from .ell import ELL

#: recursion bound; the final level takes K = max remaining row count
MAX_LEVELS = 8
#: estimated slots one deferred entry costs in later levels (drives the
#: per-level K choice: minimize n_level*K + deferred*COST)
_DEFER_SLOT_COST = 3.0


@register_format
@dataclasses.dataclass(frozen=True)
class GELL(SparseFormat):
    """Frozen gather-ELL ladder.

    ``levels[0]`` covers all rows; ``levels[i>0]`` covers the compacted
    continuation rows, and ``inv_maps[i-1]`` is the (n_rows,) int32 map
    from global row to that level's local row (== level n_rows_local for
    rows absent from the level → gather fill 0).  ``level_rows[i-1]`` is
    the (n_local,) global row per local row (for to_coo)."""

    levels: Tuple[ELL, ...] = array_field()
    inv_maps: Tuple[jax.Array, ...] = array_field()
    level_rows: Tuple[jax.Array, ...] = array_field()
    shape: Tuple[int, int] = static_field()

    @classmethod
    def from_csr(cls, csr, k0: int | None = None) -> "GELL":
        """Host-side freeze.  ``k0`` pins level-0's K (default: cost model)."""
        n_rows, n_cols = csr.shape
        indptr = csr.host("indptr").astype(np.int64)
        indices = csr.host("indices").astype(np.int32)
        data = csr.host("data")

        levels, inv_maps, level_rows = [], [], []
        rows_l = np.arange(n_rows, dtype=np.int64)   # global row per local
        consumed = np.zeros(n_rows, np.int64)
        counts = np.diff(indptr)
        for lvl in range(MAX_LEVELS):
            rem = counts[rows_l] - consumed[rows_l]
            if rows_l.size == 0:
                break
            rmax = int(rem.max(initial=0))
            if rmax == 0 and lvl > 0:
                break
            if lvl == 0 and k0 is not None:
                k = int(k0)
            elif lvl == MAX_LEVELS - 1:
                k = max(rmax, 1)
            else:
                cands = [1 << p for p in range(0, 14) if (1 << p) <= 2 * rmax]
                best_k, best_cost = max(rmax, 1), float("inf")
                for kc in cands:
                    deferred = np.maximum(rem - kc, 0).sum()
                    cost = rows_l.size * kc + deferred * _DEFER_SLOT_COST
                    if cost < best_cost:
                        best_k, best_cost = kc, cost
                k = best_k
            take = np.minimum(rem, k)
            n_l = rows_l.size
            j = np.arange(k, dtype=np.int64)
            src = (indptr[rows_l] + consumed[rows_l])[:, None] + j[None, :]
            valid = j[None, :] < take[:, None]
            src = np.where(valid, src, 0)
            cols_l = np.where(valid, indices[src], 0).astype(np.int32)
            vals_l = np.where(valid, data[src], 0)
            pad_r = -(-n_l // ELL.ROW_PAD) * ELL.ROW_PAD - n_l
            if pad_r:
                cols_l = np.concatenate(
                    [cols_l, np.zeros((pad_r, k), np.int32)])
                vals_l = np.concatenate(
                    [vals_l, np.zeros((pad_r, k), vals_l.dtype)])
                take_p = np.concatenate([take, np.zeros(pad_r, np.int64)])
            else:
                take_p = take
            ell = ELL(cols=jnp.asarray(cols_l), vals=jnp.asarray(vals_l),
                      row_nnz=jnp.asarray(take_p.astype(np.int32)),
                      shape=(n_l, n_cols))
            levels.append(ell)
            if lvl > 0:
                inv = np.full(n_rows, n_l, np.int32)
                inv[rows_l] = np.arange(n_l, dtype=np.int32)
                inv_maps.append(jnp.asarray(inv))
                level_rows.append(jnp.asarray(rows_l.astype(np.int32)))
            consumed[rows_l] += take
            cont = rem > k
            rows_l = rows_l[cont]
        return cls(levels=tuple(levels), inv_maps=tuple(inv_maps),
                   level_rows=tuple(level_rows), shape=(n_rows, n_cols))

    # -- canonical views ------------------------------------------------------
    def to_coo(self):
        from .coo import COO

        n_rows = self.shape[0]
        rs, cs, vs = [], [], []
        for i, lvl in enumerate(self.levels):
            pc = lvl.to_coo()
            if i == 0:
                rows = jnp.where(pc.rows < n_rows, pc.rows, n_rows)
            else:
                lr = self.level_rows[i - 1]
                ok = pc.rows < lr.shape[0]
                rows = jnp.where(
                    ok, lr[jnp.clip(pc.rows, 0, lr.shape[0] - 1)], n_rows)
            rs.append(rows.astype(jnp.int32))
            cs.append(pc.cols)
            vs.append(jnp.where(rows < n_rows, pc.vals, 0))
        return COO(rows=jnp.concatenate(rs), cols=jnp.concatenate(cs),
                   vals=jnp.concatenate(vs), shape=self.shape,
                   canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    def to_gell(self) -> "GELL":
        return self

    # -- structure --------------------------------------------------------------
    @property
    def nse(self) -> int:
        return sum(l.nse for l in self.levels)

    @property
    def index_dtype(self):
        return jnp.dtype(jnp.int32)

    @property
    def data(self):
        return self.levels[0].vals

    @property
    def n_levels(self) -> int:
        return len(self.levels)

    def n_non_zero_entries(self):
        n = self.levels[0].n_non_zero_entries()
        for i, lvl in enumerate(self.levels[1:]):
            n = n + jnp.sum(lvl.row_nnz[: self.level_rows[i].shape[0]]
                            ).astype(jnp.int32)
        return n

    def scale(self, scalar) -> "GELL":
        return dataclasses.replace(
            self, levels=tuple(l.scale(scalar) for l in self.levels))

    def astype(self, dtype) -> "GELL":
        return dataclasses.replace(
            self, levels=tuple(l.astype(dtype) for l in self.levels))

    def fill_ratio(self) -> float:
        n = int(np.asarray(self.n_non_zero_entries()))
        return n / max(self.nse, 1)

    def spmv_traffic_bytes(self) -> int:
        """Layout speed-of-light HBM bytes for one SpMV: every level's
        slot arrays + the continuation maps, x read once, y written once."""
        from ..types import accum_dtype

        total = 0
        for lvl in self.levels:
            total += lvl.cols.size * 4 + lvl.vals.size * lvl.vals.dtype.itemsize
        for inv in self.inv_maps:
            total += inv.size * 4
        total += self.shape[1] * jnp.dtype(self.dtype).itemsize
        total += self.shape[0] * jnp.dtype(accum_dtype(self.dtype)).itemsize
        return int(total)
