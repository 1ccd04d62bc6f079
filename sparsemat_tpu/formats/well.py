"""WELL — windowed ELLPACK for general matrices.

No reference counterpart (the reference's SpMV is a serial pointer-chase,
src/sparsematrix.rs:146-158).  WELL groups the matrix so every x access is
a gather within one 128-wide column window:

* rows are grouped in blocks of 8;
* each row's entries are partitioned by 128-wide *column windows*;
* each (row-block, window) pair with entries becomes a tile holding up to K
  entries per row: ``vals``/``lidx`` of shape (8, K), lidx = column within
  the window;
* tiles are sorted by (row-block, window); ``tile_rows`` and ``tile_wins``
  name each tile's output block and x window.

SpMV (``kernels/spmv.py``): gather each tile's x window by lidx, FMA
against vals, sum into the 8-row output block.  HBM traffic ≈ tile data +
one x window per tile.  The layout was built for a 128-lane window-gather
unit; it is off the automatic path on the H100.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import SparseFormat, array_field, register_format, static_field

ROW_BLOCK = 8
WINDOW = 128

@register_format
@dataclasses.dataclass(frozen=True)
class WELL(SparseFormat):
    """Windowed-ELL sparse matrix (frozen, host-built).

    ``vals``: (n_tiles, 8, K) values (padding 0);
    ``lidx``: (n_tiles, 8, K) column-within-window ids (padding 0);
    ``tile_rows``: (n_tiles,) row-block id per tile (sorted ascending);
    ``tile_wins``: (n_tiles,) window id per tile;
    ``row_cnt``: (n_tiles, 8) stored-entry count per tile row — slots fill
    consecutively, so slot < count ⟺ stored.  Keeps explicitly-stored zeros
    distinguishable from padding on round-trip (the reference's ``get_mut``
    inserts and counts zero entries, src/sparsematrix.rs:112-114).  May be
    None for ad-hoc constructions (falls back to ``val != 0``).
    """

    _spmv_read_fields = ("vals", "lidx", "tile_rows", "tile_wins")  # row_cnt: round-trip only

    vals: jax.Array = array_field()
    lidx: jax.Array = array_field()
    tile_rows: jax.Array = array_field()
    tile_wins: jax.Array = array_field()
    row_cnt: jax.Array | None = array_field()
    shape: Tuple[int, int] = static_field()

    @classmethod
    def from_csr(cls, csr, k_tile: int | None = None) -> "WELL":
        """Host-side freeze from CSR.  ``k_tile`` caps entries per (row,
        window); rows denser than that in one window get split across
        duplicate tiles (accumulated by the kernel)."""
        n_rows, n_cols = csr.shape
        indptr = csr.host("indptr").astype(np.int64)
        indices = csr.host("indices").astype(np.int64)
        data = csr.host("data")
        nnz = int(indptr[-1])
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))
        rb = rows[:nnz] // ROW_BLOCK
        win = indices[:nnz] // WINDOW
        lane = (indices[:nnz] % WINDOW).astype(np.int32)
        lrow = (rows[:nnz] % ROW_BLOCK).astype(np.int32)
        vals = data[:nnz]

        # order by (row-block, window, local row) — tile grouping key
        order = np.lexsort((lrow, win, rb))
        rb, win, lane, lrow, vals = rb[order], win[order], lane[order], lrow[order], vals[order]
        key = rb * (int(n_cols) // WINDOW + 2) + win
        tile_start = np.ones(nnz, bool)
        tile_start[1:] = key[1:] != key[:-1]
        tile_id_raw = np.cumsum(tile_start) - 1

        # slot within (tile, local row)
        rkey = key * ROW_BLOCK + lrow
        new_run = np.ones(nnz, bool)
        new_run[1:] = rkey[1:] != rkey[:-1]
        run_starts = np.flatnonzero(new_run)
        slot = np.arange(nnz) - np.repeat(run_starts, np.diff(
            np.append(run_starts, nnz)))

        kmax = int(slot.max(initial=-1)) + 1 if nnz else 1
        if k_tile is None:
            k_tile = min(max(kmax, 1), WINDOW)
        # overflow entries (slot >= k_tile) go to duplicate overflow tiles
        level = slot // k_tile
        slot_in = slot % k_tile
        n_levels = int(level.max(initial=0)) + 1
        # final tile identity = (tile_id_raw, level); re-sort so duplicates
        # of a row block remain consecutive
        order2 = np.lexsort((slot_in, level, tile_id_raw))
        rb2, win2, lane2, lrow2, vals2 = (rb[order2], win[order2], lane[order2],
                                          lrow[order2], vals[order2])
        tkey = tile_id_raw[order2] * n_levels + level[order2]
        tstart = np.ones(nnz, bool)
        tstart[1:] = tkey[1:] != tkey[:-1]
        tid = np.cumsum(tstart) - 1
        n_tiles = int(tid.max(initial=-1)) + 1 if nnz else 0
        # sort tiles by row-block (they already are: tile_id_raw ordered by rb)

        v_t = np.zeros((max(n_tiles, 1), ROW_BLOCK, k_tile), data.dtype)
        l_t = np.zeros((max(n_tiles, 1), ROW_BLOCK, k_tile), np.int32)
        v_t[tid, lrow2, slot_in[order2]] = vals2
        l_t[tid, lrow2, slot_in[order2]] = lane2
        c_t = np.zeros((max(n_tiles, 1), ROW_BLOCK), np.int32)
        np.add.at(c_t, (tid, lrow2), 1)
        t_rows = np.zeros(max(n_tiles, 1), np.int32)
        t_wins = np.zeros(max(n_tiles, 1), np.int32)
        t_rows[tid] = rb2.astype(np.int32)
        t_wins[tid] = win2.astype(np.int32)

        # every row block must be visited by ≥1 tile so the kernel zeroes its
        # output block — add all-zero dummy tiles for blocks with no entries
        n_rb = max(-(-n_rows // ROW_BLOCK), 1)
        present = np.zeros(n_rb, bool)
        if nnz:
            present[t_rows[: n_tiles]] = True
        else:
            n_tiles = 0
        missing = np.flatnonzero(~present).astype(np.int32)
        if missing.size:
            v_t = np.concatenate(
                [v_t[:n_tiles],
                 np.zeros((missing.size, ROW_BLOCK, k_tile), data.dtype)])
            l_t = np.concatenate(
                [l_t[:n_tiles],
                 np.zeros((missing.size, ROW_BLOCK, k_tile), np.int32)])
            c_t = np.concatenate(
                [c_t[:n_tiles], np.zeros((missing.size, ROW_BLOCK), np.int32)])
            t_rows = np.concatenate([t_rows[:n_tiles], missing])
            t_wins = np.concatenate([t_wins[:n_tiles],
                                     np.zeros(missing.size, np.int32)])
            order3 = np.argsort(t_rows, kind="stable")
            v_t, l_t, c_t, t_rows, t_wins = (v_t[order3], l_t[order3],
                                             c_t[order3], t_rows[order3],
                                             t_wins[order3])
        return cls(vals=jnp.asarray(v_t), lidx=jnp.asarray(l_t),
                   tile_rows=jnp.asarray(t_rows), tile_wins=jnp.asarray(t_wins),
                   row_cnt=jnp.asarray(c_t), shape=(n_rows, n_cols))

    # -- canonical views ----------------------------------------------------
    def to_coo(self):
        from .coo import COO

        n_tiles, rbk, k = self.vals.shape
        rows = (self.tile_rows[:, None, None] * ROW_BLOCK
                + jnp.arange(rbk, dtype=jnp.int32)[None, :, None])
        cols = self.tile_wins[:, None, None] * WINDOW + self.lidx
        rows = jnp.broadcast_to(rows, self.vals.shape).reshape(-1)
        cols = cols.reshape(-1)
        vals = self.vals.reshape(-1)
        # padding slots carry val 0 but real-looking coords; the occupancy
        # counts distinguish them from explicitly-stored zeros
        stored = self._stored_mask().reshape(-1)
        n_rows = self.shape[0]
        return COO(rows=jnp.where(stored, rows, n_rows),
                   cols=jnp.where(stored, cols, 0),
                   vals=jnp.where(stored, vals, 0),
                   shape=self.shape, canonical=False)

    def _stored_mask(self) -> jax.Array:
        """(n_tiles, 8, K) bool: slot holds a stored entry (incl. explicit
        zeros) vs padding."""
        if self.row_cnt is None:
            return self.vals != 0
        return (jnp.arange(self.k_tile, dtype=jnp.int32)[None, None, :]
                < self.row_cnt[:, :, None])

    def to_csr(self):
        return self.to_coo().to_csr()

    # -- structure ----------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(np.prod(self.vals.shape))

    @property
    def n_tiles(self) -> int:
        return int(self.vals.shape[0])

    @property
    def k_tile(self) -> int:
        return int(self.vals.shape[2])

    @property
    def index_dtype(self):
        return jnp.dtype(jnp.int32)

    @property
    def data(self):
        return self.vals

    def n_non_zero_entries(self):
        if self.row_cnt is not None:
            return jnp.sum(self.row_cnt).astype(jnp.int32)
        return jnp.sum(self.vals != 0).astype(jnp.int32)

    def scale(self, scalar) -> "WELL":
        return dataclasses.replace(self, vals=self.vals * jnp.asarray(scalar, self.vals.dtype))

    def fill_ratio(self) -> float:
        """Stored / padded slots (host-side dispatch metric)."""
        n = int(np.asarray(self.n_non_zero_entries()))
        return n / max(self.nse, 1)
