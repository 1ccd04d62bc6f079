"""StripELL — strip-packed slabs: height-granularity-1 window packing.

The scattered-regime successor to SlabPack (formats/slab.py) for matrices
with BOUNDED column span (FEM/banded classes).  Replaces the serial row
loop of the reference (src/sparsematrix.rs:146-158) in the same regime
SlabPack covers, at ~half the memory traffic.

Why: SlabPack's window buckets quantize per-(block, window) heights to the
8-sublane granularity that ``take_along_axis`` demands, while a pwtk-class
FEM matrix averages only ~1.75 entries per (row, window) — measured fill
0.13, 83 B/nnz, and its SpMV kernel already runs at 106% of that layout's
speed of light (r4), so the LAYOUT is the whole remaining cost.  StripELL
packs at height granularity 1:

* a **strip** is one (128-lane) slot row: level ``l`` of window ``w`` in a
  128-row block — lane r holds the l-th entry (column order) of row r in
  window w, or padding;
* strips of ALL the block's windows concatenate into one (c_total, 128)
  tile (8-sublane padding happens once per BLOCK, not once per window);
* the per-strip window indices live in a separate (c_total,) side array
  (``wrel``, relative to a per-group base window ``wtile``·32), so the
  SpMV (kernels/strip.py) gathers x at (wtile·32 + wrel)·128 + lidx.

Blocks are classed by strip count (SlabPack-style histogram split) so
per-class ``c_total`` padding stays small.  The layout was built for a
128-lane window-gather unit; on the H100 its SpMV lost to GELL and ELL on
the fem surrogate (PERF.md), so it is off the automatic path.

Constraint: every block group's windows must fit one 128-window span
starting at a 32-window stride (max span 96 windows = 12,288 columns).
``from_csr`` raises ``ValueError`` beyond that.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import SparseFormat, array_field, register_format, static_field

RB = 128          # rows per block == lane count
WINDOW = 128      # columns per window == take_along lane span
TILE_STRIDE = 32  # x^T tiles start every 32 windows
SUBLANE = 8


@register_format
@dataclasses.dataclass(frozen=True)
class StripPart(SparseFormat):
    """One homogeneous class of a StripELL: groups of ``g4`` CONSECUTIVE
    blocks sharing one xᵀ tile per group and one class-wide c_total.

    Grouping is the per-grid-step overhead lever (CLAUDE.md: ~300-500 ns
    per step): a step processes a whole group against a single tile DMA.
    Consecutive blocks of a banded/FEM matrix shift by ~1 window per
    block, so a group's union span still fits one 128-window tile."""

    vals: jax.Array = array_field()    # (nb, c_total, 128) values
    #: (nb, c_total // lidx_pack, 128) col-in-window indices, ``lidx_pack``
    #: strips byte-packed per int32 word (strip s lives in byte s // (c/p)
    #: of word row s %% (c/p)) — col-in-window is 7 bits, so packing cuts
    #: the index stream 4x; the kernel unpacks with two vector ops per
    #: chunk (shift + mask), far cheaper than the HBM bytes saved
    lidx: jax.Array = array_field()
    #: (nb, cg, 128) window per strip, RELATIVE to the GROUP's x^T tile
    #: (cg = ceil(c_total/128); tail padded with 0)
    wrel: jax.Array = array_field()
    wtile: jax.Array = array_field()   # (nb // g4,) x^T tile id per group
    #: (nb, c_total, 128) bool stored-entry mask (distinguishes explicit
    #: zeros from strip padding; not read by the SpMV kernel)
    occ: jax.Array = array_field()
    block_ids: Tuple[int, ...] = static_field()  # original block index per row
    shape: Tuple[int, int] = static_field()
    g4: int = static_field(default=1)  # blocks per group (grid step)
    lidx_pack: int = static_field(default=1)  # strips per lidx word

    @property
    def c_total(self) -> int:
        return int(self.vals.shape[1])

    @property
    def n_blocks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def data(self):
        return self.vals

    @property
    def index_dtype(self):
        return jnp.dtype(jnp.int32)

    def n_non_zero_entries(self):
        return jnp.sum(self.occ).astype(jnp.int32)

    def scale(self, scalar) -> "StripPart":
        return dataclasses.replace(
            self, vals=self.vals * jnp.asarray(scalar, self.vals.dtype))

    def lidx_unpacked(self) -> jax.Array:
        """(nb, c_total, 128) int32 col-in-window (unpacks ``lidx``)."""
        if self.lidx_pack == 1:
            return self.lidx.astype(jnp.int32)
        parts = [(self.lidx >> (8 * k)) & 0xFF
                 for k in range(self.lidx_pack)]
        return jnp.concatenate(parts, axis=1)[:, : self.c_total]

    def abs_windows(self) -> jax.Array:
        """(nb, c_total) absolute window id per strip."""
        nb, c, _ = self.vals.shape
        wr = self.wrel.reshape(nb, -1)[:, :c].astype(jnp.int32)
        wt_blk = jnp.repeat(self.wtile.astype(jnp.int32), self.g4)[:nb]
        return wt_blk[:, None] * TILE_STRIDE + wr

    def to_coo(self):
        from .coo import COO

        nb, c, rb = self.vals.shape
        n_rows = self.shape[0]
        cols = (self.abs_windows()[:, :, None] * WINDOW
                + self.lidx_unpacked())
        rows = (jnp.asarray(np.asarray(self.block_ids, np.int64)
                            .astype(np.int32))[:, None, None] * RB
                + jnp.arange(rb, dtype=jnp.int32)[None, None, :])
        rows = jnp.broadcast_to(rows, self.vals.shape).reshape(-1)
        stored = self.occ.reshape(-1)
        return COO(rows=jnp.where(stored, rows, n_rows),
                   cols=jnp.where(stored, cols.reshape(-1), 0),
                   vals=jnp.where(stored, self.vals.reshape(-1), 0),
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()


@register_format
@dataclasses.dataclass(frozen=True)
class StripELL(SparseFormat):
    """Strip-packed window format: class parts + static recombination."""

    parts: Tuple[StripPart, ...] = array_field()
    shape: Tuple[int, int] = static_field()

    @classmethod
    def from_csr(cls, csr, n_classes: int = 32,
                 group: int = 16, lidx_pack: int = 4) -> "StripELL":
        """``group`` consecutive blocks share one xᵀ tile and one grid
        step (per-step overhead amortized; consecutive blocks of a banded
        operand shift ~1 window/block so the union span still fits a
        tile).  Classes are histograms over GROUPS, keyed by the group's
        max per-block strip count.  ``lidx_pack`` strips share each lidx
        int32 word (7-bit col-in-window → byte-packed, 4× less index
        traffic)."""
        n_rows, n_cols = csr.shape
        indptr = csr.host("indptr").astype(np.int64)
        indices = csr.host("indices").astype(np.int64)
        data = csr.host("data")
        nnz = int(indptr[-1])
        n_rb = max(-(-n_rows // RB), 1)
        group = int(np.clip(group, 1, n_rb))
        n_grp = -(-n_rb // group)
        n_rbp = n_grp * group             # blocks incl. trailing group pad
        if nnz == 0:
            part = _empty_part((n_rows, n_cols), tuple(range(n_rb)),
                               data.dtype)
            return cls(parts=(part,), shape=(n_rows, n_cols))

        rows = np.repeat(np.arange(n_rows, dtype=np.int64),
                         np.diff(indptr))[:nnz]
        cols = indices[:nnz]
        vals = data[:nnz]
        blk = rows // RB
        lane = rows % RB
        win = cols // WINDOW
        n_win = max(-(-n_cols // WINDOW), 1)

        # per-GROUP x^T tile base; every window of the group must fit the
        # 128-window tile starting at TILE_STRIDE * wtile
        egrp = blk // group
        wmin = np.full(n_grp, np.iinfo(np.int64).max)
        wmax = np.full(n_grp, -1, np.int64)
        np.minimum.at(wmin, egrp, win)
        np.maximum.at(wmax, egrp, win)
        has = wmax >= 0
        wmin[~has] = 0
        wmax[~has] = 0
        # clamp to the LAST tile of the padded x — tiles overlap (stride
        # 32, width 128), so high-wmin groups are covered by the final
        # tile; an unclamped wmin//stride would point past the end of x
        n_tiles = max(-(-max(n_win - (WINDOW - TILE_STRIDE), 0)
                        // TILE_STRIDE), 0) + 1
        wtile_g = np.minimum(wmin // TILE_STRIDE, n_tiles - 1)
        span = wmax - wtile_g * TILE_STRIDE
        if int(span.max(initial=0)) >= 128:
            raise ValueError(
                f"StripELL needs every {group}-block group's column span "
                f"within one 128-window tile (max relative window "
                f"{int(span.max())} >= 128) — use SlabPack/RouteStream "
                "for wide-scatter matrices, or a smaller ``group``")

        # level = rank of the entry within its (blk, win, lane) group,
        # in column order (CSR is column-sorted per row already)
        key = (blk * n_win + win) * RB + lane
        order = np.argsort(key, kind="stable")
        ks = key[order]
        newgrp = np.concatenate([[True], ks[1:] != ks[:-1]])
        gid = np.cumsum(newgrp) - 1
        first_of_grp = np.flatnonzero(newgrp)
        level = np.arange(nnz) - first_of_grp[gid]

        # strip id within block: strips ordered by (win, level)
        bw = ks // RB                        # blk * n_win + win, sorted
        sb = bw // n_win                     # block of each sorted entry
        sw = bw % n_win
        skey = (sb * n_win + sw) * 64 + np.minimum(level, 63)
        uniq, sidx = np.unique(skey, return_inverse=True)
        s_blk = uniq // (n_win * 64)
        # strip index within its block (uniq is sorted → grouped by block)
        s_first = np.searchsorted(s_blk, np.arange(n_rb))
        strip_in_blk = np.arange(uniq.size) - s_first[s_blk]
        n_strips = np.bincount(s_blk.astype(np.int64),
                               minlength=n_rbp).astype(np.int64)
        if int(level.max(initial=0)) > 63:
            raise ValueError("StripELL: >64 entries in one (row, window)")

        # class split over GROUPS by the group's max per-block strip count
        strips_g = n_strips.reshape(n_grp, group).max(axis=1)
        n_classes = int(np.clip(n_classes, 1, n_grp))
        order_g = np.argsort(strips_g, kind="stable")
        chunks = [np.sort(ch) for ch in np.array_split(order_g, n_classes)
                  if ch.size]
        parts = []
        pos_of_blk = np.zeros(n_rbp, np.int64)
        cls_of_blk = np.zeros(n_rbp, np.int64)
        for ci, ch in enumerate(chunks):
            blocks = (ch[:, None] * group + np.arange(group)).ravel()
            pos_of_blk[blocks] = np.arange(blocks.size)
            cls_of_blk[blocks] = ci

        ent_cls = cls_of_blk[sb]
        ent_pos = pos_of_blk[sb]
        lidx_pack = int(lidx_pack)
        if lidx_pack not in (1, 2, 4):
            raise ValueError("lidx_pack must be 1, 2 or 4")
        quant = SUBLANE * lidx_pack
        for ci, ch in enumerate(chunks):
            blocks = (ch[:, None] * group + np.arange(group)).ravel()
            c_total = int(-(-max(int(strips_g[ch].max(initial=0)), 1)
                            // quant) * quant)
            cg = -(-c_total // WINDOW)
            nb = blocks.size
            vals_t = np.zeros((nb, c_total, RB), data.dtype)
            lidx_t = np.zeros((nb, c_total, RB), np.int32)
            occ_t = np.zeros((nb, c_total, RB), bool)
            wrel_t = np.zeros((nb, cg * WINDOW), np.int32)
            sel = ent_cls == ci
            so = order[sel]
            spos = strip_in_blk[sidx[sel]]
            epos = ent_pos[sel]
            elane = lane[so]
            vals_t[epos, spos, elane] = vals[so]
            lidx_t[epos, spos, elane] = (cols[so] % WINDOW).astype(np.int32)
            occ_t[epos, spos, elane] = True
            # per-strip relative window (vs the strip's GROUP tile)
            ssel = (cls_of_blk[s_blk] == ci)
            sp = strip_in_blk[ssel]
            sbp = pos_of_blk[s_blk[ssel]]
            wrel_t[sbp, sp] = ((uniq[ssel] // 64) % n_win
                               - wtile_g[s_blk[ssel] // group] * TILE_STRIDE
                               ).astype(np.int32)
            if lidx_pack > 1:
                cp = c_total // lidx_pack
                packed = lidx_t[:, 0:cp].copy()
                for k in range(1, lidx_pack):
                    packed |= lidx_t[:, k * cp:(k + 1) * cp] << (8 * k)
                lidx_out = packed
            else:
                lidx_out = lidx_t
            parts.append(StripPart(
                vals=jnp.asarray(vals_t), lidx=jnp.asarray(lidx_out),
                wrel=jnp.asarray(wrel_t.reshape(nb, cg, WINDOW)),
                wtile=jnp.asarray(wtile_g[ch].astype(np.int32)),
                occ=jnp.asarray(occ_t),
                block_ids=tuple(int(b) for b in blocks),
                shape=(n_rows, n_cols), g4=group, lidx_pack=lidx_pack))
        return cls(parts=tuple(parts), shape=(n_rows, n_cols))

    # -- canonical views ------------------------------------------------------
    def to_coo(self):
        from .coo import COO

        coos = [p.to_coo() for p in self.parts]
        return COO(rows=jnp.concatenate([c.rows for c in coos]),
                   cols=jnp.concatenate([c.cols for c in coos]),
                   vals=jnp.concatenate([c.vals for c in coos]),
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    # -- structure ------------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(sum(np.prod(p.vals.shape) for p in self.parts))

    @property
    def index_dtype(self):
        return jnp.dtype(jnp.int32)

    @property
    def dtype(self):
        return self.parts[0].vals.dtype

    @property
    def data(self):
        return self.parts[0].vals

    def n_non_zero_entries(self):
        return sum(p.n_non_zero_entries() for p in self.parts)

    def scale(self, scalar) -> "StripELL":
        return dataclasses.replace(
            self, parts=tuple(p.scale(scalar) for p in self.parts))

    def fill_ratio(self) -> float:
        n = int(np.asarray(self.n_non_zero_entries()))
        return n / max(self.nse, 1)

    def spmv_traffic_bytes(self) -> int:
        """Layout speed-of-light bytes per SpMV: every array the SpMV reads
        once (vals+lidx+wrel+wtile), x read once, y written once."""
        from ..types import accum_dtype

        total = 0
        for p in self.parts:
            total += p.vals.size * jnp.dtype(p.vals.dtype).itemsize
            total += p.lidx.size * jnp.dtype(p.lidx.dtype).itemsize
            total += p.wrel.size * 4 + p.wtile.size * 4
        xb = self.shape[1] * jnp.dtype(self.dtype).itemsize
        total += xb
        total += self.shape[0] * jnp.dtype(accum_dtype(self.dtype)).itemsize
        return int(total)


def _empty_part(shape, block_ids, dtype):
    nb = len(block_ids)
    return StripPart(vals=jnp.zeros((nb, SUBLANE, RB), dtype),
                     lidx=jnp.zeros((nb, SUBLANE, RB), jnp.int32),
                     wrel=jnp.zeros((nb, 1, WINDOW), jnp.int32),
                     wtile=jnp.zeros((nb,), jnp.int32),
                     occ=jnp.zeros((nb, SUBLANE, RB), bool),
                     block_ids=tuple(block_ids), shape=shape)
