"""SlabELL — slab-windowed, window-bucketed ELL for *scattered* rows with
bounded column span (the SuiteSparse/FEM regime — BASELINE.md pwtk/cant).

Each 128·k-row block's entries are regrouped by the 128-column window they
fall in (*window buckets*); bucket heights are static (global max per
window, rounded to 8 rows), so padding replaces masking:

* ``vals``/``lidx`` are (n_rb, C, RB) with the row block on the last axis;
* ``win_lo[block]`` is the first x window of the block's slab of S
  windows; slot (c, r) of bucket w reads x[(win_lo + w)·128 + lidx].

The layout was built for a 128-lane window-gather unit; its SpMV here is
the per-slot gather of ``kernels/spmv.py``.  Traffic per SpMV ≈ C/K × ELL
bytes (the bucket-padding inflation, typically 1.5-3× for banded
scatter).  SlabPack and SlabStream below cut that padding.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import SparseFormat, array_field, register_format, static_field

SLAB_ROW_BLOCK = 256
WINDOW = 128
SUBLANE = 8
#: padded slots one spilled entry costs in the exact slab refreeze of the
#: overflow (measured ~67 on FEM-class spills).  A slab slot streams at
#: ~0.011 ns (8 B at HBM rate), so 67 slots/entry ≈ 0.7 ns/entry — 10×
#: cheaper at runtime than any per-element XLA path (~7.5 ns/element).
_SPILL_SLOT_COST = 67


@register_format
@dataclasses.dataclass(frozen=True)
class SlabELL(SparseFormat):
    """Frozen slab-windowed matrix (host-built).

    ``vals``/``lidx``: (n_rb, C, RB) transposed tiles — the C axis is the
    concatenation of S window buckets whose static (offset, height) ranges
    are ``buckets``; ``lidx`` is the column within the bucket's window
    (0..127, padding slots 0 with val 0); ``win_lo``: (n_rb,) first window
    of each block's slab; ``bucket_cnt``: (n_rb, S, RB) stored-entry count
    per (block, window, lane-row) — entries fill a bucket's ranks
    consecutively, so rank < count ⟺ stored.  Preserves explicitly-stored
    zeros on round-trip (≈ ``get_mut`` zero-insert contract,
    src/sparsematrix.rs:112-114); may be None for ad-hoc constructions
    (e.g. DistSlab shards — falls back to ``val != 0``).
    """

    _spmv_read_fields = ("vals", "lidx", "win_lo")  # bucket_cnt: round-trip only

    vals: jax.Array = array_field()
    lidx: jax.Array = array_field()
    win_lo: jax.Array = array_field()
    bucket_cnt: jax.Array | None = array_field()
    shape: Tuple[int, int] = static_field()
    #: ((offset, height), ...) per slab window — offsets into the C axis
    buckets: Tuple[Tuple[int, int], ...] = static_field()

    @classmethod
    def from_csr(cls, csr, rb: int = SLAB_ROW_BLOCK) -> "SlabELL":
        """Host-side freeze.  ``rb`` must be a multiple of 128 (the tile
        lane width).  Columns within each row must be (and are, for
        canonical CSR) sorted, so a row's slots per window are consecutive."""
        if rb % WINDOW:
            raise ValueError(f"rb must be a multiple of {WINDOW}, got {rb}")
        n_rows, n_cols = csr.shape
        indptr = csr.host("indptr").astype(np.int64)
        indices = csr.host("indices").astype(np.int64)
        data = csr.host("data")
        nnz = int(indptr[-1])
        n_rb = max(-(-n_rows // rb), 1)

        if nnz == 0:
            return cls(vals=jnp.zeros((n_rb, SUBLANE, rb), data.dtype),
                       lidx=jnp.zeros((n_rb, SUBLANE, rb), jnp.int32),
                       win_lo=jnp.zeros((n_rb,), jnp.int32),
                       bucket_cnt=jnp.zeros((n_rb, 1, rb), jnp.int32),
                       shape=(n_rows, n_cols),
                       buckets=((0, SUBLANE),))

        counts = np.diff(indptr)
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), counts)
        blk = rows // rb
        lrow = (rows % rb).astype(np.int64)
        win = indices // WINDOW

        # slab base per block over REAL entries
        lo = np.full(n_rb, np.iinfo(np.int64).max)
        np.minimum.at(lo, blk, win)
        hi = np.zeros(n_rb, np.int64)
        np.maximum.at(hi, blk, win)
        lo[lo == np.iinfo(np.int64).max] = 0
        s = int((hi - lo).max(initial=0)) + 1

        w_rel = win - lo[blk]                      # slab window ∈ [0, S)
        # rank of each entry within its (row, window) group: rows are
        # column-sorted, so groups are consecutive runs
        boundary = np.empty(nnz, bool)
        boundary[0] = True
        boundary[1:] = (rows[1:] != rows[:-1]) | (w_rel[1:] != w_rel[:-1])
        idx = np.arange(nnz, dtype=np.int64)
        run_start = idx[boundary]
        rank = idx - run_start[np.cumsum(boundary) - 1]

        # static bucket heights: global max rank per slab window, 8-rounded
        heights = np.zeros(s, np.int64)
        np.maximum.at(heights, w_rel, rank + 1)
        heights = -(-heights // SUBLANE) * SUBLANE
        heights = np.maximum(heights, SUBLANE)
        offs = np.concatenate([[0], np.cumsum(heights)])
        c_total = int(offs[-1])

        vals_t = np.zeros((n_rb, c_total, rb), data.dtype)
        lidx_t = np.zeros((n_rb, c_total, rb), np.int32)
        cpos = offs[w_rel] + rank
        vals_t[blk, cpos, lrow] = data[:nnz]
        lidx_t[blk, cpos, lrow] = (indices % WINDOW).astype(np.int32)
        cnt = np.zeros((n_rb, s, rb), np.int32)
        np.add.at(cnt, (blk, w_rel, lrow), 1)
        buckets = tuple((int(offs[w]), int(heights[w])) for w in range(s))
        return cls(vals=jnp.asarray(vals_t), lidx=jnp.asarray(lidx_t),
                   win_lo=jnp.asarray(lo.astype(np.int32)),
                   bucket_cnt=jnp.asarray(cnt),
                   shape=(n_rows, n_cols), buckets=buckets)

    # -- canonical views ------------------------------------------------------
    def _window_of_cpos(self) -> np.ndarray:
        """Static (C,) slab-window id per C-axis position."""
        w_of = np.zeros(self.c_total, np.int32)
        for w, (o, h) in enumerate(self.buckets):
            w_of[o : o + h] = w
        return w_of

    def to_coo(self):
        from .coo import COO

        n_rb, c, rb = self.vals.shape
        n_rows = self.shape[0]
        w_of = jnp.asarray(self._window_of_cpos())
        cols = (self.lidx.astype(jnp.int32)
                + (self.win_lo[:, None, None] + w_of[None, :, None]) * WINDOW)
        rows = (jnp.arange(n_rb, dtype=jnp.int32)[:, None, None] * rb
                + jnp.arange(rb, dtype=jnp.int32)[None, None, :])
        rows = jnp.broadcast_to(rows, self.vals.shape).reshape(-1)
        cols = cols.reshape(-1)
        vals = self.vals.reshape(-1)
        stored = self._stored_mask().reshape(-1)
        return COO(rows=jnp.where(stored, rows, n_rows),
                   cols=jnp.where(stored, cols, 0),
                   vals=jnp.where(stored, vals, 0),
                   shape=self.shape, canonical=False)

    def _stored_mask(self) -> jax.Array:
        """(n_rb, C, RB) bool: slot holds a stored entry (incl. explicit
        zeros) vs bucket padding."""
        if self.bucket_cnt is None:
            return self.vals != 0
        w_of = self._window_of_cpos()                      # (C,) static
        offs = np.array([o for o, _ in self.buckets], np.int32)
        rank_c = jnp.asarray(np.arange(self.c_total, dtype=np.int32)
                             - offs[w_of])                 # rank within bucket
        cnt_c = self.bucket_cnt[:, jnp.asarray(w_of), :]   # (n_rb, C, RB)
        return rank_c[None, :, None] < cnt_c

    def to_csr(self):
        return self.to_coo().to_csr()

    # -- structure --------------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(np.prod(self.vals.shape))

    @property
    def row_block(self) -> int:
        return int(self.vals.shape[2])

    @property
    def n_row_blocks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def c_total(self) -> int:
        return int(self.vals.shape[1])

    @property
    def slab_windows(self) -> int:
        return len(self.buckets)

    @property
    def index_dtype(self):
        return jnp.dtype(jnp.int32)

    @property
    def data(self):
        return self.vals

    def n_non_zero_entries(self):
        if self.bucket_cnt is not None:
            return jnp.sum(self.bucket_cnt).astype(jnp.int32)
        return jnp.sum(self.vals != 0).astype(jnp.int32)

    def scale(self, scalar) -> "SlabELL":
        return dataclasses.replace(
            self, vals=self.vals * jnp.asarray(scalar, self.vals.dtype))

    def fill_ratio(self) -> float:
        n = int(np.asarray(self.n_non_zero_entries()))
        return n / max(self.nse, 1)

    def x_windows(self) -> int:
        """Windows of the operand vector incl. slab overrun slack."""
        return -(-self.shape[1] // WINDOW) + self.slab_windows


# --- SlabPack: per-block-class bucket heights ---------------------------------

@register_format
@dataclasses.dataclass(frozen=True)
class SlabPack(SparseFormat):
    """SlabELL with *per-block-class* bucket heights (round-2 verdict #6).

    The plain SlabELL pads every block's window buckets to the GLOBAL max
    height — one dense-ish block inflates the whole matrix (measured 9.4×
    traffic on a pwtk-class FEM surrogate).  SlabPack instead groups the
    row blocks into ``n_classes`` classes by their exact (8-rounded)
    per-window height profiles; each class becomes a homogeneous
    :class:`SlabELL` part padded only to the CLASS max.  SpMV runs once
    per part and recombines the block rows by a static permutation (a
    block-granular gather — 1 KB rows, negligible).

    Bucket heights additionally carry a *spill budget*: the height of a
    (class, window) bucket is the smallest 8-multiple that keeps at least
    ``1 - spill_frac`` of its entries; the spilled tail (entries whose
    within-(row, window) rank exceeds the height — the deep-occupancy
    outliers that would otherwise set the lane-direction max) is refrozen
    exactly (spill_frac=0) into a small recursive ``overflow`` pack whose
    SpMV result is added back.  On Poisson-occupancy FEM matrices this
    halves the padded slot count again on top of the class split.

    ``parts[i]`` covers global row blocks ``block_ids[i]`` (ascending);
    every global block appears in exactly one part.  Successor of the same
    serial row loop as SlabELL (reference: src/sparsematrix.rs:146-158).
    """

    parts: Tuple[SlabELL, ...] = array_field()
    #: per-part tuple of global row-block ids (static, ascending)
    block_ids: Tuple[Tuple[int, ...], ...] = static_field()
    shape: Tuple[int, int] = static_field()
    row_block: int = static_field()
    #: deep-occupancy outlier entries as a GELL gather ladder (or None)
    overflow: object = dataclasses.field(
        default=None, metadata={"pytree_node": True})

    @classmethod
    def from_csr(cls, csr, rb: int = SLAB_ROW_BLOCK,
                 n_classes: int = 8, spill_frac: float = 0.02) -> "SlabPack":
        """Host-side freeze with per-block-class bucket heights.

        Blocks are keyed by their exact padded slot count (sum of 8-rounded
        per-window heights), sorted, and split into ``n_classes``
        equal-count classes; class heights are the per-window max over
        members, lowered to the 8-multiple minimizing padded-slots +
        spill-cost (``spill_frac > 0`` enables spilling; the spilled tail
        goes to ``overflow``).  Zero-height windows (no entries anywhere in
        the class) cost nothing — the kernel skips them."""
        if rb % WINDOW:
            raise ValueError(f"rb must be a multiple of {WINDOW}, got {rb}")
        n_rows, n_cols = csr.shape
        indptr = csr.host("indptr").astype(np.int64)
        indices = csr.host("indices").astype(np.int64)
        data = csr.host("data")
        nnz = int(indptr[-1])
        n_rb = max(-(-n_rows // rb), 1)

        if nnz == 0:
            part = SlabELL(vals=jnp.zeros((n_rb, SUBLANE, rb), data.dtype),
                           lidx=jnp.zeros((n_rb, SUBLANE, rb), jnp.int32),
                           win_lo=jnp.zeros((n_rb,), jnp.int32),
                           bucket_cnt=jnp.zeros((n_rb, 1, rb), jnp.int32),
                           shape=(n_rb * rb, n_cols),
                           buckets=((0, SUBLANE),))
            return cls(parts=(part,), block_ids=(tuple(range(n_rb)),),
                       shape=(n_rows, n_cols), row_block=rb)

        counts = np.diff(indptr)
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), counts)
        blk = rows // rb
        lrow = (rows % rb).astype(np.int64)
        win = indices // WINDOW

        # slab base per block over REAL entries
        lo = np.full(n_rb, np.iinfo(np.int64).max)
        np.minimum.at(lo, blk, win)
        hi = np.zeros(n_rb, np.int64)
        np.maximum.at(hi, blk, win)
        empty = lo == np.iinfo(np.int64).max
        lo[empty] = 0
        hi[empty] = 0
        span = hi - lo + 1
        s_max = int(span.max(initial=1))

        w_rel = win - lo[blk]                      # slab window ∈ [0, span_b)
        # rank of each entry within its (row, window) group (rows are
        # column-sorted, so groups are consecutive runs)
        boundary = np.empty(nnz, bool)
        boundary[0] = True
        boundary[1:] = (rows[1:] != rows[:-1]) | (w_rel[1:] != w_rel[:-1])
        idx = np.arange(nnz, dtype=np.int64)
        run_start = idx[boundary]
        rank = idx - run_start[np.cumsum(boundary) - 1]

        # exact per-(block, window) heights, 8-rounded; 0 where empty
        H = np.zeros((n_rb, s_max), np.int64)
        np.maximum.at(H, (blk, w_rel), rank + 1)
        H8 = -(-H // SUBLANE) * SUBLANE
        c_exact = H8.sum(axis=1)                   # per-block padded slots

        # class partition: sort blocks by slot count, equal-count chunks
        n_classes = int(np.clip(n_classes, 1, n_rb))
        order = np.argsort(c_exact, kind="stable")
        chunks = [np.sort(ch) for ch in np.array_split(order, n_classes)
                  if ch.size]

        # pre-bucket the entries by block for fast per-class selection
        eorder = np.argsort(blk, kind="stable")
        blk_sorted = blk[eorder]
        blk_starts = np.searchsorted(blk_sorted, np.arange(n_rb + 1))

        parts, ids, spills = [], [], []
        for members in chunks:
            sel = np.concatenate(
                [eorder[blk_starts[b]:blk_starts[b + 1]] for b in members]
            ) if members.size else np.zeros(0, np.int64)
            Hc = H8[members].max(axis=0) if members.size else np.zeros(1, np.int64)
            s_c = max(int(np.nonzero(Hc)[0].max(initial=0)) + 1, 1)
            heights = Hc[:s_c].copy()
            nb_c = len(members)
            if spill_frac > 0 and sel.size:
                # lower each window's height to the 8-multiple minimizing
                # total cost: padded slots kept + spilled entries at their
                # (estimated) refreeze slot cost.  Deep-occupancy outliers
                # and near-empty windows both spill; the bulk stays padded.
                ew_all = w_rel[sel]
                rmax = int(rank[sel].max(initial=0))
                hist = np.zeros((s_c, rmax + 2), np.int64)
                np.add.at(hist, (ew_all, rank[sel]), 1)
                above = hist[:, ::-1].cumsum(axis=1)[:, ::-1]  # (s_c, r) = #rank>=r
                cand = np.arange(0, -(-(rmax + 1) // SUBLANE) * SUBLANE + 1,
                                 SUBLANE)
                cand_sp = above[:, np.minimum(cand, rmax + 1)]  # spilled at h
                cost = cand[None, :] * (nb_c * rb) + cand_sp * _SPILL_SLOT_COST
                pick = cand[np.argmin(cost, axis=1)]
                heights = np.minimum(heights, pick)
                spill_e = sel[rank[sel] >= heights[ew_all]]
                if spill_e.size:
                    spills.append(spill_e)
                    sel = sel[rank[sel] < heights[ew_all]]
            if heights.sum() == 0:
                heights = np.array([SUBLANE], np.int64)
                s_c = 1
            else:
                s_c = max(int(np.nonzero(heights)[0].max(initial=0)) + 1, 1)
                heights = heights[:s_c]
            offs = np.concatenate([[0], np.cumsum(heights)])
            c_total = int(offs[-1])
            nb_c = len(members)
            lb_of = np.full(n_rb, -1, np.int64)
            lb_of[members] = np.arange(nb_c)

            vals_t = np.zeros((nb_c, c_total, rb), data.dtype)
            lidx_t = np.zeros((nb_c, c_total, rb), np.int32)
            cnt = np.zeros((nb_c, s_c, rb), np.int32)
            if sel.size:
                eb = lb_of[blk[sel]]
                ew = w_rel[sel]
                cpos = offs[ew] + rank[sel]
                vals_t[eb, cpos, lrow[sel]] = data[sel]
                lidx_t[eb, cpos, lrow[sel]] = (indices[sel] % WINDOW).astype(np.int32)
                np.add.at(cnt, (eb, ew, lrow[sel]), 1)
            buckets = tuple((int(offs[w]), int(heights[w])) for w in range(s_c))
            parts.append(SlabELL(
                vals=jnp.asarray(vals_t), lidx=jnp.asarray(lidx_t),
                win_lo=jnp.asarray(lo[members].astype(np.int32)),
                bucket_cnt=jnp.asarray(cnt),
                shape=(nb_c * rb, n_cols), buckets=buckets))
            ids.append(tuple(int(b) for b in members))

        overflow = None
        if spills:
            # refreeze the spilled tail exactly (no further spilling) with
            # narrow 128-lane row blocks — spills are lane-sparse, and a
            # padded slab stream still beats every per-element XLA path
            sp = np.concatenate(spills)
            overflow = cls._freeze_entries(
                rows[sp], indices[sp], data[sp], (n_rows, n_cols))
        return cls(parts=tuple(parts), block_ids=tuple(ids),
                   shape=(n_rows, n_cols), row_block=rb, overflow=overflow)

    @classmethod
    def _freeze_entries(cls, erows, ecols, evals, shape):
        """Exact (spill_frac=0) refreeze of loose triplets via a host CSR."""
        from .csr import CSR

        order = np.lexsort((ecols, erows))
        erows, ecols, evals = erows[order], ecols[order], evals[order]
        indptr = np.zeros(shape[0] + 1, np.int64)
        np.add.at(indptr, erows + 1, 1)
        indptr = np.cumsum(indptr)
        csr = CSR.from_arrays(indptr.astype(np.int32),
                              ecols.astype(np.int32), evals, shape)
        return cls.from_csr(csr, rb=WINDOW, n_classes=16, spill_frac=0.0)


    # -- canonical views ------------------------------------------------------
    def to_coo(self):
        from .coo import COO

        rb = self.row_block
        n_rows = self.shape[0]
        rs, cs, vs = [], [], []
        for part, ids in zip(self.parts, self.block_ids):
            pc = part.to_coo()
            ids_arr = jnp.asarray(np.asarray(ids, np.int64))
            valid = pc.rows < part.shape[0]
            gb = jnp.clip(pc.rows // rb, 0, len(ids) - 1)
            gr = ids_arr[gb] * rb + pc.rows % rb
            ok = valid & (gr < n_rows)
            rs.append(jnp.where(ok, gr, n_rows).astype(jnp.int32))
            cs.append(jnp.where(ok, pc.cols, 0))
            vs.append(jnp.where(ok, pc.vals, 0))
        if self.overflow is not None:
            oc = self.overflow.to_coo()
            rs.append(oc.rows.astype(jnp.int32))
            cs.append(oc.cols)
            vs.append(oc.vals)
        return COO(rows=jnp.concatenate(rs), cols=jnp.concatenate(cs),
                   vals=jnp.concatenate(vs), shape=self.shape,
                   canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    # -- structure --------------------------------------------------------------
    @property
    def nse(self) -> int:
        n = sum(p.nse for p in self.parts)
        return n + (self.overflow.nse if self.overflow is not None else 0)

    @property
    def index_dtype(self):
        return jnp.dtype(jnp.int32)

    @property
    def data(self):
        return self.parts[0].vals

    @property
    def n_row_blocks(self) -> int:
        return sum(len(ids) for ids in self.block_ids)

    def n_non_zero_entries(self):
        n = sum(p.n_non_zero_entries() for p in self.parts)
        if self.overflow is not None:
            n = n + self.overflow.n_non_zero_entries()
        return n

    def scale(self, scalar) -> "SlabPack":
        return dataclasses.replace(
            self, parts=tuple(p.scale(scalar) for p in self.parts),
            overflow=(self.overflow.scale(scalar)
                      if self.overflow is not None else None))

    def astype(self, dtype) -> "SlabPack":
        return dataclasses.replace(
            self, parts=tuple(p.astype(dtype) for p in self.parts),
            overflow=(self.overflow.astype(dtype)
                      if self.overflow is not None else None))

    def fill_ratio(self) -> float:
        n = int(np.asarray(self.n_non_zero_entries()))
        return n / max(self.nse, 1)

    def spmv_traffic_bytes(self) -> int:
        """Layout speed-of-light bytes: every part's streamed arrays once,
        plus one x read and one y write (parts share the operand)."""
        from ..types import accum_dtype

        total = 0
        for p in self.parts:
            for name in p._spmv_read_fields:
                arr = getattr(p, name)
                total += arr.size * jnp.dtype(arr.dtype).itemsize
        if self.overflow is not None:
            adt = accum_dtype(self.dtype)
            total += (self.overflow.spmv_traffic_bytes()
                      - self.shape[1] * jnp.dtype(self.dtype).itemsize
                      - self.shape[0] * jnp.dtype(adt).itemsize)
        total += self.shape[1] * jnp.dtype(self.dtype).itemsize
        total += self.shape[0] * jnp.dtype(accum_dtype(self.dtype)).itemsize
        return int(total)


# --- SlabStream: flat chunk stream with per-(block, window)-exact heights ----

@register_format
@dataclasses.dataclass(frozen=True)
class SlabStream(SparseFormat):
    """Slab layout as ONE flat stream of (8-row × RB-lane) chunks.

    SlabELL pads window buckets to the global max height and SlabPack to a
    class max; both leave real padding on mixed-occupancy FEM matrices
    (measured 14.2× / 10.4× traffic inflation on a pwtk-class surrogate at
    full scale).  SlabStream stores each (row-block, x-window) bucket at
    its EXACT 8-rounded height: buckets are split into 8-sublane chunks and
    all chunks concatenate into one (N, 8, RB) stream; two index arrays
    route each chunk to its x window and its output block, and the SpMV
    scatter-adds each chunk's sums into its block.  No classes, no
    recombination gather.

    Successor of the same serial row loop as SlabELL (reference:
    src/sparsematrix.rs:146-158).

    ``vals``/``lidx``: (N, 8, RB); ``win_id``/``blk_id``: (N,) int32
    (absolute x-window / output block per chunk); ``cnt8``: (N, RB) int32 —
    stored entries per (chunk, lane), rank-within-chunk < cnt8 ⟺ stored
    (preserves explicitly-stored zeros, ≈ get_mut zero-insert,
    src/sparsematrix.rs:112-114).
    """

    _spmv_read_fields = ("vals", "lidx", "win_id", "blk_id")

    vals: jax.Array = array_field()
    lidx: jax.Array = array_field()
    win_id: jax.Array = array_field()
    blk_id: jax.Array = array_field()
    cnt8: jax.Array = array_field()
    shape: Tuple[int, int] = static_field()
    row_block: int = static_field()

    @classmethod
    def from_csr(cls, csr, rb: int = SLAB_ROW_BLOCK) -> "SlabStream":
        if rb % WINDOW:
            raise ValueError(f"rb must be a multiple of {WINDOW}, got {rb}")
        n_rows, n_cols = csr.shape
        indptr = csr.host("indptr").astype(np.int64)
        indices = csr.host("indices").astype(np.int64)
        data = csr.host("data")
        nnz = int(indptr[-1])
        n_rb = max(-(-n_rows // rb), 1)
        n_win = max(-(-n_cols // WINDOW), 1)

        if nnz == 0:
            return cls(vals=jnp.zeros((1, SUBLANE, rb), data.dtype),
                       lidx=jnp.zeros((1, SUBLANE, rb), jnp.int32),
                       win_id=jnp.zeros((1,), jnp.int32),
                       blk_id=jnp.zeros((1,), jnp.int32),
                       cnt8=jnp.zeros((1, rb), jnp.int32),
                       shape=(n_rows, n_cols), row_block=rb)

        counts = np.diff(indptr)
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), counts)
        blk = rows // rb
        lrow = (rows % rb).astype(np.int64)
        win = indices // WINDOW

        # rank of each entry within its (row, window) group (rows are
        # column-sorted → groups are consecutive runs)
        boundary = np.empty(nnz, bool)
        boundary[0] = True
        boundary[1:] = (rows[1:] != rows[:-1]) | (win[1:] != win[:-1])
        idx = np.arange(nnz, dtype=np.int64)
        run_start = idx[boundary]
        rank = idx - run_start[np.cumsum(boundary) - 1]

        # (block, window) buckets at exact 8-rounded heights → chunk stream
        key = blk * n_win + win
        ukey, key_inv = np.unique(key, return_inverse=True)
        hmax = np.zeros(ukey.shape[0], np.int64)
        np.maximum.at(hmax, key_inv, rank + 1)
        n_chunks_per = -(-hmax // SUBLANE)
        chunk_start = np.concatenate([[0], np.cumsum(n_chunks_per)])
        n_chunks = int(chunk_start[-1])

        vals_t = np.zeros((n_chunks, SUBLANE, rb), data.dtype)
        lidx_t = np.zeros((n_chunks, SUBLANE, rb), np.int32)
        ch = chunk_start[key_inv] + rank // SUBLANE
        sub = rank % SUBLANE
        vals_t[ch, sub, lrow] = data[:nnz]
        lidx_t[ch, sub, lrow] = (indices % WINDOW).astype(np.int32)

        # per-(bucket, lane) counts → per-chunk clipped counts
        kcnt = np.zeros((ukey.shape[0], rb), np.int64)
        np.add.at(kcnt, (key_inv, lrow), 1)
        key_of_chunk = np.repeat(np.arange(ukey.shape[0]), n_chunks_per)
        cl = np.arange(n_chunks) - chunk_start[key_of_chunk]
        cnt8 = np.clip(kcnt[key_of_chunk] - SUBLANE * cl[:, None], 0,
                       SUBLANE).astype(np.int32)

        return cls(vals=jnp.asarray(vals_t), lidx=jnp.asarray(lidx_t),
                   win_id=jnp.asarray((ukey % n_win)[key_of_chunk]
                                      .astype(np.int32)),
                   blk_id=jnp.asarray((ukey // n_win)[key_of_chunk]
                                      .astype(np.int32)),
                   cnt8=jnp.asarray(cnt8),
                   shape=(n_rows, n_cols), row_block=rb)

    # -- canonical views ------------------------------------------------------
    def to_coo(self):
        from .coo import COO

        n_rows = self.shape[0]
        n, _, rb = self.vals.shape
        sub = jnp.arange(SUBLANE, dtype=jnp.int32)
        lane = jnp.arange(rb, dtype=jnp.int32)
        stored = sub[None, :, None] < self.cnt8[:, None, :]
        rows = (self.blk_id[:, None, None] * rb + lane[None, None, :])
        rows = jnp.broadcast_to(rows, self.vals.shape)
        cols = (self.win_id[:, None, None] * WINDOW
                + self.lidx.astype(jnp.int32))
        ok = stored & (rows < n_rows)
        return COO(rows=jnp.where(ok, rows, n_rows).reshape(-1),
                   cols=jnp.where(ok, cols, 0).reshape(-1),
                   vals=jnp.where(ok, self.vals, 0).reshape(-1),
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    # -- structure --------------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(np.prod(self.vals.shape))

    @property
    def n_chunks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def n_row_blocks(self) -> int:
        return max(-(-self.shape[0] // self.row_block), 1)

    @property
    def index_dtype(self):
        return jnp.dtype(jnp.int32)

    @property
    def data(self):
        return self.vals

    def n_non_zero_entries(self):
        return jnp.sum(self.cnt8).astype(jnp.int32)

    def scale(self, scalar) -> "SlabStream":
        return dataclasses.replace(
            self, vals=self.vals * jnp.asarray(scalar, self.vals.dtype))

    def fill_ratio(self) -> float:
        n = int(np.asarray(self.n_non_zero_entries()))
        return n / max(self.nse, 1)

    def x_windows(self) -> int:
        return max(-(-self.shape[1] // WINDOW), 1)
