"""RouteStream — statically-routed product stream for *globally scattered*
matrices (the scircuit regime, BASELINE config 4).

All routing is decided at FREEZE time.  Entries are sorted by column
window and packed into 128-entry *A-rows* (one x window per row); per
*supertile* (128 A-rows) a static 3-phase permutation (lane-gather →
transpose → lane-gather → transpose → lane-gather, Hall routing tables from
a vectorized Euler-halving edge coloring) lands every product on its
exclusive *staging* slot.  Staging is laid out so each 128-lane row holds
whole matrix-row segments of one output window; a per-region prefix sum
(one triangular matmul) and two static extractions give the row sums.

The layout was built for a 128-lane window-gather unit with no scatter.
Its SpMV here is the table replay in ``kernels/route.py`` — on an H100
100-400× slower than GELL (PERF.md) — so it is off the automatic path.
Replaces the reference's serial row loop (reference:
src/sparsematrix.rs:146-158) for matrices with no band/window structure.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import SparseFormat, array_field, register_format, static_field

LANE = 128
SUP_ROWS = 128          # A-rows per supertile (one (128,128) routing unit)
REG_ROWS = 128          # staging rows per region (one (128,128) reduce unit)


# --- freeze-time helpers -------------------------------------------------------

def _euler_color_128(inst: np.ndarray, src: np.ndarray, dst: np.ndarray,
                     bits: int = 7) -> np.ndarray:
    """Proper 128-edge-coloring of a batch of 128-regular bipartite
    multigraphs, fully vectorized.

    ``inst``/``src``/``dst``: per-edge instance id and endpoint rows
    (each (E,), every (inst, src) and (inst, dst) has degree exactly
    2**bits).  Returns per-edge colors in [0, 2**bits) such that within
    each instance no two edges at a common endpoint share a color.

    Method: recursive Euler halving.  At each level, pair consecutive
    same-(instance, color-prefix, endpoint) edges on both sides; the pair
    links form disjoint even cycles over edges; 2-coloring the cycles
    (orbit labels from scipy's C connected-components over the two-step
    permutation) splits every endpoint's degree exactly in half.
    log2(degree) levels yield the full coloring.
    """
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    e = src.shape[0]
    if e == 0:
        return np.zeros(0, np.int64)
    inst = inst.astype(np.int64)
    src32 = src.astype(np.int32)
    dst32 = dst.astype(np.int32)
    color = np.zeros(e, np.int32)
    indptr = np.arange(e + 1, dtype=np.int64)
    ones = np.ones(e, np.int8)
    for level in range(bits):
        # partner on each side: group by (inst, color, endpoint) with one
        # fused-key argsort; pair consecutive edges (group sizes are even —
        # degrees are 128 / 2^level)
        def partners(endpoint):
            key = (inst * (1 << level) + color) * 128 + endpoint
            order = np.argsort(key, kind="stable").astype(np.int32)
            p = np.empty(e, np.int32)
            a = order.reshape(-1, 2)
            p[a[:, 0]] = a[:, 1]
            p[a[:, 1]] = a[:, 0]
            return p

        sp = partners(src32)
        dp = partners(dst32)
        # two-step map g = sp∘dp partitions edges into even/odd orbits of
        # each cycle; dp links the two orbits of a cycle
        g = sp[dp]
        adj = csr_matrix((ones, g, indptr), shape=(e, e))
        _, orbit = connected_components(adj, directed=False)
        bit = orbit > orbit[dp]
        color = color * 2 + bit
    return color.astype(np.int64)


def _pack_rows_128(keys: np.ndarray):
    """Pack entries (sorted by ``keys``) into 128-lane rows, starting a new
    row whenever the key changes or the current row is full.  Returns
    (row_of_entry, lane_of_entry, n_rows)."""
    n = keys.shape[0]
    if n == 0:
        return (np.zeros(0, np.int64), np.zeros(0, np.int64), 0)
    new_key = np.empty(n, bool)
    new_key[0] = True
    new_key[1:] = keys[1:] != keys[:-1]
    gid = np.cumsum(new_key) - 1
    starts = np.nonzero(new_key)[0]
    within = np.arange(n) - starts[gid]
    rows_before = np.concatenate([[0], np.cumsum(-(-np.diff(
        np.concatenate([starts, [n]])) // LANE))])
    row = rows_before[gid] + within // LANE
    lane = within % LANE
    return row, lane, int(rows_before[-1])


@register_format
@dataclasses.dataclass(frozen=True)
class RouteStream(SparseFormat):
    """Frozen statically-routed product stream (host-built).

    Phase-A arrays (per A-row): ``a_vals``/``a_lidx`` (n_arows, 128) with
    ``a_win`` the x window per row; ``a_rows`` keeps the matrix row per
    slot (sentinel n_rows for padding) for canonical views only — the
    kernels never read it.

    Kernel-1 routing tables ``p1``/``m1``/``p2``/``p3``/``touch`` per
    (supertile, split) land each product on its ARRIVAL staging slot:
    supertile contributions are packed contiguously per region (the r4.0
    cut routed straight to the reduce layout, which scatters one supertile
    over ~8000 staging rows and exploded the split count/table bytes ~30×).
    Kernel-2 tables: ``q1``/``q2``/``q3`` re-permute each region from
    arrival order to the reduce layout (whole matrix-row segments per
    lane-row, one y window per row — dummy slots carry zeros, so no mask
    is needed); ``lpos``/``ppos``/``pmask``/``segmask``/``wrow`` drive the
    prefix-sum segment extraction.

    Preserves explicitly-stored zeros (slots are identity-mapped, values
    untouched — ≈ the get_mut zero-insert contract,
    src/sparsematrix.rs:112-114).
    """

    _spmv_read_fields = ("a_vals", "a_lidx", "a_win", "p1", "m1", "p2",
                         "p3", "touch", "q1", "q2", "q3", "lpos", "ppos",
                         "pmask", "segmask", "wrow")

    a_vals: jax.Array = array_field()
    a_lidx: jax.Array = array_field()
    a_win: jax.Array = array_field()
    a_rows: jax.Array = array_field()
    p1: jax.Array = array_field()
    m1: jax.Array = array_field()
    p2: jax.Array = array_field()
    p3: jax.Array = array_field()
    touch: jax.Array = array_field()
    q1: jax.Array = array_field()
    q2: jax.Array = array_field()
    q3: jax.Array = array_field()
    lpos: jax.Array = array_field()
    ppos: jax.Array = array_field()
    pmask: jax.Array = array_field()
    segmask: jax.Array = array_field()
    wrow: jax.Array = array_field()
    shape: Tuple[int, int] = static_field()

    @classmethod
    def from_csr(cls, csr) -> "RouteStream":
        n_rows, n_cols = csr.shape
        indptr = csr.host("indptr").astype(np.int64)
        indices = csr.host("indices").astype(np.int64)
        data = csr.host("data")
        nnz = int(indptr[-1])
        n_win = max(-(-n_cols // LANE), 1)
        n_ywin = max(-(-n_rows // LANE), 1)

        if nnz == 0:
            z128 = np.zeros((SUP_ROWS, LANE), np.int32)
            zf = np.zeros((1, LANE, LANE), data.dtype)
            zi = np.zeros((1, LANE, LANE), np.int32)
            return cls(
                a_vals=jnp.zeros((SUP_ROWS, LANE), data.dtype),
                a_lidx=jnp.asarray(z128), a_win=jnp.zeros((SUP_ROWS,), jnp.int32),
                a_rows=jnp.full((SUP_ROWS, LANE), n_rows, jnp.int32),
                p1=jnp.asarray(zi[None]), m1=jnp.asarray(zf[None]),
                p2=jnp.asarray(zi[None]), p3=jnp.asarray(zi[None]),
                touch=jnp.zeros((1, 1, LANE), jnp.int32),
                q1=jnp.asarray(zi), q2=jnp.asarray(zi), q3=jnp.asarray(zi),
                lpos=jnp.asarray(zi), ppos=jnp.asarray(zi),
                pmask=jnp.asarray(zf), segmask=jnp.asarray(zf),
                wrow=jnp.full((1, LANE), n_ywin, jnp.int32),
                shape=(n_rows, n_cols))

        counts = np.diff(indptr)
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), counts)
        cols = indices[:nnz]
        vals = data[:nnz]

        # ---- [A] reduce-layout packing (entries in CSR order) ---------------
        # lane-rows hold whole matrix-row segments of ONE output window;
        # matrix rows with >128 entries split into full chunks
        ywin = rows // LANE
        within_row = np.arange(nnz) - indptr[rows]
        chunk = within_row // LANE
        seg_new = np.empty(nnz, bool)
        seg_new[0] = True
        seg_new[1:] = (rows[1:] != rows[:-1]) | (chunk[1:] != chunk[:-1])
        seg_id = np.cumsum(seg_new) - 1
        seg_sizes = np.bincount(seg_id)
        seg_ywin = ywin[seg_new]
        n_seg = seg_sizes.shape[0]
        # first-fit segments into reduce rows per ywin (plain-python lists —
        # numpy scalar indexing is ~10× slower per step on the bench host)
        sizes_l = seg_sizes.tolist()
        ywin_l = seg_ywin.tolist()
        srow_l = [0] * n_seg
        sstart_l = [0] * n_seg
        n_srows = 0
        fill = LANE + 1  # force a new row at k == 0
        prev_w = -1
        for k in range(n_seg):
            sz = sizes_l[k]
            w = ywin_l[k]
            if w != prev_w or fill + sz > LANE:
                n_srows += 1
                fill = 0
                prev_w = w
            srow_l[k] = n_srows - 1
            sstart_l[k] = fill
            fill += sz
        srow_of_seg = np.asarray(srow_l, np.int64)
        sstart_of_seg = np.asarray(sstart_l, np.int64)
        # per-entry REDUCE slot (CSR order)
        red_srow = srow_of_seg[seg_id]
        red_slane = sstart_of_seg[seg_id] + (within_row % LANE)
        n_reg = max(-(-n_srows // REG_ROWS), 1)
        n_srows_pad = n_reg * REG_ROWS

        # ---- [B] kernel-2 extraction tables ----------------------------------
        lpos = np.zeros((n_reg, REG_ROWS, LANE), np.int32)
        ppos = np.zeros((n_reg, REG_ROWS, LANE), np.int32)
        pmask = np.zeros((n_reg, REG_ROWS, LANE), np.float32)
        segmask = np.zeros((n_reg, REG_ROWS, LANE), np.float32)
        wrow = np.full((n_reg, REG_ROWS), n_ywin, np.int32)  # dump default
        seg_end = sstart_of_seg + seg_sizes - 1
        seg_row_mod = (rows[seg_new] % LANE).astype(np.int64)
        reg_s = srow_of_seg // REG_ROWS
        rloc_s = srow_of_seg % REG_ROWS
        lpos[reg_s, rloc_s, seg_row_mod] = seg_end.astype(np.int32)
        has_prev = sstart_of_seg > 0
        ppos[reg_s[has_prev], rloc_s[has_prev], seg_row_mod[has_prev]] = (
            sstart_of_seg[has_prev] - 1).astype(np.int32)
        pmask[reg_s[has_prev], rloc_s[has_prev], seg_row_mod[has_prev]] = 1.0
        segmask[reg_s, rloc_s, seg_row_mod] = 1.0
        wrow[reg_s, rloc_s] = seg_ywin.astype(np.int32)

        # ---- [C] phase-A packing (entries sorted by x window) ----------------
        win = cols // LANE
        order_a = np.lexsort((rows, win))
        arow, alane, n_arows = _pack_rows_128(win[order_a])
        n_sup = max(-(-n_arows // SUP_ROWS), 1)
        n_arows_pad = n_sup * SUP_ROWS
        a_vals = np.zeros((n_arows_pad, LANE), data.dtype)
        a_lidx = np.zeros((n_arows_pad, LANE), np.int32)
        a_win = np.zeros((n_arows_pad,), np.int32)
        a_rows = np.full((n_arows_pad, LANE), n_rows, np.int32)
        a_vals[arow, alane] = vals[order_a]
        a_lidx[arow, alane] = (cols[order_a] % LANE).astype(np.int32)
        first_in_row = np.concatenate([[True], arow[1:] != arow[:-1]])
        a_win[arow[first_in_row]] = win[order_a][first_in_row]
        a_rows[arow, alane] = rows[order_a].astype(np.int32)
        e_sup = arow // SUP_ROWS
        e_srcrow = arow % SUP_ROWS

        # ---- [D] arrival-layout packing --------------------------------------
        # per region, supertile contributions are packed CONTIGUOUSLY in
        # supertile order — each (supertile, region) run touches only
        # ceil(run/128)+1 arrival rows, keeping splits (and table bytes)
        # small
        e_reg = (red_srow // REG_ROWS)[order_a]     # region per order_a pos
        ord_arr = np.lexsort((np.arange(nnz), e_sup, e_reg))
        # rank within region in arrival order
        reg_sorted = e_reg[ord_arr]
        reg_new = np.empty(nnz, bool)
        reg_new[0] = True
        reg_new[1:] = reg_sorted[1:] != reg_sorted[:-1]
        reg_start = np.nonzero(reg_new)[0]
        rank = np.arange(nnz) - reg_start[np.cumsum(reg_new) - 1]
        arr_row = np.empty(nnz, np.int64)   # order_a positions
        arr_lane = np.empty(nnz, np.int64)
        arr_row[ord_arr] = reg_sorted * REG_ROWS + rank // LANE
        arr_lane[ord_arr] = rank % LANE

        # ---- [E] split assignment + touch tables -----------------------------
        split_of_entry = np.zeros(nnz, np.int64)
        blockrow_of_entry = np.zeros(nnz, np.int64)
        order_by_sup = np.argsort(e_sup, kind="stable")
        sup_starts = np.searchsorted(e_sup[order_by_sup],
                                     np.arange(n_sup + 1))
        max_splits = 1
        per_sup_splits = []
        for t in range(n_sup):
            sel = order_by_sup[sup_starts[t]:sup_starts[t + 1]]
            if sel.size == 0:
                per_sup_splits.append([np.zeros(0, np.int64)])
                continue
            sr_t = arr_row[sel]
            urows = np.unique(sr_t)
            ureg = urows // REG_ROWS
            regs, rcnt = np.unique(ureg, return_counts=True)
            # first-fit contiguous region runs into splits (≤128 rows each)
            split_first_reg = [regs[0]]
            fill = 0
            for rgi, cnt in zip(regs.tolist(), rcnt.tolist()):
                if fill + cnt > SUP_ROWS:
                    split_first_reg.append(rgi)
                    fill = 0
                fill += cnt
            bounds = np.asarray(split_first_reg, np.int64)
            n_spl_t = bounds.shape[0]
            urow_split = np.searchsorted(bounds, ureg, side="right") - 1
            splits_rows = [urows[urow_split == s_i] for s_i in range(n_spl_t)]
            per_sup_splits.append(splits_rows)
            max_splits = max(max_splits, n_spl_t)
            ent_split = np.searchsorted(bounds, sr_t // REG_ROWS,
                                        side="right") - 1
            split_of_entry[sel] = ent_split
            for s_i in range(n_spl_t):
                rows_s = splits_rows[s_i]
                in_s = ent_split == s_i
                blockrow_of_entry[sel[in_s]] = np.searchsorted(
                    rows_s, sr_t[in_s])

        n_splits = max_splits
        touch = np.full((n_sup, n_splits, SUP_ROWS), n_srows_pad, np.int32)
        for t in range(n_sup):
            for s_i, rows_s in enumerate(per_sup_splits[t]):
                touch[t, s_i, :rows_s.shape[0]] = rows_s.astype(np.int32)

        # ---- [F] kernel-1 routing tables (edge coloring #1) -------------------
        inst_e = e_sup * n_splits + split_of_entry
        src_e = e_srcrow
        dst_e = blockrow_of_entry
        n_inst = n_sup * n_splits
        deg_src = np.zeros((n_inst, SUP_ROWS), np.int64)
        np.add.at(deg_src, (inst_e, src_e), 1)
        deg_dst = np.zeros((n_inst, SUP_ROWS), np.int64)
        np.add.at(deg_dst, (inst_e, dst_e), 1)
        inactive = ~np.isin(np.arange(n_inst), np.unique(inst_e))
        deg_src[inactive] = LANE
        deg_dst[inactive] = LANE
        def_src = (LANE - deg_src).reshape(-1)
        def_dst = (LANE - deg_dst).reshape(-1)
        ii = np.repeat(np.arange(n_inst), SUP_ROWS)
        rr = np.tile(np.arange(SUP_ROWS), n_inst)
        d_inst = np.repeat(ii, def_src)
        d_src = np.repeat(rr, def_src)
        d_dst = np.repeat(rr, def_dst)  # per-instance deficits are equal
        inst_all = np.concatenate([inst_e, d_inst])
        src_all = np.concatenate([src_e, d_src])
        dst_all = np.concatenate([dst_e, d_dst])
        colors = _euler_color_128(inst_all, src_all, dst_all)

        p1 = np.zeros((n_sup, n_splits, SUP_ROWS, LANE), np.int32)
        m1 = np.zeros((n_sup, n_splits, SUP_ROWS, LANE), np.float32)
        p2 = np.zeros((n_sup, n_splits, SUP_ROWS, LANE), np.int32)
        p3 = np.zeros((n_sup, n_splits, SUP_ROWS, LANE), np.int32)
        inst_t = inst_all // n_splits
        inst_s = inst_all % n_splits
        # P1[s, c] = source lane of the color-c edge from A-row s (real
        # edges; dummies stay 0 and are masked by M1)
        p1[inst_t[:nnz], inst_s[:nnz], src_e, colors[:nnz]] = \
            alane.astype(np.int32)
        m1[inst_t[:nnz], inst_s[:nnz], src_e, colors[:nnz]] = 1.0
        # P2[c, j] = s for the color-c edge into dst j (incl. dummies)
        p2[inst_t, inst_s, colors, dst_all] = src_all.astype(np.int32)
        # P3[j, l_dst] = color of the edge landing at arrival lane l_dst;
        # unused lanes point at a dummy color into j (value 0)
        p3[inst_t[:nnz], inst_s[:nnz], dst_e,
           arr_lane % LANE] = colors[:nnz].astype(np.int32)
        dummy_sel = np.zeros(inst_all.shape[0], bool)
        dummy_sel[nnz:] = True
        first_dummy = np.full((n_inst, SUP_ROWS), 1 << 30, np.int64)
        np.minimum.at(first_dummy, (inst_all[dummy_sel], dst_all[dummy_sel]),
                      colors[dummy_sel])
        first_dummy[first_dummy >= (1 << 30)] = 0
        used = np.zeros((n_inst, SUP_ROWS, LANE), bool)
        used[inst_e, dst_e, arr_lane % LANE] = True
        used[inactive] = True      # leave skipped instances' tables zero
        it, jt, lt = np.nonzero(~used)
        p3[it // n_splits, it % n_splits, jt, lt] = \
            first_dummy[it, jt].astype(np.int32)

        # ---- [G] kernel-2 arrival→reduce permutation (edge coloring #2) -------
        # per region: bijection between 128×128 arrival slots and 128×128
        # reduce slots.  Real edges: each entry.  Dummies pair the empty
        # arrival slots with the padding reduce slots; empty arrival lanes
        # sit at the END of the last partial row (packed), so lane 127 of a
        # deficient row is always empty — dummies read zeros, no mask.
        reg_e = red_srow // REG_ROWS                 # CSR order
        q_src = arr_row % REG_ROWS
        q_dst = red_srow % REG_ROWS
        # align arrival (order_a-index) arrays to CSR order
        inv_a = np.empty(nnz, np.int64)
        inv_a[order_a] = np.arange(nnz)
        q_src_csr = q_src[inv_a]
        arr_lane_csr = arr_lane[inv_a]
        degq_src = np.zeros((n_reg, REG_ROWS), np.int64)
        np.add.at(degq_src, (reg_e, q_src_csr), 1)
        degq_dst = np.zeros((n_reg, REG_ROWS), np.int64)
        np.add.at(degq_dst, (reg_e, q_dst), 1)
        dq_src = (LANE - degq_src).reshape(-1)
        dq_dst = (LANE - degq_dst).reshape(-1)
        qi = np.repeat(np.arange(n_reg), REG_ROWS)
        qr = np.tile(np.arange(REG_ROWS), n_reg)
        q_inst_all = np.concatenate([reg_e, np.repeat(qi, dq_src)])
        q_src_all = np.concatenate([q_src_csr, np.repeat(qr, dq_src)])
        q_dst_all = np.concatenate([q_dst, np.repeat(qr, dq_dst)])
        q_colors = _euler_color_128(q_inst_all, q_src_all, q_dst_all)

        q1 = np.full((n_reg, REG_ROWS, LANE), LANE - 1, np.int32)
        q2 = np.zeros((n_reg, REG_ROWS, LANE), np.int32)
        q3 = np.zeros((n_reg, REG_ROWS, LANE), np.int32)
        # Q1[s, c] = arrival lane of the color-c edge from arrival row s;
        # dummies default to lane 127 — always empty (zero) on a row with
        # deficit, because arrival rows pack entries from lane 0
        q1[reg_e, q_src_csr, q_colors[:nnz]] = arr_lane_csr.astype(np.int32)
        # Q2[c, j] = s for the color-c edge into reduce row j (incl. dummies)
        q2[q_inst_all, q_colors, q_dst_all] = q_src_all.astype(np.int32)
        # Q3[j, l] = color of the edge landing at reduce lane l; unused
        # lanes take a dummy color into j (zero value)
        q3[reg_e, q_dst, red_slane % LANE] = q_colors[:nnz].astype(np.int32)
        q_dummy = np.zeros(q_inst_all.shape[0], bool)
        q_dummy[nnz:] = True
        firstq = np.full((n_reg, REG_ROWS), 1 << 30, np.int64)
        np.minimum.at(firstq, (q_inst_all[q_dummy], q_dst_all[q_dummy]),
                      q_colors[q_dummy])
        firstq[firstq >= (1 << 30)] = 0
        usedq = np.zeros((n_reg, REG_ROWS, LANE), bool)
        usedq[reg_e, q_dst, red_slane % LANE] = True
        it2, jt2, lt2 = np.nonzero(~usedq)
        q3[it2, jt2, lt2] = firstq[it2, jt2].astype(np.int32)

        return cls(
            a_vals=jnp.asarray(a_vals), a_lidx=jnp.asarray(a_lidx),
            a_win=jnp.asarray(a_win), a_rows=jnp.asarray(a_rows),
            p1=jnp.asarray(p1), m1=jnp.asarray(m1.astype(data.dtype)),
            p2=jnp.asarray(p2), p3=jnp.asarray(p3),
            touch=jnp.asarray(touch),
            q1=jnp.asarray(q1), q2=jnp.asarray(q2), q3=jnp.asarray(q3),
            lpos=jnp.asarray(lpos), ppos=jnp.asarray(ppos),
            pmask=jnp.asarray(pmask.astype(data.dtype)),
            segmask=jnp.asarray(segmask.astype(data.dtype)),
            wrow=jnp.asarray(wrow),
            shape=(n_rows, n_cols))

    # -- canonical views --------------------------------------------------------
    def to_coo(self):
        from .coo import COO

        n_rows = self.shape[0]
        rows = self.a_rows.reshape(-1)
        cols = (self.a_win[:, None] * LANE
                + self.a_lidx.astype(jnp.int32)).reshape(-1)
        vals = self.a_vals.reshape(-1)
        ok = rows < n_rows
        return COO(rows=jnp.where(ok, rows, n_rows).astype(jnp.int32),
                   cols=jnp.where(ok, cols, 0),
                   vals=jnp.where(ok, vals, 0),
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    def to_route(self) -> "RouteStream":
        return self

    # -- structure ----------------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(np.prod(self.a_vals.shape))

    @property
    def n_sup(self) -> int:
        return self.p1.shape[0]

    @property
    def n_splits(self) -> int:
        return self.p1.shape[1]

    @property
    def n_regions(self) -> int:
        return self.lpos.shape[0]

    @property
    def index_dtype(self):
        return jnp.dtype(jnp.int32)

    @property
    def data(self):
        return self.a_vals

    def n_non_zero_entries(self):
        return jnp.sum(self.a_rows < self.shape[0]).astype(jnp.int32)

    def scale(self, scalar) -> "RouteStream":
        return dataclasses.replace(
            self, a_vals=self.a_vals * jnp.asarray(scalar, self.a_vals.dtype))

    def fill_ratio(self) -> float:
        n = int(np.asarray(self.n_non_zero_entries()))
        return n / max(self.nse, 1)

    def x_windows(self) -> int:
        return max(-(-self.shape[1] // LANE), 1)

    def y_windows(self) -> int:
        return max(-(-self.shape[0] // LANE), 1)

    def spmv_traffic_bytes(self) -> int:
        """Layout speed-of-light bytes: every kernel-read array once, the
        staging round-trip, x read once, y written once."""
        from ..types import accum_dtype

        total = 0
        for name in self._spmv_read_fields:
            arr = getattr(self, name)
            total += arr.size * jnp.dtype(arr.dtype).itemsize
        staging = (self.n_regions * REG_ROWS + SUP_ROWS) * LANE * 4
        total += 2 * staging
        total += self.shape[1] * jnp.dtype(self.dtype).itemsize
        total += self.shape[0] * jnp.dtype(accum_dtype(self.dtype)).itemsize
        return int(total)
