"""Row-partitioned distributed sparse matrices.

Successor of ``SparseMatPar`` (reference: src/sparsemat_par.rs:12-35): the
same contiguous block-row decomposition, but blocks live on different chips
of a ``jax.sharding.Mesh`` and the SpMV the reference left as a
commented-out thread sketch (sparsemat_par.rs:37-68) is realized with
``shard_map`` + collectives:

* ``DistDIA`` — banded matrices; the operand vector exchanges only h-wide
  *halo edges* with neighbor chips (``lax.ppermute``), so interconnect traffic per
  step is O(halo), not O(n).  This is the distributed pattern for stencil
  operators (BASELINE config 5).
* ``DistCSR`` / ``DistELL`` — general matrices; the operand is
  ``lax.all_gather``-ed (each chip needs arbitrary columns).
* Dot products in solvers reduce via GSPMD-inserted psum — the completed
  version of the reference's unfinished mpsc gather.

All dist formats are pytrees whose leading (block) axis is sharded, so they
pass through jit/shard_map like any array.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..formats.base import array_field, register_format, static_field
from ..types import accum_dtype
from .mesh import ROWS_AXIS


def _pad_rows(n_rows: int, n_blocks: int) -> int:
    return -(-n_rows // n_blocks) * n_blocks


# --- DistDIA -----------------------------------------------------------------


@register_format
@dataclasses.dataclass(frozen=True)
class DistDIA:
    """Banded matrix, block-row partitioned.

    ``data``: (n_blocks, n_diags, rows_per_block) — axis 0 sharded;
    ``offsets``: static diagonal offsets; ``shape``: global (unpadded).
    """

    data: jax.Array = array_field()
    offsets: Tuple[int, ...] = static_field()
    shape: Tuple[int, int] = static_field()
    axis: str = static_field()

    @property
    def n_blocks(self) -> int:
        return int(self.data.shape[0])

    @property
    def rows_per_block(self) -> int:
        return int(self.data.shape[2])

    @property
    def halo(self) -> int:
        return max((abs(o) for o in self.offsets), default=0)

    @property
    def padded_rows(self) -> int:
        return self.n_blocks * self.rows_per_block

    def matvec(self, x: jax.Array, mesh: Mesh) -> jax.Array:
        return dist_dia_spmv(self, x, mesh)

    def padded_vector(self, v, mesh: Mesh) -> jax.Array:
        """Pad a global vector to the block grid and shard it by rows.
        Host (numpy) input is placed directly onto the global sharding —
        required when the mesh spans multiple processes."""
        pad = self.padded_rows - v.shape[0]
        if isinstance(v, np.ndarray):
            if pad:
                v = np.concatenate([v, np.zeros((pad,), v.dtype)])
            return jax.device_put(v, NamedSharding(mesh, P(self.axis)))
        v = jnp.asarray(v)
        if pad:
            v = jnp.concatenate([v, jnp.zeros((pad,), v.dtype)])
        return jax.device_put(v, NamedSharding(mesh, P(self.axis)))

    def unpad(self, v: jax.Array) -> jax.Array:
        return v[: self.shape[0]]


def distribute_dia(dia, mesh: Mesh, axis: str = ROWS_AXIS) -> DistDIA:
    """Partition a DIA matrix over the mesh (host-side).

    ≈ SparseMatPar::with_sub_matrices (src/sparsemat_par.rs:20-28) with
    n_blocks = mesh size; rows pad up to a block multiple."""
    n_blocks = mesh.shape[axis]
    n_rows, n_cols = dia.shape
    padded = _pad_rows(n_rows, n_blocks)
    data = np.asarray(dia.data)
    if padded > n_rows:
        data = np.concatenate(
            [data, np.zeros((data.shape[0], padded - n_rows), data.dtype)], axis=1)
    r = padded // n_blocks
    blocks = data.reshape(data.shape[0], n_blocks, r).transpose(1, 0, 2)
    sharded = jax.device_put(
        blocks, NamedSharding(mesh, P(axis, None, None)))
    return DistDIA(data=sharded, offsets=tuple(dia.offsets),
                   shape=dia.shape, axis=axis)


def dist_dia_spmv(mat: DistDIA, x: jax.Array, mesh: Mesh) -> jax.Array:
    """y = A @ x with halo exchange.  ``x`` must be the padded sharded vector
    (see ``padded_vector``); returns the padded sharded result.

    Out-of-band data slots are zero, so the wrap-around halo garbage at the
    first/last block multiplies against zeros — no boundary masking needed.
    """
    h = mat.halo
    r = mat.rows_per_block
    n_blocks = mat.n_blocks
    offsets = mat.offsets
    axis = mat.axis
    if h > r:
        return _dist_dia_spmv_allgather(mat, x, mesh)

    fwd = [(i, (i + 1) % n_blocks) for i in range(n_blocks)]
    bwd = [(i, (i - 1) % n_blocks) for i in range(n_blocks)]

    def local(data_blk, x_blk):
        # data_blk: (1, nd, r); x_blk: (r,)
        d = data_blk[0]
        if h > 0 and n_blocks > 1:
            left = jax.lax.ppermute(x_blk[r - h:], axis, fwd)   # from left nbr
            right = jax.lax.ppermute(x_blk[:h], axis, bwd)      # from right nbr
            x_ext = jnp.concatenate([left, x_blk, right])
        elif h > 0:
            x_ext = jnp.pad(x_blk, (h, h))
        else:
            x_ext = x_blk
        adt = accum_dtype(jnp.result_type(d.dtype, x_blk.dtype))
        y = jnp.zeros((r,), adt)
        for k, off in enumerate(offsets):
            y = y + d[k].astype(adt) * jax.lax.slice_in_dim(
                x_ext.astype(adt), off + h, off + h + r)
        return y

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis)),
        out_specs=P(axis))(mat.data, x)


def _dist_dia_spmv_allgather(mat: DistDIA, x: jax.Array, mesh: Mesh):
    axis = mat.axis
    r = mat.rows_per_block
    offsets = mat.offsets
    pr = mat.padded_rows

    def local(data_blk, x_blk):
        d = data_blk[0]
        xg = jax.lax.all_gather(x_blk, axis, tiled=True)        # (padded_rows,)
        blk = jax.lax.axis_index(axis)
        base = blk * r
        adt = accum_dtype(jnp.result_type(d.dtype, xg.dtype))
        y = jnp.zeros((r,), adt)
        for k, off in enumerate(offsets):
            start = jnp.clip(base + off, -r, pr)  # dynamic but bounded
            seg = jax.lax.dynamic_slice_in_dim(
                jnp.pad(xg.astype(adt), (r, r)), start + r, r)
            y = y + d[k].astype(adt) * seg
        return y

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis)),
        out_specs=P(axis))(mat.data, x)


# --- DistCSR / DistELL -------------------------------------------------------


@register_format
@dataclasses.dataclass(frozen=True)
class DistCSR:
    """General sparse matrix, block-row partitioned; column ids are GLOBAL.

    ``indptr``: (n_blocks, rows_per_block+1); ``indices``/``data``/
    ``local_rows``: (n_blocks, nnz_max) with per-block tail padding
    (local_row = rows_per_block ⇒ dropped).
    """

    indptr: jax.Array = array_field()
    indices: jax.Array = array_field()
    data: jax.Array = array_field()
    local_rows: jax.Array = array_field()
    shape: Tuple[int, int] = static_field()
    axis: str = static_field()

    @property
    def n_blocks(self) -> int:
        return int(self.indptr.shape[0])

    @property
    def rows_per_block(self) -> int:
        return int(self.indptr.shape[1]) - 1

    @property
    def padded_rows(self) -> int:
        return self.n_blocks * self.rows_per_block

    padded_vector = DistDIA.padded_vector
    unpad = DistDIA.unpad

    def matvec(self, x: jax.Array, mesh: Mesh) -> jax.Array:
        return dist_csr_spmv(self, x, mesh)


@register_format
@dataclasses.dataclass(frozen=True)
class DistELL:
    """ELL blocks with global column ids: cols/vals (n_blocks, rpb, K)."""

    cols: jax.Array = array_field()
    vals: jax.Array = array_field()
    shape: Tuple[int, int] = static_field()
    axis: str = static_field()

    @property
    def n_blocks(self) -> int:
        return int(self.cols.shape[0])

    @property
    def rows_per_block(self) -> int:
        return int(self.cols.shape[1])

    @property
    def padded_rows(self) -> int:
        return self.n_blocks * self.rows_per_block

    padded_vector = DistDIA.padded_vector
    unpad = DistDIA.unpad

    def matvec(self, x: jax.Array, mesh: Mesh) -> jax.Array:
        return dist_ell_spmv(self, x, mesh)


def distribute_csr(csr, mesh: Mesh, axis: str = ROWS_AXIS,
                   format: str = "csr"):
    """Partition a CSR matrix into block rows over the mesh (host-side).
    ``format='ell'`` produces DistELL blocks instead (regular layout)."""
    n_blocks = mesh.shape[axis]
    n_rows, n_cols = csr.shape
    padded = _pad_rows(n_rows, n_blocks)
    r = padded // n_blocks
    indptr = csr.host("indptr").astype(np.int64)
    indices = csr.host("indices").astype(np.int64)
    data = csr.host("data")

    if format == "ell":
        counts = np.diff(indptr)
        k = max(int(counts.max(initial=0)), 1)
        cols_b = np.zeros((n_blocks, r, k), np.int32)
        vals_b = np.zeros((n_blocks, r, k), data.dtype)
        for b in range(n_blocks):
            for li in range(r):
                g = b * r + li
                if g >= n_rows:
                    break
                s, e = indptr[g], indptr[g + 1]
                cols_b[b, li, : e - s] = indices[s:e]
                vals_b[b, li, : e - s] = data[s:e]
        return DistELL(
            cols=jax.device_put(cols_b,
                                NamedSharding(mesh, P(axis, None, None))),
            vals=jax.device_put(vals_b,
                                NamedSharding(mesh, P(axis, None, None))),
            shape=csr.shape, axis=axis)

    block_nnz = [int(indptr[min((b + 1) * r, n_rows)] - indptr[min(b * r, n_rows)])
                 for b in range(n_blocks)]
    nnz_max = max(max(block_nnz), 1)
    indptr_b = np.zeros((n_blocks, r + 1), np.int32)
    indices_b = np.zeros((n_blocks, nnz_max), np.int32)
    data_b = np.zeros((n_blocks, nnz_max), data.dtype)
    lrows_b = np.full((n_blocks, nnz_max), r, np.int32)  # pad → dropped
    for b in range(n_blocks):
        lo = min(b * r, n_rows)
        hi = min((b + 1) * r, n_rows)
        s, e = indptr[lo], indptr[hi]
        indices_b[b, : e - s] = indices[s:e]
        data_b[b, : e - s] = data[s:e]
        local_ptr = indptr[lo : hi + 1] - s
        indptr_b[b, : hi - lo + 1] = local_ptr
        indptr_b[b, hi - lo + 1 :] = local_ptr[-1]
        lrows_b[b, : e - s] = np.repeat(
            np.arange(hi - lo, dtype=np.int32), np.diff(indptr[lo : hi + 1]))
    spec = NamedSharding(mesh, P(axis, None))
    return DistCSR(
        indptr=jax.device_put(indptr_b, spec),
        indices=jax.device_put(indices_b, spec),
        data=jax.device_put(data_b, spec),
        local_rows=jax.device_put(lrows_b, spec),
        shape=csr.shape, axis=axis)


def dist_csr_spmv(mat: DistCSR, x: jax.Array, mesh: Mesh) -> jax.Array:
    """y = A @ x with an all-gathered operand (general column structure)."""
    axis = mat.axis
    r = mat.rows_per_block

    def local(indices_blk, data_blk, lrows_blk, x_blk):
        xg = jax.lax.all_gather(x_blk, axis, tiled=True)
        adt = accum_dtype(jnp.result_type(data_blk.dtype, xg.dtype))
        prod = data_blk[0].astype(adt) * xg.at[indices_blk[0]].get(
            mode="fill", fill_value=0).astype(adt)
        y = jnp.zeros((r,), adt)
        return y.at[lrows_blk[0]].add(prod, mode="drop")

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis)),
        out_specs=P(axis))(mat.indices, mat.data, mat.local_rows, x)


def dist_ell_spmv(mat: DistELL, x: jax.Array, mesh: Mesh) -> jax.Array:
    axis = mat.axis

    def local(cols_blk, vals_blk, x_blk):
        xg = jax.lax.all_gather(x_blk, axis, tiled=True)
        adt = accum_dtype(jnp.result_type(vals_blk.dtype, xg.dtype))
        gathered = xg.at[cols_blk[0]].get(mode="fill", fill_value=0)
        return jnp.sum(vals_blk[0].astype(adt) * gathered.astype(adt), axis=1)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None, None), P(axis, None, None), P(axis)),
        out_specs=P(axis))(mat.cols, mat.vals, x)


# --- DistCSRSubset: halo-subset exchange for general matrices -----------------


@register_format
@dataclasses.dataclass(frozen=True)
class DistCSRSubset:
    """General sparse matrix, block-row partitioned, with *subset* operand
    exchange (round-2 verdict #9): instead of all-gathering the whole
    operand (O(n) interconnect traffic per SpMV, ``DistCSR``), each device
    sends every peer ONLY the x entries that peer's rows actually
    reference.  The needed-column sets are computed once at distribute
    time.

    Exchange structure (round-4 verdict #8): n_dev−1 ``lax.ppermute``
    hops — hop k ships device d's subset for peer (d+k) mod n_dev.  SPMD
    forces a uniform payload per HOP, but each hop pads only to ITS OWN
    max, so one skewed pair inflates one hop instead of every pair (the
    old single all_to_all padded all n·(n−1) slots to the global max).

    ``send_idx[k]``: (n_dev, m_k) — local x indices device d ships on hop
    k (pad 0; receivers never reference padding).  ``indices``: (n_dev,
    nnz_max) LOCAL renumbered columns: ``[0, r)`` = own shard,
    ``r + hop_off[k] + pos`` = slot pos of hop k's received subset.

    Completed successor of the reference's unrealized parallel mvp
    (src/sparsemat_par.rs:37-68), in the spirit of BASELINE config 5's
    "halo exchange overlapped with local SpMV".
    """

    send_idx: Tuple[jax.Array, ...] = array_field()
    indices: jax.Array = array_field()
    data: jax.Array = array_field()
    local_rows: jax.Array = array_field()
    shape: Tuple[int, int] = static_field()
    axis: str = static_field()
    #: per-hop subset slot count (len n_dev-1; hop k ↔ peer (d+k) % n_dev)
    hop_m: Tuple[int, ...] = static_field()
    rpb: int = static_field()

    @property
    def n_blocks(self) -> int:
        return int(self.indices.shape[0])

    @property
    def rows_per_block(self) -> int:
        return self.rpb

    @property
    def padded_rows(self) -> int:
        return self.n_blocks * self.rpb

    padded_vector = DistDIA.padded_vector
    unpad = DistDIA.unpad

    def exchange_bytes_per_spmv(self) -> int:
        """Interconnect payload per SpMV: Σ_hops n_dev·m_k values — each
        hop padded to its own max consumer, so traffic tracks the actual
        boundary profile instead of n²·(worst pair)."""
        n = self.n_blocks
        return n * sum(self.hop_m) * int(jnp.dtype(self.data.dtype).itemsize)

    def matvec(self, x: jax.Array, mesh: Mesh) -> jax.Array:
        return dist_csr_subset_spmv(self, x, mesh)


def distribute_csr_subset(csr, mesh: Mesh, axis: str = ROWS_AXIS
                          ) -> DistCSRSubset:
    """Partition a CSR matrix with precomputed needed-column subsets
    (host-side).  Requires n_cols ≤ padded rows (square-ish operators,
    same assumption as the other row-partitioned formats)."""
    n_dev = mesh.shape[axis]
    n_rows, n_cols = csr.shape
    padded = _pad_rows(max(n_rows, n_cols), n_dev)
    r = padded // n_dev
    indptr = csr.host("indptr").astype(np.int64)
    indices = csr.host("indices").astype(np.int64)
    data = csr.host("data")

    needed = {}          # (owner d, consumer b) -> sorted unique local cols
    block_entries = []
    for b in range(n_dev):
        lo, hi = min(b * r, n_rows), min((b + 1) * r, n_rows)
        s, e = indptr[lo], indptr[hi]
        cols_b = indices[s:e]
        owners = cols_b // r
        for d in np.unique(owners):
            if d != b:
                needed[(int(d), b)] = np.unique(
                    cols_b[owners == d] - d * r)
        block_entries.append((lo, hi, s, e, cols_b, owners))

    # hop k carries owner d → consumer (d+k) % n_dev; pad to the HOP max
    hop_m = []
    send_idx = []
    for k in range(1, n_dev):
        mk = max([needed.get((d, (d + k) % n_dev), _EMPTY_I64).size
                  for d in range(n_dev)] + [1])
        sk = np.zeros((n_dev, mk), np.int32)
        for d in range(n_dev):
            v = needed.get((d, (d + k) % n_dev))
            if v is not None:
                sk[d, : v.size] = v
        hop_m.append(mk)
        send_idx.append(sk)
    hop_off = np.concatenate([[0], np.cumsum(hop_m)]).astype(np.int64)

    nnz_max = max(max((e - s) for (_, _, s, e, _, _) in block_entries), 1)
    indices_b = np.zeros((n_dev, nnz_max), np.int32)
    data_b = np.zeros((n_dev, nnz_max), data.dtype)
    lrows_b = np.full((n_dev, nnz_max), r, np.int32)
    for b, (lo, hi, s, e, cols_b, owners) in enumerate(block_entries):
        local = np.empty(cols_b.shape, np.int64)
        own = owners == b
        local[own] = cols_b[own] - b * r
        for d in np.unique(owners):
            if d == b:
                continue
            k = (b - d) % n_dev          # hop that delivers owner d → b
            sel = owners == d
            pos = np.searchsorted(needed[(int(d), b)], cols_b[sel] - d * r)
            local[sel] = r + hop_off[k - 1] + pos
        indices_b[b, : e - s] = local
        data_b[b, : e - s] = data[s:e]
        lrows_b[b, : e - s] = np.repeat(
            np.arange(hi - lo, dtype=np.int32), np.diff(indptr[lo:hi + 1]))

    spec2 = NamedSharding(mesh, P(axis, None))
    return DistCSRSubset(
        send_idx=tuple(jax.device_put(sk, spec2) for sk in send_idx),
        indices=jax.device_put(indices_b, spec2),
        data=jax.device_put(data_b, spec2),
        local_rows=jax.device_put(lrows_b, spec2),
        shape=csr.shape, axis=axis, hop_m=tuple(hop_m), rpb=r)


_EMPTY_I64 = np.zeros(0, np.int64)


def dist_csr_subset_spmv(mat: DistCSRSubset, x: jax.Array,
                         mesh: Mesh) -> jax.Array:
    """y = A @ x with subset exchange: per hop, gather the entries the
    k-ahead peer needs and ``ppermute`` them; then a purely local gather +
    scatter-add over the renumbered columns."""
    axis = mat.axis
    n_dev = mat.n_blocks

    def local(indices_blk, data_blk, lrows_blk, x_blk, *send_blks):
        r = x_blk.shape[0]
        parts = [x_blk]
        for k, sk in enumerate(send_blks, start=1):
            mine = x_blk.at[sk[0]].get(mode="fill", fill_value=0)
            perm = [(d, (d + k) % n_dev) for d in range(n_dev)]
            parts.append(jax.lax.ppermute(mine, axis, perm))
        xl = jnp.concatenate(parts) if len(parts) > 1 else x_blk
        adt = accum_dtype(jnp.result_type(data_blk.dtype, x_blk.dtype))
        prod = data_blk[0].astype(adt) * xl.at[indices_blk[0]].get(
            mode="fill", fill_value=0).astype(adt)
        y = jnp.zeros((r,), adt)
        return y.at[lrows_blk[0]].add(prod, mode="drop")

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None), P(axis, None), P(axis, None), P(axis))
        + tuple(P(axis, None) for _ in mat.send_idx),
        out_specs=P(axis))(mat.indices, mat.data, mat.local_rows, x,
                           *mat.send_idx)


# --- DistSlab ----------------------------------------------------------------


@register_format
@dataclasses.dataclass(frozen=True)
class DistSlab:
    """Scattered bounded-span matrix (SlabELL), block-row partitioned.

    Each device owns ``blocks_per_dev`` row blocks of a global SlabELL
    freeze; ``win_lo`` is pre-shifted into *local extended-x window*
    coordinates so the kernel needs no device-id arithmetic.  SpMV
    exchanges ``halo_windows`` 128-column window edges with the two
    neighbor chips (``lax.ppermute``) — interconnect traffic per step is
    O(halo), not O(n), the scattered-matrix analogue of DistDIA's
    banded halo exchange."""

    vals: jax.Array = array_field()      # (n_dev, nrb_l, C, RB)
    lidx: jax.Array = array_field()      # (n_dev, nrb_l, C, RB)
    win_lo: jax.Array = array_field()    # (n_dev, nrb_l) local ext coords
    shape: Tuple[int, int] = static_field()
    buckets: Tuple[Tuple[int, int], ...] = static_field()
    halo_windows: int = static_field()
    local_windows: int = static_field()
    axis: str = static_field()

    @property
    def n_blocks(self) -> int:
        return int(self.vals.shape[0])

    @property
    def rows_per_block(self) -> int:
        return self.local_windows * 128

    @property
    def padded_rows(self) -> int:
        return self.n_blocks * self.rows_per_block

    padded_vector = DistDIA.padded_vector
    unpad = DistDIA.unpad

    def matvec(self, x: jax.Array, mesh: Mesh) -> jax.Array:
        return dist_slab_spmv(self, x, mesh)


def distribute_slab(csr, mesh: Mesh, axis: str = ROWS_AXIS,
                    rb: int | None = None) -> DistSlab:
    """Partition a matrix over the mesh as window-bucketed slabs
    (host-side).  One global SlabELL freeze (uniform static buckets across
    devices), regrouped into per-device block runs."""
    from ..formats.slab import SLAB_ROW_BLOCK, WINDOW, SlabELL

    rb = rb or SLAB_ROW_BLOCK
    n_dev = mesh.shape[axis]
    n_rows, n_cols = csr.shape
    # rows per device: a multiple of the row block (rb is a 128-multiple)
    r = -(-(-(-n_rows // n_dev)) // rb) * rb
    sl = SlabELL.from_csr(csr, rb=rb)
    nrb_total = n_dev * (r // rb)
    pad_blocks = nrb_total - sl.n_row_blocks
    vals = np.asarray(sl.vals)
    lidx = np.asarray(sl.lidx)
    wlo = np.asarray(sl.win_lo).astype(np.int64)
    if pad_blocks:
        vals = np.concatenate(
            [vals, np.zeros((pad_blocks,) + vals.shape[1:], vals.dtype)])
        lidx = np.concatenate(
            [lidx, np.zeros((pad_blocks,) + lidx.shape[1:], lidx.dtype)])
    nrb_l = r // rb
    w_l = r // WINDOW
    s = sl.slab_windows
    dev = np.arange(nrb_total) // nrb_l
    if pad_blocks:
        # all-zero tail blocks read their own device's first window, so
        # they add no halo
        wlo = np.concatenate([wlo, dev[sl.n_row_blocks:] * w_l])
    # halo: how far any block's slab reaches outside its device's x shard
    h = int(max(0,
                (dev * w_l - wlo).max(initial=0),
                (wlo + s - (dev + 1) * w_l).max(initial=0)))
    wlo_local = wlo - dev * w_l + h
    spec3 = NamedSharding(mesh, P(axis, None, None, None))
    spec1 = NamedSharding(mesh, P(axis, None))
    return DistSlab(
        vals=jax.device_put(vals.reshape((n_dev, nrb_l) + vals.shape[1:]), spec3),
        lidx=jax.device_put(lidx.reshape((n_dev, nrb_l) + lidx.shape[1:]), spec3),
        win_lo=jax.device_put(
            wlo_local.reshape(n_dev, nrb_l).astype(np.int32), spec1),
        shape=csr.shape, buckets=sl.buckets, halo_windows=h,
        local_windows=w_l, axis=axis)


def dist_slab_spmv(mat: DistSlab, x: jax.Array, mesh: Mesh) -> jax.Array:
    """y = A @ x with window-halo exchange.  ``x`` must be the padded
    sharded vector (``padded_vector``); returns the padded sharded result.

    Wrap-around halo garbage at the first/last device is only referenced
    by padding slots (val 0), so no boundary masking is needed — the same
    argument as DistDIA."""
    from ..formats.slab import WINDOW, SlabELL
    from ..kernels.spmv import slab_spmv_xla

    h = mat.halo_windows
    w_l = mat.local_windows
    n_dev = mat.n_blocks
    r = mat.rows_per_block
    axis = mat.axis
    buckets = mat.buckets
    if h > w_l:
        raise ValueError(
            f"halo ({h} windows) exceeds the local shard ({w_l} windows) — "
            f"use DistELL (all-gather) for this span/mesh combination")

    fwd = [(i, (i + 1) % n_dev) for i in range(n_dev)]
    bwd = [(i, (i - 1) % n_dev) for i in range(n_dev)]
    hx = h * WINDOW

    def local(vals_blk, lidx_blk, wl_blk, x_blk):
        if h > 0 and n_dev > 1:
            left = jax.lax.ppermute(x_blk[r - hx:], axis, fwd)
            right = jax.lax.ppermute(x_blk[:hx], axis, bwd)
            x_ext = jnp.concatenate([left, x_blk, right])
        elif h > 0:
            x_ext = jnp.pad(x_blk, (hx, hx))
        else:
            x_ext = x_blk
        sl = SlabELL(vals=vals_blk[0], lidx=lidx_blk[0], win_lo=wl_blk[0],
                     bucket_cnt=None, shape=(r, x_ext.shape[0]),
                     buckets=buckets)
        return slab_spmv_xla(sl, x_ext)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(axis, None, None, None), P(axis, None, None, None),
                  P(axis, None), P(axis)),
        out_specs=P(axis))(mat.vals, mat.lidx, mat.win_lo, x)
