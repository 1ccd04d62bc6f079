"""XLA SpMV formulations of the windowed layouts (WELL, SlabELL, SlabPack,
SlabStream).

Each is a gather of x by (window, lane) index, an FMA against the stored
values and a sum or scatter-add into the output rows; XLA fuses the
gather into the product and emits one scatter-add for the row blocks.
They replace the serial row loop of the reference
(src/sparsematrix.rs:146-158) for these formats.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.slab import WINDOW as SLAB_WINDOW
from ..formats.slab import SlabELL, SlabPack, SlabStream
from ..formats.well import ROW_BLOCK, WELL, WINDOW
from ..types import accum_dtype


def _pad_x_windows(well: WELL, x: jax.Array):
    n_cols = well.shape[1]
    n_win = max(-(-n_cols // WINDOW), 1)
    xp = jnp.pad(x, (0, n_win * WINDOW - n_cols))
    return xp.reshape(n_win, WINDOW), n_win


def well_spmv_xla(well: WELL, x: jax.Array) -> jax.Array:
    """SpMV on the format's own arrays (its only device path)."""
    n_rows = well.shape[0]
    xw, _ = _pad_x_windows(well, x)
    adt = accum_dtype(jnp.result_type(well.vals.dtype, x.dtype))
    tiles_x = xw[well.tile_wins]                              # (T, 128)
    g = jnp.take_along_axis(
        jnp.broadcast_to(tiles_x[:, None, :],
                         (well.n_tiles, ROW_BLOCK, WINDOW)),
        well.lidx, axis=2)                                    # (T, 8, K)
    partial = jnp.sum(well.vals.astype(adt) * g.astype(adt), axis=2)  # (T, 8)
    n_rb = -(-n_rows // ROW_BLOCK)
    y = jnp.zeros((n_rb, ROW_BLOCK), adt)
    y = y.at[well.tile_rows].add(partial, mode="drop")
    return y.reshape(-1)[:n_rows]


# --- SlabELL: window-bucketed slabs (see formats/slab.py) --------------------

def slab_spmv_xla(sl: SlabELL, x: jax.Array) -> jax.Array:
    """SpMV on the format's own arrays (its only device path)."""
    n_rows = sl.shape[0]
    adt = accum_dtype(jnp.result_type(sl.vals.dtype, x.dtype))
    w_of = jnp.asarray(sl._window_of_cpos())
    cols = sl.lidx.astype(jnp.int32) + (
        sl.win_lo[:, None, None] + w_of[None, :, None]) * SLAB_WINDOW
    xg = x.at[cols].get(mode="fill", fill_value=0)
    y = jnp.sum(sl.vals.astype(adt) * xg.astype(adt), axis=1)  # (n_rb, rb)
    return y.reshape(-1)[:n_rows]


# --- SlabPack: per-block-class buckets (see formats/slab.py) -----------------

def _slab_pack_combine(pack: SlabPack, part_ys) -> jax.Array:
    """Recombine per-part block rows by the static block permutation."""
    rb = pack.row_block
    ids_concat = np.concatenate(
        [np.asarray(ids, np.int64) for ids in pack.block_ids])
    inv = np.argsort(ids_concat)
    Y = jnp.concatenate([y.reshape(-1, rb) for y in part_ys], axis=0)
    return Y[jnp.asarray(inv)].reshape(-1)[: pack.shape[0]]


def slab_pack_spmv_xla(pack: SlabPack, x: jax.Array) -> jax.Array:
    """SpMV on the format's own arrays (its only device path)."""
    ys = [slab_spmv_xla(p, x) for p in pack.parts]
    y = _slab_pack_combine(pack, ys)
    if pack.overflow is not None:
        y = y + slab_pack_spmv_xla(pack.overflow, x)
    return y


# --- SlabStream: flat chunk stream, per-(block, window)-exact heights --------

def slab_stream_spmv_xla(st: SlabStream, x: jax.Array) -> jax.Array:
    """SpMV on the format's own arrays: a per-slot gather, then one
    scatter-add of the chunk sums into their row blocks."""
    n_rows = st.shape[0]
    rb = st.row_block
    adt = accum_dtype(jnp.result_type(st.vals.dtype, x.dtype))
    n_win = st.x_windows()
    lane_cols = (st.win_id[:, None, None] * SLAB_WINDOW
                 + st.lidx.astype(jnp.int32))               # (N, 8, RB)
    xp = jnp.pad(x.astype(adt), (0, n_win * SLAB_WINDOW - x.shape[0]))
    prod = st.vals.astype(adt) * xp[lane_cols]
    contrib = prod.sum(axis=1)                              # (N, RB)
    n_rb = st.n_row_blocks
    y = jnp.zeros((n_rb + 1, rb), adt)
    y = y.at[jnp.minimum(st.blk_id, n_rb)].add(contrib)
    return y[:n_rb].reshape(-1)[:n_rows]
