"""BSR — block-sparse rows: the blocked format for SpMM.

No reference counterpart (the reference's SpGEMM/SpMM story is a serial
dense column sweep, src/sparsematrix.rs:186-210).  BSR stores the nonzero
(BR × BC) blocks of the matrix densely, so ``Y = A @ B`` becomes one dense
(BR × BC)·(BC × m) product per stored block — a single batched matmul —
with no per-entry gather in the inner loop.  The win over the gather-based
ELL/CSR SpMM paths grows with block density; for matrices with genuine
block structure (FEM, multi-DOF meshes — e.g. the SuiteSparse pwtk/cant
configs in BASELINE.md) this is the fastest path.

Layout:
* ``blocks``:     (T, BR, BC) dense values (zero-filled);
* ``block_rows``: (T,) block-row id per tile, sorted ascending;
* ``block_cols``: (T,) block-column id per tile.

BR defaults to 8 and BC to 128; block shapes are multiples of (8, 128).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .base import SparseFormat, array_field, register_format, static_field

BLOCK_ROWS = 8     # f32 sublane count
BLOCK_COLS = 128   # lane count


@register_format
@dataclasses.dataclass(frozen=True)
class BSR(SparseFormat):
    """Frozen block-sparse-row matrix (host-built)."""

    blocks: jax.Array = array_field()
    block_rows: jax.Array = array_field()
    block_cols: jax.Array = array_field()
    #: (T, BR, BC) bool occupancy — distinguishes explicitly-stored zeros
    #: from block padding on round-trip (≈ get_mut zero-insert contract,
    #: src/sparsematrix.rs:112-114).  None ⇒ fall back to ``val != 0``.
    occ: jax.Array | None = array_field()
    shape: Tuple[int, int] = static_field()

    @classmethod
    def from_csr(cls, csr, br: int = BLOCK_ROWS, bc: int = BLOCK_COLS) -> "BSR":
        """Host-side freeze: bucket entries into (br × bc) blocks, keep the
        nonempty ones.  Every block-row gets ≥1 tile (all-zero if needed)."""
        if br % 8 or bc % 128:
            raise ValueError(f"block shape ({br},{bc}) must be (8k, 128k) "
                             "(multiples of (8, 128))")
        n_rows, n_cols = csr.shape
        indptr = csr.host("indptr").astype(np.int64)
        indices = csr.host("indices").astype(np.int64)
        data = csr.host("data")
        nnz = int(indptr[-1])
        rows = np.repeat(np.arange(n_rows, dtype=np.int64), np.diff(indptr))[:nnz]
        cols = indices[:nnz]
        vals = data[:nnz]

        brow = rows // br
        bcol = cols // bc
        n_bc = max(-(-n_cols // bc), 1)
        key = brow * n_bc + bcol
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        start = np.ones(nnz, bool)
        start[1:] = key_s[1:] != key_s[:-1]
        tid = np.cumsum(start) - 1
        n_tiles = int(tid[-1]) + 1 if nnz else 0

        blocks = np.zeros((max(n_tiles, 1), br, bc), data.dtype)
        occ = np.zeros((max(n_tiles, 1), br, bc), bool)
        t_rows = np.zeros(max(n_tiles, 1), np.int32)
        t_cols = np.zeros(max(n_tiles, 1), np.int32)
        if nnz:
            blocks[tid, (rows[order] % br), (cols[order] % bc)] = vals[order]
            occ[tid, (rows[order] % br), (cols[order] % bc)] = True
            t_rows[tid] = (brow[order]).astype(np.int32)
            t_cols[tid] = (bcol[order]).astype(np.int32)

        # dummy tiles for empty block-rows, so every block row has a tile
        n_br = max(-(-n_rows // br), 1)
        present = np.zeros(n_br, bool)
        if nnz:
            present[t_rows[:n_tiles]] = True
        else:
            n_tiles = 0
        missing = np.flatnonzero(~present).astype(np.int32)
        if missing.size:
            blocks = np.concatenate(
                [blocks[:n_tiles], np.zeros((missing.size, br, bc), data.dtype)])
            occ = np.concatenate(
                [occ[:n_tiles], np.zeros((missing.size, br, bc), bool)])
            t_rows = np.concatenate([t_rows[:n_tiles], missing])
            t_cols = np.concatenate([t_cols[:n_tiles],
                                     np.zeros(missing.size, np.int32)])
            order2 = np.argsort(t_rows, kind="stable")
            blocks, occ, t_rows, t_cols = (blocks[order2], occ[order2],
                                           t_rows[order2], t_cols[order2])
        return cls(blocks=jnp.asarray(blocks), block_rows=jnp.asarray(t_rows),
                   block_cols=jnp.asarray(t_cols), occ=jnp.asarray(occ),
                   shape=(n_rows, n_cols))

    @classmethod
    def from_coo(cls, coo, br: int = BLOCK_ROWS, bc: int = BLOCK_COLS) -> "BSR":
        return cls.from_csr(coo.to_csr(), br=br, bc=bc)

    @classmethod
    def from_csr_device(cls, csr, br: int = BLOCK_ROWS,
                        bc: int = BLOCK_COLS) -> "BSR":
        """Device-side freeze for large / low-fill matrices.

        The host computes only O(nnz) integer bookkeeping (tile ids and
        per-entry slot indices); the dense (T, br, bc) block array — which
        for low-fill matrices is 10-100× larger than the CSR itself — is
        materialized by ONE device scatter instead of being built in host
        RAM and copied to the device.  ``occ`` is
        not built (round-trip then treats explicit zeros as absent, fine
        for the compute path).  Values come from ``csr.data`` already on
        device."""
        if br % 8 or bc % 128:
            raise ValueError(f"block shape ({br},{bc}) must be (8k, 128k) "
                             "(multiples of (8, 128))")
        n_rows, n_cols = csr.shape
        indptr = csr.host("indptr").astype(np.int64)
        indices = csr.host("indices").astype(np.int64)
        nnz = int(indptr[-1])
        rows = np.repeat(np.arange(n_rows, dtype=np.int64),
                         np.diff(indptr))[:nnz]
        cols = indices[:nnz]
        brow = rows // br
        bcol = cols // bc
        n_bc = max(-(-n_cols // bc), 1)
        key = brow * n_bc + bcol
        order = np.argsort(key, kind="stable")
        key_s = key[order]
        start = np.ones(nnz, bool)
        if nnz:
            start[1:] = key_s[1:] != key_s[:-1]
        tid = np.cumsum(start) - 1 if nnz else np.zeros(0, np.int64)
        n_tiles = int(tid[-1]) + 1 if nnz else 0
        firsts = np.flatnonzero(start) if nnz else np.zeros(0, np.int64)
        t_rows = (key_s[firsts] // n_bc).astype(np.int32)
        t_cols = (key_s[firsts] % n_bc).astype(np.int32)

        # dummy all-zero tiles for empty block-rows, then a stable sort by
        # block row (the SpMM kernel requires block_rows ascending)
        n_br = max(-(-n_rows // br), 1)
        present = np.zeros(n_br, bool)
        present[t_rows] = True
        missing = np.flatnonzero(~present).astype(np.int32)
        t_rows_all = np.concatenate([t_rows, missing])
        t_cols_all = np.concatenate([t_cols,
                                     np.zeros(missing.size, np.int32)])
        order2 = np.argsort(t_rows_all, kind="stable")
        inv2 = np.empty_like(order2)
        inv2[order2] = np.arange(order2.size)
        t_rows_all = t_rows_all[order2]
        t_cols_all = t_cols_all[order2]
        n_all = n_tiles + missing.size

        pos = inv2[tid] if nnz else tid  # tile slot after the final sort
        lin = (pos * (br * bc) + (rows[order] % br) * bc
               + (cols[order] % bc))
        lin_dtype = np.int32 if n_all * br * bc < (1 << 31) else np.int64
        flat = jnp.zeros((max(n_all, 1) * br * bc,), csr.data.dtype)
        if nnz:
            vals_sorted = jnp.asarray(csr.data)[jnp.asarray(
                order.astype(np.int32 if nnz < (1 << 31) else np.int64))]
            flat = flat.at[jnp.asarray(lin.astype(lin_dtype))].set(vals_sorted)
        blocks = flat.reshape(max(n_all, 1), br, bc)
        out = cls(blocks=blocks, block_rows=jnp.asarray(t_rows_all),
                  block_cols=jnp.asarray(t_cols_all), occ=None,
                  shape=(n_rows, n_cols))
        out._stash_host(block_rows=t_rows_all, block_cols=t_cols_all)
        return out

    # -- canonical views ------------------------------------------------------
    def to_coo(self):
        from .coo import COO

        t, br, bc = self.blocks.shape
        rows = (self.block_rows[:, None, None].astype(jnp.int32) * br
                + jnp.arange(br, dtype=jnp.int32)[None, :, None])
        cols = (self.block_cols[:, None, None].astype(jnp.int32) * bc
                + jnp.arange(bc, dtype=jnp.int32)[None, None, :])
        rows = jnp.broadcast_to(rows, self.blocks.shape).reshape(-1)
        cols = jnp.broadcast_to(cols, self.blocks.shape).reshape(-1)
        vals = self.blocks.reshape(-1)
        stored = (self.occ.reshape(-1) if self.occ is not None else vals != 0)
        n_rows = self.shape[0]
        return COO(rows=jnp.where(stored, rows, n_rows),
                   cols=jnp.where(stored, cols, 0),
                   vals=jnp.where(stored, vals, 0),
                   shape=self.shape, canonical=False)

    def to_csr(self):
        return self.to_coo().to_csr()

    # -- structure --------------------------------------------------------------
    @property
    def nse(self) -> int:
        return int(np.prod(self.blocks.shape))

    @property
    def n_tiles(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def br(self) -> int:
        return int(self.blocks.shape[1])

    @property
    def bc(self) -> int:
        return int(self.blocks.shape[2])

    @property
    def index_dtype(self):
        return jnp.dtype(jnp.int32)

    @property
    def data(self):
        return self.blocks

    def n_non_zero_entries(self):
        if self.occ is not None:
            return jnp.sum(self.occ).astype(jnp.int32)
        return jnp.sum(self.blocks != 0).astype(jnp.int32)

    def scale(self, scalar) -> "BSR":
        return dataclasses.replace(
            self, blocks=self.blocks * jnp.asarray(scalar, self.blocks.dtype))

    def fill_ratio(self) -> float:
        """Stored / padded slots — dispatch metric: BSR wins when blocks are
        dense enough that the matmul FLOPs aren't wasted on zeros."""
        n = int(np.asarray(self.n_non_zero_entries()))
        return n / max(self.nse, 1)
