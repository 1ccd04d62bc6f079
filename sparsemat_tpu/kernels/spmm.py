"""BSR SpMM: Y = A @ B with block-sparse A and dense B.

The reference's only multiply-by-matrix is the serial SpGEMM sweep
(src/sparsematrix.rs:186-210); dense-operand SpMM has no counterpart.
Every stored (BR × BC) block of A contracts against the (BC × m) row band
of B its block column selects: one batched einsum, which XLA hands to the
GPU's matrix library, then a scatter-add of the (T, BR, m) partial
products into their block rows.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..formats.bsr import BSR
from ..types import accum_dtype


def _pad_rows(arr: jax.Array, multiple: int) -> jax.Array:
    pad = -arr.shape[0] % multiple
    if pad:
        arr = jnp.pad(arr, ((0, pad), (0, 0)))
    return arr


def bsr_spmm_xla(bsr: BSR, B: jax.Array) -> jax.Array:
    """Y = A @ B.  ``Precision.HIGHEST`` keeps the contraction in true f32:
    the default lets a float32 product run in TF32 (~1e-3 relative error),
    which is wrong for a solver library."""
    n_rows, n_cols = bsr.shape
    br, bc = bsr.br, bsr.bc
    adt = accum_dtype(jnp.result_type(bsr.blocks.dtype, B.dtype))
    Bp = _pad_rows(B.astype(adt), bc)
    Bb = Bp.reshape(-1, bc, B.shape[1])                       # (Kb, bc, m)
    gathered = Bb.at[bsr.block_cols].get(mode="fill", fill_value=0)
    partial = jnp.einsum("tij,tjk->tik", bsr.blocks.astype(adt), gathered,
                         preferred_element_type=adt,
                         precision=jax.lax.Precision.HIGHEST)  # (T, br, m)
    n_rb = -(-n_rows // br)
    Y = jnp.zeros((n_rb, br, B.shape[1]), adt)
    Y = Y.at[bsr.block_rows].add(partial, mode="drop")
    return Y.reshape(-1, B.shape[1])[:n_rows]
