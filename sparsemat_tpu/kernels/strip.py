"""StripELL SpMV (see formats/strip.py) in plain ``jax.numpy``.

Each class part is a (blocks, strips, 128) rectangle of values and
window-relative column ids; the SpMV gathers x at the absolute columns,
sums over strips, and puts the part's 128-row block results back in matrix
row order by one static permutation.  Replaces the reference's serial row
loop (src/sparsematrix.rs:146-158) in the bounded-span scattered regime.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.strip import WINDOW, StripELL
from ..types import accum_dtype


def _combine(st: StripELL, part_ys) -> jax.Array:
    """Static block-granular recombination (cf. SlabPack's combine)."""
    ids = np.concatenate([np.asarray(p.block_ids, np.int64)
                          for p in st.parts])
    inv = np.argsort(ids)
    Y = jnp.concatenate(part_ys, axis=0)
    return Y[jnp.asarray(inv)].reshape(-1)[: st.shape[0]]


def strip_spmv_xla(st: StripELL, x: jax.Array) -> jax.Array:
    """y = A @ x over the strip parts."""
    adt = accum_dtype(jnp.result_type(st.dtype, x.dtype))
    ys = []
    for p in st.parts:
        cols = (p.abs_windows()[:, :, None] * WINDOW
                + p.lidx_unpacked())
        xg = x.astype(adt).at[cols].get(mode="fill", fill_value=0)
        ys.append(jnp.sum(p.vals.astype(adt) * xg, axis=1))   # (nb, 128)
    return _combine(st, ys)
