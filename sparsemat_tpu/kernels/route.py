"""RouteStream SpMV (see formats/route.py) in plain ``jax.numpy``/``lax``.

``route_spmv_xla`` replays the freeze-time routing tables: window gathers
and products in A-slot order, the three-phase static permutation
(take_along / transpose / take_along) into staging rows, then a per-region
segmented reduce (a triangular-matmul prefix sum and two extractions) into
the output windows — ``lax.scan`` over supertiles and regions, so the
compiled program stays O(1) in the matrix size.

Replaces the reference's serial row loop (src/sparsematrix.rs:146-158)
for the globally scattered regime.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..formats.route import LANE, REG_ROWS, SUP_ROWS, RouteStream
from ..types import accum_dtype

#: upper-triangular ones — prefix[l] = sum_{l' <= l} p[l'] as one matmul
_TRI = np.triu(np.ones((LANE, LANE), np.float32))


def _x_windows(rs: RouteStream, x: jax.Array, adt):
    n_win = rs.x_windows()
    xp = jnp.pad(x.astype(adt), (0, n_win * LANE - x.shape[0]))
    return xp.reshape(n_win, LANE)


def route_spmv_xla(rs: RouteStream, x: jax.Array) -> jax.Array:
    """y = A @ x by the freeze-time routing tables."""
    adt = accum_dtype(jnp.result_type(rs.a_vals.dtype, x.dtype))
    xw = _x_windows(rs, x, adt)
    n_sup = rs.n_sup
    n_spl = rs.n_splits
    n_reg = rs.n_regions

    # phase A: products in A-slot order
    xrow = xw[rs.a_win]                                    # (n_arows, 128)
    g = jnp.take_along_axis(xrow, rs.a_lidx, axis=1)
    prod = rs.a_vals.astype(adt) * g                       # (n_arows, 128)
    blocks = prod.reshape(n_sup, SUP_ROWS, LANE)

    # 3-phase routing into staging
    def route_step(staging, inp):
        blk, p1t, m1t, p2t, p3t, toucht = inp
        for s in range(n_spl):
            b1 = jnp.take_along_axis(blk, p1t[s], axis=1)
            b1 = b1 * m1t[s].astype(adt)
            b3 = jnp.take_along_axis(b1.T, p2t[s], axis=1)
            b5 = jnp.take_along_axis(b3.T, p3t[s], axis=1)
            staging = staging.at[toucht[s]].add(b5)
        return staging, None

    staging0 = jnp.zeros((n_reg * REG_ROWS + SUP_ROWS, LANE), adt)
    staging, _ = jax.lax.scan(
        route_step, staging0,
        (blocks, rs.p1, rs.m1, rs.p2, rs.p3, rs.touch))

    # phase B: segmented reduce per region
    n_ywin = rs.y_windows()
    tri = jnp.asarray(_TRI, adt)

    def reduce_step(y, inp):
        blk, q1r, q2r, q3r, lp, pp, pm, sm, wr = inp
        # arrival → reduce layout (3-phase static permutation; dummy slots
        # carry zeros, no mask needed)
        b1 = jnp.take_along_axis(blk, q1r, axis=1)
        b3 = jnp.take_along_axis(b1.T, q2r, axis=1)
        blk_r = jnp.take_along_axis(b3.T, q3r, axis=1)
        prefix = jnp.dot(blk_r, tri, preferred_element_type=adt,
                         precision=jax.lax.Precision.HIGHEST)
        e1 = jnp.take_along_axis(prefix, lp, axis=1)
        e0 = jnp.take_along_axis(prefix, pp, axis=1)
        seg = (e1 - e0 * pm.astype(adt)) * sm.astype(adt)
        return y.at[wr].add(seg), None

    stag3 = staging[: n_reg * REG_ROWS].reshape(n_reg, REG_ROWS, LANE)
    y0 = jnp.zeros((n_ywin + 1, LANE), adt)
    y, _ = jax.lax.scan(reduce_step, y0,
                        (stag3, rs.q1, rs.q2, rs.q3, rs.lpos, rs.ppos,
                         rs.pmask, rs.segmask, rs.wrow))
    return y[:n_ywin].reshape(-1)[: rs.shape[0]]
