"""Shared machinery for frozen sparse formats.

The reference's central abstraction is the ``SparseMatrix`` trait
(reference: src/sparsematrix.rs:62-339): associated Value/Index types, a row
iterator, and shared default algorithms.  This redesign splits that
into (a) *frozen, immutable, pytree-registered* format classes here — safe to
pass through jit/pjit/shard_map — and (b) functional ops in
``sparsemat_tpu.ops`` written once against the COO/CSR canonical views, which
every format can produce (≈ the trait-default algorithms written once against
``iter_row``).

Padding convention (replaces linked-list UNSET chains, src/indexlist.rs:33):
structure arrays may carry *tail padding* so that array sizes stay static
under XLA.  A padded entry has ``row == n_rows`` (one past the last row —
dropped by XLA scatter semantics), ``col == 0`` (clamp-safe gather) and
``val == 0`` (harmless in accumulation).  Host-side ``prune()`` compacts.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..types import accum_dtype, compute_index_dtype

Shape = Tuple[int, int]


def register_format(cls):
    """Register a format dataclass as a JAX pytree (arrays = children,
    ``shape`` & friends = static aux data)."""
    data_fields = [f.name for f in dataclasses.fields(cls) if f.metadata.get("pytree_node", True)]
    meta_fields = [f.name for f in dataclasses.fields(cls) if not f.metadata.get("pytree_node", True)]
    jax.tree_util.register_dataclass(cls, data_fields=data_fields, meta_fields=meta_fields)
    return cls


def array_field():
    return dataclasses.field(metadata={"pytree_node": True})


def static_field(**kwargs):
    return dataclasses.field(metadata={"pytree_node": False}, **kwargs)


class SparseFormat:
    """Mixin providing the operator surface the reference stamps out with its
    ``sparsemat_ops!`` macro (src/sparsematrix.rs:370-445): + - * scalar, and
    ``A @ x`` = SpMV / ``A @ B`` = SpMM."""

    shape: Shape

    # -- host-side array cache -----------------------------------------------
    # Every device→host readback waits for the device and copies, so format
    # constructors that already hold host buffers stash them here and every
    # host-side freeze/convert path reads through host().
    def _stash_host(self, **arrays) -> "SparseFormat":
        object.__setattr__(
            self, "_host_cache", {k: np.asarray(v) for k, v in arrays.items()})
        return self

    def host(self, name: str) -> np.ndarray:
        """Field ``name`` as a numpy array, cached across calls."""
        cache = getattr(self, "_host_cache", None)
        if cache is None:
            cache = {}
            object.__setattr__(self, "_host_cache", cache)
        if name not in cache:
            cache[name] = np.asarray(getattr(self, name))
        return cache[name]

    # -- canonical views (each concrete class overrides what it can) --------
    def to_coo(self):
        raise NotImplementedError

    def to_csr(self):
        raise NotImplementedError

    def to_ell(self, n_cols_per_row: int | None = None):
        return self.to_csr().to_ell(n_cols_per_row=n_cols_per_row)

    def to_sell(self, slice_height: int = 8):
        from .sell import SELL

        return SELL.from_csr(self.to_csr(), slice_height=slice_height)

    def to_strip(self, n_classes: int = 32, group: int = 16,
                 lidx_pack: int = 4):
        from .strip import StripELL

        return StripELL.from_csr(self.to_csr(), n_classes=n_classes,
                                 group=group, lidx_pack=lidx_pack)

    def to_dia(self):
        from .dia import DIA

        return DIA.from_csr(self.to_csr())

    def to_well(self, k_tile: int | None = None):
        from .well import WELL

        return WELL.from_csr(self.to_csr(), k_tile=k_tile)

    def to_slab(self, rb: int | None = None):
        from .slab import SLAB_ROW_BLOCK, SlabELL

        return SlabELL.from_csr(self.to_csr(), rb=rb or SLAB_ROW_BLOCK)

    def to_slab_pack(self, rb: int | None = None, n_classes: int = 8):
        from .slab import SLAB_ROW_BLOCK, SlabPack

        return SlabPack.from_csr(self.to_csr(), rb=rb or SLAB_ROW_BLOCK,
                                 n_classes=n_classes)

    def to_gell(self, k0: int | None = None):
        from .gell import GELL

        return GELL.from_csr(self.to_csr(), k0=k0)

    def to_slab_stream(self, rb: int | None = None):
        from .slab import SLAB_ROW_BLOCK, SlabStream

        return SlabStream.from_csr(self.to_csr(), rb=rb or SLAB_ROW_BLOCK)

    def to_route(self):
        from .route import RouteStream

        return RouteStream.from_csr(self.to_csr())

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def dtype(self):
        return self.data.dtype  # type: ignore[attr-defined]

    @property
    def index_dtype(self):
        raise NotImplementedError

    # -- algebra (dispatches into ops; imported lazily to avoid cycles) -----
    def __matmul__(self, other):
        from .. import ops

        if isinstance(other, SparseFormat):
            return ops.spgemm(self, other)
        other = jnp.asarray(other)
        if other.ndim == 1:
            return ops.spmv(self, other)
        elif other.ndim == 2:
            return ops.spmm(self, other)
        raise ValueError(f"cannot multiply sparse matrix by array of rank {other.ndim}")

    def mvp(self, x):
        """SpMV — name kept from the reference (src/sparsematrix.rs:146)."""
        from .. import ops

        return ops.spmv(self, jnp.asarray(x))

    def __add__(self, other):
        from .. import ops

        return ops.add(self, other)

    def __sub__(self, other):
        from .. import ops

        return ops.sub(self, other)

    def __mul__(self, scalar):
        return self.scale(scalar)

    def __rmul__(self, scalar):
        return self.scale(scalar)

    def scale(self, scalar):
        """Scale all stored values (≈ SparseMatrix::scale, src/sparsematrix.rs:117)."""
        raise NotImplementedError

    @property
    def T(self):
        from .. import ops

        return ops.transpose(self)

    def transpose(self):
        from .. import ops

        return ops.transpose(self)

    def inner_prod(self, l, r):
        """Bilinear form lᵀ A r (≈ src/sparsematrix.rs:161-171)."""
        from .. import ops

        return ops.inner_prod(self, l, r)

    def astype(self, dtype) -> "SparseFormat":
        """Same structure, values cast to ``dtype`` (floating arrays only —
        index/bookkeeping arrays keep their integer types).  The
        analogue of re-instantiating the reference's generics at another
        <T> (src/types.rs:54-68); used by mixed-precision solvers."""
        dtype = jnp.dtype(dtype)
        updates = {}
        for f in dataclasses.fields(self):  # type: ignore[arg-type]
            if not f.metadata.get("pytree_node", True):
                continue
            arr = getattr(self, f.name)
            if arr is not None and jnp.issubdtype(arr.dtype, jnp.floating):
                updates[f.name] = arr.astype(dtype)
        return dataclasses.replace(self, **updates)  # type: ignore[type-var]

    # -- performance model ---------------------------------------------------
    #: array fields the SpMV hot path actually streams from HBM; None means
    #: "all array fields".  Formats override to exclude bookkeeping arrays
    #: (e.g. CSR.indptr, WELL.row_cnt) the kernel never touches.
    _spmv_read_fields: Tuple[str, ...] | None = None

    def spmv_traffic_bytes(self) -> int:
        """Layout speed-of-light HBM bytes for ONE SpMV on this frozen
        layout: every array the kernel must stream (padding slots included —
        they are part of the layout), read exactly once, plus x read once
        and y written once.

        This is a true LOWER bound for any kernel operating on this layout
        (halo overlap, re-reads, and scatter read-modify-write only add to
        it), so a roofline fraction computed against it cannot exceed 1 for
        an honest measurement — the number bench.py reports as
        "fraction of speed-of-light"."""
        fields = self._spmv_read_fields
        if fields is None:
            fields = tuple(
                f.name for f in dataclasses.fields(self)  # type: ignore[arg-type]
                if f.metadata.get("pytree_node", True))
        total = 0
        for name in fields:
            arr = getattr(self, name)
            if arr is not None:
                total += arr.size * jnp.dtype(arr.dtype).itemsize
        x_bytes = self.shape[1] * jnp.dtype(self.dtype).itemsize
        y_bytes = self.shape[0] * jnp.dtype(accum_dtype(self.dtype)).itemsize
        return int(total + x_bytes + y_bytes)

    # -- structure queries --------------------------------------------------
    @property
    def nse(self) -> int:
        """Static number of stored entry *slots* (incl. tail padding)."""
        raise NotImplementedError

    def n_non_zero_entries(self):
        """Number of stored (non-padding) entries — may be a traced scalar if
        the matrix carries padding (≈ src/sparsematrix.rs:103)."""
        raise NotImplementedError

    def density(self):
        """Stored entries / (n_rows * n_cols) (≈ src/sparsematrix.rs:237-241)."""
        n = self.n_non_zero_entries()
        return n / float(self.n_rows * self.n_cols)

    def sparsity(self):
        """1 - density (≈ src/sparsematrix.rs:244-246)."""
        return 1.0 - self.density()

    def todense(self) -> jax.Array:
        coo = self.to_coo()
        out = jnp.zeros(self.shape, dtype=self.dtype)
        valid = coo.rows.astype(jnp.int32) < self.shape[0]
        r = jnp.where(valid, coo.rows.astype(jnp.int32), self.shape[0])
        v = jnp.where(valid, coo.vals, 0)
        return out.at[r, coo.cols.astype(jnp.int32)].add(v, mode="drop")

    def __iter__(self):
        """Whole-matrix (row, col, val) iterator, row-major, skipping empty
        rows (≈ the trait's ``Iter``, src/sparsematrix.rs:28-59, whose
        ``next`` advances past rows with no entries).  Canonical
        column-sorted order within each row.  Host-side convenience."""
        csr = self.to_csr()
        indptr = csr.host("indptr")
        indices = csr.host("indices")
        data = csr.host("data")
        for i in range(csr.n_rows):
            for p in range(int(indptr[i]), int(indptr[i + 1])):
                yield i, int(indices[p]), data[p]

    def get(self, i: int, j: int):
        """Point lookup A[i, j], 0 if absent (≈ SparseMatrix::get,
        src/sparsematrix.rs:106-110).  Host-side convenience — O(nse)."""
        coo = self.to_coo()
        r = np.asarray(coo.rows)
        c = np.asarray(coo.cols)
        v = np.asarray(coo.vals)
        hit = (r == i) & (c == j)
        return v[hit].sum() if hit.any() else v.dtype.type(0)

    def __getitem__(self, ij):
        i, j = ij
        return self.get(i, j)

    def __repr__(self) -> str:
        return (
            f"{type(self).__name__}(shape={self.shape}, nse={self.nse}, "
            f"dtype={np.dtype(self.dtype)})"
        )


# --- canonicalization helpers (jittable) ------------------------------------


def sort_coo(rows, cols, vals, shape: Shape):
    """Sort COO triplets into canonical row-major, column-sorted order.

    Replaces the reference's per-row ``Sortable::sort_row`` chain rewrites
    (src/sparsemat_indexlist.rs:102-109) with ONE device-wide multi-operand
    ``lax.sort``: (row, col) are lexicographic keys, values ride as payload.
    This needs no 64-bit fused key (immune to the int32 key overflow the
    earlier formulation had to dodge) and needs one sort instead of an
    argsort plus gathers — sorts dominate SpGEMM, so this is a hot path.  Padding entries (row == n_rows) sort to the tail."""
    r, c, v = jax.lax.sort(
        (rows.astype(jnp.int32), cols.astype(jnp.int32), vals), num_keys=2)
    return r.astype(rows.dtype), c.astype(cols.dtype), v


def dedup_sorted_coo(rows, cols, vals, shape: Shape):
    """Sum duplicate coordinates in a *sorted* COO stream, keeping array sizes
    static: survivors are compacted to the front, vacated slots become tail
    padding (row = n_rows, col = 0, val = 0).

    This is the batch equivalent of the reference's insert-time dedup
    (``get_mut`` find-or-insert, src/sparsemat_indexlist.rs:158-164).
    Returns (rows, cols, vals, n_unique) with n_unique a traced scalar.
    """
    n_rows, n_cols = shape
    nse = rows.shape[0]
    if nse == 0:
        return rows, cols, vals, jnp.zeros((), jnp.int32)
    cdt = compute_index_dtype(rows.dtype)
    r = rows.astype(cdt)
    c = cols.astype(cdt)
    is_pad = r >= n_rows
    same = (r == jnp.roll(r, 1)) & (c == jnp.roll(c, 1))
    same = same.at[0].set(False)
    # group id per unique coordinate (padding collapses into one trailing group)
    new_group = ~same
    gid = jnp.cumsum(new_group.astype(jnp.int32)) - 1
    summed = jax.ops.segment_sum(
        vals.astype(accum_dtype(vals.dtype)), gid, num_segments=nse
    ).astype(vals.dtype)
    # first slot of each group supplies the coordinates
    first_idx = jnp.where(new_group, jnp.arange(nse), nse - 1)
    first_of_group = jax.ops.segment_min(first_idx, gid, num_segments=nse)
    n_groups = gid[-1] + 1
    slot = jnp.arange(nse)
    valid_group = slot < n_groups
    gr = jnp.where(valid_group, r[jnp.clip(first_of_group, 0, nse - 1)], n_rows)
    gc = jnp.where(valid_group, c[jnp.clip(first_of_group, 0, nse - 1)], 0)
    gpad = gr >= n_rows
    out_rows = jnp.where(gpad, n_rows, gr).astype(rows.dtype)
    out_cols = jnp.where(gpad, 0, gc).astype(cols.dtype)
    out_vals = jnp.where(gpad, 0, summed)
    n_unique = jnp.sum((~gpad) & valid_group).astype(jnp.int32)
    return out_rows, out_cols, out_vals, n_unique


def rows_to_indptr(rows, n_rows: int, index_dtype=None):
    """Row ids (sorted) → CSR indptr via bincount+cumsum (the device
    replacement for the reference's offset bookkeeping,
    src/sparsemat_crs.rs:24-50)."""
    cdt = compute_index_dtype(rows.dtype)
    counts = jnp.bincount(
        jnp.clip(rows.astype(cdt), 0, n_rows), length=n_rows + 1
    )[:n_rows]  # padding rows (== n_rows) fall in the dropped tail bucket
    indptr = jnp.concatenate([jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)])
    return indptr.astype(index_dtype if index_dtype is not None else cdt)


def indptr_to_rows(indptr, nse: int, index_dtype=None):
    """CSR indptr → per-entry row ids (searchsorted; padding tail → n_rows)."""
    n_rows = indptr.shape[0] - 1
    idt = index_dtype if index_dtype is not None else indptr.dtype
    pos = jnp.arange(nse)
    row_ids = jnp.searchsorted(indptr[1:], pos, side="right")
    row_ids = jnp.where(pos < indptr[-1], row_ids, n_rows)
    return row_ids.astype(idt)
