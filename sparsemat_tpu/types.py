"""Dtype and index-width policy for sparsemat_tpu.

Equivalent of the reference's compile-time generic type layer
(reference: src/types.rs:14-77 — ``IndexType`` with MAX/ZERO/ONE constants and
usize conversions, ``ValueType`` blanket numeric trait, ``FloatType`` marker
gating solvers).  The natural device index width is int32; narrower
widths (int8/int16) are supported as *storage* dtypes that are widened to
int32 at compute time, mirroring the reference's u8..u64 index generics.

The reference uses ``Index::MAX`` as an UNSET sentinel terminating index-list
chains (src/indexlist.rs:33, src/sparsematrix.rs:68).  The frozen formats
have no chains; UNSET survives only as the padding marker exported by the
assembly builder and in ELL padding masks.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp
import numpy as np

# --- index dtypes -----------------------------------------------------------

#: Index dtypes accepted for sparse structure arrays (≈ IndexType impls,
#: reference src/types.rs:47-51).  int64 requires jax_enable_x64.
INDEX_DTYPES = (jnp.int8, jnp.int16, jnp.int32, jnp.int64)

#: Default index dtype — the device's native integer width for indexing.
DEFAULT_INDEX_DTYPE = jnp.int32

#: Value dtypes (≈ ValueType, reference src/types.rs:54-68).
VALUE_DTYPES = (
    jnp.float32,
    jnp.float64,
    jnp.bfloat16,
    jnp.float16,
    jnp.int8,
    jnp.int16,
    jnp.int32,
    jnp.int64,
)

#: Float dtypes allowed in iterative solvers (≈ FloatType marker,
#: reference src/types.rs:70-77 — f32/f64 only; we additionally admit
#: bfloat16 storage with float32 accumulation).
FLOAT_DTYPES = (jnp.float32, jnp.float64, jnp.bfloat16, jnp.float16)


def unset_value(index_dtype: Any) -> int:
    """UNSET sentinel for an index dtype = its max value.

    Mirrors ``SparseMatrix::UNSET = Index::MAX`` (reference
    src/sparsematrix.rs:68, src/indexlist.rs:33).
    """
    return int(np.iinfo(np.dtype(index_dtype)).max)


def check_index_dtype(index_dtype: Any) -> Any:
    dt = jnp.dtype(index_dtype)
    if dt not in [jnp.dtype(d) for d in INDEX_DTYPES]:
        raise TypeError(f"unsupported index dtype {dt}; expected one of {INDEX_DTYPES}")
    return dt


def check_value_dtype(dtype: Any) -> Any:
    dt = jnp.dtype(dtype)
    if dt not in [jnp.dtype(d) for d in VALUE_DTYPES]:
        raise TypeError(f"unsupported value dtype {dt}; expected one of {VALUE_DTYPES}")
    return dt


def is_float_dtype(dtype: Any) -> bool:
    return jnp.dtype(dtype) in [jnp.dtype(d) for d in FLOAT_DTYPES]


def compute_index_dtype(index_dtype: Any) -> Any:
    """Widen a storage index dtype to the compute width (int32+)."""
    dt = jnp.dtype(index_dtype)
    if dt.itemsize < 4:
        return jnp.dtype(jnp.int32)
    return dt


def accum_dtype(dtype: Any) -> Any:
    """Accumulation dtype for reductions: low-precision floats accumulate in f32.

    Low-precision floats accumulate in float32; float64 stays float64 (requires
    jax_enable_x64 — reference solvers are f64, src/lib.rs:38).
    """
    dt = jnp.dtype(dtype)
    if dt in (jnp.dtype(jnp.bfloat16), jnp.dtype(jnp.float16)):
        return jnp.dtype(jnp.float32)
    return dt


@dataclasses.dataclass(frozen=True)
class TypePolicy:
    """Bundle of (value dtype, index storage dtype) — ≈ the reference's
    ``<T, I>`` generic parameter pair that every format carries
    (e.g. src/sparsemat_crs.rs:9 ``SparseMatCRS<T, I>``)."""

    dtype: Any = jnp.float32
    index_dtype: Any = DEFAULT_INDEX_DTYPE

    def __post_init__(self):
        object.__setattr__(self, "dtype", check_value_dtype(self.dtype))
        object.__setattr__(self, "index_dtype", check_index_dtype(self.index_dtype))

    @property
    def unset(self) -> int:
        return unset_value(self.index_dtype)


DEFAULT_POLICY = TypePolicy()
