"""sparsemat_tpu — a sparse linear-algebra framework in JAX.

A from-scratch rebuild of the capability surface of the ``sparsemat`` Rust
library (reference: lostinc0de/sparsemat, see SURVEY.md) redesigned for
accelerators through JAX/XLA:

* two-phase lifecycle: a mutable host-side assembly **builder** (C++-backed
  hash accumulator, ≈ SparseMatIndexList) freezes into immutable device
  **formats** (COO / CSR / ELL / SELL) registered as JAX pytrees;
* all algorithms are functional batch ops (sort / segment-scan / gather-FMA)
  that jit, vmap, and shard;
* iterative solvers (CG, Jacobi, …) as ``lax.while_loop`` programs;
* multi-device scale-out via ``jax.sharding.Mesh`` + ``shard_map`` with
  row-partitioned matrices and collective dot products (the realized version
  of the reference's commented-out thread parallelism,
  src/sparsemat_par.rs:37-68).
"""

from . import checkpoint, formats, io, ops, solvers, vectors
from .builder import PartitionedBuilder, SparseBuilder
from .solvers import (
    BiCGStab,
    BlockJacobiPreconditioner,
    ConjugateGradient,
    GMRES,
    Jacobi,
    JacobiPreconditioner,
    SolveInfo,
)
from .formats import (
    BSR, COO, CSR, DIA, ELL, GELL, SELL, WELL, RowVec, SlabELL, SlabPack,
    SlabStream, SparseFormat,
    auto_format,
)
from .ops import (
    DimensionError,
    add,
    extract_row,
    inner_prod,
    is_sorted,
    is_sorted_row,
    is_symmetric,
    rmatvec,
    spgemm,
    spmm,
    spmv,
    spmv_chain,
    spmv_dot,
    sub,
    transpose,
)
from .vectors import DenseVec, SparseVec, norm, norm_squared

__version__ = "0.1.0"

__all__ = [
    "BSR", "COO", "CSR", "DIA", "ELL", "GELL", "RowVec", "SELL", "SlabELL",
    "SlabPack", "SlabStream", "WELL",
    "SparseFormat", "auto_format",
    "SparseBuilder", "PartitionedBuilder",
    "ConjugateGradient", "Jacobi", "BiCGStab", "GMRES",
    "JacobiPreconditioner", "BlockJacobiPreconditioner",
    "SolveInfo", "solvers",
    "DimensionError",
    "spmv", "spmm", "spgemm", "rmatvec", "spmv_chain", "spmv_dot",
    "add", "sub", "transpose", "inner_prod", "is_symmetric",
    "is_sorted", "is_sorted_row", "extract_row",
    "DenseVec", "SparseVec", "norm", "norm_squared",
    "formats", "ops", "vectors", "io", "checkpoint",
]


def eye(dim: int, *, dtype=None, index_dtype=None, format: str = "csr"):
    """Identity matrix (≈ SparseMatrix::eye, src/sparsematrix.rs:92-98)."""
    import jax.numpy as jnp

    from .types import DEFAULT_INDEX_DTYPE

    kwargs = dict(dtype=dtype or jnp.float32,
                  index_dtype=index_dtype or DEFAULT_INDEX_DTYPE)
    if format == "csr":
        return CSR.eye(dim, **kwargs)
    if format == "coo":
        return COO.eye(dim, **kwargs)
    raise ValueError(f"unknown format {format!r}")


def from_dense(mat, *, format: str = "csr"):
    """Convert a dense array to a sparse format."""
    if format == "csr":
        return CSR.from_dense(mat)
    if format == "coo":
        return COO.from_dense(mat)
    raise ValueError(f"unknown format {format!r}")
