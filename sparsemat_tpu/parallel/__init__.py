"""Multi-chip distribution layer.

The realized version of the reference's parallelism story: ``SparseMatPar``
partitions rows into blocks but its threaded SpMV was never finished
(reference: src/sparsemat_par.rs:37-68 — commented-out std::thread + mpsc
sketch whose gather is incomplete).  Here the same 1-D block-row
decomposition (sparsemat_par.rs:20-35) maps onto a ``jax.sharding.Mesh``:

* matrices are stored with a leading block axis sharded over the mesh
  (``DistDIA`` / ``DistCSR`` / ``DistELL``);
* SpMV runs under ``shard_map`` — banded matrices exchange halo edges with
  neighbor chips via ``lax.ppermute`` (neighbor traffic only), general
  matrices ``all_gather`` the operand vector;
* solver dot products reduce with ``lax.psum`` — the completed version of
  the mpsc gather the reference never wrote;
* the same ``solvers.cg`` code runs distributed by passing the distributed
  matvec and sharded vectors.
"""

from .dist import (DistCSR, DistCSRSubset, DistDIA, DistELL, DistSlab,
                   dist_csr_spmv, dist_csr_subset_spmv, dist_dia_spmv,
                   dist_ell_spmv, dist_slab_spmv, distribute_csr,
                   distribute_csr_subset, distribute_dia, distribute_slab)
from .mesh import make_mesh, row_sharding
from .multihost import (init_distributed, make_host_mesh, make_mesh_2d,
                        process_info)

__all__ = [
    "DistDIA", "DistCSR", "DistCSRSubset", "DistELL", "DistSlab",
    "distribute_dia", "distribute_csr", "distribute_csr_subset",
    "distribute_slab",
    "dist_dia_spmv", "dist_csr_spmv", "dist_csr_subset_spmv",
    "dist_ell_spmv", "dist_slab_spmv",
    "make_mesh", "row_sharding",
    "init_distributed", "make_host_mesh", "make_mesh_2d", "process_info",
]
