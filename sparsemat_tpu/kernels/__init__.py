"""Per-format SpMV/SpMM formulations in plain ``jax.numpy``/``lax``.

``ops.matvec`` dispatches each frozen format to the one function here that
serves it; XLA compiles them for whatever device runs the program.
"""

from .spmm import bsr_spmm_xla
from .spmv import slab_pack_spmv_xla, slab_spmv_xla, well_spmv_xla

__all__ = ["well_spmv_xla", "slab_spmv_xla", "slab_pack_spmv_xla",
           "bsr_spmm_xla"]
