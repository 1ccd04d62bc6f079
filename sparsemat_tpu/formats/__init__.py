"""Frozen sparse formats (immutable pytrees).

Format map vs the reference (see SURVEY.md §2):

* ``COO``  ≈ the frozen snapshot of ``SparseMatIndexList``
  (src/sparsemat_indexlist.rs) — flat triplets, assembly output.
* ``CSR``  ≈ ``SparseMatCRS`` (src/sparsemat_crs.rs) — canonical compute.
* ``ELL``  — regular padded layout (no reference counterpart; replaces
  the serial row loop with vectorizable rectangles).
* ``SELL`` — sliced ELL for skewed nnz/row distributions.
* ``BSR``  — blocked rows for batched dense block matmuls (SpMM path).

The ragged ``SparseMatRowVec`` (src/sparsemat_rowvec.rs) cannot be a
static-shape *device* layout; its API parity lives in the host-side
``RowVec`` (formats/rowvec.py) which freezes to CSR/COO for compute.
"""

from .base import SparseFormat
from .bsr import BSR
from .coo import COO
from .csr import CSR
from .dia import DIA
from .ell import ELL
from .rowvec import RowVec
from .route import RouteStream
from .sell import SELL
from .gell import GELL
from .slab import SlabELL, SlabPack, SlabStream
from .strip import StripELL, StripPart
from .well import WELL

__all__ = ["SparseFormat", "BSR", "COO", "CSR", "DIA", "ELL", "GELL",
           "RouteStream", "RowVec", "SELL", "SlabELL", "SlabPack",
           "SlabStream", "StripELL", "StripPart", "WELL", "auto_format"]


def auto_format(mat, *, max_diags: int = 48):
    """Pick the compute format for a frozen matrix (host-side).

    Heuristic (≈ the per-matrix kernel dispatch SURVEY.md §7 M3 calls for),
    ordered by SpMV throughput measured on an H100 (PERF.md, bring-up):

    * few distinct diagonals → DIA (static shifted slices: one fused pass);
    * everything else → GELL, the gather ladder.  It beat the CSR stream,
      ELL, SELL, StripELL, SlabPack and RouteStream on every matrix
      measured: FEM surrogates at ELL padding 2.26×, 1.86× and 1.57×
      (169 / 248 / 266 Gnnz/s against ELL's 148 / 195 / 236) and the
      scattered circuit surrogate at 171k and 4M rows (40.1 and 40.6
      against ≤ 31.3).
    """
    import numpy as np

    csr = mat.to_csr()
    nnz = int(np.asarray(csr.n_non_zero_entries()))
    if nnz == 0:
        return csr
    if DIA.diagonal_count(csr) <= max_diags:
        return DIA.from_csr(csr)
    return GELL.from_csr(csr)
