"""Observability utilities: roofline accounting, kernel timing, profiling.

The reference has no tracing/profiling at all (SURVEY.md §5 — its only perf
artifact is an #[inline] hint, src/types.rs:30-32); BASELINE.json demands
per-kernel roofline reporting (nnz/s, GB/s), which lives here.
"""

from .profiling import (
    DEVICE_PEAKS,
    KernelReport,
    card_name_and_power_limit,
    compile_cache_dir,
    device_peaks,
    enable_compile_cache,
    roofline_spmv,
    time_chained_op,
    trace_to,
)

__all__ = ["DEVICE_PEAKS", "KernelReport", "card_name_and_power_limit",
           "compile_cache_dir",
           "device_peaks", "enable_compile_cache", "roofline_spmv",
           "time_chained_op", "trace_to"]
