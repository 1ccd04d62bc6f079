"""Kernel timing, roofline accounting and the device peaks table.

One timer: ``time_chained_op`` chains K data-dependent applications of a
step inside ONE jitted ``fori_loop`` (so per-dispatch launch overhead is
amortized and XLA cannot hoist the work out of the loop) and waits with
``block_until_ready``.  Its chain length is quantized to powers of two, so
repeated runs reuse one compiled program.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Sequence

import numpy as np

import jax
import jax.numpy as jnp

#: Published peaks per ``device_kind`` (NVIDIA H100 SXM data sheet and the
#: Hopper architecture white paper): HBM bytes/s and L2 bytes.  The rate
#: assumes the card's full 700 W power limit.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bw": 3.35e12, "l2_bytes": 50e6},
}

#: seconds one timed chain of ``time_chained_op`` aims at
CHAIN_TARGET_SECS = 0.5


def device_peaks(device=None) -> dict:
    """Peaks of ``device`` (default: the first JAX device).  A device kind
    missing from the table is an error: no peak is ever assumed."""
    d = device if device is not None else jax.devices()[0]
    try:
        return DEVICE_PEAKS[d.device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {d.device_kind!r} "
            f"(platform {d.platform!r}); add it to DEVICE_PEAKS with its "
            "source") from None


def card_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` for the visible cards,
    one line each (a card below its 700 W limit runs slower under load,
    so every number is reported beside this)."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def compile_cache_dir() -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` when set, else the fixed
    ``<repo>/.jax_cache`` (a cache directory that moves never hits)."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    return os.path.join(repo, ".jax_cache")


def enable_compile_cache() -> str:
    """Keep every compiled program in ``compile_cache_dir()``."""
    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path


def time_chained_op(step_fn: Callable, x0, captures: Sequence = (),
                    inner: int | None = None, reps: int = 3,
                    max_inner: int = 1 << 16) -> float:
    """Seconds per application of ``step_fn(v, *captures)``.

    ``inner`` chained applications run inside one jit; when ``inner`` is
    None it is chosen from a 10-step probe so one timed run lasts about
    ``CHAIN_TARGET_SECS``, rounded down to a power of two (the chain length is
    baked into the compiled loop).  ``captures`` (e.g. the matrix) are
    passed as arguments, not closed over: closure constants would be
    inlined into the program.  Every operand the step reads must depend on
    the carry, or XLA hoists the work out of the loop."""
    caps = tuple(captures)

    def make_run(n):
        @jax.jit
        def run(x, c):
            return jax.lax.fori_loop(0, n, lambda i, v: step_fn(v, *c), x)

        return run

    if inner is None:
        probe = 10
        run = make_run(probe)
        run(x0, caps).block_until_ready()          # compile + warm
        t0 = time.perf_counter()
        run(x0, caps).block_until_ready()
        est = max((time.perf_counter() - t0) / probe, 1e-9)
        inner = int(np.clip(CHAIN_TARGET_SECS / est, probe, max_inner))
        inner = 1 << int(np.log2(inner))
    run = make_run(inner)
    run(x0, caps).block_until_ready()
    best = np.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        run(x0, caps).block_until_ready()
        best = min(best, time.perf_counter() - t0)
    return best / inner


@dataclasses.dataclass
class KernelReport:
    """Roofline report for one kernel invocation profile."""

    name: str
    seconds: float
    nnz: int
    bytes_model: int
    flops: int
    hbm_bw: float  # bytes/s the hardware can stream

    @property
    def gnnz_per_s(self) -> float:
        return self.nnz / self.seconds / 1e9

    @property
    def gb_per_s(self) -> float:
        return self.bytes_model / self.seconds / 1e9

    @property
    def roofline_seconds(self) -> float:
        return self.bytes_model / self.hbm_bw

    @property
    def roofline_fraction(self) -> float:
        return self.roofline_seconds / self.seconds

    def __str__(self):
        return (f"{self.name}: {self.seconds*1e6:.1f} us  "
                f"{self.gnnz_per_s:.2f} Gnnz/s  {self.gb_per_s:.0f} GB/s  "
                f"{100*self.roofline_fraction:.1f}% of roofline")


def roofline_spmv(fmt, x, hbm_bw: float | None = None,
                  name: str | None = None,
                  inner: int | None = None) -> KernelReport:
    """Measure an SpMV path against its layout traffic roofline
    (``fmt.spmv_traffic_bytes()``).  ``hbm_bw`` defaults to the device's
    published peak."""
    from ..ops import spmv

    if hbm_bw is None:
        hbm_bw = device_peaks()["hbm_bw"]
    dt = time_chained_op(lambda v, m: spmv(m, v) * 5e-4, jnp.asarray(x),
                         captures=(fmt,), inner=inner)
    nnz = int(np.asarray(fmt.n_non_zero_entries()))
    return KernelReport(
        name=name or type(fmt).__name__, seconds=dt, nnz=nnz,
        bytes_model=int(fmt.spmv_traffic_bytes()), flops=2 * nnz,
        hbm_bw=hbm_bw)


@contextlib.contextmanager
def trace_to(path: str):
    """jax.profiler trace context (view with tensorboard / xprof)."""
    jax.profiler.start_trace(path)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
