"""Test environment: the CPU backend with 8 virtual devices, so the
multi-device sharding paths (mesh/shard_map) run without accelerators
(SURVEY.md §4), and x64 enabled for the f64 reference solvers.

Tests that can only run on the GPU carry the ``gpu`` marker and take the
``gpu_device`` fixture, which skips them here; ``chip_smoke.py`` calls
them on the card, in its own process."""

import os

# Must run before jax initializes a backend.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", True)  # reference solvers are f64 (src/lib.rs:38)

from sparsemat_tpu.utils import enable_compile_cache  # noqa: E402

# Persistent compilation cache — the suite compiles many tiny programs.
enable_compile_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running; the tier-1 run deselects it")
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA device; skipped on the CPU, run on the "
        "card by chip_smoke.py")


@pytest.fixture
def gpu_device():
    """The first CUDA device, or a skip when the backend has none."""
    d = jax.devices()[0]
    if d.platform != "gpu":
        pytest.skip(f"needs a GPU; this backend is {d.platform!r}")
    return d
