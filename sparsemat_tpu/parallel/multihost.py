"""Multi-host (multi-process) runtime glue.

The reference's only parallel construct is single-process
(``SparseMatPar`` + a dead intra-process mpsc sketch,
reference: src/sparsemat_par.rs:3-7,37-68).  This module supplies what a
multi-host GPU cluster needs around the dist layer in ``parallel/dist.py``:

* ``init_distributed`` — one-call wrapper over ``jax.distributed.initialize``
  so every host joins the same JAX runtime (no-op when single-process);
* ``make_host_mesh`` — a 1-D row mesh whose device order is HOST-MAJOR:
  consecutive row blocks land on the same host, so the halo exchanges of
  ``DistDIA``/``DistSlab`` ride NVLink between local cards and only the
  once-per-host block boundary crosses the network;
* ``make_mesh_2d`` — an explicit (hosts × local devices) mesh for
  algorithms that want to treat the two interconnects differently (e.g.
  hierarchical reductions: psum over 'chips' within a host, then over
  'hosts').

Multi-process correctness is exercised by tests/test_multiprocess.py, which
launches real separate processes on the CPU backend; weak scaling is
measured by scripts/weak_scaling.py.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh

from .mesh import ROWS_AXIS

_initialized = False


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     local_device_ids=None) -> None:
    """Join (or create) the multi-host JAX runtime.

    Each host calls this once before building meshes, with the
    coordinator's ``host:port``, the process count and its own process id
    (no cluster environment supplies them).  Safe to call when
    single-process (explicit num_processes=1 is a no-op) or to call twice
    (second call is ignored).
    """
    global _initialized
    if _initialized:
        return
    if num_processes == 1 and coordinator_address is None:
        _initialized = True  # nothing to initialize for one process
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids)
    _initialized = True


def host_major_devices() -> np.ndarray:
    """All global devices ordered host-major (process_index, then local id).
    ``jax.devices()`` already promises this order; we enforce it explicitly
    so the row-block → device assignment below is deterministic."""
    devs = sorted(jax.devices(), key=lambda d: (d.process_index, d.id))
    return np.array(devs)


def make_host_mesh(axis_name: str = ROWS_AXIS) -> Mesh:
    """1-D row mesh over ALL processes' devices, host-major.

    Drop-in for ``mesh.make_mesh()`` on a pod: the contiguous block-row
    partition of the dist layer then maps block i//chips_per_host to host
    i//chips_per_host — DistDIA's ppermute halo ring crosses the network exactly
    once per host boundary and stays within a host otherwise."""
    return Mesh(host_major_devices(), (axis_name,))


def make_mesh_2d(host_axis: str = "hosts", chip_axis: str = "chips") -> Mesh:
    """(n_hosts × chips_per_host) mesh — outer axis spans hosts, inner the devices of one host."""
    devs = host_major_devices()
    n_proc = jax.process_count()
    per_host = devs.size // n_proc
    if n_proc * per_host != devs.size:
        raise ValueError(
            f"uneven device count: {devs.size} devices over {n_proc} hosts")
    return Mesh(devs.reshape(n_proc, per_host), (host_axis, chip_axis))


def process_info() -> dict:
    """Small observability helper: this process's place in the job."""
    return {
        "process_index": jax.process_index(),
        "process_count": jax.process_count(),
        "local_devices": len(jax.local_devices()),
        "global_devices": len(jax.devices()),
    }
