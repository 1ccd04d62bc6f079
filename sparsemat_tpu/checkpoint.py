"""Checkpoint / resume.

The reference has no persistence at all — its only serialization is one-way
debug text (reference: src/sparsematrix.rs:284-338; SURVEY.md §5 flags
checkpoint/resume as a new capability this build must supply).  This
module provides:

* ``save_matrix`` / ``load_matrix`` — any frozen format round-trips through
  one ``.npz`` file: array fields as npz entries, static fields (shape,
  offsets, …) as a JSON header.  Formats are dataclass pytrees, so the
  field split is introspected, not hand-listed; *nested* formats
  (``SlabPack.parts``/``.overflow``, ``GELL.levels``, tuples of arrays)
  recurse, so every entry of ``formats.__all__`` serializes — enforced by
  tests/test_checkpoint.py parameterizing over all of them.
* ``save_solve_state`` / ``load_solve_state`` / ``resume`` — solver
  checkpointing.  CG/GMRES restarted from a checkpointed iterate ``x`` is
  mathematically a fresh solve with a better initial guess (conjugacy
  history is not preserved — same convergence guarantee, possibly a few
  extra iterations), which keeps the checkpoint format tiny and
  solver-agnostic: (x, iterations, residual_norm).
"""

from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np

_FORMAT_REGISTRY = {}


def _registry():
    if not _FORMAT_REGISTRY:
        from . import formats

        for name in formats.__all__:
            cls = getattr(formats, name)
            if isinstance(cls, type) and dataclasses.is_dataclass(cls):
                _FORMAT_REGISTRY[cls.__name__] = cls
    return _FORMAT_REGISTRY


def _flatten_field(v, key: str, arrays: dict):
    """Describe one pytree field value as a JSON node, stashing arrays.

    Handles: plain arrays, None, nested format dataclasses (SlabPack
    overflow), and tuples mixing either (SlabPack.parts, GELL.levels,
    GELL.inv_maps)."""
    if v is None:
        return {"kind": "none"}
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return {"kind": "format", "value": _flatten_format(v, key + ".", arrays)}
    if isinstance(v, (tuple, list)):
        return {"kind": "tuple",
                "items": [_flatten_field(e, f"{key}.{i}", arrays)
                          for i, e in enumerate(v)]}
    arrays[key] = np.asarray(v)
    return {"kind": "array", "key": key}


def _flatten_format(mat, prefix: str, arrays: dict) -> dict:
    desc = {"format": type(mat).__name__, "static": {}, "fields": {}}
    for f in dataclasses.fields(mat):
        v = getattr(mat, f.name)
        if f.metadata.get("pytree_node", True):
            desc["fields"][f.name] = _flatten_field(v, prefix + f.name, arrays)
        else:
            desc["static"][f.name] = v
    return desc


def _untuple(v):
    # JSON turns tuples into lists; static fields may nest (e.g. WELL.chunks
    # is a tuple of 4-tuples)
    return tuple(_untuple(e) for e in v) if isinstance(v, list) else v


def _unflatten_field(node, z):
    kind = node["kind"]
    if kind == "none":
        return None
    if kind == "format":
        return _unflatten_format(node["value"], z)
    if kind == "tuple":
        return tuple(_unflatten_field(e, z) for e in node["items"])
    return jnp.asarray(z[node["key"]])


def _unflatten_format(desc: dict, z):
    cls = _registry().get(desc["format"])
    if cls is None:
        raise ValueError(f"unknown format {desc['format']!r} in checkpoint")
    kwargs = {k: _untuple(v) for k, v in desc["static"].items()}
    for name, node in desc["fields"].items():
        kwargs[name] = _unflatten_field(node, z)
    return cls(**kwargs)


def save_matrix(path: str, mat) -> None:
    """Serialize a frozen format (arbitrarily nested) to ``.npz``."""
    if not dataclasses.is_dataclass(mat):
        raise TypeError(f"cannot checkpoint {type(mat).__name__}: freeze the "
                        "builder to a format first")
    arrays = {}
    desc = _flatten_format(mat, "", arrays)
    header = json.dumps({"version": 2, "root": desc})
    np.savez(path, __header__=np.frombuffer(header.encode(), np.uint8),
             **arrays)


def load_matrix(path: str):
    """Load a matrix saved by ``save_matrix``."""
    with np.load(path) as z:
        header = json.loads(bytes(z["__header__"]).decode())
        if "root" not in header:  # v1 flat layout (pre round-4 files)
            cls = _registry().get(header["format"])
            if cls is None:
                raise ValueError(
                    f"{path}: unknown format {header['format']!r}")
            kwargs = {k: _untuple(v) for k, v in header["static"].items()}
            for f in dataclasses.fields(cls):
                if f.metadata.get("pytree_node", True):
                    kwargs[f.name] = jnp.asarray(z[f.name])
            return cls(**kwargs)
        return _unflatten_format(header["root"], z)


class SolveState(NamedTuple):
    """Resumable solver checkpoint."""

    x: np.ndarray
    iterations: int
    residual_norm: float


def save_solve_state(path: str, x, info=None) -> None:
    """Checkpoint a (possibly partial) solve: the iterate + progress info."""
    np.savez(path, x=np.asarray(x),
             iterations=np.int64(int(info.iterations) if info is not None else 0),
             residual_norm=np.float64(
                 float(info.residual_norm) if info is not None else np.inf))


def load_solve_state(path: str) -> SolveState:
    with np.load(path) as z:
        return SolveState(x=z["x"], iterations=int(z["iterations"]),
                          residual_norm=float(z["residual_norm"]))


def resume(solver_fn, A, b, state: SolveState, **kw):
    """Continue a checkpointed solve: ``solver_fn(A, b, x0=state.x, **kw)``
    with the reported iteration count offset by the checkpoint's."""
    x, info = solver_fn(A, b, x0=jnp.asarray(state.x), **kw)
    return x, info._replace(iterations=info.iterations + state.iterations)
