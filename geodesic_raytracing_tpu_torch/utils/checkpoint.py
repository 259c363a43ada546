"""Checkpoint and resume of a fit's parameters (port of
``geodesic_raytracing_tpu.utils.checkpoint``, the same file format: a
directory with ``meta.json`` and ``arrays.npz``, so that a checkpoint written
by either package loads in the other).  Values are stored as numpy arrays;
tensors are copied to the host first."""

from __future__ import annotations

import json
import os
import tempfile
from pathlib import Path

import numpy as np


def _host(v) -> np.ndarray:
    if hasattr(v, "detach"):  # a torch tensor, on any device
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def save_checkpoint(path: str | Path, step: int, params: dict,
                    opt_state: dict | None = None,
                    extra: dict | None = None) -> None:
    """Atomic checkpoint write (a directory with meta.json + arrays.npz)."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    arrays = {f"params/{k}": _host(v) for k, v in params.items()}
    if opt_state:
        arrays.update({f"opt/{k}": _host(v) for k, v in opt_state.items()})

    # np.savez appends ".npz" unless the name already ends with it, so the
    # temporary file carries the suffix, or the rename would move an empty
    # file into place.
    fd, tmp = tempfile.mkstemp(dir=str(path), suffix=".tmp.npz")
    os.close(fd)
    np.savez(tmp, **arrays)
    os.replace(tmp, path / "arrays.npz")

    meta = {"step": int(step), "extra": extra or {}}
    fd, tmp = tempfile.mkstemp(dir=str(path), suffix=".json.tmp")
    with os.fdopen(fd, "w") as f:
        json.dump(meta, f)
    os.replace(tmp, path / "meta.json")


def load_checkpoint(path: str | Path):
    """``(step, params, opt_state, extra)`` (numpy values), or None when
    there is no checkpoint at ``path``."""
    path = Path(path)
    if not (path / "meta.json").exists():
        return None
    meta = json.loads((path / "meta.json").read_text())
    data = np.load(path / "arrays.npz")
    params = {k.split("/", 1)[1]: data[k] for k in data.files
              if k.startswith("params/")}
    opt = {k.split("/", 1)[1]: data[k] for k in data.files
           if k.startswith("opt/")}
    return meta["step"], params, opt, meta.get("extra", {})
