"""Content-pack discovery and loading (port of
``geodesic_raytracing_tpu.content``).

The reference's content manager (content_manager.cpp:9-379): scan a content
directory for metric definitions paired with JSON configs, with config
inheritance (``inherit_settings``), pack-local coordinate systems and
origin-distance functions, menu ordering by ``sorting.json``, and error
tolerance: a broken definition is reported as a "(broken)" entry instead of
a crash (content_manager.cpp:104-140).

A pack for the port is a directory of Python modules that define torch
metric functions against ``geodesic_raytracing_tpu_torch.metrics.base``
(``examples/pack_torch``):

    my_pack/
      my_hole.py        # def metric(x, params): ... ; DEFAULTS = {...}
      my_hole.json      # the schema of the reference's scripts/*.json
      coordinates/
        my_to_polar.py  # def transform(x, params): ...
      origins/
        my_origin.py    # def origin(polar, params): ...
      sorting.json

Loading a pack registers its metrics.  On the card a pack metric runs as a
built-in one does: at its first launch ``ops/emit.py`` writes its kernel
struct from its function and the ray-march kernel is built with it
(``ops.raymarch.instance_of``); what the emitter cannot emit raises there,
naming the op.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path

from .coordinates import transforms as tr
from .metrics import base as mbase

# JSON keys that map 1:1 onto MetricConfig fields (metric.hpp:359-433).
_CONFIG_KEYS = {f.name for f in dataclasses.fields(mbase.MetricConfig)}


@dataclasses.dataclass
class Pack:
    """A loaded content pack: metrics (some possibly broken) + menu order."""

    directory: Path
    metrics: dict[str, mbase.Metric] = dataclasses.field(default_factory=dict)
    broken: dict[str, str] = dataclasses.field(default_factory=dict)
    order: list[str] = dataclasses.field(default_factory=list)


def _import_module(path: Path):
    name = f"_grt_torch_pack_{abs(hash(str(path)))}_{path.stem}"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_config(directory: Path, stem: str, _depth: int = 0) -> dict:
    """JSON config with ``inherit_settings`` resolved
    (content_manager.cpp:70-112): a base resolves in the pack first, then
    among the built-in base presets."""
    if _depth > 8:
        raise ValueError(f"inherit_settings loop at {stem}")
    cfg_path = directory / f"{stem}.json"
    data = json.loads(cfg_path.read_text()) if cfg_path.exists() else {}
    inherit = data.pop("inherit_settings", None)
    merged: dict = {}
    if inherit:
        if (directory / f"{inherit}.json").exists():
            merged.update(load_config(directory, inherit, _depth + 1))
        elif inherit in mbase.BASE_CONFIGS:
            merged.update(mbase.BASE_CONFIGS[inherit])
        else:
            raise FileNotFoundError(f"unknown inherit_settings {inherit!r}")
    merged.update(data)
    return merged


def _load_support(directory: Path) -> None:
    """Register the pack's coordinate transforms, periodicities and origin
    functions in the global registries under their file stems."""
    coords = directory / "coordinates"
    if coords.is_dir():
        for f in sorted(coords.glob("*.py")):
            mod = _import_module(f)
            fn = getattr(mod, "transform", None) or getattr(mod, "func", None)
            if fn is None:
                continue
            if "periodicity" in f.stem:
                tr.PERIODICITY[f.stem] = fn
            else:
                tr.TRANSFORMS[f.stem] = fn
    origins = directory / "origins"
    if origins.is_dir():
        for f in sorted(origins.glob("*.py")):
            mod = _import_module(f)
            fn = getattr(mod, "origin", None) or getattr(mod, "func", None)
            if fn is not None:
                mbase.ORIGINS[f.stem] = fn


def load_metric_from_module(directory: Path, stem: str) -> mbase.Metric:
    """One metric = module + config pair (``load_metric_from_script``,
    content_manager.cpp:9-53)."""
    mod = _import_module(directory / f"{stem}.py")
    fn = getattr(mod, "metric", None)
    if fn is None:
        raise AttributeError(f"{stem}.py defines no `metric(x, params)`")

    raw = load_config(directory, stem)
    for key in set(raw) - _CONFIG_KEYS:  # the reference warns (metric.hpp:431)
        print(f"Warning, unknown key name {key}", file=sys.stderr)
        raw.pop(key)
    raw.setdefault("name", stem)
    config = mbase.MetricConfig(**raw)
    structure = getattr(mod, "STRUCTURE", None)
    return mbase.Metric(
        name=config.name,
        fn=fn,
        config=config,
        defaults=dict(getattr(mod, "DEFAULTS", {})),
        diagonal=bool(getattr(mod, "DIAGONAL", False)),
        spherically_symmetric=bool(getattr(mod, "SPHERICALLY_SYMMETRIC",
                                           False)),
        depends_on=tuple(getattr(mod, "DEPENDS_ON", (0, 1, 2, 3))),
        structure=None if structure is None else frozenset(
            tuple(e) for e in structure),
        rank1=getattr(mod, "RANK1", None),
    )


def load_pack(directory: str | Path, register: bool = True) -> Pack:
    """Scan a content directory (``content::load``,
    content_manager.cpp:181-261)."""
    directory = Path(directory)
    pack = Pack(directory=directory)
    _load_support(directory)

    for py in sorted(directory.glob("*.py")):
        stem = py.stem
        try:
            metric = load_metric_from_module(directory, stem)
        except Exception as e:  # a broken pack must not crash the app
            pack.broken[stem] = f"{type(e).__name__}: {e}"
            continue
        pack.metrics[metric.name] = metric
        if register:
            mbase.register(metric)

    sorting = directory / "sorting.json"
    if sorting.exists():
        try:
            stems = [Path(o).stem for o in json.loads(sorting.read_text())]
            pack.order = [s for s in stems if s in pack.metrics
                          or any(m.config.name == s
                                 for m in pack.metrics.values())]
        except Exception:
            pack.order = sorted(pack.metrics)
    else:
        pack.order = sorted(pack.metrics)
    return pack
