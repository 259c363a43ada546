"""Find a cell, its configuration, its traffic mix, its limits and the
per-layer metric readers by the names in ``BENCHMARK.json``.

Everything that belongs to one configuration, one mix or one metric is a
file of its own, so that a cell, a mix or a metric is added with new files
and a new manifest entry:

* ``BENCHMARK.json`` at the root: the manifest (its ``configs`` entries
  name each configuration's ``file``);
* ``benchmark/traffic/<mix>.json``: a traffic mix;
* ``benchmark/limits/<cell>.json``: the limit of each number the check of
  the cell compares;
* ``benchmark/layer_metrics/<metric>.py``: the reader of a per-layer
  metric, a function ``read(run)`` that returns the value or None.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def load(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _named(entries: list, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def cell(manifest: dict, name: str) -> dict:
    return _named(manifest["workloads"], name, "workload")


def config(root: Path, manifest: dict, name: str) -> dict:
    entry = _named(manifest["configs"], name, "configuration")
    return json.loads((Path(root) / entry["file"]).read_text())


def mix(root: Path, name: str) -> dict:
    return json.loads((Path(root) / "benchmark" / "traffic"
                       / f"{name}.json").read_text())


def limits(root: Path, cell_name: str) -> dict:
    return json.loads((Path(root) / "benchmark" / "limits"
                       / f"{cell_name}.json").read_text())


def reader(root: Path, metric: str):
    """The ``read`` function of ``benchmark/layer_metrics/<metric>.py``."""
    path = Path(root) / "benchmark" / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"benchmark_layer_metric_{metric.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(entries: list, cell_name: str) -> list:
    """The metrics of ``entries`` that cell ``cell_name`` reports."""
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]


def problems(manifest: dict) -> list:
    """What in the manifest breaks the rules for names and units."""
    out = []
    names = [("config", c["name"]) for c in manifest["configs"]]
    names += [("workload", w["name"]) for w in manifest["workloads"]]
    names += [("workload config", w["config"]) for w in manifest["workloads"]]
    names += [("traffic", w["traffic"]) for w in manifest["workloads"]]
    names += [("reduced key", k) for c in manifest["configs"]
              for k in c["reduced"]]
    metrics = manifest["end_to_end"] + manifest["per_layer"]
    names += [("metric", m["name"]) for m in metrics]
    out += [f"{what} name {n!r}" for what, n in names
            if not NAME.fullmatch(n)]
    out += [f"unit {m['unit']!r} of {m['name']}" for m in metrics
            if not UNIT.fullmatch(m["unit"])]
    for what, entries in (("config", manifest["configs"]),
                          ("workload", manifest["workloads"]),
                          ("metric", metrics)):
        seen = [e["name"] for e in entries]
        out += [f"{what} {n!r} twice" for n in set(seen)
                if seen.count(n) > 1]
    out += [f"metric {m['name']}: better {m['better']!r}" for m in metrics
            if m["better"] not in ("lower", "higher")]
    return out
