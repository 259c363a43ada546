"""A spacetime of the plain reference: the metric function, its static
configuration and the parameter defaults.

Frozen copy of the parts of ``geodesic_raytracing_tpu_torch/metrics/base.py``
(commit e647ccc) that the march and the frame read, for metrics in polar
(t, r, theta, phi) charts.  Each metric lives in a file of its own,
``metrics/<name>.py``, that defines ``METRIC``; ``load(name)`` finds it, so
that a configuration with another metric brings its metric as a new file.
"""

from __future__ import annotations

import dataclasses
import importlib.util
from pathlib import Path
from typing import Callable, Mapping

import numpy as np
import torch

Tensor = torch.Tensor

METRICS_DIR = Path(__file__).resolve().parent / "metrics"


@dataclasses.dataclass(frozen=True)
class Spacetime:
    """The metric and the fields of the reference renderer's metric config
    that the march and the frame read (the polar chart's ``polar_base``
    preset supplies the defaults).  ``depends_on``: coordinates the metric
    depends on; ``structure``: its structurally nonzero upper-triangle
    entries, or None = dense."""

    name: str
    fn: Callable
    defaults: Mapping[str, float]
    depends_on: tuple
    structure: frozenset | None
    spherically_symmetric: bool = False
    use_prepass: bool = False
    max_acceleration_change: float = 1e-4
    adaptive_precision: bool = True
    detect_singularities: bool = True
    singular: bool = False
    traversable_event_horizon: bool = False
    singular_terminator: float = 1.0
    follow_geodesics_forward: bool = False
    unconditionally_nonsingular: bool = False

    def params(self, overrides: Mapping[str, float]) -> dict:
        """``{name: float32 value as a Python float}``."""
        p = {k: float(np.float32(v)) for k, v in self.defaults.items()}
        for k, v in overrides.items():
            if k not in p:
                raise KeyError(f"{self.name} has no parameter {k!r}")
            p[k] = float(np.float32(v))
        return p

    def to_polar(self, x: Tensor, params) -> Tensor:
        return x

    def from_polar(self, x: Tensor, params) -> Tensor:
        return x

    def to_polar_velocity(self, x: Tensor, v: Tensor, params) -> Tensor:
        return torch.func.jvp(lambda y: self.to_polar(y, params), (x,),
                              (v,))[1]

    def precision_weights(self) -> tuple:
        """The reference renderer's per-coordinate error weights of a polar
        chart."""
        if self.spherically_symmetric:
            return (1.0, 1.0, 8.0, 8.0)
        return (1.0, 1.0, 8.0, 32.0)


def load(name: str) -> Spacetime:
    """The ``METRIC`` of ``metrics/<name>.py``."""
    path = METRICS_DIR / f"{name}.py"
    if not path.is_file():
        raise KeyError(f"the reference has no metric {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_reference_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.METRIC
