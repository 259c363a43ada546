"""Metric definition framework (port of ``geodesic_raytracing_tpu.metrics.base``).

A metric is a plain Python function ``g(x, params) -> (4, 4, *B)`` written
componentwise on torch tensors, plus a static ``MetricConfig``.  Parameters
are a dict of Python floats holding float32 values (the reference's
``jnp.float32`` scalars); torch casts a Python scalar to the tensor's dtype
before the op, so they behave as float32 constants.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Mapping

import numpy as np
import torch

from ..coordinates import transforms as _tr
from ..ops.geometry import emitting

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class MetricConfig:
    """Static per-metric configuration (field-for-field the reference's)."""

    name: str = ""
    description: str = ""
    use_prepass: bool = False
    max_acceleration_change: float = 1e-7

    singular: bool = False
    traversable_event_horizon: bool = False
    singular_terminator: float = 1.0

    adaptive_precision: bool = True
    detect_singularities: bool = False
    follow_geodesics_forward: bool = False

    has_cylindrical_singularity: bool = False
    cylindrical_terminator: float = 0.005

    coordinate_system: str = "X_Y_THETA_PHI"

    to_polar: str = ""
    from_polar: str = ""
    origin_distance: str = ""
    coordinate_periodicity: str = ""

    unconditionally_nonsingular: bool = False


# Base presets the ported metrics inherit (scripts/{polar,cartesian,
# cartesian_skew,cylindrical,ingoing_ef,ingoing_ef_variable,
# skewed_polar}_base.json).
BASE_CONFIGS: dict[str, dict] = {
    "polar_base": dict(
        coordinate_system="X_Y_THETA_PHI",
        adaptive_precision=True,
        detect_singularities=True,
        max_acceleration_change=1e-4,
        to_polar="polar_to_polar",
        from_polar="polar_to_polar",
        coordinate_periodicity="polar_periodicity",
        origin_distance="at_origin",
    ),
    "cartesian_base": dict(
        coordinate_system="CARTESIAN",
        adaptive_precision=True,
        detect_singularities=True,
        max_acceleration_change=1e-4,
        to_polar="cartesian_to_polar",
        from_polar="polar_to_cartesian",
        origin_distance="at_origin",
    ),
    "cartesian_skew_base": dict(
        coordinate_system="CARTESIAN",
        adaptive_precision=True,
        detect_singularities=True,
        max_acceleration_change=1e-4,
        to_polar="cartesian_skew_to_polar",
        from_polar="polar_to_cartesian_skew",
        origin_distance="at_origin",
    ),
    "cylindrical_base": dict(
        coordinate_system="CYLINDRICAL",
        adaptive_precision=True,
        detect_singularities=True,
        max_acceleration_change=1e-4,
        to_polar="cylindrical_to_polar",
        from_polar="polar_to_cylindrical",
        coordinate_periodicity="cylindrical_periodicity",
        origin_distance="at_origin",
    ),
    "ingoing_ef_base": dict(
        coordinate_system="X_Y_THETA_PHI",
        traversable_event_horizon=True,
        adaptive_precision=True,
        detect_singularities=True,
        max_acceleration_change=1e-6,
        to_polar="ingoing_ef_to_polar",
        from_polar="polar_to_ingoing_ef",
        coordinate_periodicity="polar_periodicity",
        origin_distance="at_origin",
    ),
    "ingoing_ef_variable_base": dict(
        coordinate_system="X_Y_THETA_PHI",
        traversable_event_horizon=True,
        adaptive_precision=True,
        detect_singularities=True,
        max_acceleration_change=1e-6,
        to_polar="ingoing_ef_variable_to_polar",
        from_polar="polar_to_ingoing_ef_variable",
        coordinate_periodicity="polar_periodicity",
        origin_distance="at_origin",
    ),
    "skewed_polar_base": dict(
        coordinate_system="X_Y_THETA_PHI",
        adaptive_precision=True,
        detect_singularities=True,
        max_acceleration_change=1e-4,
        to_polar="skewed_polar_to_polar",
        from_polar="polar_to_skewed_polar",
        coordinate_periodicity="polar_periodicity",
        origin_distance="at_origin",
    ),
}


def make_config(inherit: str | None = None, **overrides) -> MetricConfig:
    """Build a MetricConfig, optionally inheriting a base preset."""
    fields = {}
    if inherit:
        fields.update(BASE_CONFIGS[inherit])
    fields.update(overrides)
    return MetricConfig(**fields)


def at_origin(polar: Tensor, params) -> Tensor:
    """scripts/origins/at_origin.js — distance is just r."""
    return polar[1]


def alcubierre_origin(polar: Tensor, params) -> Tensor:
    """scripts/origins/alcubierre_origin.js — distance to the moving warp
    bubble at x = v t, from the polar event.  The kernel's
    ``Alcubierre::origin_distance`` (csrc/warp.cuh) computes the same
    composition."""
    t, r, theta, phi = polar[0], polar[1], polar[2], polar[3]
    st = torch.sin(theta)
    cx = r * st * torch.cos(phi)
    cy = r * st * torch.sin(phi)
    cz = r * torch.cos(theta)
    x_pos = cx - params["velocity"] * t
    return torch.sqrt(x_pos * x_pos + cy * cy + cz * cz)


ORIGINS = {
    "at_origin": at_origin,
    "alcubierre_origin": alcubierre_origin,
    "": at_origin,
}


@dataclasses.dataclass(frozen=True, eq=False)
class Metric:
    """A spacetime: metric tensor function + static config + param defaults.

    ``depends_on``: coordinates g depends on (partials for the others are
    never taken).  ``structure``: structurally nonzero upper-triangle
    entries, or None = dense; the integrator drops the absent entries'
    terms from the inverse and the Christoffel contraction.  ``rank1``:
    a Kerr-Schild decomposition ``(x, params) -> (f, l)`` with
    ``fn(x, p) == minkowski_plus(*rank1(x, p))`` and l eta-null, or None;
    the integrator then takes the rank-1 acceleration
    (``ops.geometry.acceleration_batched_rank1``).
    """

    name: str
    fn: Callable
    config: MetricConfig
    defaults: Mapping[str, float] = dataclasses.field(default_factory=dict)
    diagonal: bool = False
    spherically_symmetric: bool = False
    depends_on: tuple = (0, 1, 2, 3)
    structure: frozenset | None = None
    rank1: Callable | None = None

    def params(self, **overrides) -> dict:
        """``{name: float32 value}`` (as Python floats) with overrides."""
        p = {k: float(np.float32(v)) for k, v in self.defaults.items()}
        for k, v in overrides.items():
            if k not in p:
                raise KeyError(f"{self.name} has no parameter {k!r}")
            p[k] = float(np.float32(v))
        return p

    def nonzeros(self) -> frozenset | None:
        """Structurally nonzero (i <= j) metric entries, or None = dense."""
        if self.structure is not None:
            return self.structure
        if self.diagonal:
            return frozenset((i, i) for i in range(4))
        return None

    def to_polar(self, x: Tensor, params) -> Tensor:
        return _tr.get_transform(self.config.to_polar)(x, params)

    def from_polar(self, x: Tensor, params) -> Tensor:
        return _tr.get_transform(self.config.from_polar)(x, params)

    def to_polar_velocity(self, x: Tensor, v: Tensor, params) -> Tensor:
        return _tr.velocity_transform(
            _tr.get_transform(self.config.to_polar), x, v, params)

    def from_polar_velocity(self, x: Tensor, v: Tensor, params) -> Tensor:
        return _tr.velocity_transform(
            _tr.get_transform(self.config.from_polar), x, v, params)

    def origin_distance(self, polar: Tensor, params) -> Tensor:
        return ORIGINS[self.config.origin_distance](polar, params)

    def periods(self, params, *, device) -> Tensor:
        """Per-coordinate periodicity (0 = aperiodic), (4,) float32 on
        ``device``."""
        return _tr.get_periodicity(self.config.coordinate_periodicity)(
            params, device=device)

    def precision_weights(self) -> tuple[float, float, float, float]:
        """The reference's W_V1..4 per-coordinate error weights."""
        cs = self.config.coordinate_system
        if cs == "X_Y_THETA_PHI":
            if self.spherically_symmetric:
                return (1.0, 1.0, 8.0, 8.0)
            return (1.0, 1.0, 8.0, 32.0)
        if cs == "CYLINDRICAL":
            return (1.0, 1.0, 8.0, 1.0)
        return (1.0, 1.0, 1.0, 1.0)


@dataclasses.dataclass(frozen=True)
class BakedFn:
    """A metric function with its parameters fixed as Python floats: it
    ignores the parameters it is called with (``runtime.hotswap.bake``; the
    kernel launches the baked build of the metric's instance)."""

    fn: Callable
    params: tuple  # ((name, value), ...)

    def __call__(self, x, _params=None):
        return self.fn(x, dict(self.params))


REGISTRY: dict[str, Metric] = {}


def register(metric: Metric) -> Metric:
    REGISTRY[metric.name] = metric
    return metric


def get_metric(name: str) -> Metric:
    """The registered metric; a KeyError names the registered ones."""
    try:
        return REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown metric {name!r} "
                       f"(available: {list_metrics()})") from None


def list_metrics() -> list[str]:
    return sorted(REGISTRY)


def diag_metric(d0, d1, d2, d3, *, device=None) -> Tensor:
    """Assemble a diagonal 4x4 metric from its components (see
    :func:`sym_metric`)."""
    return sym_metric({(0, 0): d0, (1, 1): d1, (2, 2): d2, (3, 3): d3},
                      device=device)


def sym_metric(entries: Mapping[tuple[int, int], Tensor], *,
               device=None) -> Tensor:
    """Assemble a symmetric 4x4 metric from an upper-triangle entry dict.

    Scalar components give (4, 4); components of shape ``B`` give
    (4, 4, *B) (component-first).  A component may be a Python float: it
    becomes a float32 constant on the device of the tensor components, or
    on ``device`` when there is none (a constant metric), made by a fill on
    that device and not by an upload."""
    trace = emitting()
    if trace is not None:  # ops.emit: the keys are the structure it emits
        return trace.sym_metric(dict(entries))
    ref = next((v for v in entries.values() if isinstance(v, torch.Tensor)),
               None)
    if ref is None:
        ref = torch.zeros((), dtype=torch.float32, device=device)
    vals = torch.broadcast_tensors(*(
        v if isinstance(v, torch.Tensor)
        else torch.full((), float(v), dtype=ref.dtype, device=ref.device)
        for v in entries.values()))
    z = torch.zeros_like(vals[0])
    grid = [[z] * 4 for _ in range(4)]
    for (i, j), v in zip(entries.keys(), vals):
        grid[i][j] = v
        if i != j:
            grid[j][i] = v
    return torch.stack([torch.stack(row) for row in grid])


def minkowski_plus(f: Tensor, lv: Tensor) -> Tensor:
    """eta_ab + f l_a l_b, the Kerr-Schild form: ``f`` of shape ``B`` and
    ``lv`` of shape (4, *B) give (4, 4, *B)."""
    g = f * lv[:, None] * lv[None, :]
    # eta from the identity on g's device (neither an upload nor a scalar
    # write, which would wait for the device in a frame): 1 - 2 e0 e0.
    eye = torch.eye(4, dtype=g.dtype, device=g.device)
    eta = eye - 2.0 * eye[:, :1] * eye[:1, :]
    return g + eta.reshape((4, 4) + (1,) * (g.ndim - 2))
