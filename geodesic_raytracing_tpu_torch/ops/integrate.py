"""The geodesic integrator: adaptive-step velocity Verlet over ray batches
(port of ``geodesic_raytracing_tpu.ops.integrate``).

``trace_rays`` dispatches on the device of the state: CUDA tensors go to the
hand-written ray-march kernel (``ops.raymarch.trace_rays_cuda``), which
launches or raises; CPU tensors go to ``trace_rays_reference``, the eager
port of the reference's ``while`` driver and the kernel's plain twin.

Status codes: 0 = active, 1 = escaped (samples the sky), 2 = dead (black).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..metrics.base import Metric
from . import geometry

Tensor = torch.Tensor

ACTIVE = 0
ESCAPED = 1
DEAD = 2

# do_generic_rays loop limit (cl.cl:4016: 4096 * 4).
MAX_STEPS_DEFAULT = 16384

# acceleration_to_precision's float-precision workaround constant (256*256).
_PRECISION_SCALE = 65536.0
_MAX_TIMESTEP = 100000.0


class Features(NamedTuple):
    """Runtime-tunable engine features (the reference's dynamic feature
    config).  Python floats, used as float32 constants."""

    universe_size: float = 20.0
    max_acceleration_change: float = 0.01
    max_precision_radius: float = 10.0
    min_step: float = 1e-6
    ambient_precision: float = 0.2
    subambient_precision: float = 0.5

    @classmethod
    def for_metric(cls, metric, **overrides) -> "Features":
        """Features seeded from the metric's config (its
        ``max_acceleration_change`` feeds the step controller)."""
        kw = dict(max_acceleration_change=metric.config.max_acceleration_change)
        kw.update(overrides)
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class TraceOptions:
    """Trace options.  Only ``max_steps`` varies in the ported slice; the
    reference's other values of the remaining fields (the "euler"
    integrator, affine reparameterisation, constant-theta planar mode) are
    refused by ``check_ported`` until they are ported."""

    max_steps: int = MAX_STEPS_DEFAULT
    reparameterisation: bool = False
    integrator: str = "verlet"
    planar: bool = False


class RayState(NamedTuple):
    """Structure-of-arrays ray state.  Vectors (N, 4); scalars (N,);
    ``status`` and ``steps`` (committed steps) int32."""

    position: Tensor
    velocity: Tensor
    acceleration: Tensor
    next_ds: Tensor
    running_dlambda_dnew: Tensor
    status: Tensor
    steps: Tensor


class _StateT(NamedTuple):
    """Internal component-first state: vectors (4, N)."""

    position: Tensor
    velocity: Tensor
    acceleration: Tensor
    next_ds: Tensor
    running_dlambda_dnew: Tensor
    status: Tensor
    steps: Tensor


def acceleration_to_precision(acc: Tensor, max_acceleration, w_v, udiv
                              ) -> tuple[Tensor, Tensor]:
    """cl.cl:3400-3429 — error estimate and ideal next step from a
    component-first (4, N) acceleration.  ``w_v``: 4 Python float weights,
    ``udiv`` their maximum.  Returns ``(diff, next_ds)`` of (N,)."""
    wa = [acc[i] * w_v[i] for i in range(4)]
    ss = wa[0] * wa[0] + wa[1] * wa[1] + wa[2] * wa[2] + wa[3] * wa[3]
    err_scale = torch.sqrt(torch.clamp(ss, min=1e-30)) * (0.01 / udiv)
    # The scalar terms in float32 arithmetic, as the kernel computes them.
    err = np.float32(max_acceleration)
    diff = err_scale * _PRECISION_SCALE
    floor = err * np.float32(_PRECISION_SCALE / (_MAX_TIMESTEP * _MAX_TIMESTEP))
    diff = torch.clamp(diff, min=float(floor))
    next_ds = float(np.sqrt(err * np.float32(_PRECISION_SCALE))) \
        * torch.rsqrt(diff)
    return diff, next_ds


def metric_acceleration(metric: Metric, pos, vel, params):
    """Sparsity-pruned geodesic acceleration of a component-first batch."""
    return geometry.acceleration_batched(metric.fn, pos, vel, params,
                                         deps=metric.depends_on,
                                         nz=metric.nonzeros())


def verlet_step(metric: Metric, position, velocity, acceleration, ds, params):
    """cl.cl:3273-3346 — velocity Verlet (no affine reparameterisation:
    K = 1).  All vectors component-first (4, N)."""
    ds_ = ds[None, :]
    next_position = position + velocity * ds_ + 0.5 * acceleration * ds_ * ds_
    intermediate_velocity = velocity + acceleration * ds_
    next_acceleration = metric_acceleration(
        metric, next_position, intermediate_velocity, params)
    next_velocity = velocity + 0.5 * (acceleration + next_acceleration) * ds_
    return next_position, next_velocity, next_acceleration


def check_ported(opts: TraceOptions) -> None:
    """Raise for the trace options the port does not implement yet (the
    Euler integrator, affine reparameterisation, planar mode)."""
    if opts.integrator != "verlet" or opts.reparameterisation or opts.planar:
        raise NotImplementedError(
            "only the Verlet march without reparameterisation or planar "
            "mode is ported")


def check_ported_metric(metric: Metric) -> None:
    """Raise for the metric configs whose step branches are not ported yet.

    The ported step (and the kernel's, ``csrc/march.cuh``) is the adaptive
    controller with the blow-up test and no singular or cylindrical
    terminator: the config of ``kerr_boyer``, the one registered metric."""
    cfg = metric.config
    if (not cfg.adaptive_precision or cfg.singular
            or cfg.has_cylindrical_singularity
            or cfg.unconditionally_nonsingular):
        raise NotImplementedError(
            f"metric {metric.name!r}: only the adaptive step without "
            "singular or cylindrical terminators is ported")


def initial_next_ds(metric: Metric, features: Features, acc: Tensor) -> Tensor:
    """Seed the adaptive step size from the launch acceleration (4, N)."""
    check_ported_metric(metric)
    w = metric.precision_weights()
    _, next_ds = acceleration_to_precision(
        acc, features.max_acceleration_change, w, udiv=float(max(w)))
    return next_ds


def init_ray_state(metric: Metric, position: Tensor, velocity: Tensor, params,
                   features: Features) -> RayState:
    """Initial RayState from (N, 4) positions/velocities: null-fix the
    velocity, compute the launch acceleration, seed the adaptive step."""
    pos = position.T.contiguous()
    vel = velocity.T.contiguous()
    n = pos.shape[1]
    vel = geometry.fix_null_batched(metric.fn(pos, params), vel)
    acc = metric_acceleration(metric, pos, vel, params)
    next_ds = initial_next_ds(metric, features, acc)
    dev = pos.device
    return RayState(
        position=pos.T.contiguous(),
        velocity=vel.T.contiguous(),
        acceleration=acc.T.contiguous(),
        next_ds=next_ds,
        running_dlambda_dnew=torch.ones((n,), dtype=pos.dtype, device=dev),
        status=torch.zeros((n,), dtype=torch.int32, device=dev),
        steps=torch.zeros((n,), dtype=torch.int32, device=dev),
    )


def make_step_fn(metric: Metric, features: Features, opts: TraceOptions):
    """One masked integrator iteration over a component-first ray batch,
    term for term the reference's ``make_step_fn`` (Verlet, adaptive
    precision).  ``f_in_x`` is the launch-time |v^t| of each ray (the
    blow-up test's baseline)."""
    check_ported(opts)
    check_ported_metric(metric)
    cfg = metric.config
    w_v = metric.precision_weights()
    udiv = float(max(w_v))

    def step(state: _StateT, f_in_x: Tensor, params) -> _StateT:
        pos, vel, acc = state.position, state.velocity, state.acceleration
        active = state.status == ACTIVE

        polar = metric.to_polar(pos, params)
        abs_r = torch.abs(metric.origin_distance(polar, params))

        new_max = features.max_precision_radius
        near = abs_r < new_max
        ds = torch.where(
            near,
            torch.clamp(state.next_ds, max=features.ambient_precision),
            0.1 * (abs_r - new_max) + features.ambient_precision,
        )
        ds = torch.where(active, ds, torch.zeros_like(ds))

        newly_escaped = torch.abs(polar[1]) >= features.universe_size
        rd = state.running_dlambda_dnew
        dead = (torch.abs(vel[0]) > (1000.0 + f_in_x) * rd) & (
            torch.abs(acc[0]) > 100.0 * rd)

        status = state.status
        status = torch.where(active & newly_escaped, ESCAPED, status)
        status = torch.where(active & dead & ~newly_escaped, DEAD, status)
        active = status == ACTIVE

        npos, nvel, nacc = verlet_step(metric, pos, vel, acc, ds, params)

        # Finiteness probe on the TRIAL state's component sum, before the
        # commit (an overflow of the sum itself counts as non-finite).
        probe = (npos[0] + npos[1] + npos[2] + npos[3]
                 + nvel[0] + nvel[1] + nvel[2] + nvel[3]
                 + nacc[0] + nacc[1] + nacc[2] + nacc[3])
        bad = ~torch.isfinite(probe)
        status = torch.where(active & bad, DEAD, status)
        active = status == ACTIVE

        err = features.max_acceleration_change
        diff, ideal_ds = acceleration_to_precision(nacc, err, w_v, udiv)
        # Division-free forms of calculate_ds_error (cl.cl:3431-3456).
        cand = 0.99 * torch.minimum(torch.maximum(ideal_ds, 0.3 * ds),
                                    2.0 * ds)
        cand = torch.clamp(cand, min=features.min_step)
        skip = 1.95 * cand < ds
        kill = torch.zeros_like(skip)
        if cfg.detect_singularities:
            kill_at = np.float32(err) * np.float32(10000.0 * _PRECISION_SCALE)
            kill = (cand <= features.min_step) & (diff > float(kill_at))
        # Error control applies only in the near zone.
        skip = skip & near
        kill = kill & near
        status = torch.where(active & kill, DEAD, status)
        commit = active & ~kill & ~skip
        next_ds = torch.where(active, cand, state.next_ds)

        cm = commit[None, :]
        return _StateT(
            position=torch.where(cm, npos, pos),
            velocity=torch.where(cm, nvel, vel),
            acceleration=torch.where(cm, nacc, acc),
            next_ds=next_ds,
            running_dlambda_dnew=state.running_dlambda_dnew,  # K = 1
            status=status,
            steps=state.steps + commit.to(torch.int32),
        )

    return step


def _take(s: _StateT, idx: Tensor) -> _StateT:
    return _StateT(*(t[..., idx] for t in s))


def trace_rays_reference(metric: Metric, state: RayState, params,
                         features: Features = Features(),
                         opts: TraceOptions = TraceOptions()) -> RayState:
    """Eager port of the reference's ``while`` driver: every active ray
    takes trial iterations until it leaves ACTIVE or ``opts.max_steps``
    iterations have run.  Finished rays leave the working set (the step is
    per-ray elementwise, so this changes no number).  The blow-up test's
    baseline is the launch |v^t| of ``state``."""
    pos = state.position.T.contiguous()
    vel = state.velocity.T.contiguous()
    acc = state.acceleration.T.contiguous()
    full = _StateT(pos, vel, acc, state.next_ds.clone(),
                   state.running_dlambda_dnew.clone(), state.status.clone(),
                   state.steps.clone())
    f_in_x = torch.abs(full.velocity[0])
    step = make_step_fn(metric, features, opts)

    ids = torch.nonzero(full.status == ACTIVE).flatten()
    work = _take(full, ids)
    fx = f_in_x[ids]

    def write_back(w: _StateT, where: Tensor):
        for dst, src in zip(full, w):
            dst[..., where] = src

    for _ in range(opts.max_steps):
        if ids.numel() == 0:
            break
        work = step(work, fx, params)
        done = work.status != ACTIVE
        if bool(done.any()):
            write_back(_take(work, done), ids[done])
            keep = ~done
            work, ids, fx = _take(work, keep), ids[keep], fx[keep]
    write_back(work, ids)
    return RayState(full.position.T.contiguous(), full.velocity.T.contiguous(),
                    full.acceleration.T.contiguous(), full.next_ds,
                    full.running_dlambda_dnew, full.status, full.steps)


def trace_rays(metric: Metric, state: RayState, params,
               features: Features = Features(),
               opts: TraceOptions = TraceOptions(),
               image_width: int | None = None) -> RayState:
    """March every ray to termination or the step limit.

    A state on a CUDA device runs the hand-written ray-march kernel, which
    launches or raises; a state on the CPU runs the eager reference.
    ``image_width``: the rays are the pixels of a row-major image of this
    width, which lets the kernel group them by pixel tile; it changes no
    result."""
    if state.position.is_cuda:
        from .raymarch import trace_rays_cuda

        return trace_rays_cuda(metric, state, params, features, opts,
                               image_width=image_width)
    return trace_rays_reference(metric, state, params, features, opts)
