"""The geodesic march of the plain reference: adaptive-step velocity Verlet
over ray batches, every ray to ESCAPED, DEAD or the step limit.

Frozen copy of ``geodesic_raytracing_tpu_torch/ops/integrate.py`` (commit
e647ccc): ``init_ray_state``, ``make_step_fn`` (the Verlet integrator
without affine reparameterisation, with planar mode) and the ``while``
driver ``trace_rays_reference`` with its graphed replay.  ``march`` takes a
``dtype``: the state and every operation of the march in that precision
(float32 as the configurations state it; a lower one is the check's
control).

Status codes: 0 = active, 1 = escaped (samples the sky), 2 = dead (black).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .geometry import acceleration_batched, fix_null_batched

Tensor = torch.Tensor

ACTIVE = 0
ESCAPED = 1
DEAD = 2

_PRECISION_SCALE = 65536.0
_MAX_TIMESTEP = 100000.0
_SCHEDULE_MIN_RADIUS = 3.0
# Trial iterations between two reads of the working set's status.
GRAPH_CHUNK = 16


class Features(NamedTuple):
    universe_size: float = 20.0
    max_acceleration_change: float = 0.01
    max_precision_radius: float = 10.0
    min_step: float = 1e-6
    ambient_precision: float = 0.2
    subambient_precision: float = 0.5


def features_for(metric) -> Features:
    """``Features.for_metric``: the defaults with the metric's step
    controller tolerance."""
    return Features(max_acceleration_change=metric.max_acceleration_change)


class RayState(NamedTuple):
    """Structure-of-arrays ray state: vectors (N, 4), scalars (N,),
    ``status`` and ``steps`` (committed steps) int32."""

    position: Tensor
    velocity: Tensor
    acceleration: Tensor
    next_ds: Tensor
    running_dlambda_dnew: Tensor
    status: Tensor
    steps: Tensor


class _StateT(NamedTuple):
    position: Tensor
    velocity: Tensor
    acceleration: Tensor
    next_ds: Tensor
    running_dlambda_dnew: Tensor
    status: Tensor
    steps: Tensor


def acceleration_to_precision(acc: Tensor, max_acceleration, w_v, udiv):
    """Error estimate and ideal next step from a (4, N) acceleration."""
    wa = [acc[i] * w_v[i] for i in range(4)]
    ss = wa[0] * wa[0] + wa[1] * wa[1] + wa[2] * wa[2] + wa[3] * wa[3]
    err_scale = torch.sqrt(torch.clamp(ss, min=1e-30)) * (0.01 / udiv)
    err = np.float32(max_acceleration)
    diff = err_scale * _PRECISION_SCALE
    floor = err * np.float32(_PRECISION_SCALE / (_MAX_TIMESTEP * _MAX_TIMESTEP))
    diff = torch.clamp(diff, min=float(floor))
    next_ds = float(np.sqrt(err * np.float32(_PRECISION_SCALE))) \
        * torch.rsqrt(diff)
    return diff, next_ds


def schedule_constants(features: Features) -> tuple[float, float]:
    inv_span = np.float32(1.0) / (np.float32(features.max_precision_radius)
                                  - np.float32(_SCHEDULE_MIN_RADIUS))
    slope = np.float32(features.subambient_precision
                       - features.ambient_precision)
    return float(inv_span), float(slope)


def metric_acceleration(metric, pos, vel, params, deps=None):
    if deps is None:
        deps = metric.depends_on
    return acceleration_batched(metric.fn, pos, vel, params, deps=deps,
                                nz=metric.structure)


def verlet_step(metric, position, velocity, acceleration, ds, params,
                deps=None):
    ds_ = ds[None, :]
    next_position = position + velocity * ds_ + 0.5 * acceleration * ds_ * ds_
    intermediate_velocity = velocity + acceleration * ds_
    next_acceleration = metric_acceleration(
        metric, next_position, intermediate_velocity, params, deps=deps)
    next_velocity = velocity + 0.5 * (acceleration + next_acceleration) * ds_
    return next_position, next_velocity, next_acceleration, torch.ones_like(ds)


def initial_next_ds(metric, features: Features, acc: Tensor) -> Tensor:
    if metric.adaptive_precision:
        w = metric.precision_weights()
        _, next_ds = acceleration_to_precision(
            acc, features.max_acceleration_change, w, udiv=float(max(w)))
        return next_ds
    return torch.full(acc.shape[1:], 1e-5, dtype=acc.dtype, device=acc.device)


def init_ray_state(metric, position: Tensor, velocity: Tensor, params,
                   features: Features) -> RayState:
    """Launch state from (N, 4) positions and velocities: null-fixed
    velocity, launch acceleration, seeded step."""
    pos = position.T.contiguous()
    vel = velocity.T.contiguous()
    n = pos.shape[1]
    gab = metric.fn(pos, params)
    vel = fix_null_batched(gab, vel)
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


def make_step_fn(metric, features: Features, planar: bool):
    """One masked integrator iteration over a component-first batch."""
    w_v = metric.precision_weights()
    udiv = float(max(w_v))
    deps = metric.depends_on
    if planar:
        deps = tuple(d for d in deps if d != 2)
    adaptive = metric.adaptive_precision
    inv_span, slope = schedule_constants(features)
    half_pi = float(np.float32(np.pi / 2))

    def step(state: _StateT, f_in_x: Tensor, params) -> _StateT:
        pos, vel, acc = state.position, state.velocity, state.acceleration
        active = state.status == ACTIVE

        polar = metric.to_polar(pos, params)
        abs_r = torch.abs(polar[1])

        new_max = features.max_precision_radius
        if adaptive:
            ds = state.next_ds
        else:
            mixd = torch.clamp((abs_r - _SCHEDULE_MIN_RADIUS) * inv_span,
                               0.0, 1.0)
            ds = features.ambient_precision + slope * mixd
        near = abs_r < new_max
        ds = torch.where(
            near,
            torch.clamp(ds, max=features.ambient_precision),
            0.1 * (abs_r - new_max) + features.ambient_precision,
        )
        ds = torch.where(active, ds, torch.zeros_like(ds))

        newly_escaped = torch.abs(polar[1]) >= features.universe_size
        if metric.singular:
            newly_escaped = newly_escaped | (
                torch.abs(polar[1]) < metric.singular_terminator)
        dead = torch.zeros_like(newly_escaped)
        rd = state.running_dlambda_dnew
        if not metric.unconditionally_nonsingular:
            dead = dead | ((torch.abs(vel[0]) > (1000.0 + f_in_x) * rd) & (
                torch.abs(acc[0]) > 100.0 * rd))

        status = state.status
        status = torch.where(active & newly_escaped, ESCAPED, status)
        status = torch.where(active & dead & ~newly_escaped, DEAD, status)
        active = status == ACTIVE

        npos, nvel, nacc, K = verlet_step(metric, pos, vel, acc, ds, params,
                                          deps=deps)
        if planar:
            npos = torch.stack([npos[0], npos[1],
                                torch.full_like(npos[2], half_pi), npos[3]])
            zero = torch.zeros_like(nvel[2])
            nvel = torch.stack([nvel[0], nvel[1], zero, nvel[3]])
            nacc = torch.stack([nacc[0], nacc[1], zero, nacc[3]])

        probe = (npos[0] + npos[1] + npos[2] + npos[3]
                 + nvel[0] + nvel[1] + nvel[2] + nvel[3]
                 + nacc[0] + nacc[1] + nacc[2] + nacc[3])
        bad = ~torch.isfinite(probe)
        status = torch.where(active & bad, DEAD, status)
        active = status == ACTIVE

        commit = active
        next_ds = state.next_ds
        if adaptive:
            err = features.max_acceleration_change
            diff, ideal_ds = acceleration_to_precision(nacc, err, w_v, udiv)
            cand = 0.99 * torch.minimum(torch.maximum(ideal_ds, 0.3 * ds),
                                        2.0 * ds)
            cand = torch.clamp(cand, min=features.min_step)
            skip = 1.95 * cand < ds
            kill = torch.zeros_like(skip)
            if metric.detect_singularities:
                kill_at = np.float32(err) * np.float32(
                    10000.0 * _PRECISION_SCALE)
                kill = (cand <= features.min_step) & (diff > float(kill_at))
            skip = skip & near
            kill = kill & near
            status = torch.where(active & kill, DEAD, status)
            commit = active & ~kill & ~skip
            next_ds = torch.where(active, cand, next_ds)

        cm = commit[None, :]
        return _StateT(
            position=torch.where(cm, npos, pos),
            velocity=torch.where(cm, nvel, vel),
            acceleration=torch.where(cm, nacc, acc),
            next_ds=next_ds,
            running_dlambda_dnew=torch.where(commit, rd * K, rd),
            status=status,
            steps=state.steps + commit.to(torch.int32),
        )

    return step


def _take(s: _StateT, idx: Tensor) -> _StateT:
    return _StateT(*(t[..., idx] for t in s))


def _march_graphed(step, work: _StateT, ids: Tensor, fx: Tensor, params,
                   max_steps: int, write_back):
    """The march with the step replayed from a CUDA graph (the same kernels
    on the same inputs, so the same bits); the working set shrinks when
    half of it has finished.  On CPU tensors each replay is an eager
    step."""
    capture = work.position.is_cuda
    its = 0
    while its < max_steps and ids.numel():
        n = ids.numel()
        static = _StateT(*(t.clone() for t in work))

        def iterate():
            for dst, src in zip(static, step(static, fx, params)):
                dst.copy_(src)

        iterate()
        its += 1
        graph, replay = None, iterate
        if capture and its < max_steps:
            graph = torch.cuda.CUDAGraph()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                graph.capture_begin()
                iterate()
                graph.capture_end()
            torch.cuda.current_stream().wait_stream(side)
            replay = graph.replay
        while its < max_steps:
            for _ in range(min(GRAPH_CHUNK, max_steps - its)):
                replay()
                its += 1
            if int((static.status == ACTIVE).sum()) <= n // 2:
                break
        graph = replay = None
        done = static.status != ACTIVE
        write_back(_take(static, done), ids[done])
        keep = ~done
        work, ids, fx = _take(static, keep), ids[keep], fx[keep]
    if capture:
        torch.cuda.empty_cache()
    return work, ids


def march(metric, state: RayState, params, features: Features, planar: bool,
          max_steps: int, dtype=torch.float32) -> RayState:
    """Every ACTIVE ray takes trial iterations until it leaves ACTIVE or
    ``max_steps`` iterations have run (``trace_rays_reference``, graphed on
    CUDA tensors, eager on the CPU).  The float fields are marched in
    ``dtype`` and returned in float32."""
    def cast(t):
        return t.to(dtype)

    full = _StateT(cast(state.position.T).contiguous(),
                   cast(state.velocity.T).contiguous(),
                   cast(state.acceleration.T).contiguous(),
                   cast(state.next_ds).clone(),
                   cast(state.running_dlambda_dnew).clone(),
                   state.status.clone(), state.steps.clone())
    f_in_x = torch.abs(full.velocity[0])
    step = make_step_fn(metric, features, planar)

    ids = torch.nonzero(full.status == ACTIVE).flatten()
    work = _take(full, ids)
    fx = f_in_x[ids]

    def write_back(w: _StateT, where: Tensor):
        for dst, src in zip(full, w):
            dst[..., where] = src

    work, ids = _march_graphed(step, work, ids, fx, params, max_steps,
                               write_back)
    write_back(work, ids)
    f32 = torch.float32
    return RayState(full.position.T.to(f32).contiguous(),
                    full.velocity.T.to(f32).contiguous(),
                    full.acceleration.T.to(f32).contiguous(),
                    full.next_ds.to(f32), full.running_dlambda_dnew.to(f32),
                    full.status, full.steps)
