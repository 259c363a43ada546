"""The geodesic integrator: adaptive-step velocity Verlet over ray batches
(port of ``geodesic_raytracing_tpu.ops.integrate``).

``trace_rays`` has the reference's two drivers.  ``method="while"``
dispatches on the device of the state: CUDA tensors go to the hand-written
ray-march kernel (``ops.raymarch.trace_rays_cuda``), which launches or
raises; CPU tensors go to ``trace_rays_reference``, the eager port of the
reference's ``while`` driver and the kernel's plain twin.  ``method="scan"``
is the differentiable fixed-length march with recomputed windows, in eager
torch on whatever device the state is on.

Status codes: 0 = active, 1 = escaped (samples the sky), 2 = dead (black).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
import torch.utils.checkpoint

from ..metrics.base import Metric
from ..utils import profiling
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
    """Trace options: the iteration budget, the integrator ("verlet" or
    "euler"), affine reparameterisation (K = 1/max|v'| after every Verlet
    step), constant-theta planar mode (set by the render pipeline for a
    spherically symmetric metric, whose rays it first rotates into the
    equator), the driver (``method``: "while", the march to termination
    (on the card the ray-march kernel), "plain", the same march as eager
    torch on any device (``trace_rays_reference``), or "scan", the
    differentiable fixed-length march) and the scan's recomputation window
    (``remat_every`` iterations)."""

    max_steps: int = MAX_STEPS_DEFAULT
    reparameterisation: bool = False
    integrator: str = "verlet"
    method: str = "while"
    planar: bool = False
    remat_every: int = 128

    def __post_init__(self):
        if self.integrator not in ("verlet", "euler"):
            raise ValueError(f"unknown integrator {self.integrator!r}")
        if self.method not in ("while", "plain", "scan"):
            raise ValueError(f"unknown trace method {self.method!r}")


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


# The near end of the scheduled step's radius ramp (cl.cl:4059-4086).
_SCHEDULE_MIN_RADIUS = 3.0


def schedule_constants(features: Features) -> tuple[float, float]:
    """``(inv_span, slope)`` of the scheduled step ``linear_val(|r|, 3,
    max_precision_radius, ambient, subambient)`` as float32 values: the
    reciprocal of the radius span and the step's rise over it.  The plain
    march and the kernel's wrapper both take them from here, so that both
    use the same two constants."""
    inv_span = np.float32(1.0) / (np.float32(features.max_precision_radius)
                                  - np.float32(_SCHEDULE_MIN_RADIUS))
    slope = np.float32(features.subambient_precision
                       - features.ambient_precision)
    return float(inv_span), float(slope)


def metric_acceleration(metric: Metric, pos, vel, params, deps=None):
    """Geodesic acceleration of a component-first batch: the rank-1
    Kerr-Schild path where the metric declares a decomposition
    (``Metric.rank1``), else the sparsity-pruned contraction (``deps``: the
    coordinates to differentiate, default the metric's)."""
    if metric.rank1 is not None:
        return geometry.acceleration_batched_rank1(metric.rank1, pos, vel,
                                                   params)
    if deps is None:
        deps = metric.depends_on
    return geometry.acceleration_batched(metric.fn, pos, vel, params,
                                         deps=deps, nz=metric.nonzeros())


def verlet_step(metric: Metric, position, velocity, acceleration, ds, params,
                reparameterisation: bool = False, deps=None):
    """cl.cl:3273-3346 — velocity Verlet with optional affine
    reparameterisation (K = 1/max|v'|).  All vectors component-first
    (4, N).  Returns ``(position, velocity, acceleration, K)``."""
    ds_ = ds[None, :]
    next_position = position + velocity * ds_ + 0.5 * acceleration * ds_ * ds_
    intermediate_velocity = velocity + acceleration * ds_
    next_acceleration = metric_acceleration(
        metric, next_position, intermediate_velocity, params, deps=deps)
    next_velocity = velocity + 0.5 * (acceleration + next_acceleration) * ds_
    if reparameterisation:
        a = torch.abs(next_velocity)
        max_divisor = torch.maximum(torch.maximum(a[0], a[1]),
                                    torch.maximum(a[2], a[3]))
        K = 1.0 / max_divisor
        return (next_position, next_velocity * K[None, :],
                next_acceleration * (K * K)[None, :], K)
    return (next_position, next_velocity, next_acceleration,
            torch.ones_like(ds))


def initial_next_ds(metric: Metric, features: Features, acc: Tensor) -> Tensor:
    """Seed the step size from the launch acceleration (4, N): the adaptive
    controller's ideal step, or 1e-5 for a metric without adaptive
    precision (whose step comes from the schedule)."""
    if metric.config.adaptive_precision:
        w = metric.precision_weights()
        _, next_ds = acceleration_to_precision(
            acc, features.max_acceleration_change, w, udiv=float(max(w)))
        return next_ds
    return torch.full(acc.shape[1:], 1e-5, dtype=acc.dtype, device=acc.device)


def init_ray_state(metric: Metric, position: Tensor, velocity: Tensor, params,
                   features: Features, fix_null_velocity: bool = True
                   ) -> RayState:
    """Initial RayState from (N, 4) positions/velocities: null-fix the
    velocity (unless ``fix_null_velocity`` is False, as for a timelike
    geodesic), compute the launch acceleration, seed the adaptive step."""
    pos = position.T.contiguous()
    vel = velocity.T.contiguous()
    n = pos.shape[1]
    if fix_null_velocity:
        gab = metric.fn(pos, params)
        if gab.ndim == 2:  # constant metric: add a broadcast batch axis
            gab = gab[..., None]
        vel = geometry.fix_null_batched(gab, vel)
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


def make_step_fn(metric: Metric, features: Features, opts: TraceOptions,
                 with_ds: bool = False):
    """One masked integrator iteration over a component-first ray batch,
    term for term the reference's ``make_step_fn``, every branch of it.
    ``f_in_x`` is the launch-time |v^t| of each ray (the blow-up test's
    baseline).  With ``with_ds`` the step also returns the committed step
    sizes (0 where nothing committed), for the geodesic recorder."""
    cfg = metric.config
    w_v = metric.precision_weights()
    udiv = float(max(w_v))
    deps = metric.depends_on
    if opts.planar:
        # theta is pinned; only the theta acceleration component uses
        # d_theta and it is identically zero on the equator of a symmetric
        # metric.
        deps = tuple(d for d in deps if d != 2)
    adaptive = cfg.adaptive_precision and opts.integrator == "verlet"
    inv_span, slope = schedule_constants(features)
    half_pi = float(np.float32(np.pi / 2))

    def step(state: _StateT, f_in_x: Tensor, params) -> _StateT:
        pos, vel, acc = state.position, state.velocity, state.acceleration
        active = state.status == ACTIVE

        polar = metric.to_polar(pos, params)
        abs_r = torch.abs(metric.origin_distance(polar, params))

        new_max = features.max_precision_radius
        if adaptive:
            ds = state.next_ds
        else:
            # Step schedule (cl.cl:4059-4086): linear in |r| between 3 and
            # the precision radius, from the ambient to the subambient step.
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

        # Termination tests on the current position (cl.cl:4088-4130).
        newly_escaped = torch.abs(polar[1]) >= features.universe_size
        if cfg.singular:
            newly_escaped = newly_escaped | (
                torch.abs(polar[1]) < cfg.singular_terminator)
        dead = torch.zeros_like(newly_escaped)
        if cfg.has_cylindrical_singularity:
            dead = dead | (pos[1] < cfg.cylindrical_terminator)
        rd = state.running_dlambda_dnew
        if not cfg.unconditionally_nonsingular:
            # |v/rd| > t  <=>  |v| > t*rd  (rd > 0).
            dead = dead | ((torch.abs(vel[0]) > (1000.0 + f_in_x) * rd) & (
                torch.abs(acc[0]) > 100.0 * rd))

        status = state.status
        status = torch.where(active & newly_escaped, ESCAPED, status)
        status = torch.where(active & dead & ~newly_escaped, DEAD, status)
        active = status == ACTIVE

        if opts.integrator == "euler":
            # step_euler (cl.cl:3352-3377): acceleration at the current
            # event, then a semi-implicit update.
            nacc = metric_acceleration(metric, pos, vel, params, deps=deps)
            nvel = vel + nacc * ds[None, :]
            npos = pos + nvel * ds[None, :]
            K = torch.ones_like(ds)
        else:
            npos, nvel, nacc, K = verlet_step(
                metric, pos, vel, acc, ds, params, opts.reparameterisation,
                deps=deps)
        if opts.planar:
            # IS_CONSTANT_THETA pins (cl.cl:3990-3995).
            npos = torch.stack([npos[0], npos[1],
                                torch.full_like(npos[2], half_pi), npos[3]])
            zero = torch.zeros_like(nvel[2])
            nvel = torch.stack([nvel[0], nvel[1], zero, nvel[3]])
            nacc = torch.stack([nacc[0], nacc[1], zero, nacc[3]])

        # Finiteness probe on the TRIAL state's component sum, before the
        # commit (an overflow of the sum itself counts as non-finite).
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
            # Division-free forms of calculate_ds_error (cl.cl:3431-3456).
            cand = 0.99 * torch.minimum(torch.maximum(ideal_ds, 0.3 * ds),
                                        2.0 * ds)
            cand = torch.clamp(cand, min=features.min_step)
            skip = 1.95 * cand < ds
            kill = torch.zeros_like(skip)
            if cfg.detect_singularities:
                kill_at = np.float32(err) * np.float32(
                    10000.0 * _PRECISION_SCALE)
                kill = (cand <= features.min_step) & (diff > float(kill_at))
            # Error control applies only in the near zone.
            skip = skip & near
            kill = kill & near
            status = torch.where(active & kill, DEAD, status)
            commit = active & ~kill & ~skip
            next_ds = torch.where(active, cand, next_ds)

        cm = commit[None, :]
        out = _StateT(
            position=torch.where(cm, npos, pos),
            velocity=torch.where(cm, nvel, vel),
            acceleration=torch.where(cm, nacc, acc),
            next_ds=next_ds,
            running_dlambda_dnew=torch.where(commit, rd * K, rd),
            status=status,
            steps=state.steps + commit.to(torch.int32),
        )
        if with_ds:
            return out, torch.where(commit, ds, 0.0)
        return out

    return step


def _take(s: _StateT, idx: Tensor) -> _StateT:
    return _StateT(*(t[..., idx] for t in s))


# Trial iterations between two reads of the working set's status in the
# graphed march (each read waits for the device).
GRAPH_CHUNK = 16


def _march_graphed(step, work: _StateT, ids: Tensor, fx: Tensor, params,
                   max_steps: int, write_back) -> tuple[_StateT, Tensor]:
    """The ``while`` march with the step replayed from a CUDA graph: the
    same kernels on the same inputs, so the same bits, without the host's
    cost of launching each op.  A graph holds one working-set size, so the
    set shrinks only when half of it has finished; until then a finished
    ray takes iterations that change nothing (inactive, its step is 0 and
    never commits, as in ``trace_rays_scan``).  The status is read every
    ``GRAPH_CHUNK`` iterations.  On CPU tensors each replay is an eager
    step (how the tests hold this march to the eager one).  At its end the
    march returns its graphs' memory pools to the device
    (``torch.cuda.empty_cache``): the caching allocator keeps a dead graph's
    private pool reserved until then, and a 1080p march of a complex
    two-body metric leaves several GiB.  Returns the working set and its
    ray indices after ``max_steps`` iterations."""
    capture = work.position.is_cuda
    its = 0
    while its < max_steps and ids.numel():
        n = ids.numel()
        static = _StateT(*(t.clone() for t in work))

        def iterate():
            for dst, src in zip(static, step(static, fx, params)):
                dst.copy_(src)

        # One eager iteration first: lazy initialisation stays out of the
        # capture.
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


def trace_rays_reference(metric: Metric, state: RayState, params,
                         features: Features = Features(),
                         opts: TraceOptions = TraceOptions(),
                         graphed: bool | None = None,
                         f_in_x: Tensor | None = None) -> RayState:
    """Eager port of the reference's ``while`` driver: every active ray
    takes trial iterations until it leaves ACTIVE or ``opts.max_steps``
    iterations have run.  Finished rays leave the working set (the step is
    per-ray elementwise, so this changes no number).  The blow-up test's
    baseline ``f_in_x`` is the launch |v^t| of each ray (default: taken from
    ``state``).  ``graphed`` (by default on CUDA tensors) replays the step
    from a CUDA graph, ``_march_graphed``; otherwise every iteration is an
    eager step."""
    pos = state.position.T.contiguous()
    vel = state.velocity.T.contiguous()
    acc = state.acceleration.T.contiguous()
    full = _StateT(pos, vel, acc, state.next_ds.clone(),
                   state.running_dlambda_dnew.clone(), state.status.clone(),
                   state.steps.clone())
    if f_in_x is None:
        f_in_x = torch.abs(full.velocity[0])
    step = make_step_fn(metric, features, opts)

    ids = torch.nonzero(full.status == ACTIVE).flatten()
    work = _take(full, ids)
    fx = f_in_x[ids]

    def write_back(w: _StateT, where: Tensor):
        for dst, src in zip(full, w):
            dst[..., where] = src

    if graphed is None:
        graphed = pos.is_cuda
    if graphed:
        work, ids = _march_graphed(step, work, ids, fx, params,
                                   opts.max_steps, write_back)
    else:
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


def trace_rays_scan(metric: Metric, state: RayState, params,
                    features: Features = Features(),
                    opts: TraceOptions = TraceOptions()) -> RayState:
    """The reference's differentiable driver (``method="scan"``): a fixed
    ``outer_n * inner_n`` trial iterations over ALL rays, with ``inner_n =
    min(remat_every, max_steps)`` and ``outer_n = ceil(max_steps /
    inner_n)``, so up to ``inner_n - 1`` more than ``max_steps``, as the
    reference's nested scan.  Finished rays take no-op iterations through the
    step's own masks (a DEAD or ESCAPED ray steps with ds = 0 and never
    commits), so the final state equals the ``while`` driver's wherever that
    one ran to the end; nothing waits for the device.

    With grad enabled each window of ``inner_n`` iterations runs under
    ``torch.utils.checkpoint`` (non-reentrant): the backward pass keeps only
    the window boundaries and recomputes one window at a time, the
    reference's ``jax.checkpoint`` on its outer scan body.  The returned
    tensors carry the autograd graph back to ``params`` (tensors that
    require grad) and to ``state``.  This driver never calls the CUDA
    kernel, which is forward-only as the reference's Pallas kernel is: on a
    GPU it runs as eager torch ops, the reference's own XLA path."""
    st = _StateT(state.position.T, state.velocity.T, state.acceleration.T,
                 state.next_ds, state.running_dlambda_dnew, state.status,
                 state.steps)
    # Only compared with, never differentiated.
    f_in_x = torch.abs(st.velocity[0]).detach()
    step = make_step_fn(metric, features, opts)
    inner_n = min(opts.remat_every, opts.max_steps)
    outer_n = -(-opts.max_steps // inner_n)

    def window(*s):
        s = _StateT(*s)
        for _ in range(inner_n):
            s = step(s, f_in_x, params)
        return tuple(s)

    s = tuple(st)
    for _ in range(outer_n):
        if torch.is_grad_enabled():
            s = torch.utils.checkpoint.checkpoint(window, *s,
                                                  use_reentrant=False)
        else:
            s = window(*s)
    s = _StateT(*s)
    return RayState(s.position.T, s.velocity.T, s.acceleration.T, s.next_ds,
                    s.running_dlambda_dnew, s.status, s.steps)


def trace_rays(metric: Metric, state: RayState, params,
               features: Features = Features(),
               opts: TraceOptions = TraceOptions(),
               image_width: int | None = None) -> RayState:
    """March every ray to termination or the step limit.

    ``opts.method``:

    * ``"while"``: a state on a CUDA device runs the hand-written ray-march
      kernel, which launches or raises (never eager torch); a state on the
      CPU runs the eager reference.  Not differentiable: with grad enabled,
      a state or parameter tensor that requires grad raises (a kernel
      launch would silently cut the graph).
    * ``"plain"``: the same march as eager torch on the state's device
      (:func:`trace_rays_reference`), never the kernel.
    * ``"scan"``: :func:`trace_rays_scan`, reverse-differentiable with
      respect to ``params`` and the launch state, on the state's device.
      ``render.pipeline.compute_render_data`` has no option: in grad mode,
      an input or a parameter that requires grad sends it to its eager
      twin on any device, else a CUDA state takes its kernel.

    ``image_width``: the rays are the pixels of a row-major image of this
    width, which lets the kernel group them by pixel tile; it changes no
    result.  Each call is a ``trace`` span of ``utils.profiling``'s
    recorder."""
    with profiling.span("trace", state.position.device):
        if opts.method == "scan":
            return trace_rays_scan(metric, state, params, features, opts)
        if torch.is_grad_enabled() and any(
                isinstance(t, Tensor) and t.requires_grad
                for t in (*state, *params.values())):
            raise ValueError("trace_rays: the 'while' driver is not "
                             "differentiable; use "
                             "TraceOptions(method='scan')")
        if state.position.is_cuda and opts.method == "while":
            from .raymarch import trace_rays_cuda

            return trace_rays_cuda(metric, state, params, features, opts,
                                   image_width=image_width)
        return trace_rays_reference(metric, state, params, features, opts)


def trace_rays_recorded_reference(metric: Metric, state: RayState, params,
                                  features: Features = Features(),
                                  opts: TraceOptions = TraceOptions(),
                                  n_slots: int = 16,
                                  steps_per_slot: int = 64
                                  ) -> tuple[RayState, Tensor]:
    """The plain recorded march, twin of the kernel's
    (``ops.raymarch.trace_rays_recorded_cuda``): ``n_slots`` marches of
    ``steps_per_slot`` trial iterations by :func:`trace_rays_reference`
    (graphed on CUDA tensors), every one with the launch state's |v^t| as
    the blow-up test's baseline (as the reference's scan of slots, which
    takes it once).  Returns ``(final RayState, path (n_slots+1, N, 4))``."""
    f_in_x = torch.abs(state.velocity[:, 0]).contiguous()
    slot = dataclasses.replace(opts, max_steps=steps_per_slot)
    n = state.position.shape[0]
    path = torch.empty((n_slots + 1, n, 4), dtype=state.position.dtype,
                       device=state.position.device)
    path[0] = state.position
    for j in range(n_slots):
        state = trace_rays_reference(metric, state, params, features, slot,
                                     f_in_x=f_in_x)
        path[j + 1] = state.position
    return state, path


def trace_rays_recorded(metric: Metric, state: RayState, params,
                        features: Features = Features(),
                        opts: TraceOptions = TraceOptions(),
                        n_slots: int = 16, steps_per_slot: int = 64,
                        image_width: int | None = None
                        ) -> tuple[RayState, Tensor]:
    """Trace while recording the ray paths every ``steps_per_slot``
    iterations: the triangle-mode path recording of ``do_generic_rays``
    (cl.cl:4181-4232, ``ray_skip``).

    Returns ``(final RayState, path (n_slots+1, N, 4))``: slot 0 is the
    launch position and slot j the position after ``j * steps_per_slot``
    trial iterations (terminated rays repeat their last position, so their
    later segments are degenerate and never hit).  ``opts.max_steps`` is
    not read: every ray has ``n_slots * steps_per_slot`` trial iterations.

    A state on a CUDA device is marched by ``n_slots`` launches of the
    ray-march kernel (``ops.raymarch.trace_rays_recorded_cuda``), which
    launch or raise; a state on the CPU by the plain recorded march."""
    if state.position.is_cuda:
        from .raymarch import trace_rays_recorded_cuda

        return trace_rays_recorded_cuda(metric, state, params, features,
                                        opts, n_slots, steps_per_slot,
                                        image_width=image_width)
    return trace_rays_recorded_reference(metric, state, params, features,
                                         opts, n_slots, steps_per_slot)
