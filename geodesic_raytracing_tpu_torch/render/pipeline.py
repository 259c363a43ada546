"""End-to-end render pipeline: camera -> rays -> geodesics -> image (port of
``geodesic_raytracing_tpu.render.pipeline``: the dense and the adaptive frame).

Stages, each a plain function on tensors of one device: ``init_camera_rays``
(observer tetrad, pixel directions, null rays), ``integrate.trace_rays`` (the
CUDA ray-march kernel on a GPU), ``compute_render_data`` (snap to the
universe or the terminator sphere, texture coordinates, redshift factor) and
``shade`` (EWA sky sampling, redshift colour).  For a spherically symmetric
metric the rays are first rotated into the equator (``ops/planar.py``), the
march pins theta, and ``compute_render_data`` rotates the endpoints back.

The adaptive frame (``adaptive_sampling=True``) marches a 16x coarser
prepass image, the quarter grid (every even pixel, minus the rays the
prepass proves black) and the three other pixels of the top-k quarter blocks
by angular error; the remaining pixels are interpolated.  Each march is one
launch of the same kernel; every other stage is plain torch ops, none of
which waits for the device.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple

import numpy as np
import torch

from .. import camera as cam
from ..metrics.base import Metric
from ..ops import geometry, integrate, packing, planar as pl_planar, tetrad
from ..ops.integrate import Features, RayState, TraceOptions
from . import background as bg
from . import colour

Tensor = torch.Tensor


class RenderData(NamedTuple):
    """Per-pixel shading inputs (reference ``struct render_data``)."""

    tex_coord: Tensor  # (N, 2) in [0,1]^2
    z_shift: Tensor  # (N,)
    side: Tensor  # (N,) int32: 1 = r>=0 universe, 0 = far side
    terminated: Tensor  # (N,) int32 status
    angles: Tensor  # (N, 2) snapped (theta, phi)
    steps: Tensor  # (N,) committed integrator steps


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """Render settings the ported slices read (graphics_settings.hpp).
    ``trace.planar`` is set by the pipeline (``_planar_enabled``), never by
    the caller."""

    width: int = 1920
    height: int = 1080
    fov_degrees: float = 90.0
    anisotropy: int = 16
    redshift: bool = False
    # use_old_redshift feature (main.cpp:1139): skip the blueshift
    # energy-overflow redistribution (cl.cl:5397-5406).
    old_redshift: bool = False
    # DOMINANT_COLOUR variant (cl.cl:5724-5792): per-pixel test wavelength.
    dominant_colour: bool = False
    # Spectral-shift experiment on the CIE 1931 horseshoe.
    spectral_redshift: bool = False
    trace: TraceOptions = TraceOptions()
    # Quarter-density trace + error-driven refinement (main.cpp:1152), with
    # the angular-error threshold in pixels of angle (main.cpp:1155) and the
    # prepass image's scale-down.
    adaptive_sampling: bool = False
    adaptive_threshold: float = 64.0
    prepass_scale: int = 16
    # Refinement ray budget as a fraction of the quarter blocks.  Blocks are
    # prioritised by angular error (terminated-mismatch blocks first); the
    # lowest-error blocks beyond the budget fall back to interpolation.
    # 1.0 = every block may be traced.
    refine_budget: float = 0.375
    trilinear: bool = True  # mip blending; False = nearest level
    # EWA probe-iteration schedule ((frac, iters), ...) over the pixels
    # sorted by probe demand; empty = the top third at the full budget.
    probe_segments: tuple = ()
    # Shade only the traced rays (quarter grid + refined blocks) and
    # interpolate RGB across the blocks that passed the angular-error test,
    # instead of assembling full-resolution render data and shading every
    # pixel (the reference renderer's semantics, cl.cl:5223-5344).
    shade_traced_only: bool = True
    # Probe schedule of the refine-ray shade set under shade_traced_only;
    # empty derives one from probe_segments with 4x the fractions.
    refine_probe_segments: tuple = ()
    # Constant-theta planar tracing for spherically symmetric metrics
    # (exact by symmetry; GENERIC_CONSTANT_THETA).
    planar: bool = True
    # Trace the geodesics forwards in affine time instead of backwards (the
    # reference's flip toggle; follow_geodesics_forward flips it again).
    flip_geodesic_direction: bool = False
    # Bilinear taps for the EWA probes instead of point samples.
    probe_bilinear: bool = False


# ---------------------------------------------------------------------------
# Ray initialisation
# ---------------------------------------------------------------------------

def camera_to_generic(metric: Metric, camera: cam.Camera, params) -> Tensor:
    """Polar camera position -> metric generic coordinates."""
    return metric.from_polar(camera.polar_position, params)


def camera_frame(metric: Metric, camera: cam.Camera, params):
    """Generic camera position + oriented, boosted observer tetrad.

    A camera riding a recorded geodesic (``frame_override``) supplies its
    interpolated position and tetrad directly
    (handle_interpolating_geodesic cl.cl:2738-2872) and skips the
    static-observer construction."""
    if camera.frame_override is not None:
        return camera.frame_override
    position = camera_to_generic(metric, camera, params)
    es = cam.observer_tetrad(metric, position, params,
                             basis_speed3=camera.basis_speed, orient=True)
    return position, es


def _trace_sign(metric: Metric, flip: bool = False) -> float:
    """Backwards-in-affine-time tracing unless the metric follows
    geodesics forward (cl.cl:3196-3206); ``flip`` (the settings'
    ``flip_geodesic_direction``) reverses either."""
    sign = 1.0 if metric.config.follow_geodesics_forward else -1.0
    return -sign if flip else sign


def _grid_coords(w: int, h: int, step: float, device):
    """Flat row-major pixel coordinates ``(cx, cy)`` of the w x h grid of
    every ``step``-th pixel."""
    yy, xx = torch.meshgrid(
        step * torch.arange(h, dtype=torch.float32, device=device),
        step * torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return xx.reshape(-1), yy.reshape(-1)


def rays_for_pixels(metric: Metric, camera: cam.Camera, position, es, params,
                    settings: RenderSettings, features: Features,
                    cx: Tensor, cy: Tensor, planar: bool = False):
    """Null rays for flat pixel coordinate arrays ``cx``/``cy`` of the
    W x H image (``init_rays_generic`` cl.cl:3143-3251).  With ``planar``
    every ray is rotated into the equatorial plane (``correct_lightray``).
    Returns ``(state, ku_uobsu, inv_quat)`` (inv_quat None unless
    planar)."""
    dirs = cam.directions_for_pixels(cx, cy, settings.width,
                                     settings.height, camera.quat,
                                     settings.fov_degrees)
    return rays_for_directions(metric, position, es, params, features, dirs,
                               planar, settings.flip_geodesic_direction)


def rays_for_directions(metric: Metric, position, es, params,
                        features: Features, dirs: Tensor,
                        planar: bool = False, flip: bool = False):
    """Null rays along the camera-space directions ``dirs`` (3, N) from the
    observer at ``position`` with tetrad ``es``: ``rays_for_pixels`` after
    its pixel directions.  Returns ``(state, ku_uobsu, inv_quat)``."""
    sign = _trace_sign(metric, flip)
    velocity = (
        dirs[0][:, None] * es[1][None, :]
        + dirs[1][:, None] * es[2][None, :]
        + dirs[2][:, None] * es[3][None, :]
        + sign * es[0][None, :]
    )
    n = velocity.shape[0]
    positions = position.expand(n, 4)

    inv_quat = None
    if planar:
        # (The expanded positions share their memory: a jvp needs a copy.)
        p_t, v_t, inv_quat = pl_planar.to_planar(
            metric, positions.T.contiguous(), velocity.T.contiguous(), params)
        positions, velocity = p_t.T, v_t.T

    state = integrate.init_ray_state(metric, positions, velocity, params,
                                     features)
    if planar:
        # Pin residual theta dynamics from the rotation's fp noise.
        vel_p, acc_p = state.velocity.clone(), state.acceleration.clone()
        vel_p[:, 2] = 0.0
        acc_p[:, 2] = 0.0
        state = state._replace(velocity=vel_p, acceleration=acc_p)

    # ku_uobsu: observer-frame energy at emission (cl.cl:3047-3060), as
    # elementwise sums (no matmul, so no TF32 path on the card).
    gab = metric.fn(position, params)
    uobs_low = geometry.matvec(gab, es[0])
    v = state.velocity
    ku_uobsu = (v[:, 0] * uobs_low[0] + v[:, 1] * uobs_low[1]
                + v[:, 2] * uobs_low[2] + v[:, 3] * uobs_low[3])
    return state, ku_uobsu, inv_quat


def _planar_enabled(metric: Metric, settings: RenderSettings) -> bool:
    """Constant-theta planar tracing applies to spherically symmetric
    metrics (the reference's is_polar_spherically_symmetric gate,
    metric.hpp:557-622 -> GENERIC_CONSTANT_THETA)."""
    return bool(metric.spherically_symmetric) and settings.planar


def _trace_opts(metric: Metric, settings: RenderSettings) -> TraceOptions:
    """The frame's trace options with ``planar`` as the metric and the
    settings decide it."""
    return dataclasses.replace(settings.trace,
                               planar=_planar_enabled(metric, settings))


def init_camera_rays(metric: Metric, camera: cam.Camera, params,
                     settings: RenderSettings,
                     features: Features = Features(), *, device):
    """Full-image ray batch on ``device``, flattened to N = W*H
    (row-major).  Returns ``(state, ku_uobsu, inv_quat)``."""
    W, H = settings.width, settings.height
    camera = camera.to(device)
    position, es = camera_frame(metric, camera, params)
    return rays_for_pixels(metric, camera, position, es, params, settings,
                           features, *_grid_coords(W, H, 1.0, device),
                           planar=_planar_enabled(metric, settings))


# ---------------------------------------------------------------------------
# Render data (texture coords + redshift factor)
# ---------------------------------------------------------------------------

def angle_to_tex(angles: Tensor) -> Tensor:
    """(theta, phi) -> equirect uv (cl.cl:5081-5101)."""
    theta = torch.remainder(angles[..., 0], 2 * math.pi)
    phi = angles[..., 1]
    over = theta >= math.pi
    phi = torch.where(over, phi + math.pi, phi)
    theta = torch.where(over, theta - math.pi, theta)
    phi = torch.remainder(phi, 2 * math.pi)
    sx = phi / (2 * math.pi) + 0.5
    sy = theta / math.pi
    return torch.stack([sx, sy], dim=-1)


def _fix_ray_position_batched(p3, v3, sphere_radius):
    """Snap polar (r, theta, phi) endpoints p3 (3, N) along their velocity
    v3 onto the sphere of ``sphere_radius``.  Returns (3, N)."""
    sign = torch.sign(p3[0])
    sign = torch.where(sign == 0, 1.0, sign)
    r = torch.abs(p3[0])
    th, ph = p3[1], p3[2]
    vr = v3[0] * sign
    vth, vph = v3[1], v3[2]

    st, ct = torch.sin(th), torch.cos(th)
    sp, cp = torch.sin(ph), torch.cos(ph)
    px = r * st * cp
    py = r * st * sp
    pz = r * ct
    vx = vr * st * cp + r * ct * cp * vth - r * st * sp * vph
    vy = vr * st * sp + r * ct * sp * vth + r * st * cp * vph
    vz = vr * ct - r * st * vth

    vn = torch.sqrt(vx * vx + vy * vy + vz * vz)
    vn = torch.where(vn < 1e-12, 1.0, vn)
    vx, vy, vz = vx / vn, vy / vn, vz / vn

    b = 2.0 * (vx * px + vy * py + vz * pz)
    c = px * px + py * py + pz * pz - sphere_radius * sphere_radius
    disc = b * b - 4.0 * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / 2.0
    t1 = (-b + sq) / 2.0
    t = torch.where(torch.abs(t0) < torch.abs(t1), t0, t1)
    t = torch.where(disc < 0, 0.0, t)
    nx, ny, nz = px + t * vx, py + t * vy, pz + t * vz

    nr = torch.sqrt(nx * nx + ny * ny + nz * nz)
    nth = torch.atan2(torch.sqrt(nx * nx + ny * ny), nz)
    nph = torch.atan2(ny, nx)
    return torch.stack([nr * sign, nth, nph])


def compute_render_data(metric: Metric, state: RayState, ku_uobsu: Tensor,
                        params, features: Features = Features(),
                        inv_quat: Tensor | None = None) -> RenderData:
    """``calculate_render_data`` (cl.cl:5135-5220): terminated rays snapped
    to the universe sphere (or a singular metric's terminator sphere),
    textured by final (theta, phi), with the observed/emitted energy ratio
    z_shift.  ``inv_quat``: the planar rays' inverse quaternions, which
    rotate the equatorial endpoints back to each ray's true plane."""
    cfg = metric.config
    n = state.position.shape[0]
    pos = state.position.T
    vel = state.velocity.T
    rdl = state.running_dlambda_dnew
    status = state.status

    polar = metric.to_polar(pos, params)
    polar_vel = metric.to_polar_velocity(pos, vel, params)

    snapped_far = _fix_ray_position_batched(polar[1:], polar_vel[1:],
                                            features.universe_size)
    if cfg.singular:
        is_far = torch.abs(polar[1]) >= 0.5 * (
            features.universe_size + cfg.singular_terminator)
        if cfg.traversable_event_horizon:
            # Terminator-sphere snap only for traversable horizons
            # (cl.cl:5041-5045).
            near = _fix_ray_position_batched(polar[1:], polar_vel[1:],
                                             cfg.singular_terminator)
        else:
            # The raw endpoint, so that the |r| <= 1 black test below can
            # fire.
            near = polar[1:]
        snapped = torch.where(is_far[None, :], snapped_far, near)
    else:
        snapped = snapped_far

    if inv_quat is not None:
        # Planar mode: rotate the equatorial endpoint back to the ray's true
        # plane (get_intersection_position cl.cl:5056-5064).
        snapped = pl_planar.unrotate_angles(snapped, inv_quat)

    side = torch.where(polar[1] < 0, 0, 1).to(torch.int32)

    # Fresh (unoriented, unboosted) tetrad at every endpoint for the
    # observed frequency (cl.cl:5185-5208).
    gab = metric.fn(pos, params)
    if gab.ndim == 2:  # constant metric
        gab = gab[..., None].expand(4, 4, n)
    es, _ = tetrad.frame_basis_batched(gab)
    e0 = es[0]
    obs_low = [
        sum(gab[a, b] * e0[b] for b in range(4)) for a in range(4)
    ]
    gen_vel = vel / rdl[None, :]
    z_shift = (
        sum(gen_vel[a] * obs_low[a] for a in range(4)) / ku_uobsu - 1.0
    )
    z_shift = torch.clamp(z_shift, min=-0.999)

    ang = torch.stack([snapped[1], snapped[2]], dim=-1)
    tex = angle_to_tex(ang)

    if not cfg.traversable_event_horizon:
        # Endpoints inside |r| <= 1 shade black (cl.cl:5177-5183).
        status = torch.where(
            (status == integrate.ESCAPED) & (torch.abs(snapped[0]) <= 1.0),
            integrate.DEAD, status)

    return RenderData(tex_coord=tex, z_shift=z_shift, side=side,
                      terminated=status, angles=ang, steps=state.steps)


# ---------------------------------------------------------------------------
# Shading and the frame
# ---------------------------------------------------------------------------

def shade(rdata: RenderData, backgrounds: bg.Background,
          settings: RenderSettings) -> Tensor:
    """Anisotropic background sampling and relativistic redshift; rays
    that did not escape paint black.  Returns (H, W, 3) linear-light RGB in
    [0, 1]."""
    W, H = settings.width, settings.height
    tex = rdata.tex_coord.reshape(H, W, 2)
    side = rdata.side.reshape(H, W)
    terminated = rdata.terminated.reshape(H, W)
    live = terminated == integrate.ESCAPED
    rgb = bg.sample_anisotropic(
        backgrounds, tex, side, max_probes=settings.anisotropy,
        trilinear=settings.trilinear, live=live,
        probe_segments=settings.probe_segments,
        probe_bilinear=settings.probe_bilinear,
    )
    rgb = _redshifted(rgb, rdata.z_shift.reshape(H, W), settings)
    return torch.where(live[..., None], rgb, 0.0)


def _redshifted(rgb: Tensor, z_shift: Tensor,
                settings: RenderSettings) -> Tensor:
    """``rgb`` with the settings' redshift model applied (or as it is)."""
    if not settings.redshift:
        return rgb
    return colour.apply_redshift(rgb, z_shift,
                                 dominant_colour=settings.dominant_colour,
                                 old=settings.old_redshift,
                                 spectral=settings.spectral_redshift)


def check_device(device) -> torch.device:
    """The device a caller asked for; a CUDA device without a usable GPU is
    an error, never a quiet move to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                           "available")
    return device


# ---------------------------------------------------------------------------
# Adaptive sampling + prepass (handle_adaptive_sampling cl.cl:5223-5344,
# prepass cl.cl:4997-5020 + init_rays_generic:3213-3232)
# ---------------------------------------------------------------------------

def _ang_to_vec(angles: Tensor) -> Tensor:
    """(theta, phi) -> unit 3-vector, component-last."""
    th, ph = angles[..., 0], angles[..., 1]
    st = torch.sin(th)
    return torch.stack([st * torch.cos(ph), st * torch.sin(ph),
                        torch.cos(th)], dim=-1)


def _vec_to_ang(v: Tensor) -> Tensor:
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.stack(
        [torch.atan2(torch.sqrt(x * x + y * y), z), torch.atan2(y, x)],
        dim=-1)


def _angle_between(a1: Tensor, a2: Tensor) -> Tensor:
    """Great-circle angle between two (theta, phi) fields
    (``angle_between_angles2`` cl.cl:5216-5221)."""
    d = torch.sum(_ang_to_vec(a1) * _ang_to_vec(a2), dim=-1)
    return torch.acos(torch.clamp(d, -1.0, 1.0))


def _interp_rdata(c: RenderData, o: RenderData, vc: Tensor,
                  vo: Tensor) -> RenderData:
    """``interpolate_render_data`` (cl.cl:5111-5133): midpoint on the sphere,
    averaged z_shift, centre's terminated flag.  ``vc``/``vo``: the
    ``_ang_to_vec`` of the two angle fields."""
    ang = _vec_to_ang((vc + vo) / 2.0)
    return RenderData(
        tex_coord=angle_to_tex(ang),
        z_shift=(c.z_shift + o.z_shift) / 2.0,
        side=(c.side + o.side) // 2,
        terminated=c.terminated,
        angles=ang,
        steps=c.steps,
    )


def _shift2d(x: Tensor, dy: int, dx: int, fill) -> Tensor:
    """2D shift with edge fill: ``out[i, j] = x[i + dy, j + dx]``."""
    ph, pw = x.shape
    padded = x.new_full((ph + 2, pw + 2), fill)
    padded[1:-1, 1:-1] = x
    return padded[1 + dy:1 + dy + ph, 1 + dx:1 + dx + pw]


def _and5(m: Tensor) -> Tensor:
    """A bool map AND its four edge neighbours (False beyond the edge): the
    reference's 5-probe early-termination test (cl.cl:3213-3232)."""
    return (_shift2d(m, 0, -1, False) & m & _shift2d(m, 0, 1, False)
            & _shift2d(m, -1, 0, False) & _shift2d(m, 1, 0, False))


@functools.lru_cache(maxsize=None)
def _round_index(n_out: int, n_small: int, step: float, extent: int,
                 device) -> Tensor:
    """``clip(round(step * i * n_small / extent), 0, n_small - 1)`` for i in
    [0, n_out), rounded half to even on the host, as an index tensor on
    ``device`` (kept: made once per shape and device)."""
    idx = np.round(np.arange(n_out) * step * n_small / extent)
    idx = np.clip(idx, 0, n_small - 1).astype(np.int64)
    return torch.from_numpy(idx).to(device)


def _upsample_round(small: Tensor, cx_count: int, cy_count: int,
                    step: float, W: int, H: int) -> Tensor:
    """``small[round(cy*ph/H), round(cx*pw/W)]`` on the regular pixel grids
    ``cx = step*ix``, ``cy = step*iy``: a monotone nearest-neighbour
    upsample, one constant index vector per axis."""
    ph, pw = small.shape
    iy = _round_index(cy_count, ph, step, H, small.device)
    ix = _round_index(cx_count, pw, step, W, small.device)
    return small.index_select(0, iy).index_select(1, ix)


def _prepass_kill(dead: Tensor, W: int, H: int, qw: int, qh: int) -> Tensor:
    """Quarter-grid kill mask from the low-res prepass dead map: a ray skips
    tracing when its prepass cell and 4 neighbours all terminate black
    (should_early_terminate x5, cl.cl:3213-3232).  The neighbour test runs
    on the small map, which is then nearest-upsampled to the quarter grid."""
    return _upsample_round(_and5(dead), qw, qh, 2.0, W, H).reshape(-1)


def _init_rays(metric: Metric, camera: cam.Camera, frame, params,
               settings: RenderSettings, features: Features,
               cx: Tensor, cy: Tensor, kill: Tensor | None):
    """Rays of the pixels ``cx``/``cy`` from the camera's ``frame`` (the
    ``(position, es)`` of ``camera_frame``, computed once per rendered
    frame); rays under ``kill`` are born DEAD and are never marched."""
    state, ku, iquat = rays_for_pixels(
        metric, camera, *frame, params, settings, features, cx, cy,
        planar=_planar_enabled(metric, settings))
    if kill is not None:
        state = state._replace(
            status=torch.where(kill, integrate.DEAD, state.status))
    return state, ku, iquat


def _prepass_dead_map(metric: Metric, camera: cam.Camera, frame, params,
                      settings: RenderSettings, features: Features):
    """March the whole (small) image of ``settings``.  Returns its (H, W)
    dead map and step counts."""
    W, H = settings.width, settings.height
    cx, cy = _grid_coords(W, H, 1.0, frame[0].device)
    pstate, _, _ = _init_rays(metric, camera, frame, params, settings,
                              features, cx, cy, None)
    pfin = integrate.trace_rays(metric, pstate, params, features=features,
                                opts=_trace_opts(metric, settings),
                                image_width=W)
    dead = (pfin.status == integrate.DEAD).reshape(H, W)
    return dead, pfin.steps.reshape(H, W)


class RefineBudgetController:
    """Cross-frame controller: demand-proportional refinement budgeting and
    prepass reuse.

    **Budget.** The reference sizes its refinement dispatch by an atomic
    counter: exactly the frame's demand (cl.cl:5294).  Here the refine
    launch's size ``k`` is a host integer fixed before the frame's demand is
    known, so the demand fraction of earlier frames, quantised to a few
    buckets, sets it.  Feedback never blocks the pipeline: the demand scalar
    of frame t starts an asynchronous copy to pinned host memory and is read
    ``latency`` frames later, when the copy has long completed.  The budget
    grows at once when demand rises (quality first: over-budget blocks fall
    back to interpolation) and shrinks only after ``down_patience``
    consecutive low frames.

    **Feedback kept on the device.** ``qsteps`` / ``rsteps``: the previous
    frame's measured step counts of the quarter rays (nq,) and the per-block
    maximum over the three refine rays (nq,; 0 where the block was not
    traced), for a cost sort of the launches, which nothing uses yet.
    ``qterm`` / ``stream_key``: the previous frame's quarter statuses and the
    key of the stream they were rendered under.  When the key is unchanged
    (the same camera, params and features objects: a static frame stream)
    the prepass is skipped: last frame's quarter-grid dead map, eroded by
    the same 5-neighbour test, supplies the kill mask.
    """

    BUCKETS = (1 / 16, 1 / 8, 3 / 16, 1 / 4, 3 / 8, 1 / 2, 3 / 4, 1.0)

    def __init__(self, margin: float = 1.3, latency: int = 2,
                 down_patience: int = 3):
        self._pending: list = []  # (demand on the host, copy-done event)
        self._margin = margin
        self._latency = latency
        self._down_patience = down_patience
        self._down = 0
        self._current: float | None = None
        self.qsteps: Tensor | None = None
        self.rsteps: Tensor | None = None
        self.qterm: Tensor | None = None
        self.stream_key: tuple | None = None
        # The objects whose ids are in stream_key, kept alive so that no new
        # object can take an id of the key.
        self.stream_objects: tuple | None = None

    def fraction(self, cap: float) -> float:
        """The refine budget to use for the next frame (<= cap)."""
        if self._current is None:
            return cap
        return min(self._current, cap)

    def observe(self, demand_scalar) -> None:
        """Feed the measured demand fraction of the frame just issued (a 0-d
        tensor, or a host scalar); consumes matured entries without waiting
        for fresh ones."""
        done = None
        if isinstance(demand_scalar, torch.Tensor) and demand_scalar.is_cuda:
            host = torch.empty((), dtype=demand_scalar.dtype, pin_memory=True)
            host.copy_(demand_scalar, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            demand_scalar = host
        self._pending.append((demand_scalar, done))
        while len(self._pending) > self._latency:
            value, done = self._pending.pop(0)
            if done is not None:
                done.synchronize()
            self._update(float(value))

    def _update(self, demand: float) -> None:
        want = demand * self._margin
        target = next((b for b in self.BUCKETS if b >= want), 1.0)
        if self._current is None or target > self._current:
            self._current = target
            self._down = 0
        elif target < self._current:
            self._down += 1
            if self._down >= self._down_patience:
                self._current = target
                self._down = 0
        else:
            self._down = 0


def _stream_key(camera, params, features) -> tuple:
    """Cheap identity key of a frame stream: tensors compare by object id
    (reading one back would wait for the device), scalars by value; a
    geodesic camera's ``frame_override`` by the ids of its two tensors.  A
    frame loop that reuses its camera / params / features objects gets the
    steady-state prepass reuse; one that rebuilds them every frame re-runs
    the prepass: conservative, never wrong."""
    leaves = (*camera[:3], *(camera.frame_override or (None,)),
              *(x for kv in sorted(params.items()) for x in kv), *features)
    return tuple(id(x) if isinstance(x, torch.Tensor) else x for x in leaves)


def _refine_k(nq: int, frac: float) -> int:
    """Blocks in the refine launch for a budget fraction of ``nq``."""
    if frac >= 1.0:
        return nq
    return max(min(nq, 1024), (int(nq * frac) // 8) * 8)


def _adaptive_trace(metric: Metric, camera: cam.Camera, params,
                    settings: RenderSettings, features: Features,
                    controller: RefineBudgetController | None = None,
                    *, device):
    """The adaptive pipeline's trace half: prepass + quarter trace +
    budgeted refinement selection + refine trace.

    Returns ``(qr, should, sel, dest, rstate, rku, riquat, k)``: the
    operands of a finish stage (:func:`_finish` for full-res render data,
    :func:`_finish_shade` for traced-only RGB).
    """
    W, H = settings.width, settings.height
    if W % 2 or H % 2:
        raise ValueError(f"adaptive sampling needs even image dimensions, "
                         f"got {W}x{H}")
    nq = (W // 2) * (H // 2)

    # Steady-state prepass reuse: identical (camera, params, features)
    # objects mean last frame's quarter dead map is exact.  The key is taken
    # from the caller's objects, before anything moves to the device.
    key = _stream_key(camera, params, features)
    # Reuse replaces the prepass, so it is gated on the same config bit:
    # metrics without use_prepass never early-kill.
    reuse = (metric.config.use_prepass and controller is not None
             and controller.qterm is not None
             and controller.stream_key == key)
    stream_objects = (camera, params, features)
    camera = camera.to(device)
    frame = camera_frame(metric, camera, params)

    dead = None
    if metric.config.use_prepass and not reuse:
        psettings = dataclasses.replace(
            settings, width=max(W // settings.prepass_scale, 4),
            height=max(H // settings.prepass_scale, 4),
            adaptive_sampling=False)
        dead, _ = _prepass_dead_map(metric, camera, frame, params, psettings,
                                    features)

    topts = _trace_opts(metric, settings)
    state, ku, iquat = _quarter_setup(metric, camera, frame, params, settings,
                                      features, dead,
                                      controller.qterm if reuse else None)
    state = integrate.trace_rays(metric, state, params, features=features,
                                 opts=topts, image_width=W // 2)

    frac = settings.refine_budget
    if controller is not None:
        frac = controller.fraction(settings.refine_budget)
    k = _refine_k(nq, frac)
    qr, should, demand, sel, dest, rstate, rku, riquat = _refine_setup(
        metric, camera, frame, params, settings, features, state, ku, iquat,
        k)
    if controller is not None:
        controller.observe(demand)
        controller.qsteps = qr.steps
        controller.qterm = qr.terminated
        controller.stream_key = key
        controller.stream_objects = stream_objects
    # No image: ``sel`` order, the three offsets one after another.
    rstate = integrate.trace_rays(metric, rstate, params, features=features,
                                  opts=topts)
    return qr, should, sel, dest, rstate, rku, riquat, k


def render_data_adaptive(metric: Metric, camera: cam.Camera, params,
                         settings: RenderSettings, features: Features,
                         controller: RefineBudgetController | None = None,
                         *, device) -> RenderData:
    """Quarter-density trace + error-driven refinement + optional prepass,
    assembled to full-resolution render data.

    The reference renderer's atomic variable-length refinement list
    (cl.cl:5294) becomes a budgeted top-k block batch (``refine_budget``;
    1.0 = every block, masked), optionally demand-sized across frames by a
    :class:`RefineBudgetController`."""
    qr, should, sel, dest, rstate, rku, riquat, k = _adaptive_trace(
        metric, camera, params, settings, features, controller, device=device)
    rdata, rsteps = _finish(metric, rstate, rku, riquat, params, features, qr,
                            should, sel, dest, settings, k)
    if controller is not None:
        controller.rsteps = rsteps
    return rdata


def render_frame_adaptive(metric: Metric, camera: cam.Camera, params,
                          backgrounds: bg.Background,
                          settings: RenderSettings, features: Features,
                          controller: RefineBudgetController | None = None,
                          *, device) -> Tensor:
    """Adaptive frame with traced-only shading: the quarter grid and the k
    refined blocks' rays are shaded directly off their render data; blocks
    that passed the angular-error test get bilinear RGB interpolation from
    the quarter corners instead of per-pixel background gathers (about
    nq + 3k shaded pixels instead of 4nq)."""
    qr, should, sel, dest, rstate, rku, riquat, k = _adaptive_trace(
        metric, camera, params, settings, features, controller, device=device)
    img, rsteps = _finish_shade(metric, rstate, rku, riquat, params, features,
                                qr, should, sel, dest, backgrounds.to(device),
                                settings, k)
    if controller is not None:
        controller.rsteps = rsteps
    return img


def _qcoords(settings: RenderSettings, device):
    """Flat pixel coordinates of the quarter (even) pixels."""
    return _grid_coords(settings.width // 2, settings.height // 2, 2.0,
                        device)


def _quarter_setup(metric: Metric, camera: cam.Camera, frame, params,
                   settings: RenderSettings, features: Features,
                   dead: Tensor | None, prev_qterm: Tensor | None = None):
    """Quarter-pass ray init with its kill mask: from the prepass ``dead``
    map, or, for an identical frame (same camera / params / features), from
    the previous frame's quarter statuses ``prev_qterm``: exact at steady
    state, eroded by the reference's 5-neighbour margin."""
    W, H = settings.width, settings.height
    qcx, qcy = _qcoords(settings, frame[0].device)
    kill = None
    if dead is not None:
        kill = _prepass_kill(dead, W, H, W // 2, H // 2)
    if prev_qterm is not None:
        dg = (prev_qterm == integrate.DEAD).reshape(H // 2, W // 2)
        kill = _and5(dg).reshape(-1)
    return _init_rays(metric, camera, frame, params, settings, features,
                      qcx, qcy, kill)


_REFINE_OFFSETS = ((1, 0), (0, 1), (1, 1))


def _refine_setup(metric: Metric, camera: cam.Camera, frame, params,
                  settings: RenderSettings, features: Features,
                  qstate: RayState, qku: Tensor, qiquat: Tensor | None,
                  k: int):
    """Quarter render data + top-k block selection + refine-ray init
    (handle_adaptive_sampling's decision half, cl.cl:5240-5294).  Returns
    ``(qr, should, demand, sel, dest, rstate, rku, riquat)``; ``demand`` is
    the fraction of blocks that want refinement, a 0-d tensor."""
    Wh, Hh = settings.width // 2, settings.height // 2
    qr = compute_render_data(metric, qstate, qku, params, features,
                             inv_quat=qiquat)
    qg = RenderData(*(f.reshape((Hh, Wh) + f.shape[1:]) for f in qr))

    should, sel, dest = _select_refine_blocks(qg, settings, k)
    demand = should.to(torch.float32).mean()
    sflat = should.reshape(-1)[sel]
    qcx, qcy = _qcoords(settings, sel.device)
    scx, scy = qcx[sel], qcy[sel]
    rcx = torch.cat([scx + ox for ox, oy in _REFINE_OFFSETS])
    rcy = torch.cat([scy + oy for ox, oy in _REFINE_OFFSETS])
    rkill = ~torch.cat([sflat] * 3)

    rstate, rku, riquat = _init_rays(metric, camera, frame, params, settings,
                                     features, rcx, rcy, rkill)
    return qr, should, demand, sel, dest, rstate, rku, riquat


def _grid(x: Tensor, Hh: int, Wh: int) -> Tensor:
    return x.reshape((Hh, Wh) + x.shape[1:])


def _finish(metric: Metric, rstate: RayState, rku: Tensor,
            riquat: Tensor | None, params, features: Features,
            qr: RenderData, should: Tensor, sel: Tensor, dest: Tensor,
            settings: RenderSettings, k: int):
    """Refine render data + scatter-back + assembly to full-resolution
    render data.  Returns ``(rdata, rsteps)``.

    The k traced blocks return to the (Hh, Wh) grid with ONE (k, 24) row
    scatter: all RenderData fields pack into f32 columns (statuses and steps
    are small ints, exact in f32), and the three offset parts share the
    block ids."""
    Wh, Hh = settings.width // 2, settings.height // 2
    nq = Wh * Hh
    rr = compute_render_data(metric, rstate, rku, params, features,
                             inv_quat=riquat)

    f32 = torch.float32
    packed = torch.cat([
        rr.tex_coord,                          # 0, 1
        rr.z_shift[:, None],                   # 2
        rr.side.to(f32)[:, None],              # 3
        rr.terminated.to(f32)[:, None],        # 4
        rr.angles,                             # 5, 6
        rr.steps.to(f32)[:, None],             # 7
    ], dim=-1)                                 # (3k, 8)
    # sel holds unique block ids, so the copy is deterministic.
    wide = packed.new_zeros((nq, 24)).index_copy_(
        0, sel,
        torch.cat([packed[0:k], packed[k:2 * k], packed[2 * k:3 * k]], dim=1))

    def part(i):
        g = wide[:, i * 8:(i + 1) * 8]
        i32 = torch.int32
        return RenderData(
            tex_coord=_grid(g[:, 0:2], Hh, Wh),
            z_shift=_grid(g[:, 2], Hh, Wh),
            side=_grid(g[:, 3].to(i32), Hh, Wh),
            terminated=_grid(g[:, 4].to(i32), Hh, Wh),
            angles=_grid(g[:, 5:7], Hh, Wh),
            steps=_grid(g[:, 7].to(i32), Hh, Wh),
        )

    qg = RenderData(*(_grid(f, Hh, Wh) for f in qr))
    # Blocks over budget fall back to interpolation.
    traced_ok = should & (dest < k).reshape(Hh, Wh)
    # Per-block max of the three refine rays' measured steps (columns 7, 15,
    # 23 of the packed scatter); 0 where the block was not traced.
    rsteps = torch.maximum(torch.maximum(wide[:, 7], wide[:, 15]),
                           wide[:, 23])
    return _adaptive_assemble(qg, part(0), part(1), part(2), traced_ok,
                              settings), rsteps


def _shade_set(rdata_tex, rdata_side, rdata_z, rdata_term, dx, dy,
               backgrounds: bg.Background, settings: RenderSettings,
               segments: tuple) -> Tensor:
    """Shade one flat traced-ray set: EWA sample + redshift + black mask.  ``dx``/``dy``:
    (N, 2) screen-space uv derivatives in FULL-RES pixel units (already
    bias-scaled)."""
    live = rdata_term == integrate.ESCAPED
    rgb = bg.sample_anisotropic_flat(
        backgrounds, rdata_tex, rdata_side, dx, dy,
        max_probes=settings.anisotropy, trilinear=settings.trilinear,
        live=live, probe_segments=segments,
        probe_bilinear=settings.probe_bilinear,
    )
    rgb = _redshifted(rgb, rdata_z, settings)
    return torch.where(live[:, None], rgb, 0.0)


def _refine_segments(settings: RenderSettings) -> tuple:
    """Probe schedule for the refine shade set: explicit override, or the
    image-wide schedule with 4x fractions (refined blocks concentrate where
    tex derivatives are large, so their probe demand is several times the
    image-wide rate)."""
    if settings.refine_probe_segments:
        return settings.refine_probe_segments
    acc = 0.0
    out = []
    for frac, iters in settings.probe_segments:
        f = min(4.0 * float(frac), 1.0 - acc)
        if f <= 0.0:
            break
        out.append((f, iters))
        acc += f
    return tuple(out)


_BIAS_FRAC = 1.3  # sample_anisotropic's default derivative bias


def _finish_shade(metric: Metric, rstate: RayState, rku: Tensor,
                  riquat: Tensor | None, params, features: Features,
                  qr: RenderData, should: Tensor, sel: Tensor, dest: Tensor,
                  backgrounds: bg.Background, settings: RenderSettings,
                  k: int):
    """Traced-only finish: refine render data + quarter/refine shading + RGB
    scatter-back + full-res RGB assembly.  Returns ``(img, rsteps)``.

    Shading needs screen-space uv derivatives for the EWA ellipse
    (cl.cl:5524-5556).  The quarter grid takes half its quarter-neighbour
    circular diff (adjacent quarter pixels are 2 full-res pixels apart).  A
    refined block [q r0; r1 r2] has all four of its rays' tex coords
    available, so each refine ray takes intra-block forward differences:
    1-pixel steps, no cross-block data.
    """
    Wh, Hh = settings.width // 2, settings.height // 2
    nq = Wh * Hh
    rr = compute_render_data(metric, rstate, rku, params, features,
                             inv_quat=riquat)
    cd = bg._circular_diff

    # --- quarter shade ---
    qtex = qr.tex_coord.reshape(Hh, Wh, 2)
    nbr_r = torch.cat([qtex[:, 1:], qtex[:, -2:-1]], dim=1)
    nbr_d = torch.cat([qtex[1:], qtex[-2:-1]], dim=0)
    scale = 0.5 / _BIAS_FRAC
    dxq = (cd(qtex, nbr_r) * scale).reshape(nq, 2)
    dyq = (cd(qtex, nbr_d) * scale).reshape(nq, 2)
    rgb_q = _shade_set(qr.tex_coord, qr.side, qr.z_shift, qr.terminated,
                       dxq, dyq, backgrounds, settings,
                       settings.probe_segments)

    # --- refine shade (3k rays: offsets (1,0), (0,1), (1,1)) ---
    tq = qr.tex_coord[sel]                       # (k, 2) block corners
    t0, t1, t2 = (rr.tex_coord[0:k], rr.tex_coord[k:2 * k],
                  rr.tex_coord[2 * k:3 * k])
    dxr = torch.cat([cd(tq, t0), cd(t1, t2), cd(t1, t2)]) / _BIAS_FRAC
    dyr = torch.cat([cd(t0, t2), cd(tq, t1), cd(t0, t2)]) / _BIAS_FRAC
    rgb_r = _shade_set(rr.tex_coord, rr.side, rr.z_shift, rr.terminated,
                       dxr, dyr, backgrounds, settings,
                       _refine_segments(settings))

    # --- scatter the k traced blocks' RGB back to the quarter grid ---
    # ONE (k, 12) row scatter (cf. _finish): 3 offsets x RGB + the three
    # refine step counts.
    packed = torch.cat([
        rgb_r[0:k], rgb_r[k:2 * k], rgb_r[2 * k:3 * k],        # 0..8
        rr.steps.to(torch.float32).reshape(3, k).T,            # 9..11
    ], dim=1)
    wide = packed.new_zeros((nq, 12)).index_copy_(0, sel, packed)
    rsteps = torch.maximum(torch.maximum(wide[:, 9], wide[:, 10]),
                           wide[:, 11])

    # --- assembly: traced RGB where refined, RGB interpolation elsewhere ---
    qrgb = rgb_q.reshape(Hh, Wh, 3)
    qesc = (qr.terminated == integrate.ESCAPED).reshape(Hh, Wh, 1)
    traced_ok = (should & (dest < k).reshape(Hh, Wh))[..., None]

    def interp(dy, dx):
        # Midpoint RGB; the centre's terminated flag decides black
        # (cl.cl:5111-5133 carries the centre's flag for interpolated
        # data).  The roll wraps at the far edges, where every block is
        # must-refine: a wrapped neighbour shows only beyond the budget.
        nb = torch.roll(qrgb, (-dy, -dx), dims=(0, 1))
        return torch.where(qesc, 0.5 * (qrgb + nb), 0.0)

    def part(i):
        return wide[:, 3 * i:3 * i + 3].reshape(Hh, Wh, 3)

    cell_r = torch.where(traced_ok, part(0), interp(0, 1))
    cell_d = torch.where(traced_ok, part(1), interp(1, 0))
    cell_dr = torch.where(traced_ok, part(2), interp(1, 1))

    # Interleave: out[2i+a, 2j+b] = cell[a][b][i, j].
    top = torch.stack([qrgb, cell_r], dim=2)
    bot = torch.stack([cell_d, cell_dr], dim=2)
    rows = torch.stack([top, bot], dim=1)         # (Hh, 2, Wh, 2, 3)
    return rows.reshape(Hh * 2, Wh * 2, 3), rsteps


def _roll2(x: Tensor, dy: int, dx: int) -> Tensor:
    """``out[i, j] = x[i + dy, j + dx]``, wrapping at the far edges."""
    return torch.roll(x, (-dy, -dx), dims=(0, 1))


def _refine_error_terms(qg: RenderData, settings: RenderSettings):
    """Shared refinement-decision terms (cl.cl:5240-5285): the angular
    error ratio (rel_err / threshold, >= 1 means refine) and the
    must-refine mask (terminated mismatch or image border)."""
    x_err = _angle_between(_roll2(qg.angles, 0, -1), _roll2(qg.angles, 0, 1))
    y_err = _angle_between(_roll2(qg.angles, 1, 0), _roll2(qg.angles, -1, 0))
    # (2*ax + 2*ay)/4/2*pi, reference operator precedence preserved.
    rel_err = (2.0 * x_err + 2.0 * y_err) / 8.0 * math.pi

    fov_rad = settings.fov_degrees * 2.0 * math.pi / 360.0
    per_pixel = fov_rad / settings.width
    err_ratio = rel_err / (per_pixel * settings.adaptive_threshold)

    t = qg.terminated
    mism = ((t != _roll2(t, 0, -1)) | (t != _roll2(t, 0, 1))
            | (t != _roll2(t, -1, 0)) | (t != _roll2(t, 1, 0))
            | (t != _roll2(t, 1, 1)))
    border = torch.zeros_like(mism)
    border[0, :] = border[-1, :] = True
    border[:, 0] = border[:, -1] = True
    return err_ratio, mism | border


def _adaptive_should_sample(qg: RenderData, settings: RenderSettings
                            ) -> Tensor:
    """Per-quarter-block refinement decision (cl.cl:5240-5285)."""
    err_ratio, must = _refine_error_terms(qg, settings)
    return (err_ratio >= 1.0) | must


def _refine_buckets(qg: RenderData, settings: RenderSettings):
    """``(should, bucket)`` of every quarter block: 0 = must-refine; 1..14
    descending angular error (half-octave steps); 15 = below threshold."""
    err_ratio, must = _refine_error_terms(qg, settings)
    should = (err_ratio >= 1.0) | must
    logr = torch.log2(torch.clamp(err_ratio, min=1e-20))
    by_err = torch.clamp(14.0 - torch.floor(logr * 2.0), 1.0, 14.0).to(
        torch.int32)
    bucket = torch.where(should, by_err, 15)
    return should, torch.where(must, 0, bucket)


def _select_refine_blocks(qg: RenderData, settings: RenderSettings, k: int,
                          seam_rows: tuple = ()):
    """Top-k refinement blocks by error priority: must-refine (terminated
    mismatch or border) first, then by descending angular error.  Returns
    ``(should, sel, dest)``: ``sel`` the k selected flat block ids, ``dest``
    the inverse permutation of the whole ordering, with ``dest < k`` marking
    the selected blocks.

    ``seam_rows`` (grid rows that are not image-adjacent to their grid
    neighbour, for the mirrored half-bands of a multi-device frame) is not
    ported."""
    if seam_rows:
        raise NotImplementedError(
            f"seam_rows={seam_rows}: banded multi-device frames are not "
            "ported; pass no seam rows")
    should, bucket = _refine_buckets(qg, settings)
    perm, dest = packing.bucket_sort_perm(bucket.reshape(-1))
    return should, perm[:k], dest


def _adaptive_assemble(qg: RenderData, r0: RenderData, r1: RenderData,
                       r2: RenderData, should: Tensor,
                       settings: RenderSettings) -> RenderData:
    """Merge traced/interpolated cells into full-resolution RenderData."""
    W, H = settings.width, settings.height

    def shifted(dy, dx):
        return RenderData(*(_roll2(a, dy, dx) for a in qg))

    # One angle->vector conversion of the quarter grid, shifted for the
    # three neighbours.
    vq = _ang_to_vec(qg.angles)
    cells = [qg]
    for traced, (dx, dy) in zip((r0, r1, r2), _REFINE_OFFSETS):
        interp = _interp_rdata(qg, shifted(dy, dx), vq, _roll2(vq, dy, dx))
        cells.append(RenderData(*(
            torch.where(should.reshape(should.shape + (1,) * (t.ndim - 2)),
                        t, i)
            for t, i in zip(traced, interp))))

    def assemble(q, r, d, dr):
        # Interleave: out[2i+a, 2j+b] = cell[a][b][i, j].
        top = torch.stack([q, r], dim=2)      # (Hh, Wh, 2, ...)
        bot = torch.stack([d, dr], dim=2)
        rows = torch.stack([top, bot], dim=1)  # (Hh, 2, Wh, 2, ...)
        return rows.reshape((H * W,) + q.shape[2:])

    return RenderData(*(assemble(*fields) for fields in zip(*cells)))


# ---------------------------------------------------------------------------
# Whole-frame entry point
# ---------------------------------------------------------------------------

def render_frame(metric: Metric, camera: cam.Camera, params,
                 backgrounds: bg.Background, settings: RenderSettings,
                 features: Features | None = None,
                 controller: RefineBudgetController | None = None,
                 *, device) -> Tensor:
    """Trace and shade a full frame on ``device``.  Returns (H, W, 3)
    linear RGB.  Every ray march is one launch of the CUDA kernel on a GPU
    and the eager reference on the CPU: one for the dense frame, three for
    an adaptive frame (prepass, quarter grid, refinement), two when a
    ``controller`` (a :class:`RefineBudgetController`, which also sizes the
    refinement across a frame stream) lets it reuse the prepass."""
    device = check_device(device)
    if features is None:
        features = Features.for_metric(metric)
    if settings.adaptive_sampling:
        if settings.shade_traced_only:
            return render_frame_adaptive(metric, camera, params, backgrounds,
                                         settings, features,
                                         controller=controller, device=device)
        rdata = render_data_adaptive(metric, camera, params, settings,
                                     features, controller=controller,
                                     device=device)
        return shade(rdata, backgrounds.to(device), settings)
    state, ku, iquat = init_camera_rays(metric, camera, params, settings,
                                        features, device=device)
    final = integrate.trace_rays(metric, state, params, features=features,
                                 opts=_trace_opts(metric, settings),
                                 image_width=settings.width)
    rdata = compute_render_data(metric, final, ku, params, features,
                                inv_quat=iquat)
    return shade(rdata, backgrounds.to(device), settings)


# ---------------------------------------------------------------------------
# The differentiable path
# ---------------------------------------------------------------------------

def grad_safe_final(metric: Metric, launch: RayState, final: RayState,
                    params, features: Features, step_cap: int = 512):
    """Differentiation-safe final state and its consumed-pixel mask.

    Two reverse-mode hazards are kept out of the gradient:

    * rays that stop at the horizon or terminator end where the metric is
      singular (Kerr's ``g_rr`` is infinite at ``D = 0``): render data
      evaluated there holds inf, and inf times a zero cotangent is NaN in
      the summed parameter gradient, though the pixel is masked out of the
      loss;
    * rays winding many photon-sphere orbits (``steps > step_cap``): their
      tangents grow like e^(2 pi) an orbit and overflow float32 in the
      backward pass.

    Every lane that is not consumed (escaped, on the far half of the
    universe sphere, at most ``step_cap`` committed steps) gets its LAUNCH
    position, velocity and acceleration (a regular point).  Returns
    ``(final_sane, consumed)``; a loss masks its pixels by ``consumed``.
    The forward frame does not use this: the near-horizon and photon-ring
    pixels are part of the image."""
    polar_r = torch.abs(metric.to_polar(final.position.T, params)[1])
    consumed = ((final.status == integrate.ESCAPED)
                & (polar_r >= 0.5 * features.universe_size)
                & (final.steps <= step_cap))
    m = consumed[:, None]
    sane = final._replace(
        position=torch.where(m, final.position, launch.position),
        velocity=torch.where(m, final.velocity, launch.velocity),
        acceleration=torch.where(m, final.acceleration, launch.acceleration))
    return sane, consumed


def trace_frame(metric: Metric, camera: cam.Camera, params,
                settings: RenderSettings, features: Features | None = None,
                *, device):
    """Trace only (no shading), in the physical frame (planar off), with
    ``settings.trace`` as it is.  Returns ``(final RayState, ku_uobsu)``."""
    device = check_device(device)
    if features is None:
        features = Features.for_metric(metric)
    nsettings = dataclasses.replace(settings, planar=False)
    state, ku, _ = init_camera_rays(metric, camera, params, nsettings,
                                    features, device=device)
    final = integrate.trace_rays(metric, state, params, features=features,
                                 opts=settings.trace)
    return final, ku
