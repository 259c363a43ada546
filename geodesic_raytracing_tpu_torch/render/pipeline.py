"""End-to-end render pipeline: camera -> rays -> geodesics -> image (port of
``geodesic_raytracing_tpu.render.pipeline``: the non-adaptive frame).

Stages, each a plain function on tensors of one device: ``init_camera_rays``
(observer tetrad, pixel directions, null rays), ``integrate.trace_rays`` (the
CUDA ray-march kernel on a GPU), ``compute_render_data`` (snap to the
universe sphere, texture coordinates) and ``shade`` (EWA sky sampling).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from .. import camera as cam
from ..metrics.base import Metric
from ..ops import geometry, integrate, tetrad
from ..ops.integrate import Features, RayState, TraceOptions
from . import background as bg

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
    """Render settings the ported slice reads (graphics_settings.hpp)."""

    width: int = 1920
    height: int = 1080
    fov_degrees: float = 90.0
    anisotropy: int = 16
    trace: TraceOptions = TraceOptions()
    # The adaptive pipeline is not ported yet: render_frame refuses it.
    adaptive_sampling: bool = False
    trilinear: bool = True  # mip blending; False = nearest level
    # EWA probe-iteration schedule ((frac, iters), ...) over the pixels
    # sorted by probe demand; empty = the top third at the full budget.
    probe_segments: tuple = ()


# ---------------------------------------------------------------------------
# Ray initialisation
# ---------------------------------------------------------------------------

def camera_to_generic(metric: Metric, camera: cam.Camera, params) -> Tensor:
    """Polar camera position -> metric generic coordinates."""
    return metric.from_polar(camera.polar_position, params)


def camera_frame(metric: Metric, camera: cam.Camera, params):
    """Generic camera position + oriented, boosted observer tetrad."""
    position = camera_to_generic(metric, camera, params)
    es = cam.observer_tetrad(metric, position, params,
                             basis_speed3=camera.basis_speed, orient=True)
    return position, es


def _trace_sign(metric: Metric) -> float:
    """Backwards-in-affine-time tracing unless the metric follows
    geodesics forward (cl.cl:3196-3206)."""
    return 1.0 if metric.config.follow_geodesics_forward else -1.0


def rays_for_pixels(metric: Metric, camera: cam.Camera, position, es, params,
                    settings: RenderSettings, features: Features,
                    cx: Tensor, cy: Tensor):
    """Null rays for flat pixel coordinate arrays ``cx``/``cy`` of the
    W x H image (``init_rays_generic`` cl.cl:3143-3251).  Returns
    ``(state, ku_uobsu)``."""
    W, H = settings.width, settings.height
    dev = cx.device
    fov_rad = settings.fov_degrees * math.pi / 180.0
    f_stop = (W / 2) / torch.tan(
        torch.tensor(fov_rad / 2, dtype=torch.float32, device=dev))
    dx = cx - W / 2.0
    dy = cy - H / 2.0
    dz = f_stop.expand(cx.shape)
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
    dirs = cam.rot_quat_batched(torch.stack([dx * inv, dy * inv, dz * inv]),
                                camera.quat)  # (3, N)

    sign = _trace_sign(metric)
    velocity = (
        dirs[0][:, None] * es[1][None, :]
        + dirs[1][:, None] * es[2][None, :]
        + dirs[2][:, None] * es[3][None, :]
        + sign * es[0][None, :]
    )
    n = velocity.shape[0]
    positions = position.expand(n, 4)
    state = integrate.init_ray_state(metric, positions, velocity, params,
                                     features)

    # ku_uobsu: observer-frame energy at emission (cl.cl:3047-3060), as
    # elementwise sums (no matmul, so no TF32 path on the card).
    gab = metric.fn(position, params)
    uobs_low = geometry.matvec(gab, es[0])
    v = state.velocity
    ku_uobsu = (v[:, 0] * uobs_low[0] + v[:, 1] * uobs_low[1]
                + v[:, 2] * uobs_low[2] + v[:, 3] * uobs_low[3])
    return state, ku_uobsu


def init_camera_rays(metric: Metric, camera: cam.Camera, params,
                     settings: RenderSettings,
                     features: Features = Features(), *, device):
    """Full-image ray batch on ``device``, flattened to N = W*H
    (row-major).  Returns ``(state, ku_uobsu)``."""
    W, H = settings.width, settings.height
    camera = camera.to(device)
    position, es = camera_frame(metric, camera, params)
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return rays_for_pixels(metric, camera, position, es, params, settings,
                           features, xx.reshape(-1), yy.reshape(-1))


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
                        params, features: Features = Features()
                        ) -> RenderData:
    """``calculate_render_data`` (cl.cl:5135-5220): escaped rays snapped to
    the universe sphere, textured by final (theta, phi), with the
    observed/emitted energy ratio z_shift."""
    cfg = metric.config
    pos = state.position.T
    vel = state.velocity.T
    rdl = state.running_dlambda_dnew
    status = state.status

    polar = metric.to_polar(pos, params)
    polar_vel = metric.to_polar_velocity(pos, vel, params)

    snapped_far = _fix_ray_position_batched(polar[1:], polar_vel[1:],
                                            features.universe_size)
    if cfg.singular:
        raise NotImplementedError(
            "singular metrics' terminator snap is not ported yet")
    snapped = snapped_far

    side = torch.where(polar[1] < 0, 0, 1).to(torch.int32)

    # Fresh (unoriented, unboosted) tetrad at every endpoint for the
    # observed frequency (cl.cl:5185-5208).
    gab = metric.fn(pos, params)
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
    """Anisotropic background sampling; rays that did not escape paint
    black.  Returns (H, W, 3) linear-light RGB in [0, 1]."""
    W, H = settings.width, settings.height
    tex = rdata.tex_coord.reshape(H, W, 2)
    side = rdata.side.reshape(H, W)
    terminated = rdata.terminated.reshape(H, W)
    live = terminated == integrate.ESCAPED
    rgb = bg.sample_anisotropic(
        backgrounds, tex, side, max_probes=settings.anisotropy,
        trilinear=settings.trilinear, live=live, probe_segments=settings.probe_segments,
    )
    return torch.where(live[..., None], rgb, 0.0)


def check_device(device) -> torch.device:
    """The device a caller asked for; a CUDA device without a usable GPU is
    an error, never a quiet move to the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' requested but no CUDA GPU is "
                           "available")
    return device


def render_frame(metric: Metric, camera: cam.Camera, params,
                 backgrounds: bg.Background, settings: RenderSettings,
                 features: Features | None = None, *, device) -> Tensor:
    """Trace and shade a full frame on ``device``.  Returns (H, W, 3)
    linear RGB.  The ray march is one launch of the CUDA kernel on a GPU
    and the eager reference on the CPU."""
    device = check_device(device)
    if settings.adaptive_sampling:
        raise NotImplementedError(
            "adaptive sampling is not ported yet; pass "
            "adaptive_sampling=False for the dense frame")
    if features is None:
        features = Features.for_metric(metric)
    state, ku = init_camera_rays(metric, camera, params, settings, features,
                                 device=device)
    final = integrate.trace_rays(metric, state, params, features=features,
                                 opts=settings.trace)
    rdata = compute_render_data(metric, final, ku, params, features)
    return shade(rdata, backgrounds.to(device), settings)
