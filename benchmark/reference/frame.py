"""The frame of the plain reference: camera, rays, march, render data and
shading, dense or adaptive, as ``render_frame`` of the port computes it.

Frozen copy of ``geodesic_raytracing_tpu_torch/render/pipeline.py`` (commit
e647ccc), trimmed to the settings the benchmark's configurations use: no
redshift, traced-only shading of the adaptive frame, the Verlet march.

The adaptive frame of a stream depends on the frames before it: the
prepass (first frame) or the last frame's quarter statuses decide which
quarter rays are born DEAD, and a ``RefineBudgetController`` sizes the
refinement from the demand of earlier frames.  ``render`` works both out
again for frame ``index`` of a still stream: every quarter ray is marched
once (a ray's march does not depend on the others), each frame's kill mask
and quarter render data are selected from that march and from the rays born
DEAD, and the controller is run on the frames' demands.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from . import camera as cam
from . import planar as pl_planar
from . import sky as bg
from . import tetrad
from .geometry import matvec
from .march import ACTIVE, DEAD, ESCAPED, RayState, features_for, march
from .march import init_ray_state

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class Settings:
    """The render settings the reference reads (``RenderSettings``)."""

    width: int
    height: int
    max_steps: int
    fov_degrees: float = 90.0
    anisotropy: int = 16
    adaptive_sampling: bool = False
    adaptive_threshold: float = 64.0
    prepass_scale: int = 16
    refine_budget: float = 0.375
    trilinear: bool = True
    probe_segments: tuple = ()
    refine_probe_segments: tuple = ()
    planar: bool = True
    probe_bilinear: bool = False


class RenderData(NamedTuple):
    tex_coord: Tensor
    z_shift: Tensor
    side: Tensor
    terminated: Tensor
    angles: Tensor
    steps: Tensor


# ---------------------------------------------------------------------------
# Rays
# ---------------------------------------------------------------------------

def _trace_sign(metric) -> float:
    return 1.0 if metric.follow_geodesics_forward else -1.0


def _grid_coords(w: int, h: int, step: float, device):
    yy, xx = torch.meshgrid(
        step * torch.arange(h, dtype=torch.float32, device=device),
        step * torch.arange(w, dtype=torch.float32, device=device),
        indexing="ij",
    )
    return xx.reshape(-1), yy.reshape(-1)


def _planar(metric, settings: Settings) -> bool:
    return bool(metric.spherically_symmetric) and settings.planar


def camera_frame(metric, params, polar_position, basis_speed):
    """Generic camera position and its observer tetrad."""
    position = metric.from_polar(polar_position, params)
    es = cam.observer_tetrad(metric, position, params, basis_speed)
    return position, es


def rays_for_pixels(metric, quat, position, es, params, settings: Settings,
                    features, cx: Tensor, cy: Tensor, kill=None):
    """Launch state of the pixels ``cx``/``cy`` (rays under ``kill`` born
    DEAD).  Returns ``(state, ku_uobsu, inv_quat)``."""
    planar = _planar(metric, settings)
    dirs = cam.directions_for_pixels(cx, cy, settings.width,
                                     settings.height, quat,
                                     settings.fov_degrees)
    sign = _trace_sign(metric)
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
        p_t, v_t, inv_quat = pl_planar.to_planar(
            metric, positions.T.contiguous(), velocity.T.contiguous(), params)
        positions, velocity = p_t.T, v_t.T

    state = init_ray_state(metric, positions, velocity, params, features)
    if planar:
        vel_p, acc_p = state.velocity.clone(), state.acceleration.clone()
        vel_p[:, 2] = 0.0
        acc_p[:, 2] = 0.0
        state = state._replace(velocity=vel_p, acceleration=acc_p)

    gab = metric.fn(position, params)
    uobs_low = matvec(gab, es[0])
    v = state.velocity
    ku_uobsu = (v[:, 0] * uobs_low[0] + v[:, 1] * uobs_low[1]
                + v[:, 2] * uobs_low[2] + v[:, 3] * uobs_low[3])
    if kill is not None:
        state = state._replace(status=torch.where(kill, DEAD, state.status))
    return state, ku_uobsu, inv_quat


# ---------------------------------------------------------------------------
# Render data and shading
# ---------------------------------------------------------------------------

def angle_to_tex(angles: Tensor) -> Tensor:
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


def compute_render_data(metric, state: RayState, ku_uobsu: Tensor, params,
                        features, inv_quat: Tensor | None) -> RenderData:
    """Endpoints snapped to the universe sphere, texture coordinates,
    z_shift, and the |r| <= 1 black test."""
    pos = state.position.T
    vel = state.velocity.T
    rdl = state.running_dlambda_dnew
    status = state.status

    polar = metric.to_polar(pos, params)
    polar_vel = metric.to_polar_velocity(pos, vel, params)

    snapped_far = _fix_ray_position_batched(polar[1:], polar_vel[1:],
                                            features.universe_size)
    if metric.singular:
        is_far = torch.abs(polar[1]) >= 0.5 * (
            features.universe_size + metric.singular_terminator)
        if metric.traversable_event_horizon:
            near = _fix_ray_position_batched(polar[1:], polar_vel[1:],
                                             metric.singular_terminator)
        else:
            near = polar[1:]
        snapped = torch.where(is_far[None, :], snapped_far, near)
    else:
        snapped = snapped_far

    if inv_quat is not None:
        snapped = pl_planar.unrotate_angles(snapped, inv_quat)

    side = torch.where(polar[1] < 0, 0, 1).to(torch.int32)

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

    if not metric.traversable_event_horizon:
        status = torch.where(
            (status == ESCAPED) & (torch.abs(snapped[0]) <= 1.0),
            DEAD, status)

    return RenderData(tex_coord=tex, z_shift=z_shift, side=side,
                      terminated=status, angles=ang, steps=state.steps)


def shade(rdata: RenderData, backgrounds, settings: Settings) -> Tensor:
    """EWA sky sampling; rays that did not escape paint black.  (H, W, 3)."""
    W, H = settings.width, settings.height
    tex = rdata.tex_coord.reshape(H, W, 2)
    side = rdata.side.reshape(H, W)
    live = rdata.terminated.reshape(H, W) == ESCAPED
    rgb = bg.sample_anisotropic(
        backgrounds, tex, side, max_probes=settings.anisotropy,
        trilinear=settings.trilinear, live=live,
        probe_segments=settings.probe_segments,
        probe_bilinear=settings.probe_bilinear,
    )
    return torch.where(live[..., None], rgb, 0.0)


# ---------------------------------------------------------------------------
# The adaptive frame
# ---------------------------------------------------------------------------

def _ang_to_vec(angles: Tensor) -> Tensor:
    th, ph = angles[..., 0], angles[..., 1]
    st = torch.sin(th)
    return torch.stack([st * torch.cos(ph), st * torch.sin(ph),
                        torch.cos(th)], dim=-1)


def _angle_between(a1: Tensor, a2: Tensor) -> Tensor:
    d = torch.sum(_ang_to_vec(a1) * _ang_to_vec(a2), dim=-1)
    return torch.acos(torch.clamp(d, -1.0, 1.0))


def _shift2d(x: Tensor, dy: int, dx: int, fill) -> Tensor:
    ph, pw = x.shape
    padded = x.new_full((ph + 2, pw + 2), fill)
    padded[1:-1, 1:-1] = x
    return padded[1 + dy:1 + dy + ph, 1 + dx:1 + dx + pw]


def _and5(m: Tensor) -> Tensor:
    """A bool map AND its four edge neighbours (False beyond the edge)."""
    return (_shift2d(m, 0, -1, False) & m & _shift2d(m, 0, 1, False)
            & _shift2d(m, -1, 0, False) & _shift2d(m, 1, 0, False))


def _round_index(n_out: int, n_small: int, step: float, extent: int,
                 device) -> Tensor:
    idx = np.round(np.arange(n_out) * step * n_small / extent)
    idx = np.clip(idx, 0, n_small - 1).astype(np.int64)
    return torch.from_numpy(idx).to(device)


def _prepass_kill(dead: Tensor, W: int, H: int) -> Tensor:
    """Quarter-grid kill mask from the prepass dead map: the map AND its
    four neighbours, nearest-upsampled to the quarter grid."""
    small = _and5(dead)
    ph, pw = small.shape
    iy = _round_index(H // 2, ph, 2.0, H, small.device)
    ix = _round_index(W // 2, pw, 2.0, W, small.device)
    return small.index_select(0, iy).index_select(1, ix).reshape(-1)


def _roll2(x: Tensor, dy: int, dx: int) -> Tensor:
    return torch.roll(x, (-dy, -dx), dims=(0, 1))


def _refine_error_terms(qg: RenderData, settings: Settings):
    x_err = _angle_between(_roll2(qg.angles, 0, -1), _roll2(qg.angles, 0, 1))
    y_err = _angle_between(_roll2(qg.angles, 1, 0), _roll2(qg.angles, -1, 0))
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


def _refine_buckets(qg: RenderData, settings: Settings):
    """``(should, bucket)``: 0 = must-refine, 1..14 by descending angular
    error, 15 = below the threshold."""
    err_ratio, must = _refine_error_terms(qg, settings)
    should = (err_ratio >= 1.0) | must
    logr = torch.log2(torch.clamp(err_ratio, min=1e-20))
    by_err = torch.clamp(14.0 - torch.floor(logr * 2.0), 1.0, 14.0).to(
        torch.int32)
    bucket = torch.where(should, by_err, 15)
    return should, torch.where(must, 0, bucket)


class BudgetController:
    """The refine budget of ``RefineBudgetController``: the demand of frame
    t is read ``latency`` frames later; the budget grows at once and
    shrinks after ``down_patience`` low frames."""

    BUCKETS = (1 / 16, 1 / 8, 3 / 16, 1 / 4, 3 / 8, 1 / 2, 3 / 4, 1.0)

    def __init__(self, margin: float = 1.3, latency: int = 2,
                 down_patience: int = 3):
        self._pending: list = []
        self._margin = margin
        self._latency = latency
        self._down_patience = down_patience
        self._down = 0
        self._current: float | None = None

    def fraction(self, cap: float) -> float:
        if self._current is None:
            return cap
        return min(self._current, cap)

    def observe(self, demand: float) -> None:
        self._pending.append(demand)
        while len(self._pending) > self._latency:
            self._update(self._pending.pop(0))

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


def _refine_k(nq: int, frac: float) -> int:
    if frac >= 1.0:
        return nq
    return max(min(nq, 1024), (int(nq * frac) // 8) * 8)


_REFINE_OFFSETS = ((1, 0), (0, 1), (1, 1))
_BIAS_FRAC = 1.3


def _refine_segments(settings: Settings) -> tuple:
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


def _shade_set(tex, side, z, term, dx, dy, backgrounds, settings: Settings,
               segments: tuple) -> Tensor:
    live = term == ESCAPED
    rgb = bg.sample_anisotropic_flat(
        backgrounds, tex, side, dx, dy,
        max_probes=settings.anisotropy, trilinear=settings.trilinear,
        live=live, probe_segments=segments,
        probe_bilinear=settings.probe_bilinear,
    )
    return torch.where(live[:, None], rgb, 0.0)


def _finish_shade(metric, rstate, rku, riquat, params, features,
                  qr: RenderData, should, sel, dest, backgrounds,
                  settings: Settings, k: int) -> Tensor:
    """Refine render data, quarter and refine shading, RGB scatter-back and
    the full-resolution assembly."""
    Wh, Hh = settings.width // 2, settings.height // 2
    nq = Wh * Hh
    rr = compute_render_data(metric, rstate, rku, params, features, riquat)
    cd = bg._circular_diff

    qtex = qr.tex_coord.reshape(Hh, Wh, 2)
    nbr_r = torch.cat([qtex[:, 1:], qtex[:, -2:-1]], dim=1)
    nbr_d = torch.cat([qtex[1:], qtex[-2:-1]], dim=0)
    scale = 0.5 / _BIAS_FRAC
    dxq = (cd(qtex, nbr_r) * scale).reshape(nq, 2)
    dyq = (cd(qtex, nbr_d) * scale).reshape(nq, 2)
    rgb_q = _shade_set(qr.tex_coord, qr.side, qr.z_shift, qr.terminated,
                       dxq, dyq, backgrounds, settings,
                       settings.probe_segments)

    tq = qr.tex_coord[sel]
    t0, t1, t2 = (rr.tex_coord[0:k], rr.tex_coord[k:2 * k],
                  rr.tex_coord[2 * k:3 * k])
    dxr = torch.cat([cd(tq, t0), cd(t1, t2), cd(t1, t2)]) / _BIAS_FRAC
    dyr = torch.cat([cd(t0, t2), cd(tq, t1), cd(t0, t2)]) / _BIAS_FRAC
    rgb_r = _shade_set(rr.tex_coord, rr.side, rr.z_shift, rr.terminated,
                       dxr, dyr, backgrounds, settings,
                       _refine_segments(settings))

    packed = torch.cat([
        rgb_r[0:k], rgb_r[k:2 * k], rgb_r[2 * k:3 * k],
        rr.steps.to(torch.float32).reshape(3, k).T,
    ], dim=1)
    wide = packed.new_zeros((nq, 12)).index_copy_(0, sel, packed)

    qrgb = rgb_q.reshape(Hh, Wh, 3)
    qesc = (qr.terminated == ESCAPED).reshape(Hh, Wh, 1)
    traced_ok = (should & (dest < k).reshape(Hh, Wh))[..., None]

    def interp(dy, dx):
        nb = torch.roll(qrgb, (-dy, -dx), dims=(0, 1))
        return torch.where(qesc, 0.5 * (qrgb + nb), 0.0)

    def part(i):
        return wide[:, 3 * i:3 * i + 3].reshape(Hh, Wh, 3)

    cell_r = torch.where(traced_ok, part(0), interp(0, 1))
    cell_d = torch.where(traced_ok, part(1), interp(1, 0))
    cell_dr = torch.where(traced_ok, part(2), interp(1, 1))

    top = torch.stack([qrgb, cell_r], dim=2)
    bot = torch.stack([cell_d, cell_dr], dim=2)
    rows = torch.stack([top, bot], dim=1)
    return rows.reshape(Hh * 2, Wh * 2, 3)


def _select(mask: Tensor, a: RenderData, b: RenderData) -> RenderData:
    """Per ray: ``a`` where ``mask``, else ``b``."""
    def pick(x, y):
        m = mask.reshape(mask.shape + (1,) * (x.ndim - 1))
        return torch.where(m, x, y)

    return RenderData(*(pick(x, y) for x, y in zip(a, b)))


class Launch(NamedTuple):
    """One march of a frame: its rays, the rays ACTIVE at launch, and the
    steps those committed."""

    rays: int
    active: int
    steps: int


def _launch(state_in: RayState, state_out: RayState) -> Launch:
    return Launch(rays=int(state_in.status.numel()),
                  active=int((state_in.status == ACTIVE).sum()),
                  steps=int(state_out.steps.sum(dtype=torch.int64)))


# ---------------------------------------------------------------------------
# The frame
# ---------------------------------------------------------------------------

def render(metric, params, settings: Settings, backgrounds, polar_position,
           quat, basis_speed, index: int, dtype=torch.float32):
    """Frame ``index`` (1 = the first) of a still stream that renders every
    frame with the same camera, parameters and settings (and, for the
    adaptive frame, one budget controller).  Returns ``(image (H, W, 3),
    launches)``: the launches the frame makes, as the program makes them.
    ``dtype``: the precision of every march."""
    dev = polar_position.device
    features = features_for(metric)
    planar = _planar(metric, settings)
    frame = camera_frame(metric, params, polar_position, basis_speed)
    W, H = settings.width, settings.height

    def trace(state):
        return march(metric, state, params, features, planar,
                     settings.max_steps, dtype)

    if not settings.adaptive_sampling:
        state, ku, iquat = rays_for_pixels(
            metric, quat, *frame, params, settings, features,
            *_grid_coords(W, H, 1.0, dev))
        final = trace(state)
        rd = compute_render_data(metric, final, ku, params, features, iquat)
        return shade(rd, backgrounds, settings), [_launch(state, final)]

    if W % 2 or H % 2:
        raise ValueError(f"adaptive sampling needs even image dimensions, "
                         f"got {W}x{H}")
    Wh, Hh = W // 2, H // 2
    nq = Wh * Hh
    qcx, qcy = _grid_coords(Wh, Hh, 2.0, dev)
    qstate, qku, qiquat = rays_for_pixels(metric, quat, *frame, params,
                                          settings, features, qcx, qcy)
    qfinal = trace(qstate)
    rd_marched = compute_render_data(metric, qfinal, qku, params, features,
                                     qiquat)

    kill = rd_born_dead = None
    if metric.use_prepass:
        ps = dataclasses.replace(settings, width=max(W // settings.prepass_scale,
                                                     4),
                                 height=max(H // settings.prepass_scale, 4))
        pstate, _, _ = rays_for_pixels(metric, quat, *frame, params, ps,
                                       features, *_grid_coords(
                                           ps.width, ps.height, 1.0, dev))
        pfin = trace(pstate)
        dead = (pfin.status == DEAD).reshape(ps.height, ps.width)
        kill = _prepass_kill(dead, W, H)
        born_dead = qstate._replace(
            status=torch.full_like(qstate.status, DEAD))
        rd_born_dead = compute_render_data(metric, born_dead, qku, params,
                                           features, qiquat)

    controller = BudgetController()
    qr = rd_marched
    demand = None
    for t in range(1, index + 1):
        if t > 1 and metric.use_prepass:
            next_kill = _and5((qr.terminated == DEAD).reshape(Hh, Wh)
                              ).reshape(-1)
            if not torch.equal(next_kill, kill):
                kill, demand = next_kill, None
        if demand is None or t == index:
            qr = (rd_marched if kill is None
                  else _select(kill, rd_born_dead, rd_marched))
            qg = RenderData(*(f.reshape((Hh, Wh) + f.shape[1:]) for f in qr))
            should, bucket = _refine_buckets(qg, settings)
            demand = float(should.to(torch.float32).mean())
        k = _refine_k(nq, controller.fraction(settings.refine_budget))
        if t < index:
            controller.observe(demand)

    perm, dest = bg.bucket_sort_perm(bucket.reshape(-1))
    sel = perm[:k]
    sflat = should.reshape(-1)[sel]
    scx, scy = qcx[sel], qcy[sel]
    rcx = torch.cat([scx + ox for ox, oy in _REFINE_OFFSETS])
    rcy = torch.cat([scy + oy for ox, oy in _REFINE_OFFSETS])
    rkill = ~torch.cat([sflat] * 3)
    rstate, rku, riquat = rays_for_pixels(metric, quat, *frame, params,
                                          settings, features, rcx, rcy,
                                          kill=rkill)
    rfinal = trace(rstate)
    img = _finish_shade(metric, rfinal, rku, riquat, params, features, qr,
                        should, sel, dest, backgrounds, settings, k)

    qlaunch = qstate if kill is None else qstate._replace(
        status=torch.where(kill, DEAD, qstate.status))
    qsteps = (qfinal.steps if kill is None
              else torch.where(kill, 0, qfinal.steps))
    launches = [Launch(rays=nq, active=int((qlaunch.status == ACTIVE).sum()),
                       steps=int(qsteps.sum(dtype=torch.int64))),
                _launch(rstate, rfinal)]
    return img, launches
