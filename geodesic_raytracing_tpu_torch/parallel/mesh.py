"""Multi-device frames and the distributed train step (port of
``geodesic_raytracing_tpu.parallel.mesh``) on ``torch.distributed``.

The reference shards the image plane as ray tiles over a 1-D device mesh
(``shard_map`` over a ``"rays"`` axis): rays are independent, so a frame
needs no per-step communication, only the gather of the traced shards or
band images, and the train step one ``psum`` of the loss and the parameter
gradients.  Here the mesh is a process group (:class:`RayMesh`): each rank
drives one device and marches its shard or band with the CUDA ray-march
kernel (its eager twin on the CPU); the collectives are ``all_gather`` and
``all_reduce(SUM)`` over the group.  NCCL gathers on the device; gloo (the
CPU, or several ranks on one card, which NCCL refuses) stages every
collective through host tensors.  Without a process group the mesh is a
world of 1 and no collective runs.

The reference's cache of compiled stage programs (``_ADAPTIVE_PROGRAMS``)
has no counterpart: eager torch compiles nothing.
"""

from __future__ import annotations

import dataclasses
import os
from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from .. import camera as cam
from ..metrics.base import Metric
from ..ops import integrate
from ..ops.integrate import Features, RayState, TraceOptions
from ..render import background as bg
from ..render import pipeline

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RayMesh:
    """A 1-D mesh over the ray axis: the process group (None for a world of
    1 without one), this process's rank, the world size and the device the
    rank drives.  ``staged``: the backend (gloo) gathers host tensors, so
    every collective copies through the host; NCCL gathers on the device.
    """

    group: object
    rank: int
    size: int
    device: torch.device
    staged: bool

    def all_gather(self, t: Tensor) -> Tensor:
        """Every rank's ``t`` (equal shapes), concatenated along dim 0 in
        rank order, on this rank's device."""
        if self.group is None:
            return t
        if self.staged:
            host = t.detach().cpu().contiguous()
            parts = [torch.empty_like(host) for _ in range(self.size)]
            dist.all_gather(parts, host, group=self.group)
            return torch.cat(parts).to(self.device)
        out = t.new_empty((self.size * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.detach().contiguous(),
                                    group=self.group)
        return out

    def all_reduce_sum(self, t: Tensor) -> Tensor:
        """The sum over the ranks of ``t``, on this rank's device."""
        if self.group is None:
            return t
        if self.staged:
            host = t.detach().cpu().clone()
            dist.all_reduce(host, op=dist.ReduceOp.SUM, group=self.group)
            return host.to(self.device)
        out = t.detach().clone()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=self.group)
        return out


def ray_mesh(device=None, group=None) -> RayMesh:
    """The mesh of this process.

    Under an initialised process group (``torchrun``, or
    ``init_process_group``) rank and size are the group's (``group``, or the
    default one), and the device is ``cuda:$LOCAL_RANK`` unless ``device``
    is given.  Without one the mesh is a world of 1 on ``device`` (default
    ``cuda``).  A CUDA device without a GPU raises (``check_device``); the
    backend is NCCL or gloo, fixed here for every collective."""
    if dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD if group is None else group
        rank, size = dist.get_rank(group), dist.get_world_size(group)
        backend = dist.get_backend(group)
        if device is None:
            device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
    elif group is not None:
        raise ValueError("ray_mesh: a process group needs torch.distributed "
                         "to be initialised")
    else:
        rank, size, backend = 0, 1, None
        if device is None:
            device = "cuda"
    device = pipeline.check_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if backend not in (None, "nccl", "gloo"):
        raise ValueError(f"ray_mesh: backend {backend!r}; the mesh gathers "
                         "with nccl (on the device) or gloo (through the "
                         "host)")
    if backend == "nccl" and device.type != "cuda":
        raise ValueError(f"ray_mesh: nccl needs a CUDA device, not {device}")
    return RayMesh(group=group if backend else None, rank=rank, size=size,
                   device=device, staged=backend == "gloo")


def _pad_to(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


# ---------------------------------------------------------------------------
# Sharded trace and dense frame
# ---------------------------------------------------------------------------

def sharded_trace(metric: Metric, mesh: RayMesh, state: RayState, params,
                  features: Features, opts: TraceOptions) -> RayState:
    """Trace a ray batch with its rays sharded over the mesh: the batch is
    padded to a multiple of the world size with rays born DEAD, each rank
    marches its contiguous shard, and every rank gets the padded global
    state back (callers slice to the batch)."""
    n = state.position.shape[0]
    pad = _pad_to(n, mesh.size) - n
    state = RayState(*(t.to(mesh.device) for t in state))
    if pad:
        state = RayState(*(torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
                           for t in state))
        status = state.status.clone()
        status[n:] = integrate.DEAD
        state = state._replace(status=status)
    m = (n + pad) // mesh.size
    shard = RayState(*(t[mesh.rank * m:(mesh.rank + 1) * m] for t in state))
    final = integrate.trace_rays(metric, shard, params, features=features,
                                 opts=opts)
    return RayState(*(mesh.all_gather(t) for t in final))


def sharded_render_frame(metric: Metric, mesh: RayMesh, camera: cam.Camera,
                         params, backgrounds: bg.Background,
                         settings: pipeline.RenderSettings,
                         features: Features | None = None) -> Tensor:
    """The dense frame with its trace sharded over the mesh (planar mode
    off, as the reference's); ray init, render data and shading run whole
    on every rank.  Returns (H, W, 3) linear RGB."""
    if features is None:
        features = Features.for_metric(metric)
    state, ku, _ = pipeline.init_camera_rays(
        metric, camera, params, dataclasses.replace(settings, planar=False),
        features, device=mesh.device)
    n = state.position.shape[0]
    final = sharded_trace(metric, mesh, state, params, features,
                          settings.trace)
    final = RayState(*(t[:n] for t in final))
    rdata = pipeline.compute_render_data(metric, final, ku, params, features)
    return pipeline.shade(rdata, backgrounds.to(mesh.device), settings)


# ---------------------------------------------------------------------------
# Band-decomposed adaptive frames
# ---------------------------------------------------------------------------

class _Bands(NamedTuple):
    """Per-frame setup of a band-decomposed adaptive frame."""

    Wh: int  # quarter columns
    Hh: int  # quarter rows
    Hb: int  # quarter rows of a band
    k: int  # blocks of a band's refine launch
    band_settings: pipeline.RenderSettings  # a band's image (height 2 Hb)
    opts: TraceOptions
    frame: tuple  # camera_frame's (position, tetrad), once per frame
    kill: Tensor  # (Hh * Wh,) prepass kill map, band-row-major
    mirror: bool
    cpb: int  # row chunks a band under balance, else 0
    inv_fullres: Tensor | None  # band-major image rows -> image rows
    row_map: Tensor | None  # (n_bands, Hb) quarter rows of each band


def _cost_band_layout(kill_full: Tensor, cost_full: Tensor, Hh: int, Wh: int,
                      n_bands: int, cpb: int):
    """Per-frame cost-balanced assignment of row chunks to bands.

    The ``Hh`` quarter rows are cut into ``n_bands * cpb`` contiguous
    chunks, each priced by the prepass cost map, and the chunks go to bands
    by greedy LPT (dearest first, stable order among equal costs, each to
    the least-loaded band that has room, the first of equals) under a
    capacity of ``cpb`` chunks a band, so every band gets ``Hh / n_bands``
    rows.  Everything stays on the device.

    Returns ``(kill_perm, cost_perm, row_map, inv_fullres)``: the maps in
    band-major row order, each band's quarter rows ``(n_bands, Hh /
    n_bands)`` (its chunks in image order), and the full-resolution row
    gather that puts the band-major image back in image order."""
    dev = cost_full.device
    C = n_bands * cpb
    Hc = Hh // C
    chunk_cost = cost_full.reshape(C, Hc * Wh).sum(dim=1)
    order = torch.argsort(-chunk_cost, stable=True)
    load = torch.zeros(n_bands, dtype=torch.float32, device=dev)
    count = torch.zeros(n_bands, dtype=torch.int32, device=dev)
    assign = torch.zeros(C, dtype=torch.int32, device=dev)
    one = torch.ones(1, dtype=torch.int32, device=dev)
    for i in range(C):
        c = order[i:i + 1]
        masked = torch.where(count < cpb, load, torch.inf)
        b = torch.argmin(masked).reshape(1)
        load.index_add_(0, b, chunk_cost.index_select(0, c))
        count.index_add_(0, b, one)
        assign.index_copy_(0, c, b.to(torch.int32))
    arange_c = torch.arange(C, dtype=torch.int32, device=dev)
    band_chunks = torch.argsort(assign * C + arange_c).reshape(
        n_bands, cpb).to(torch.int32)
    row_map = (band_chunks[:, :, None] * Hc
               + torch.arange(Hc, dtype=torch.int32, device=dev)).reshape(
                   n_bands, cpb * Hc)
    rows_flat = row_map.reshape(-1)
    kill_perm = kill_full.reshape(Hh, Wh)[rows_flat].reshape(-1)
    cost_perm = cost_full.reshape(Hh, Wh)[rows_flat].reshape(-1)
    full_order = torch.stack([2 * rows_flat, 2 * rows_flat + 1],
                             dim=1).reshape(-1)
    inv_fullres = torch.argsort(full_order).to(torch.int32)
    return kill_perm, cost_perm, row_map, inv_fullres


def _band_setup(metric: Metric, camera: cam.Camera, params,
                settings: pipeline.RenderSettings, features: Features,
                n_bands: int, mirror: bool | None, balance: int | None,
                device) -> _Bands:
    """Band geometry, each band's refine size, the camera frame and the
    global prepass (1/256 of the frame's rays), once per frame.

    ``mirror``: band b covers the top half-chunk of ``Hb / 2`` quarter rows
    at ``b Hb / 2`` and its mirror image at the bottom (needs an even
    ``Hb`` and more than one band).  ``balance``: ``balance`` row chunks a
    band, assigned per frame from the prepass cost map
    (:func:`_cost_band_layout`).  The two exclude each other."""
    W, H = settings.width, settings.height
    if W % 2 or H % 2:
        raise ValueError(f"adaptive sampling needs even image dimensions, "
                         f"got {W}x{H}")
    Wh, Hh = W // 2, H // 2
    if Hh % n_bands:
        raise ValueError(f"band count ({n_bands}) must divide the quarter "
                         f"rows ({Hh})")
    Hb = Hh // n_bands
    k = pipeline._refine_k(Wh * Hb, settings.refine_budget)
    band_settings = dataclasses.replace(settings, height=2 * Hb)
    opts = pipeline._trace_opts(metric, settings)
    if mirror and (n_bands <= 1 or Hb % 2):
        raise ValueError(f"mirror=True requires n_bands > 1 and an even band "
                         f"height (n_bands={n_bands}, Hb={Hb})")
    mirror = bool(mirror)
    if balance and mirror:
        raise ValueError("balance and mirror are mutually exclusive")
    balance = balance if balance and n_bands > 1 else None
    if balance and Hb % balance:
        raise ValueError(f"balance={balance} chunks a band must divide the "
                         f"band height ({Hb} quarter rows)")

    camera = camera.to(device)
    frame = pipeline.camera_frame(metric, camera, params)
    kill = torch.zeros(Hh * Wh, dtype=torch.bool, device=device)
    cost = torch.zeros(Hh * Wh, dtype=torch.float32, device=device)
    if metric.config.use_prepass:
        psettings = dataclasses.replace(
            settings, width=max(W // settings.prepass_scale, 4),
            height=max(H // settings.prepass_scale, 4),
            adaptive_sampling=False)
        dead, psteps = pipeline._prepass_dead_map(metric, camera, frame,
                                                  params, psettings, features)
        kill = pipeline._prepass_kill(dead, W, H, Wh, Hh)
        if balance:
            cost = pipeline._prepass_cost(psteps, W, H, Wh, Hh)

    inv_fullres = row_map = None
    if balance:
        kill, _, row_map, inv_fullres = _cost_band_layout(
            kill, cost, Hh, Wh, n_bands, balance)
    elif mirror:
        Hb2 = Hb // 2
        order = np.concatenate([
            np.concatenate([np.arange(b * Hb2, (b + 1) * Hb2),
                            np.arange(Hh - (b + 1) * Hb2, Hh - b * Hb2)])
            for b in range(n_bands)])
        # The kill map is consumed band-row-major: permute it.
        kill = kill.reshape(Hh, Wh)[torch.from_numpy(order).to(device)]
        kill = kill.reshape(-1)
        # Banded image row 2i (+1) shows image row 2 order[i] (+1).
        full_order = np.stack([2 * order, 2 * order + 1], axis=1).reshape(-1)
        inv_fullres = torch.from_numpy(
            np.argsort(full_order).astype(np.int32)).to(device)
    return _Bands(Wh, Hh, Hb, k, band_settings, opts, frame, kill, mirror,
                  balance or 0, inv_fullres, row_map)


def _adaptive_band_stages(metric: Metric, camera: cam.Camera, params,
                          backgrounds: bg.Background,
                          settings: pipeline.RenderSettings,
                          features: Features, bands: _Bands):
    """The adaptive frame's stages for one band of ``Hb`` quarter rows:
    returns ``band(b) -> (2 Hb, W, 3)`` image.  ``sharded_adaptive_frame``
    calls it with its rank, ``banded_adaptive_frame`` with each band in
    turn, so the two are equal by construction.

    The stages are the single-device frame's (``render_frame_adaptive``):
    quarter rays under the prepass kill map, the quarter launch, render
    data, the top-k block selection, the refine launch of the k blocks'
    three other pixels and the traced-only finish, each on the band alone.
    A band's edge rows are must-refine like the image's borders, and so are
    the seams where a band's rows are not image-adjacent (the mirrored
    halves, the balanced chunks): nothing is interpolated across data the
    band cannot see.  Each band's refine launch holds ``k`` blocks, the
    frame's budget split evenly."""
    Wh, Hh, Hb = bands.Wh, bands.Hh, bands.Hb
    k, dev = bands.k, bands.kill.device
    camera = camera.to(dev)
    backgrounds = backgrounds.to(dev)
    Hb2 = Hb // 2
    if bands.cpb:
        # The chunk edges inside a band sit at fixed rows of the band grid
        # whatever chunks the frame assigned.
        Hc = Hb // bands.cpb
        seam = tuple(r for c in range(1, bands.cpb)
                     for r in (c * Hc - 1, c * Hc))
    else:
        seam = (Hb2 - 1, Hb2) if bands.mirror else ()
    r = torch.arange(Hb, dtype=torch.int32, device=dev)
    qcx = (2.0 * torch.arange(Wh, dtype=torch.float32, device=dev)).repeat(Hb)

    def band_rows(b: int) -> Tensor:
        if bands.cpb:
            return bands.row_map[b]
        if bands.mirror:
            return torch.where(r < Hb2, b * Hb2 + r,
                               Hh - (b + 1) * Hb2 + (r - Hb2))
        return b * Hb + r

    def band(b: int) -> Tensor:
        qcy = (2.0 * band_rows(b).to(torch.float32)).repeat_interleave(Wh)
        nqb = Wh * Hb
        kill = bands.kill[b * nqb:(b + 1) * nqb]
        # Quarter stage.
        state, ku, iquat = pipeline._init_rays(
            metric, camera, bands.frame, params, settings, features, qcx, qcy,
            kill)
        qfin = integrate.trace_rays(metric, state, params, features=features,
                                    opts=bands.opts, image_width=Wh)
        qr = pipeline.compute_render_data(metric, qfin, ku, params, features,
                                          inv_quat=iquat)
        # Refine stage.
        qg = pipeline.RenderData(*(f.reshape((Hb, Wh) + f.shape[1:])
                                   for f in qr))
        should, sel, dest = pipeline._select_refine_blocks(
            qg, settings, k, seam_rows=seam)
        sflat = should.reshape(-1)[sel]
        scx, scy = qcx[sel], qcy[sel]
        rcx = torch.cat([scx + ox for ox, oy in pipeline._REFINE_OFFSETS])
        rcy = torch.cat([scy + oy for ox, oy in pipeline._REFINE_OFFSETS])
        rkill = ~torch.cat([sflat] * 3)
        rstate, rku, riquat = pipeline._init_rays(
            metric, camera, bands.frame, params, settings, features, rcx, rcy,
            rkill)
        rfin = integrate.trace_rays(metric, rstate, params, features=features,
                                    opts=bands.opts)
        # Finish stage: the band's traced-only shading and assembly.
        img, _ = pipeline._finish_shade(
            metric, rfin, rku, riquat, params, features, qr, should, sel,
            dest, backgrounds, bands.band_settings, k)
        return img

    return band


def sharded_adaptive_frame(metric: Metric, mesh: RayMesh, camera: cam.Camera,
                           params, backgrounds: bg.Background,
                           settings: pipeline.RenderSettings,
                           features: Features | None = None,
                           mirror: bool | None = None,
                           balance: int | None = None) -> Tensor:
    """The adaptive frame (prepass, quarter trace, budgeted refinement,
    traced-only shading) sharded over quarter-row bands, one a rank.

    Every rank runs the small prepass and the camera frame for the whole
    image (so no band needs a neighbour's data), then its band's stages
    (:func:`_adaptive_band_stages`: two launches of the kernel); the band
    images are all-gathered and, for ``mirror`` or ``balance`` layouts, put
    back in image order.  A frame's collective cost is that one gather.
    The band boundaries are must-refine, so they add traced blocks (about
    0.2% of the rays a boundary) and never interpolate across a band.
    Returns (H, W, 3) linear RGB on every rank."""
    if features is None:
        features = Features.for_metric(metric)
    bands = _band_setup(metric, camera, params, settings, features, mesh.size,
                        mirror, balance, mesh.device)
    band = _adaptive_band_stages(metric, camera, params, backgrounds,
                                 settings, features, bands)
    img = mesh.all_gather(band(mesh.rank))
    if bands.inv_fullres is not None:
        img = img[bands.inv_fullres]
    return img


def banded_adaptive_frame(metric: Metric, camera: cam.Camera, params,
                          backgrounds: bg.Background,
                          settings: pipeline.RenderSettings, n_bands: int,
                          features: Features | None = None, band_sync=None,
                          mirror: bool | None = None,
                          balance: int | None = None, *, device) -> Tensor:
    """The band decomposition of :func:`sharded_adaptive_frame` run band
    after band on one device: the same stage code with the band index from
    a loop instead of the rank, so the image is the sharded frame's bit for
    bit.  It measures the banding tax on one card: the band-edge
    must-refine rows, the split refine budget and the smaller launches;
    with balanced bands an N-device frame's efficiency is at most
    ``T(1 band) / (N T(slowest band))``.  ``band_sync(b, img)`` is called
    with each band's image as it is issued (to time or force it)."""
    device = pipeline.check_device(device)
    if features is None:
        features = Features.for_metric(metric)
    bands = _band_setup(metric, camera, params, settings, features, n_bands,
                        mirror, balance, device)
    band = _adaptive_band_stages(metric, camera, params, backgrounds,
                                 settings, features, bands)
    imgs = []
    for b in range(n_bands):
        img = band(b)
        if band_sync is not None:
            band_sync(b, img)
        imgs.append(img)
    img = torch.cat(imgs)
    if bands.inv_fullres is not None:
        img = img[bands.inv_fullres]
    return img


# ---------------------------------------------------------------------------
# The distributed train step
# ---------------------------------------------------------------------------

def train_step_schedule(settings: pipeline.RenderSettings,
                        grad_step_cap: int = 512,
                        grad_hard_cap: int | None = None,
                        soft_decay_bits: float = 1.0):
    """``(grad_hard_cap, scan opts, probe opts)`` of the train step.

    The hard cap keeps lanes only up to the float32 weight-underflow
    boundary: a lane more than ``ceil(149 / decay)`` steps past the soft cap
    has loss weight 2^-149 = 0 exactly, yet its photon-ring Jacobian can
    overflow float32 in the backward pass (inf * 0 = NaN).  The
    differentiable scan covers the hard cap plus rejected-trial slack
    (1.25x), rounded up to whole recomputation windows and at most the
    trace's budget; the probe runs the ``while`` driver at the full
    budget."""
    max_steps = settings.trace.max_steps
    if grad_hard_cap is None:
        margin = int(np.ceil(149.0 / max(float(soft_decay_bits), 1e-6)))
        grad_hard_cap = min(2 * grad_step_cap, grad_step_cap + margin,
                            max_steps)
    grad_hard_cap = min(grad_hard_cap, max_steps)
    opts = dataclasses.replace(settings.trace, method="scan")
    remat = max(1, min(opts.remat_every, opts.max_steps))
    scan_steps = min(opts.max_steps,
                     -(-int(grad_hard_cap * 1.25) // remat) * remat)
    opts = dataclasses.replace(opts, max_steps=scan_steps)
    probe_opts = dataclasses.replace(settings.trace, method="while")
    return grad_hard_cap, opts, probe_opts


def _launch(metric: Metric, camera: cam.Camera, dirs: Tensor, params,
            features: Features):
    """``(launch state, ku_uobsu)`` of the pixel directions ``dirs`` (N, 3)
    from the camera's static observer (no planar rotation)."""
    position = pipeline.camera_to_generic(metric, camera, params)
    es = cam.observer_tetrad(metric, position, params,
                             basis_speed3=camera.basis_speed)
    state, ku, _ = pipeline.rays_for_directions(metric, position, es, params,
                                                features, dirs.T)
    return state, ku


def _gradients(loss: Tensor, leaves: list) -> tuple:
    """The backward pass: d loss / d each leaf (a module function, so that a
    caller can time it apart from the forward)."""
    return torch.autograd.grad(loss, leaves)


def make_train_step(metric: Metric, mesh: RayMesh,
                    settings: pipeline.RenderSettings,
                    features: Features | None = None,
                    grad_step_cap: int = 512,
                    grad_hard_cap: int | None = None,
                    soft_decay_bits: float = 1.0):
    """A training step that fits metric parameters to a target image by
    gradient descent through the recomputed-window scan of the integrator,
    with the pixels sharded over the mesh.

    Returns ``step(params, camera, target_image, backgrounds, lr) ->
    (new_params, loss)`` (``params``: a dict of floats or 0-d tensors;
    ``new_params``: 0-d float32 tensors on the mesh's device) with
    ``step.loss_and_grad(params, camera, target_image, backgrounds,
    probe_params=None) -> (loss, grads)``, ``step.loss(...)``, the loss
    alone under ``no_grad``, and ``step.update(params, grads, lr) ->
    new_params``, the update ``step`` applies to ``loss_and_grad``'s
    gradients.  Every rank gets the same loss, gradients and update.

    Term for term the reference's step:

    * **Shards.** Rank r takes the r-th of ``size`` equal runs of the
      row-major pixels (the pixel count must divide by the world size); the
      local loss is its pixels' part of the sum over all pixels.
    * **Probe.** Under ``no_grad``, on the parameters as host floats
      (``probe_params``, default ``params``), the ``while`` driver marches
      the rays at the full budget: on a GPU one launch of the CUDA kernel.
      A lane is kept when it escaped to the far half of the universe sphere
      within the hard cap; every other lane enters the differentiable scan
      pre-killed, idling at its regular launch state, so that no divergent
      trial and no deep photon-ring orbit reaches the backward pass.
    * **Soft Lyapunov window.** Each kept pixel's loss weight is
      ``2^(-soft_decay_bits * max(steps - grad_step_cap, 0))``, a constant
      of the loss taken from the probe: reverse-mode tangents of
      photon-ring rays grow about e^(2 pi) an orbit, and the weights keep
      every cotangent in float32 range while shadow-edge pixels a few steps
      past the soft cap keep near-full weight.  Since the weights are
      constants, the gradient equals the finite difference of the same
      weighted loss with the probe frozen (``probe_params``).
    * **Scan.** ``integrate.trace_rays_scan`` of the launch state on
      ``params`` (tensors that require grad), the endpoints of non-kept
      lanes replaced by their launch states, then ``compute_render_data``
      and ``read_mipmap`` at lod 3: the masked, weighted L2 against the
      target over the pixel count.
    * **All-reduce.** After the local backward, the loss and every gradient
      are summed over the ranks in one ``all_reduce`` (the reference's
      ``psum``): a sum of per-rank partial sums, so a world of N can differ
      from a world of 1 by float32 reassociation.
    * **Update.** Clip by the global gradient norm (``min(1, 1 / |g|)``),
      then SGD, under ``no_grad``, the same on every rank.
    """
    device = mesh.device
    if features is None:
        features = Features.for_metric(metric)
    grad_hard_cap, opts, probe_opts = train_step_schedule(
        settings, grad_step_cap, grad_hard_cap, soft_decay_bits)
    W, H = settings.width, settings.height
    n_rays = W * H
    if n_rays % mesh.size:
        raise ValueError(f"image pixels ({n_rays}) must divide the mesh "
                         f"({mesh.size} ranks)")
    m = n_rays // mesh.size
    lo = mesh.rank * m
    # The shard is whole pixel rows when W divides it: the probe launch
    # then groups its rays by pixel tile.
    width = W if m % W == 0 else None

    def local_loss(params, camera, dirs, target, backgrounds, probe_params):
        state, ku = _launch(metric, camera, dirs, params, features)
        with torch.no_grad():
            pp = {k: float(v) for k, v in probe_params.items()}
            pstate, _ = _launch(metric, camera, dirs, pp, features)
            probe = integrate.trace_rays(metric, pstate, pp, features,
                                         probe_opts, image_width=width)
            polar_r = torch.abs(metric.to_polar(probe.position.T, pp)[1])
            keep = ((probe.status == integrate.ESCAPED)
                    & (polar_r >= 0.5 * features.universe_size)
                    & (probe.steps <= grad_hard_cap))
            extra = torch.clamp(probe.steps.to(torch.float32)
                                - float(grad_step_cap), min=0.0)
            lyap_w = torch.where(keep, torch.exp2(-soft_decay_bits * extra),
                                 0.0)
        state = state._replace(
            status=torch.where(keep, state.status, integrate.DEAD))
        final = integrate.trace_rays(metric, state, params, features, opts)
        # Every discrete decision comes from the probe, which runs the same
        # step on the same launch state as the scan.
        mk = keep[:, None]
        final = final._replace(
            position=torch.where(mk, final.position, state.position),
            velocity=torch.where(mk, final.velocity, state.velocity),
            acceleration=torch.where(mk, final.acceleration,
                                     state.acceleration))
        rdata = pipeline.compute_render_data(metric, final, ku, params,
                                             features)
        # A blurred mip level: flat checker squares give zero or edge
        # gradients that stall the fit; the blur makes the pixel loss a
        # smooth function of the texture coordinates.
        rgb = bg.read_mipmap(backgrounds, rdata.side, rdata.tex_coord,
                             torch.full(rdata.side.shape, 3.0, device=device))
        rgb = torch.where(mk, rgb, 0.0)
        w = torch.where(keep, lyap_w, 0.0)[:, None]
        return torch.sum(w * (rgb - target) ** 2) / n_rays

    def leaves_of(params):
        return {k: (v.detach().clone() if isinstance(v, Tensor)
                    else torch.tensor(float(v), dtype=torch.float32,
                                      device=device)).requires_grad_()
                for k, v in params.items()}

    def inputs(camera, target_image, backgrounds):
        """This rank's pixel directions and target pixels."""
        camera = camera.to(device)
        dirs = cam.pixel_directions(W, H, camera.quat,
                                    settings.fov_degrees).reshape(-1, 3)
        target = target_image.to(device).reshape(-1, 3)
        return (camera, dirs[lo:lo + m], target[lo:lo + m],
                backgrounds.to(device))

    def loss_and_grad(params, camera, target_image, backgrounds,
                      probe_params=None):
        """(loss, grads) without the update, for a finite-difference check
        of the weighted loss: pass ``probe_params`` (the unperturbed point)
        to freeze the probe's masks and weights under a perturbation."""
        leaves = leaves_of(params)
        if probe_params is None:
            probe_params = leaves
        with torch.enable_grad():
            loss = local_loss(leaves, *inputs(camera, target_image,
                                              backgrounds), probe_params)
            grads = _gradients(loss, list(leaves.values()))
        total = mesh.all_reduce_sum(torch.stack([loss.detach(), *grads]))
        return total[0], dict(zip(leaves, total[1:]))

    def loss(params, camera, target_image, backgrounds, probe_params=None):
        """The loss alone, under ``no_grad`` (the same forward, so the same
        value as ``loss_and_grad``'s), for the finite differences."""
        if probe_params is None:
            probe_params = params
        with torch.no_grad():
            return mesh.all_reduce_sum(local_loss(
                params, *inputs(camera, target_image, backgrounds),
                probe_params))

    def update(params, grads, lr):
        """The step's parameter update from the summed gradients."""
        with torch.no_grad():
            # Clip by global norm: the L2 landscape has cliffs at horizon
            # crossings, and raw SGD overshoots.
            gnorm = torch.sqrt(sum(torch.sum(grads[k] * grads[k])
                                   for k in sorted(grads)) + 1e-20)
            scale = torch.clamp(1.0 / gnorm, max=1.0)
            return {k: torch.as_tensor(params[k], dtype=torch.float32,
                                       device=device) - lr * scale * g
                    for k, g in grads.items()}

    def step(params, camera, target_image, backgrounds, lr):
        loss, grads = loss_and_grad(params, camera, target_image, backgrounds)
        return update(params, grads, lr), loss

    step.loss_and_grad = loss_and_grad
    step.loss = loss
    step.update = update
    return step
