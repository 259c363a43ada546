"""The differentiable train step (port of
``geodesic_raytracing_tpu.parallel.mesh.make_train_step``), on one device.

The reference shards the rays over a device mesh and sums the loss and the
parameter gradients with one ``psum``; here the rays are one batch on one
device and there is no all-reduce.  The ``psum`` over devices comes with the
port of the rest of this module (sharded and banded frames) on
``torch.distributed`` (ROADMAP.md, Queue 1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import camera as cam
from ..metrics.base import Metric
from ..ops import integrate
from ..ops.integrate import Features
from ..render import background as bg
from ..render import pipeline

Tensor = torch.Tensor


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
                             basis_speed3=camera.basis_speed, orient=True)
    state, ku, _ = pipeline.rays_for_directions(metric, position, es, params,
                                                features, dirs.T)
    return state, ku


def _gradients(loss: Tensor, leaves: list) -> tuple:
    """The backward pass: d loss / d each leaf (a module function, so that a
    caller can time it apart from the forward)."""
    return torch.autograd.grad(loss, leaves)


def make_train_step(metric: Metric, settings: pipeline.RenderSettings,
                    features: Features | None = None,
                    grad_step_cap: int = 512,
                    grad_hard_cap: int | None = None,
                    soft_decay_bits: float = 1.0, *, device):
    """A training step that fits metric parameters to a target image by
    gradient descent through the recomputed-window scan of the integrator.

    Returns ``step(params, camera, target_image, backgrounds, lr) ->
    (new_params, loss)`` (``params``: a dict of floats or 0-d tensors;
    ``new_params``: 0-d float32 tensors on ``device``) with
    ``step.loss_and_grad(params, camera, target_image, backgrounds,
    probe_params=None) -> (loss, grads)`` and ``step.loss(...)``, the loss
    alone under ``no_grad``.

    Term for term the reference's step:

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
    * **Update.** Clip by the global gradient norm (``min(1, 1 / |g|)``),
      then SGD, under ``no_grad``.
    """
    device = pipeline.check_device(device)
    if features is None:
        features = Features.for_metric(metric)
    grad_hard_cap, opts, probe_opts = train_step_schedule(
        settings, grad_step_cap, grad_hard_cap, soft_decay_bits)
    W, H = settings.width, settings.height
    n_rays = W * H

    def local_loss(params, camera, dirs, target, backgrounds, probe_params):
        state, ku = _launch(metric, camera, dirs, params, features)
        with torch.no_grad():
            pp = {k: float(v) for k, v in probe_params.items()}
            pstate, _ = _launch(metric, camera, dirs, pp, features)
            probe = integrate.trace_rays(metric, pstate, pp, features,
                                         probe_opts, image_width=W)
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
        m = keep[:, None]
        final = final._replace(
            position=torch.where(m, final.position, state.position),
            velocity=torch.where(m, final.velocity, state.velocity),
            acceleration=torch.where(m, final.acceleration,
                                     state.acceleration))
        rdata = pipeline.compute_render_data(metric, final, ku, params,
                                             features)
        # A blurred mip level: flat checker squares give zero or edge
        # gradients that stall the fit; the blur makes the pixel loss a
        # smooth function of the texture coordinates.
        rgb = bg.read_mipmap(backgrounds, rdata.side, rdata.tex_coord,
                             torch.full(rdata.side.shape, 3.0, device=device))
        rgb = torch.where(m, rgb, 0.0)
        w = torch.where(keep, lyap_w, 0.0)[:, None]
        return torch.sum(w * (rgb - target) ** 2) / n_rays

    def leaves_of(params):
        return {k: (v.detach().clone() if isinstance(v, Tensor)
                    else torch.tensor(float(v), dtype=torch.float32,
                                      device=device)).requires_grad_()
                for k, v in params.items()}

    def inputs(camera, target_image, backgrounds):
        camera = camera.to(device)
        dirs = cam.pixel_directions(W, H, camera.quat,
                                    settings.fov_degrees).reshape(-1, 3)
        return (camera, dirs, target_image.to(device).reshape(-1, 3),
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
        return loss.detach(), dict(zip(leaves, grads))

    def loss(params, camera, target_image, backgrounds, probe_params=None):
        """The loss alone, under ``no_grad`` (the same forward, so the same
        value as ``loss_and_grad``'s), for the finite differences."""
        if probe_params is None:
            probe_params = params
        with torch.no_grad():
            return local_loss(params, *inputs(camera, target_image,
                                              backgrounds), probe_params)

    def step(params, camera, target_image, backgrounds, lr):
        loss, grads = loss_and_grad(params, camera, target_image, backgrounds)
        with torch.no_grad():
            # Clip by global norm: the L2 landscape has cliffs at horizon
            # crossings, and raw SGD overshoots.
            gnorm = torch.sqrt(sum(torch.sum(grads[k] * grads[k])
                                   for k in sorted(grads)) + 1e-20)
            scale = torch.clamp(1.0 / gnorm, max=1.0)
            new_params = {k: torch.as_tensor(params[k], dtype=torch.float32,
                                             device=device) - lr * scale * g
                          for k, g in grads.items()}
        return new_params, loss

    step.loss_and_grad = loss_and_grad
    step.loss = loss
    return step
