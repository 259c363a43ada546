"""Differentiable-rendering parameter fitting (port of
``geodesic_raytracing_tpu.fit``).

Renders a target image with the "true" metric parameters, then recovers them
by gradient descent from a perturbed start, with gradients through the
recomputed-window scan of the integrator (``parallel.make_train_step``).  On
a GPU the train step's probe march is one launch of the CUDA kernel; the
differentiable scan is eager torch on the card.

Usage:
    python -m geodesic_raytracing_tpu_torch.fit --metric schwarzschild \
        --true rs=1.1 --start rs=0.9 --steps 30 --size 32 --device cuda
    python -m geodesic_raytracing_tpu_torch.fit --metric schwarzschild \
        --size 16 --steps 4 --device cpu --checkpoint ck --checkpoint-every 2
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np


def parse_kv(items):
    out = {}
    for kv in items or []:
        k, v = kv.split("=", 1)
        out[k] = float(v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--metric", default="schwarzschild")
    ap.add_argument("--true", action="append", metavar="NAME=VALUE",
                    help="true parameter values for the target render")
    ap.add_argument("--start", action="append", metavar="NAME=VALUE",
                    help="initial parameter values for the fit")
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lr", type=float, default=0.05)
    ap.add_argument("--lr-decay", type=float, default=0.93,
                    help="per-step learning-rate decay")
    ap.add_argument("--size", type=int, default=32)
    ap.add_argument("--max-steps", type=int, default=192)
    ap.add_argument("--remat-every", type=int, default=32)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint directory (resume if present)")
    ap.add_argument("--checkpoint-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the probe march is the CUDA kernel and the "
                         "scan runs on the card; cpu: everything eager on "
                         "the CPU")
    args = ap.parse_args(argv)

    import torch

    from . import metrics
    from .camera import Camera
    from .ops.integrate import Features, TraceOptions
    from .parallel import make_train_step
    from .render import background as bg
    from .render.pipeline import RenderSettings, check_device
    from .utils.checkpoint import load_checkpoint, save_checkpoint

    device = check_device(args.device)
    metric = metrics.get_metric(args.metric)
    true_params = metric.params(**parse_kv(args.true))
    params = metric.params(**parse_kv(args.start))
    print(f"device: {device.type}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))

    settings = RenderSettings(
        width=args.size, height=args.size,
        trace=TraceOptions(max_steps=args.max_steps, method="scan",
                           remat_every=args.remat_every),
    )
    features = Features.for_metric(metric)
    step = make_train_step(metric, settings, features, device=device)

    camera = Camera.default(device=device).rotate(pitch=-np.pi / 2)
    backgrounds = bg.checker_background(256, 512, device=device)
    target = _render_target(metric, camera, true_params, backgrounds,
                            settings, features, device=device)

    start_step = 0
    if args.checkpoint:
        ck = load_checkpoint(args.checkpoint)
        if ck:
            start_step, saved, _, _ = ck
            params = {k: torch.tensor(float(v), dtype=torch.float32,
                                      device=device)
                      for k, v in saved.items()}
            print(f"resumed from step {start_step}: "
                  f"{ {k: float(v) for k, v in params.items()} }")

    t0 = time.time()
    for i in range(start_step, args.steps):
        lr_i = args.lr * args.lr_decay ** i
        params, loss = step(params, camera, target, backgrounds, lr_i)
        vals = {k: round(float(v), 5) for k, v in params.items()}
        print(f"step {i:3d} loss {float(loss):.6f} params {vals}",
              flush=True)
        if args.checkpoint and (i + 1) % args.checkpoint_every == 0:
            save_checkpoint(args.checkpoint, i + 1, params)

    print(f"fit done in {time.time() - t0:.1f}s")
    for k in true_params:
        print(f"  {k}: fitted {float(params[k]):+.5f} "
              f"true {float(true_params[k]):+.5f}")
    return 0


def _render_target(metric, camera, true_params, backgrounds, settings,
                   features, grad_step_cap: int = 512, *, device):
    """The fitting target, rendered by the loss's own path (trace with
    ``settings.trace``, the consumed-pixel rule of ``grad_safe_final`` at
    the train step's default hard cap, nearest-mip read-out at lod 3), so
    that the fit compares like with like.  Returns (H, W, 3)."""
    import torch

    from .ops import integrate
    from .render import background as bgm
    from .render import pipeline as pl

    device = pl.check_device(device)
    with torch.no_grad():
        state, ku, _ = pl.init_camera_rays(
            metric, camera, true_params,
            dataclasses.replace(settings, planar=False), features,
            device=device)
        fin = integrate.trace_rays(metric, state, true_params,
                                   features=features, opts=settings.trace)
        hard_cap = min(2 * grad_step_cap, settings.trace.max_steps)
        fin, consumed = pl.grad_safe_final(metric, state, fin, true_params,
                                           features, step_cap=hard_cap)
        rdata = pl.compute_render_data(metric, fin, ku, true_params,
                                       features)
        rgb = bgm.read_mipmap(backgrounds.to(device), rdata.side,
                              rdata.tex_coord,
                              torch.full(rdata.side.shape, 3.0,
                                         device=device))
        rgb = torch.where(consumed[:, None], rgb, 0.0)
    return rgb.reshape(settings.height, settings.width, 3)


if __name__ == "__main__":
    sys.exit(main())
