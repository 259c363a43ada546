"""Where the port's 128x128 golden frame of a metric differs between the
GPU and the CPU, which rays those pixels belong to, and which side is nearer
a float64 march of the same rays.

The scene is ``chip_smoke.py`` phase 18's (the flagship camera, pitch -90
degrees, 8,192 steps, anisotropy 4, the default checker sky).  The script
renders it four ways:

- ``card``: the frame on the GPU (its launch state, the ray-march kernel,
  the shading), as phase 18 renders it;
- ``cpu``: the frame on the CPU (the eager plain march), as the CPU golden
  tests render it;
- ``cross``: the GPU's launch state marched and shaded on the CPU, which
  separates a difference of launch states from one of the marches;
- ``f64``: the GPU frame with the disputed rays (every pixel, dilated by
  one, where two of card, cpu and the golden PNG differ by more than 32 in
  a channel, and ``--controls`` other rays drawn from a seed) replaced by
  the plain march in float64 on the CPU from the GPU's launch state.

It prints each frame's golden gate (RMSE, share of pixels off by more than
32), then, for the pixels where card and cpu differ by more than 32, the
class of each pixel's ray (``ring``: dead within r < 0.05 of the
Kerr-Schild ring in one of the marches; ``long``: at least twice the
median step count of the escaped rays; ``other``), its fates and step
counts in the three marches, and which of card and cpu is nearer the f64
pixel.  The last line is one JSON object with the counts.

Usage (one GPU; ``--device cpu`` runs every path on the CPU, as a check of
the script at a small ``--size``):

    python scripts/torch_golden_witness.py [--metric kerr_schild]
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from geodesic_raytracing_tpu_torch import cli, metrics  # noqa: E402
from geodesic_raytracing_tpu_torch.camera import Camera  # noqa: E402
from geodesic_raytracing_tpu_torch.ops import integrate  # noqa: E402
from geodesic_raytracing_tpu_torch.render import background as bg  # noqa
from geodesic_raytracing_tpu_torch.render import colour  # noqa: E402
from geodesic_raytracing_tpu_torch.render import pipeline as pl  # noqa

RING_R = 0.05
OFF = 32


def srgb8(img):
    s = colour.lin_to_srgb(img).cpu().float().numpy()
    return (np.clip(s, 0, 1) * 255).astype(np.uint8)


def gate(a, b):
    d = np.abs(a.astype(int) - b.astype(int))
    return float(np.sqrt((d.astype(float) ** 2).mean())), float(
        (d > OFF).mean())


def off(a, b):
    """Per pixel, the largest channel difference of two sRGB images."""
    return np.abs(a.astype(int) - b.astype(int)).max(axis=-1)


def ks_radius(pos, a):
    """The Kerr-Schild radius r at (n, 4) cartesian events, in float64."""
    x, y, z = (pos[:, k].astype(np.float64) for k in (1, 2, 3))
    R2 = x * x + y * y + z * z
    aa = float(a) ** 2
    r2 = 0.5 * (-aa + np.sqrt(aa * aa - 2 * aa * (x * x + y * y - z * z)
                              + R2 * R2) + R2)
    return np.sqrt(np.maximum(r2, 0.0))


def to_cpu(state, dtype=None):
    def move(t):
        t = t.detach().cpu()
        return t.to(dtype) if dtype is not None and t.is_floating_point() \
            else t
    return integrate.RayState(*(move(t) for t in state))


def frame(metric, state, ku, iquat, params, feats, settings, sky, opts):
    final = integrate.trace_rays(metric, state, params, features=feats,
                                 opts=opts, image_width=settings.width)
    return final, shade(metric, final, ku, iquat, params, feats, settings, sky)


def shade(metric, final, ku, iquat, params, feats, settings, sky):
    rdata = pl.compute_render_data(metric, final, ku, params, feats,
                                   inv_quat=iquat)
    return pl.shade(rdata, sky.to(ku.device), settings)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--metric", default="kerr_schild")
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--max-steps", type=int, default=8192)
    ap.add_argument("--controls", type=int, default=256)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--threads", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("no GPU: run with --device cpu for a check of the script")
        return 1
    torch.set_num_threads(args.threads)
    dev, host = torch.device(args.device), torch.device("cpu")
    m = metrics.get_metric(args.metric)
    params = m.params()
    feats = integrate.Features.for_metric(m)
    settings = pl.RenderSettings(
        width=args.size, height=args.size, anisotropy=4,
        trace=integrate.TraceOptions(max_steps=args.max_steps))
    opts = pl._trace_opts(m, settings)
    n = args.size * args.size
    t0 = time.perf_counter()

    def camera(d):
        return Camera.default(device=d).rotate(pitch=-math.pi / 2)

    sky_card, sky_host = bg.checker_background(device=dev), \
        bg.checker_background(device=host)
    st_c, ku_c, iq_c = pl.init_camera_rays(m, camera(dev), params, settings,
                                           feats, device=dev)
    fin_c, img_c = frame(m, st_c, ku_c, iq_c, params, feats, settings,
                         sky_card, opts)
    st_h, ku_h, iq_h = pl.init_camera_rays(m, camera(host), params, settings,
                                           feats, device=host)
    fin_h, img_h = frame(m, st_h, ku_h, iq_h, params, feats, settings,
                         sky_host, opts)
    launch_c = to_cpu(st_c)
    launch_diff = int(sum(
        (~torch.eq(a, b)).reshape(n, -1).any(dim=1)
        for a, b in zip(launch_c, st_h)).gt(0).sum())
    ku_cc = ku_c.cpu()
    iq_cc = iq_c.cpu() if iq_c is not None else None
    fin_x, img_x = frame(m, launch_c, ku_cc, iq_cc, params, feats, settings,
                         sky_host, opts)
    card, cpu, cross = srgb8(img_c), srgb8(img_h), srgb8(img_x)
    png = ROOT / "tests" / "golden" / "catalogue" / f"{args.metric}.png"
    golden = cli.read_png(png) if args.size == 128 else cpu
    print(f"[witness] {args.metric} {args.size}x{args.size} on "
          f"{torch.cuda.get_device_name(0) if dev.type == 'cuda' else 'cpu'}; "
          f"launch states differing in any bit, GPU vs CPU: {launch_diff} of "
          f"{n} rays ({time.perf_counter() - t0:.1f} s)")

    # The disputed rays, dilated by a pixel (the anisotropic sampling reads
    # the neighbours' texture coordinates), and the controls.
    dispute = ((off(card, cpu) > OFF) | (off(card, golden) > OFF)
               | (off(cpu, golden) > OFF))
    grown = dispute.copy()
    for dy, dx in ((0, 1), (0, -1), (1, 0), (-1, 0)):
        grown |= np.roll(dispute, (dy, dx), axis=(0, 1))
    rng = np.random.default_rng(args.seed)
    others = np.flatnonzero(~grown.reshape(-1))
    controls = rng.choice(others, min(args.controls, others.size),
                          replace=False)
    sel = np.union1d(np.flatnonzero(grown.reshape(-1)), controls)
    idx = torch.from_numpy(sel)
    sub64 = integrate.RayState(*(t[idx] for t in to_cpu(st_c, torch.float64)))
    t1 = time.perf_counter()
    f64 = integrate.trace_rays(m, sub64, params, features=feats, opts=opts)
    print(f"[witness] float64 march of {sel.size} rays ({grown.sum()} "
          f"disputed with their neighbours, {controls.size} controls): "
          f"{time.perf_counter() - t1:.1f} s")
    mixed = [t.clone() for t in to_cpu(fin_c)]
    for k, t in enumerate(f64):
        mixed[k][idx] = t.to(mixed[k].dtype)
    fin_64 = integrate.RayState(*mixed)
    img_64 = srgb8(shade(m, fin_64, ku_cc, iq_cc, params, feats, settings,
                         sky_host))

    rows = {}
    for what, img in (("card", card), ("cpu", cpu), ("cross", cross),
                      ("f64", img_64)):
        rmse, bad = gate(img, golden)
        rows[what] = {"rmse": rmse, "bad": bad}
        print(f"[witness] {what:5s} vs golden: RMSE {rmse:.4f}, pixels off "
              f"by >{OFF} {bad:.5f}")
    for a, b, ia, ib in (("card", "cpu", card, cpu), ("card", "cross", card,
                                                      cross),
                         ("cpu", "cross", cpu, cross)):
        rmse, bad = gate(ia, ib)
        print(f"[witness] {a} vs {b}: RMSE {rmse:.4f}, pixels off by >{OFF} "
              f"{bad:.5f}")
    ctrl = controls
    c_same = int(sum((off(card, img_64).reshape(-1)[ctrl] <= 1)))
    print(f"[witness] controls: f64 pixel within 1 of the card's on "
          f"{c_same} of {ctrl.size}")

    # The pixels where card and cpu part, by the class of their rays.
    parts = np.flatnonzero((off(card, cpu) > OFF).reshape(-1))
    fc, fh, fx = to_cpu(fin_c), fin_h, fin_x
    pos64 = fin_64.position.numpy()
    a = params.get("a", 0.0)
    esc = fc.status.numpy() == integrate.ESCAPED
    median = float(np.median(fc.steps.numpy()[esc])) if esc.any() else 0.0
    classes = {}
    nearer = {"card": 0, "cpu": 0, "tie": 0}
    by_class_nearer = {}
    for p in parts:
        sts = [int(s.status[p]) for s in (fc, fh, fin_64)]
        steps = [int(s.steps[p]) for s in (fc, fh, fin_64)]
        rr = [float(ks_radius(s.position.numpy()[p:p + 1], a)[0])
              if m.rank1 is not None else math.inf
              for s in (fc, fh, fin_64)]
        if any(st == integrate.DEAD and r < RING_R
               for st, r in zip(sts, rr)):
            cls = "ring"
        elif max(steps) >= 2 * median:
            cls = "long"
        else:
            cls = "other"
        classes[cls] = classes.get(cls, 0) + 1
        e_card = int(off(card, img_64).reshape(-1)[p])
        e_cpu = int(off(cpu, img_64).reshape(-1)[p])
        side = "card" if e_card < e_cpu else "cpu" if e_cpu < e_card \
            else "tie"
        nearer[side] += 1
        by_class_nearer.setdefault(cls, {"card": 0, "cpu": 0, "tie": 0})
        by_class_nearer[cls][side] += 1
        y, x = divmod(int(p), args.size)
        like = ("card" if (cross[y, x] == card[y, x]).all()
                else "cpu" if (cross[y, x] == cpu[y, x]).all() else "neither")
        print(f"[witness] pixel ({y}, {x}) {cls}: status card/cpu/f64 {sts}, "
              f"steps {steps}, end r {[round(r, 4) for r in rr]}, off f64: "
              f"card {e_card}, cpu {e_cpu}; cross equals {like}")
    summary = {"metric": args.metric, "rays": n, "launch_diff": launch_diff,
               "median_steps": median, "gates": rows,
               "card_cpu_parts": int(parts.size), "classes": classes,
               "nearer_f64": nearer, "nearer_by_class": by_class_nearer,
               "controls_equal": c_same, "controls": int(ctrl.size),
               "seconds": time.perf_counter() - t0}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
