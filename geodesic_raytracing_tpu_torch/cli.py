"""Command-line renderer for the PyTorch / CUDA port.

Usage:
    python -m geodesic_raytracing_tpu_torch.cli --metric kerr_boyer \
        --width 1920 --height 1080 --pitch -90 --device cuda --out kerr.png
    python -m geodesic_raytracing_tpu_torch.cli --metric schwarzschild \
        --adaptive --redshift --pitch -90 --device cuda --out schw.png
    python -m geodesic_raytracing_tpu_torch.cli --bench kerr_boyer --frames 5
    python -m geodesic_raytracing_tpu_torch.cli --list

    python -m geodesic_raytracing_tpu_torch.cli --adaptive --device cpu \
        --width 64 --height 64 --pitch -90 --max-steps 2048 --out small.png

``--adaptive`` renders the adaptive frame (prepass, quarter grid, top-k
refinement, traced-only shading) instead of the dense one.  ``--bench`` keeps
the reference CLI's protocol line ``Frametime Elapsed: <ms>``, after one
warm-up frame, or four when adaptive (the refinement budget settles first).
A spherically symmetric metric is traced in planar mode (every ray rotated
into the equator, theta pinned) unless ``--no-planar`` is given.
"""

from __future__ import annotations

import argparse
import math
import struct
import sys
import time
import zlib

import numpy as np


def write_png(path: str, arr: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an RGB PNG (standard library
    only: zlib + struct)."""
    arr = np.ascontiguousarray(arr, dtype=np.uint8)
    h, w, c = arr.shape
    if c != 3:
        raise ValueError("write_png expects (H, W, 3) uint8")
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    png = (b"\x89PNG\r\n\x1a\n"
           + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + chunk(b"IDAT", zlib.compress(raw, 6))
           + chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def _unfilter(filt: int, row: np.ndarray, prev: np.ndarray, bpp: int):
    """One PNG scanline with its filter undone (``prev``: the row above)."""
    row = row.astype(np.int32)
    if filt == 0:
        return row
    if filt == 2:
        return (row + prev) & 0xFF
    out = np.zeros_like(row)
    for i in range(len(row)):
        a = out[i - bpp] if i >= bpp else 0
        b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
        if filt == 1:
            pred = a
        elif filt == 3:
            pred = (a + b) // 2
        elif filt == 4:
            pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
            pred = a if pa <= pb and pa <= pc else b if pb <= pc else c
        else:
            raise ValueError(f"unknown PNG filter {filt}")
        out[i] = (row[i] + pred) & 0xFF
    return out


def read_png(path) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit, non-interlaced RGB or RGBA PNG (standard
    library only; the alpha channel is dropped)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG")
    at, idat, head = 8, b"", None
    while at < len(data):
        (n,) = struct.unpack(">I", data[at:at + 4])
        tag, body = data[at + 4:at + 8], data[at + 8:at + 8 + n]
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        at += 12 + n
    w, h, depth, ctype, _, _, interlace = head
    if depth != 8 or ctype not in (2, 6) or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced RGB(A) PNGs")
    bpp = 3 if ctype == 2 else 4
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + bpp * w)
    out = np.zeros((h, bpp * w), np.int32)
    prev = np.zeros(bpp * w, np.int32)
    for y in range(h):
        prev = out[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, bpp)
    return out.astype(np.uint8).reshape(h, w, bpp)[..., :3]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--metric", default="kerr_boyer")
    ap.add_argument("--bench", metavar="METRIC", default=None,
                    help="benchmark mode: print per-frame "
                         "'Frametime Elapsed: MS'")
    ap.add_argument("--frames", type=int, default=10,
                    help="bench frame count")
    ap.add_argument("--width", type=int, default=512)
    ap.add_argument("--height", type=int, default=512)
    ap.add_argument("--fov", type=float, default=90.0)
    ap.add_argument("--camera", type=float, nargs=4,
                    default=[0.0, 7.0, math.pi / 2, -math.pi / 2],
                    metavar=("T", "R", "THETA", "PHI"),
                    help="camera position in polar coordinates")
    ap.add_argument("--pitch", type=float, default=0.0,
                    help="camera pitch in degrees (-90 looks at the origin "
                         "from the default position)")
    ap.add_argument("--yaw", type=float, default=0.0)
    ap.add_argument("--roll", type=float, default=0.0)
    ap.add_argument("--anisotropy", type=int, default=8)
    ap.add_argument("--list", action="store_true",
                    help="list the ported metrics and exit")
    ap.add_argument("--param", action="append", default=[],
                    metavar="NAME=VALUE", help="metric parameter override")
    ap.add_argument("--speed", type=float, nargs=3, default=[0.0, 0.0, 0.0],
                    metavar=("VX", "VY", "VZ"),
                    help="observer 3-velocity in the tetrad frame (|v| < 1)")
    ap.add_argument("--redshift", action="store_true")
    ap.add_argument("--old-redshift", action="store_true",
                    help="reference use_old_redshift feature: no blueshift "
                         "energy redistribution")
    ap.add_argument("--dominant-colour", action="store_true",
                    help="per-pixel dominant-wavelength redshift variant")
    ap.add_argument("--spectral-redshift", action="store_true",
                    help="experimental: shift each pixel's CIE dominant "
                         "wavelength along the 1931 horseshoe")
    ap.add_argument("--no-planar", action="store_true",
                    help="trace a spherically symmetric metric in all four "
                         "coordinates instead of in its rays' planes")
    ap.add_argument("--adaptive", action="store_true",
                    help="adaptive sampling: quarter-density trace + "
                         "error-driven refinement (reference default)")
    ap.add_argument("--max-steps", type=int, default=16384)
    ap.add_argument("--out", default="out.png")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda runs the ray march as the CUDA kernel; cpu "
                         "runs its eager reference")
    args = ap.parse_args(argv)

    import torch

    from . import metrics
    from .camera import Camera
    from .ops.integrate import Features, TraceOptions
    from .render import background as bg
    from .render import colour
    from .render.pipeline import (RefineBudgetController, RenderSettings,
                                  check_device, render_frame)

    if args.list:
        print("\n".join(metrics.list_metrics()))
        return 0
    device = check_device(args.device)
    name = args.bench or args.metric
    metric = metrics.get_metric(name)
    params = metric.params(**{k: float(v) for k, v in
                              (kv.split("=", 1) for kv in args.param)})

    cam = Camera.default(device=device)._replace(
        polar_position=torch.tensor(args.camera, dtype=torch.float32,
                                    device=device),
        basis_speed=torch.tensor(args.speed, dtype=torch.float32,
                                 device=device))
    d2r = math.pi / 180.0
    if args.pitch or args.yaw or args.roll:
        cam = cam.rotate(yaw=args.yaw * d2r, pitch=args.pitch * d2r,
                         roll=args.roll * d2r)
    backgrounds = bg.checker_background(device=device)
    settings = RenderSettings(
        width=args.width, height=args.height, fov_degrees=args.fov,
        anisotropy=args.anisotropy, adaptive_sampling=args.adaptive,
        redshift=args.redshift, old_redshift=args.old_redshift,
        dominant_colour=args.dominant_colour,
        spectral_redshift=args.spectral_redshift,
        planar=not args.no_planar,
        trace=TraceOptions(max_steps=args.max_steps),
    )
    features = Features.for_metric(metric)

    # Demand-sized refinement and prepass reuse across the bench frames.
    controller = RefineBudgetController() if args.bench else None

    def frame():
        img = render_frame(metric, cam, params, backgrounds, settings,
                           features, controller=controller, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return img

    if args.bench:
        # Warm-up: kernel build and first launch; the adaptive frame's
        # budget controller settles within four frames.
        for _ in range(4 if settings.adaptive_sampling else 1):
            frame()
        for _ in range(args.frames):
            t0 = time.perf_counter()
            frame()
            ms = (time.perf_counter() - t0) * 1e3
            print(f"Frametime Elapsed: {ms:f}")
        return 0

    t0 = time.perf_counter()
    img = frame()
    dt = time.perf_counter() - t0
    srgb = colour.lin_to_srgb(img).cpu().numpy()
    write_png(args.out, (np.clip(srgb, 0, 1) * 255).astype(np.uint8))
    print(f"wrote {args.out} ({args.width}x{args.height}, {name}, "
          f"{device.type}) in {dt:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
