"""Command-line renderer for the PyTorch / CUDA port.

Usage:
    python -m geodesic_raytracing_tpu_torch.cli --metric kerr_boyer \
        --width 1920 --height 1080 --pitch -90 --device cuda --out kerr.png
    python -m geodesic_raytracing_tpu_torch.cli --bench kerr_boyer --frames 5

``--bench`` keeps the reference CLI's protocol line
``Frametime Elapsed: <ms>`` (one warm-up frame first).  Only the dense
(non-adaptive) frame is ported so far.
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
    from .render.pipeline import RenderSettings, check_device, render_frame

    device = check_device(args.device)
    name = args.bench or args.metric
    metric = metrics.get_metric(name)
    params = metric.params()

    cam = Camera.default(device)._replace(
        polar_position=torch.tensor(args.camera, dtype=torch.float32,
                                    device=device))
    d2r = math.pi / 180.0
    if args.pitch or args.yaw or args.roll:
        cam = cam.rotate(yaw=args.yaw * d2r, pitch=args.pitch * d2r,
                         roll=args.roll * d2r)
    backgrounds = bg.checker_background(device=device)
    settings = RenderSettings(
        width=args.width, height=args.height, fov_degrees=args.fov,
        anisotropy=args.anisotropy, adaptive_sampling=False,
        trace=TraceOptions(max_steps=args.max_steps),
    )
    features = Features.for_metric(metric)

    def frame():
        img = render_frame(metric, cam, params, backgrounds, settings,
                           features, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return img

    if args.bench:
        frame()  # warm-up: kernel build and first launch
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
