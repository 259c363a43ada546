"""Command-line renderer for the PyTorch / CUDA port.

Usage:
    python -m geodesic_raytracing_tpu_torch.cli --metric kerr_boyer \
        --width 1920 --height 1080 --pitch -90 --device cuda --out kerr.png
    python -m geodesic_raytracing_tpu_torch.cli --metric schwarzschild \
        --adaptive --redshift --pitch -90 --device cuda --out schw.png
    python -m geodesic_raytracing_tpu_torch.cli --metric kerr_boyer \
        --speed -0.3 0 0 --geodesic-camera 2 --adaptive --width 1920 \
        --height 1080 --pitch -90 --device cuda --out infall.png
    python -m geodesic_raytracing_tpu_torch.cli --metric schwarzschild \
        --width 1920 --height 1080 --pitch -90 --cube -6 0 -3 0 \
        --cube -6 0 3 0 --tri-intersector compact --device cuda --out tri.png
    python -m geodesic_raytracing_tpu_torch.cli --bench kerr_boyer --frames 5
    python -m geodesic_raytracing_tpu_torch.cli --list
    python -m geodesic_raytracing_tpu_torch.cli --content examples/pack_torch \
        --metric reissner_nordstrom --pitch -90 --device cuda --out rn.png
    python -m geodesic_raytracing_tpu_torch.cli --background sky.png \
        --trace-stats --supersample 2 --profile prof/ --device cuda

    python -m geodesic_raytracing_tpu_torch.cli --adaptive --device cpu \
        --width 64 --height 64 --pitch -90 --max-steps 2048 --out small.png

``--adaptive`` renders the adaptive frame (prepass, quarter grid, top-k
refinement, traced-only shading) instead of the dense one.  ``--bench`` keeps
the reference CLI's protocol line ``Frametime Elapsed: <ms>``, after one
warm-up frame, or four when adaptive (the refinement budget settles first).
After each it prints the frame's line of the port's recorder
(``utils.profiling``): ``Stages (host / device ms): <span> <host> /
<device>, ...`` by span name in the order they opened (``frame``,
``ray_init``, ``trace``, ``render_data``, ``shade`` dense; ``frame``,
``camera``, ``prepass``, ``trace``, ``quarter_setup``, ``refine_setup``,
``controller_wait``, ``finish`` adaptive; ``trace`` sums the frame's
marches; ``-`` where no device time was taken), then ``; launches <n>``
(ray-march kernel launches, 0 off the card), ``; render_data_kernel <k> of
<n>`` (the frame's render data calls the render-data kernel served, 0 off
the card, of all), ``; camera_kernel <k> of <n>`` (its observer tetrads the
observer kernel served, likewise), ``; launch_state_kernel <k> of <n>`` (its
ray launch states the launch-state kernel served, likewise) and, adaptive,
``; refine_share <k/nq>`` and ``; refine_demand <share> (frame <id>)``: the
newest demand the budget controller has read, which belongs to a frame
``latency`` frames back.
A spherically symmetric metric is traced in planar mode (every ray rotated
into the equator, theta pinned) unless ``--no-planar`` is given.

``--cube`` and ``--obj`` place objects for GR triangle rendering: each
object's worldline is traced and transported (1,024 steps, 48 segments), the
camera rays are marched with their paths recorded (64 slots of 8 trial
iterations: on the card 64 launches of the ray-march kernel, 4-D), the
``--tri-intersector`` intersects them (``render_triangles``), and the hit
colour is composited over the frame.  The split (worldlines, ray init,
recorded march + intersect, composite) and the hit and dropped counts are
printed.

``--content DIR`` loads a content pack of torch metrics (``content.py``);
on the card each pack metric's kernel struct is emitted from its function
and built at first use.  ``--background`` / ``--background2`` take PNG skies
(``render.background.load_background``).  ``--trace-method``: ``auto`` is
the kernel on ``--device cuda`` and the plain march on ``--device cpu``,
``cuda`` the kernel (on the CPU it raises), ``while`` the plain march on
either device, ``scan`` the differentiable march.  ``--trace-stats`` prints
the ray statistics of a dedicated trace, ``--profile DIR`` writes a
``torch.profiler`` trace of the frame, ``--supersample K`` renders K times
the resolution and box-filters it down.
"""

from __future__ import annotations

import argparse
import math
import struct
import sys
import time
import zlib
from typing import NamedTuple

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
    """One PNG scanline with its filter undone (``prev``: the row above).
    None and Up are vectorised, Sub a running sum per channel; Average and
    Paeth take one pixel (``bpp`` bytes) at a time."""
    row = row.astype(np.int32)
    if filt == 0:
        return row
    if filt == 2:
        return (row + prev) & 0xFF
    if filt == 1:
        return np.cumsum(row.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
    if filt not in (3, 4):
        raise ValueError(f"unknown PNG filter {filt}")
    out = np.zeros_like(row)
    zero = np.zeros(bpp, np.int32)
    for i in range(0, len(row), bpp):
        a = out[i - bpp:i] if i else zero
        b = prev[i:i + bpp]
        if filt == 3:
            pred = (a + b) // 2
        else:
            c = prev[i - bpp:i] if i else zero
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            pred = np.where((pa <= pb) & (pa <= pc), a,
                            np.where(pb <= pc, b, c))
        out[i:i + bpp] = (row[i:i + bpp] + pred) & 0xFF
    return out


# PNG colour types read: grey, RGB, grey + alpha, RGBA (bytes per pixel).
_PNG_BPP = {0: 1, 2: 3, 4: 2, 6: 4}


def read_png(path) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit, non-interlaced grey, grey + alpha, RGB
    or RGBA PNG with any of the five filter types (standard library only;
    alpha is dropped and grey widened to RGB)."""
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
    if depth != 8 or ctype not in _PNG_BPP or interlace:
        raise ValueError(f"{path}: only 8-bit non-interlaced grey, grey + "
                         "alpha, RGB or RGBA PNGs are read")
    bpp = _PNG_BPP[ctype]
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        h, 1 + bpp * w)
    out = np.zeros((h, bpp * w), np.int32)
    prev = np.zeros(bpp * w, np.int32)
    for y in range(h):
        prev = out[y] = _unfilter(int(raw[y, 0]), raw[y, 1:], prev, bpp)
    px = out.astype(np.uint8).reshape(h, w, bpp)
    if ctype in (0, 4):
        return np.repeat(px[..., :1], 3, axis=-1)
    return px[..., :3]


def geodesic_camera(metric, cam, params, tau: float, n_steps: int = 4096):
    """The reference's "Snapshot Camera Geodesic" (main.cpp:2675-2759):
    record the observer's worldline from the camera state (the static frame
    boosted by the camera's 3-velocity), transport that tetrad along it and
    attach the camera at proper time ``tau``."""
    from .ops import tetrad as tet
    from .ops.integrate import Features
    from .physics import (interpolate_camera, parallel_transport_tetrads,
                          record_geodesic)
    from .render.pipeline import camera_to_generic

    x0 = camera_to_generic(metric, cam, params)
    gab = metric.fn(x0, params)
    es0, _ = tet.frame_basis(gab)
    es0 = tet.boost_tetrad(es0, cam.basis_speed, gab)
    path = record_geodesic(metric, x0, es0[0], params,
                           Features.for_metric(metric), n_steps=n_steps)
    tets = parallel_transport_tetrads(metric, path, es0, params)
    pos, _, frame = interpolate_camera(path, tets, tau)
    return cam.on_geodesic(pos, frame)


def triangle_objects(cubes, obj_specs):
    """The objects of ``--cube T X Y Z`` and ``--obj path,t,x,y,z[,scale]``
    arguments, cubes first."""
    from .triangles import make_cube, object_from_obj

    objects = [make_cube(c) for c in cubes]
    for spec in obj_specs:
        parts = spec.split(",")
        rest = [float(v) for v in parts[1:]]
        scale = rest[4] if len(rest) > 4 else 1.0
        objects.append(object_from_obj(parts[0], rest[:4], scale=scale))
    return objects


class TriangleLayer(NamedTuple):
    """What :func:`triangle_layer` made: the hit mask (H, W) and colour
    (H, W, 3), the intersector's counters (empty for dense), the
    milliseconds of each stage, the objects' worldlines and the scene."""

    hit: object
    colour: object
    stats: dict
    ms: dict
    geos: list
    scene: object


def triangle_layer(metric, cam, params, settings, features, objects,
                   intersector: str, max_steps: int, *, device):
    """GR triangle rendering of ``objects`` seen by ``cam`` (the reference
    CLI's triangle mode): worldlines of 1,024 steps subsampled to 48
    segments, then ``render_triangles`` on dense 4-D camera rays, recorded
    in 64 slots of 8 trial iterations, with ``intersector`` (dense, binned,
    grouped or compact; the budget 64 of ``render_triangles``; compact's
    pair and item budgets sized to the frame's survivors, so that it drops
    nothing).  Returns a :class:`TriangleLayer`."""
    import dataclasses

    import torch

    from .ops import integrate
    from .render.pipeline import init_camera_rays
    from .triangles import TriangleScene, precompute_objects, render_triangles

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    ms = {}
    t0 = clock()
    geos = precompute_objects(metric, objects, params, features,
                              n_steps=1024, segments=48, device=device)
    scene = TriangleScene.build(objects)
    t1 = clock()
    ms["worldlines"] = (t1 - t0) * 1e3
    tsettings = dataclasses.replace(settings, adaptive_sampling=False,
                                    planar=False)
    state, _, _ = init_camera_rays(metric, cam, params, tsettings, features,
                                   device=device)
    t2 = clock()
    ms["ray init"] = (t2 - t1) * 1e3
    budgets = ({"pair_budget": None, "tri_budget": None}
               if intersector == "compact" else {})
    _, hit, colour, stats = render_triangles(
        metric, state, params, scene, geos, features,
        integrate.TraceOptions(max_steps=min(max_steps, 4096)),
        n_slots=64, steps_per_slot=8, binned=intersector == "binned",
        grouped=intersector == "grouped", compact=intersector == "compact",
        image_width=settings.width, with_stats=True, **budgets)
    ms["recorded march + intersect"] = (clock() - t2) * 1e3
    H, W = settings.height, settings.width
    return TriangleLayer(hit.reshape(H, W), colour.reshape(H, W, 3), stats,
                         ms, geos, scene)


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
    ap.add_argument("--geodesic-camera", type=float, default=None,
                    metavar="TAU",
                    help="ride the camera's geodesic: record the observer's "
                         "worldline from the camera state (4096 steps), "
                         "transport its tetrad and render from proper time "
                         "TAU")
    ap.add_argument("--max-steps", type=int, default=16384)
    ap.add_argument("--cube", type=float, nargs=4, action="append",
                    default=[], metavar=("T", "X", "Y", "Z"),
                    help="place a unit cube object at this spacetime point "
                         "(GR triangle rendering).  T must lie in the "
                         "camera's past (e.g. -6): camera rays integrate "
                         "backwards in time and the object's worldline is "
                         "traced forward from T")
    ap.add_argument("--obj", action="append", default=[], metavar="SPEC",
                    help="place an .obj mesh: path,t,x,y,z[,scale]")
    ap.add_argument("--tri-intersector", default="dense",
                    choices=("dense", "binned", "grouped", "compact"),
                    help="triangle intersector: dense (exact, small "
                         "scenes), binned (reference-style chunk bins), "
                         "grouped (two-level object/patch), compact "
                         "(worklist-compacted: dense orbital scenes)")
    ap.add_argument("--content", action="append", default=[],
                    metavar="DIR",
                    help="load a content pack of torch metrics (e.g. "
                         "examples/pack_torch); on --device cuda each "
                         "pack metric's kernel struct is emitted and "
                         "built at first use")
    ap.add_argument("--background", default=None,
                    help="equirect sky image (PNG)")
    ap.add_argument("--background2", default=None,
                    help="far-side sky image (PNG)")
    ap.add_argument("--supersample", type=int, default=1, metavar="K",
                    help="render at K x resolution and box-downsample "
                         "(graphics_settings supersampling, "
                         "main.cpp:1760-1792)")
    ap.add_argument("--trace-method", default="auto",
                    choices=("auto", "while", "cuda", "scan"),
                    help="ray march driver: auto = the CUDA kernel on "
                         "--device cuda and the plain march on --device "
                         "cpu; cuda = the kernel (raises on the CPU); while "
                         "= the plain march on either device; scan = the "
                         "differentiable fixed-length march")
    ap.add_argument("--trace-stats", action="store_true",
                    help="print ray statistics (status counts, step "
                         "percentiles) of a dedicated full-resolution trace")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler trace of the frame "
                         "(DIR/trace.json, Chrome format, and "
                         "DIR/summary.txt)")
    ap.add_argument("--dump-hlo", metavar="FILE", default=None,
                    help="JAX package only: the port lowers no HLO program "
                         "(its kernel is CUDA C++ built by nvcc), so this "
                         "flag has no meaning here and raises")
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
                                  check_device, render_frame, trace_frame)
    from .utils import profiling

    if args.dump_hlo:
        ap.error("--dump-hlo has no meaning in the PyTorch port (no HLO is "
                 "lowered); it belongs to the JAX package's CLI")
    for pack_dir in args.content:
        from .content import load_pack

        pack = load_pack(pack_dir)
        print(f"loaded pack {pack_dir}: "
              f"{', '.join(sorted(pack.metrics)) or 'none'}")
        for stem, err in pack.broken.items():
            print(f"  (broken) {stem}: {err}")
    if args.list:
        print("\n".join(metrics.list_metrics()))
        return 0
    device = check_device(args.device)
    method = {"auto": "while", "cuda": "while", "while": "plain",
              "scan": "scan"}[args.trace_method]
    if args.trace_method == "cuda" and device.type != "cuda":
        raise SystemExit("--trace-method cuda runs the CUDA kernel: it needs "
                         "--device cuda")
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
    if args.geodesic_camera is not None:
        cam = geodesic_camera(metric, cam, params, args.geodesic_camera)
        print(f"geodesic camera: tau={args.geodesic_camera:g} pos="
              f"{np.round(cam.frame_override[0].cpu().numpy(), 3).tolist()}")
    if args.background:
        backgrounds = bg.load_background(args.background, args.background2,
                                         device=device)
    else:
        backgrounds = bg.checker_background(device=device)
    ss = max(1, args.supersample)
    settings = RenderSettings(
        width=args.width * ss, height=args.height * ss, fov_degrees=args.fov,
        anisotropy=args.anisotropy, adaptive_sampling=args.adaptive,
        redshift=args.redshift, old_redshift=args.old_redshift,
        dominant_colour=args.dominant_colour,
        spectral_redshift=args.spectral_redshift,
        planar=not args.no_planar,
        trace=TraceOptions(max_steps=args.max_steps, method=method),
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
            frames = profiling.recent_frames()
            read = [f for f in frames if "refine_demand" in f.counters]
            print(profiling.describe(frames[-1]) + (
                f"; refine_demand {read[-1].counters['refine_demand']:g} "
                f"(frame {read[-1].id})" if read else ""))
        return 0

    t0 = time.perf_counter()
    if args.profile:
        with profiling.torch_profile(args.profile, device):
            img = frame()
        print(f"wrote a torch.profiler trace to {args.profile}")
    else:
        img = frame()
    if args.trace_stats:
        fin, _ = trace_frame(metric, cam, params, settings, features,
                             device=device)
        print(profiling.trace_stats(fin))
    if args.cube or args.obj:
        objects = triangle_objects(args.cube, args.obj)
        layer = triangle_layer(metric, cam, params, settings, features,
                               objects, args.tri_intersector, args.max_steps,
                               device=device)
        hit, tri_col, stats, ms = layer[:4]
        t_c = time.perf_counter()
        img = torch.where(hit[..., None], tri_col, img)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms["composite"] = (time.perf_counter() - t_c) * 1e3
        drops = float(stats["dropped"]) if "dropped" in stats else 0.0
        print(f"triangles: {len(objects)} objects, "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in ms.items())
              + f"; intersector {args.tri_intersector}, hits "
              f"{int(hit.sum())}, dropped {drops:g}")
    if ss > 1:  # box-downsample the supersampled frame
        img = img.reshape(args.height, ss, args.width, ss, 3).mean((1, 3))
    dt = time.perf_counter() - t0
    srgb = colour.lin_to_srgb(img).cpu().numpy()
    write_png(args.out, (np.clip(srgb, 0, 1) * 255).astype(np.uint8))
    print(f"wrote {args.out} ({args.width}x{args.height}, {name}, "
          f"{device.type}) in {dt:.2f}s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
