"""Smoke test of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py [--profile]

Builds the ray-march kernel from ``geodesic_raytracing_tpu_torch/csrc``,
checks it against its plain eager-torch twin on the card, drives the port's
main path (the dense 1920x1080 ``kerr_boyer`` frame through ``render_frame``,
with a seeded sample of that launch's own rays re-marched by the plain twin),
times it, and runs the CLI on the card.  ``--profile`` adds a
``torch.profiler`` trace of one steady frame (kernel counts, device busy
time, idle share).  Every failed check raises, so the script exits non-zero;
it also refuses to run (exit 2, no result) without a CUDA GPU.

Output, one line per phase, then the kernel table as one JSON line, the
card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import struct
import subprocess
import sys
import time
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# Ray-set tolerances on the card: transcendentals differ in the last ulp
# between the kernel and torch's CUDA ops, and photon-ring rays amplify a
# 1e-7 seed by about one bit per step, so a few fates and step counts may
# differ; positions are compared where the step counts agree.
SET_A_MIN_STEPS_EQ = 62  # of 64, status equal on all
SET_B_MIN_STATUS_EQ = 0.995
SET_B_MIN_STEPS_EQ = 0.98
POS_TOL = 1e-4  # rtol and atol
# The golden gate of tests/test_parity_images.py on sRGB uint8 images.
GATE_RMSE = 4.0
GATE_BAD_FRAC = 0.01
# Estimated shadow: ~22 deg angular radius of a 90 deg fov ~ 23% of pixels.
SHADOW_RANGE = (0.10, 0.40)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def make_rays(n, r0=7.0):
    """The ray set of tests/test_integrator.py::make_rays."""
    pos = np.tile([0.0, r0, np.pi / 2, 0.0], (n, 1)).astype(np.float32)
    angles = np.linspace(0.05, 0.8, n)
    vel = np.stack([np.ones(n), -np.cos(angles), np.zeros(n),
                    np.sin(angles) / r0], axis=-1).astype(np.float32)
    return pos, vel


def compare_states(k, p):
    """(status equal, steps equal, max |dpos| over escaped rays with equal
    steps, positions within POS_TOL there) of kernel vs plain states."""
    import torch

    st_eq = k.status == p.status
    sp_eq = k.steps == p.steps
    ok = (p.status == 1) & sp_eq
    kp, pp = k.position[ok], p.position[ok]
    err = float((kp - pp).abs().max()) if kp.numel() else 0.0
    close = bool(torch.allclose(kp, pp, rtol=POS_TOL, atol=POS_TOL))
    return int(st_eq.sum()), int(sp_eq.sum()), err, close


def golden_gate(a, b):
    """RMSE and fraction of pixels off by > 32 of two sRGB uint8 images."""
    d = np.abs(a.astype(int) - b.astype(int))
    return float(np.sqrt((d.astype(float) ** 2).mean())), float(
        (d > 32).mean())


def to_srgb8(img):
    from geodesic_raytracing_tpu_torch.render import colour

    s = colour.lin_to_srgb(img).cpu().numpy()
    return (np.clip(s, 0, 1) * 255).astype(np.uint8)


def read_png_rgb(path: Path) -> np.ndarray:
    """(H, W, 3) uint8 of an 8-bit RGB PNG with filter 0 on every row (what
    the CLI's ``write_png`` writes)."""
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    at, idat, w, h = 8, b"", 0, 0
    while at < len(data):
        (n,) = struct.unpack(">I", data[at:at + 4])
        tag, body = data[at + 4:at + 8], data[at + 8:at + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        at += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all(), "unexpected PNG row filter"
    return raw[:, 1:].reshape(h, w, 3)


def profile_frame(frame, frame_ms: float) -> None:
    """``torch.profiler`` over one steady frame: device kernels, their
    merged busy time, and the idle share against the profiled wall and
    against the unprofiled frame time ``frame_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    frame()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        frame()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        print("[6 profile] the profiler saw no device events: not measured")
        return
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy_us, (lo, hi) = 0.0, spans[0]
    for a, b in spans[1:]:
        if a > hi:
            busy_us, lo = busy_us + (hi - lo), a
        hi = max(hi, b)
    busy_ms = (busy_us + (hi - lo)) / 1e3
    march = [e for e in dev if "raymarch_kernel" in e.name]
    march_ms = sum(e.time_range.elapsed_us() for e in march) / 1e3
    kernels = [e for e in dev if not e.name.startswith(("Memcpy", "Memset"))]
    print(f"[6 profile] one steady frame: {len(kernels)} device kernels "
          f"({len(dev) - len(kernels)} memcpy/memset), raymarch_kernel "
          f"{len(march)} launch(es) {march_ms:.3f} ms; device busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms profiled wall (idle share "
          f"{1 - busy_ms / wall_ms:.4f}); against the unprofiled "
          f"{frame_ms:.3f} ms frame, idle share {1 - busy_ms / frame_ms:.4f}")
    ops = [a for a in prof.key_averages() if a.device_type == DeviceType.CPU
           and a.key.startswith("aten::")]
    top = sorted(ops, key=lambda a: -a.count)[:6]
    print("[6 profile] most-called host ops: " + ", ".join(
        f"{a.key} {a.count}" for a in top))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the port on "
                                 "one GPU.")
    ap.add_argument("--profile", action="store_true",
                    help="trace one steady 1080p frame with torch.profiler")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2

    from geodesic_raytracing_tpu_torch import cli
    from geodesic_raytracing_tpu_torch.bench_config import flagship_config
    from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
    from geodesic_raytracing_tpu_torch.render import background as bg
    from geodesic_raytracing_tpu_torch.render import pipeline as pl

    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    name = torch.cuda.get_device_name(0)

    # -- 1. device and build ------------------------------------------------
    t0 = time.perf_counter()
    raymarch.get_lib()
    build_s = time.perf_counter() - t0
    print(f"[1 device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name} | nvcc build "
          f"{raymarch.BUILD_INFO.get('seconds')} s (load {build_s:.2f} s)")
    for line in raymarch.BUILD_INFO.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[1 device] ptxas: {line.strip()}")

    metric, params, camera, settings, feats = flagship_config(device=dev)
    settings = dataclasses.replace(settings, adaptive_sampling=False)
    sky = bg.checker_background(device=dev)

    def kernel_and_plain(state, max_steps):
        opts = integrate.TraceOptions(max_steps=max_steps)
        k = raymarch.trace_rays_cuda(metric, state, params, feats, opts)
        p = integrate.trace_rays_reference(metric, state, params, feats, opts)
        torch.cuda.synchronize()
        return k, p

    # -- 2a. kernel vs plain: the make_rays(64) set --------------------------
    pos, vel = make_rays(64)
    sa = integrate.init_ray_state(metric, torch.from_numpy(pos).to(dev),
                                  torch.from_numpy(vel).to(dev), params, feats)
    sa.status[::7] = integrate.DEAD
    k, p = kernel_and_plain(sa, 4096)
    st, sp, err_a, close = compare_states(k, p)
    print(f"[2a rays] 64 rays, max_steps 4096: status equal {st}/64, "
          f"steps equal {sp}/64, max |dpos| {err_a:.3g}")
    assert st == 64 and sp >= SET_A_MIN_STEPS_EQ and close, (st, sp, err_a)

    # -- 2b. kernel vs plain: 4096 flagship-camera pixels --------------------
    rng = np.random.default_rng(0)
    cx = rng.integers(0, settings.width, 4096).astype(np.float32)
    cy = rng.integers(0, settings.height, 4096).astype(np.float32)
    position, es = pl.camera_frame(metric, camera, params)
    sb, _ = pl.rays_for_pixels(metric, camera, position, es, params,
                               settings, feats, torch.from_numpy(cx).to(dev),
                               torch.from_numpy(cy).to(dev))
    k, p = kernel_and_plain(sb, 16384)
    st, sp, err_b, close = compare_states(k, p)
    print(f"[2b rays] 4096 flagship pixels, max_steps 16384: status equal "
          f"{st / 4096:.4f}, steps equal {sp / 4096:.4f}, max |dpos| "
          f"{err_b:.3g}")
    assert st >= SET_B_MIN_STATUS_EQ * 4096, st
    assert sp >= SET_B_MIN_STEPS_EQ * 4096, sp
    assert close, err_b

    # -- 3. the main path at 1920x1080 ---------------------------------------
    # The frame's own march is recorded (its input and the kernel's output)
    # so that a sample of its rays can be re-marched by the plain twin.
    launch = []
    trace_rays = integrate.trace_rays

    def recording_trace_rays(metric_, state, *a, **kw):
        out = trace_rays(metric_, state, *a, **kw)
        launch.append((state, out))
        return out

    integrate.trace_rays = recording_trace_rays
    try:
        raymarch.LAUNCHES = 0
        img = pl.render_frame(metric, camera, params, sky, settings, feats,
                              device=dev)
        torch.cuda.synchronize()
        launches = raymarch.LAUNCHES
    finally:
        integrate.trace_rays = trace_rays
    finite = bool(torch.isfinite(img).all())
    black = float((img == 0).all(dim=-1).float().mean())
    print(f"[3 frame] {settings.width}x{settings.height} kerr_boyer: "
          f"shape {tuple(img.shape)}, finite {finite}, kernel launches "
          f"{launches}, shadow fraction {black:.4f}")
    assert launches == 1, launches
    assert finite and tuple(img.shape) == (settings.height, settings.width, 3)
    assert SHADOW_RANGE[0] <= black <= SHADOW_RANGE[1], black
    (s_in, s_out), = launch
    n_rays = settings.width * settings.height
    assert s_in.position.shape == (n_rays, 4), s_in.position.shape
    rows = torch.from_numpy(np.sort(np.random.default_rng(1).choice(
        n_rays, 4096, replace=False))).to(dev)
    p = integrate.trace_rays_reference(
        metric, integrate.RayState(*(t[rows] for t in s_in)), params, feats,
        settings.trace)
    k = integrate.RayState(*(t[rows] for t in s_out))
    st, sp, err_f, close = compare_states(k, p)
    print(f"[3 frame] 4096 of the frame's {n_rays} kernel rays vs plain: "
          f"status equal {st / 4096:.4f}, steps equal {sp / 4096:.4f}, "
          f"max |dpos| {err_f:.3g}")
    assert st >= SET_B_MIN_STATUS_EQ * 4096, st
    assert sp >= SET_B_MIN_STEPS_EQ * 4096, sp
    assert close, err_f
    del launch, s_in, s_out

    # -- 4. kernel frame vs plain frame at 480x270 ---------------------------
    small = dataclasses.replace(settings, width=480, height=270)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    state, ku = pl.init_camera_rays(metric, camera, params, small, feats,
                                    device=dev)
    torch.cuda.synchronize()
    ev[0].record()
    fk = raymarch.trace_rays_cuda(metric, state, params, feats, small.trace)
    ev[1].record()
    fp = integrate.trace_rays_reference(metric, state, params, feats,
                                        small.trace)
    ev[2].record()
    torch.cuda.synchronize()
    trace_ms = ev[0].elapsed_time(ev[1])
    plain_ms = ev[1].elapsed_time(ev[2])
    imgs = [pl.shade(pl.compute_render_data(metric, f, ku, params, feats),
                     sky, small) for f in (fk, fp)]
    rmse, bad = golden_gate(to_srgb8(imgs[0]), to_srgb8(imgs[1]))
    print(f"[4 gate] 480x270 kernel vs plain frame: RMSE {rmse:.4f}, "
          f"pixels off by >32 {bad:.5f}; trace kernel {trace_ms:.3f} ms, "
          f"plain {plain_ms:.1f} ms")
    assert rmse < GATE_RMSE and bad < GATE_BAD_FRAC, (rmse, bad)

    # -- 5. timing the 1080p frame -------------------------------------------
    def timed_frame():
        e = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        e[0].record()
        s, ku_ = pl.init_camera_rays(metric, camera, params, settings, feats,
                                     device=dev)
        e[1].record()
        fin = integrate.trace_rays(metric, s, params, feats, settings.trace)
        e[2].record()
        rd = pl.compute_render_data(metric, fin, ku_, params, feats)
        e[3].record()
        pl.shade(rd, sky, settings)
        e[4].record()
        torch.cuda.synchronize()
        return [e[i].elapsed_time(e[i + 1]) for i in range(4)]

    timed_frame()  # warm
    splits = [timed_frame() for _ in range(3)]
    totals = [sum(s) for s in splits]
    for i, (s, t) in enumerate(zip(splits, totals)):
        print(f"[5 time] frame {i}: {t:.3f} ms ({n_rays / t / 1e3:.4f} "
              f"Mrays/s) = ray init {s[0]:.3f} + trace kernel {s[1]:.3f} + "
              f"render data {s[2]:.3f} + shade {s[3]:.3f} ms")
    if args.profile:
        profile_frame(timed_frame, sum(totals) / len(totals))

    # -- 7. the CLI on the card: bench protocol, then one 1080p PNG ----------
    cli_args = ["--width", "1920", "--height", "1080", "--pitch", "-90",
                "--device", "cuda"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--bench", "kerr_boyer", "--frames", "2", *cli_args])
    bench = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("Frametime Elapsed: ")]
    assert rc == 0 and len(bench) == 2, buf.getvalue()
    png = ROOT / "build" / "chip_smoke" / "kerr_cli.png"
    png.parent.mkdir(parents=True, exist_ok=True)
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--metric", "kerr_boyer", *cli_args, "--out",
                       str(png)])
    cli_img = read_png_rgb(png)
    cli_black = float((cli_img == 0).all(axis=-1).mean())
    print(f"[7 cli] --bench kerr_boyer 1920x1080 on cuda: "
          f"{'; '.join(bench)}; PNG {cli_img.shape}, shadow fraction "
          f"{cli_black:.4f}")
    assert rc == 0 and cli_img.shape == (1080, 1920, 3), cli_img.shape
    assert SHADOW_RANGE[0] <= cli_black <= SHADOW_RANGE[1], cli_black

    table = {"kernels": [{
        "name": "raymarch_kerr_boyer",
        "route": "cuda",
        "source": "geodesic_raytracing_tpu_torch/csrc/raymarch.cu",
        "replaces": "geodesic_raytracing_tpu/ops/pallas/raymarch.py:488",
        "launches": launches,
        "max_abs_err": max(err_a, err_b, err_f),
        "ms": trace_ms,
        "plain_ms": plain_ms,
    }]}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
