"""Smoke test of the PyTorch / CUDA port on one GPU.

    python3 chip_smoke.py [--profile] [--kernel-flags "..."]
    python3 chip_smoke.py --sweep ["flags; flags; ..."]

Builds the ray-march kernel from ``geodesic_raytracing_tpu_torch/csrc``,
checks it against its plain eager-torch twin on the card, drives the port's
main paths through ``render_frame`` at 1920x1080 ``kerr_boyer``: the dense
frame (one launch) and the adaptive flagship frame of ``flagship_config`` as
it comes (prepass, quarter grid and refinement: three launches in a first
frame, two in a steady one), each launch's own rays marched once more by the
plain twin.  It counts each launch's work (steps, trial iterations, idle
lanes), holds the kernel's time against its bound, holds the adaptive frame
against the dense one and the kernel frames against the plain frames at
480x270, checks that a steady adaptive frame never waits for the device,
times both frames stage by stage, and runs the CLI on the card.
``--profile`` adds a ``torch.profiler`` trace of one steady frame of each
kind (kernel counts, device busy time, idle share).  ``--kernel-flags`` appends
nvcc flags to the kernel's build, to run every check on a variant of it.
Every failed check raises, so the script exits non-zero; it also refuses to
run (exit 2, no result) without a CUDA GPU.

``--sweep`` runs no check of the port: it builds the kernel once for each set
of nvcc flags (default ``SWEEP``: the steps of the kernel's design), marches
the 1080p and the 480x270 frame's rays with each in turns, and prints each
variant's registers, times, idle lanes and its agreement with the first.

Output, one line per phase, then the kernel table as one JSON line, the
card's ``nvidia-smi`` name and power limit, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import io
import json
import os
import shlex
import statistics
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

# The kernel's bound.  Peaks of one H100 SXM (NVIDIA's data sheet): float32
# outside the tensor cores, counting a fused multiply-add as two; HBM3.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
# Bytes per ray, read once and written once: 3 float4 rows, next_ds, rdl,
# status, steps (the launch |v^t| is read only).
RAY_BYTES_RW = 3 * 16 + 4 * 4
RAY_BYTES_RO = 4
# Float32 operations of one trial iteration, counted from csrc/march.cuh with
# the pruned duals of csrc/dual.cuh (an add, a multiply, a compare or select,
# and each of sin, cos, 1/x, sqrt, rsqrt as one; negations, |x| and products
# with a seed's 1 as none): 65 in the metric with its partials, 89 in the
# contraction and the pruned inverse, 111 in the trial step, the probe and
# the step controller.
OPS_PER_TRIAL = 65 + 89 + 111

# The adaptive 1080p frame against the dense one, as the JAX package's own
# test of its adaptive path states it: share of pixels whose largest channel
# difference is above 0.1, and the median of that difference.
ADAPTIVE_MAX_OFF_FRAC = 0.06
ADAPTIVE_MAX_MEDIAN = 0.01
# Above this idle-lane factor of the refine launch a cost sort of its rays is
# worth measuring (phase 13).
SORT_IDLE_FACTOR = 1.10

# --sweep: the kernel's design, step by step.  The first variant is the
# simple kernel (unpruned duals, separate sinf and cosf, 32 rays of a row per
# warp, no bound on registers); each later one is compared with it.
_ROWS = "-DGRT_MIN_BLOCKS=1 -DGRT_ROW_WARPS"
SWEEP = (
    f"{_ROWS} -DGRT_SEPARATE_TRIG -DGRT_FULL_TANGENTS",
    f"{_ROWS} -DGRT_SEPARATE_TRIG",
    _ROWS,
    "-DGRT_MIN_BLOCKS=1",
    "-DGRT_MIN_BLOCKS=3",
    "",
    "-DGRT_THREADS=64 -DGRT_MIN_BLOCKS=16",
    "-DGRT_THREADS=128 -DGRT_MIN_BLOCKS=8",
    "-DGRT_THREADS=512 -DGRT_MIN_BLOCKS=2",
    "-fmad=true",
)


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


def idle_lane_factor(trials, width=None, tile=(8, 4)):
    """32 x (sum over warps of the warp's largest count) / (sum of counts),
    for a kernel that gives warp w the rays 32w .. 32w + 31 of ``trials``
    (N,) in index order; with ``width``, for ``tile`` (wide, high) pixel
    tiles of the row-major image of that width instead."""
    import torch

    t = trials.to(torch.int64)
    if width is not None:
        (tw, th), h = tile, t.numel() // width
        t = t.reshape(h, width)
        t = torch.nn.functional.pad(t, (0, -width % tw, 0, -h % th))
        t = t.reshape(t.shape[0] // th, th, t.shape[1] // tw, tw).permute(
            0, 2, 1, 3)
    t = torch.nn.functional.pad(t.reshape(-1), (0, -t.numel() % 32))
    return float(32 * t.reshape(-1, 32).max(dim=1).values.sum() / t.sum())


def bound_ms(n_rays: int, total_trials: int):
    """(bound, operations bound, bytes bound) in ms of a launch that marches
    ``n_rays`` rays through ``total_trials`` trial iterations."""
    ops = total_trials * OPS_PER_TRIAL / PEAK_FP32_FLOPS * 1e3
    byt = n_rays * (2 * RAY_BYTES_RW + RAY_BYTES_RO) / PEAK_BYTES_PER_S * 1e3
    return max(ops, byt), ops, byt


def launch_work(metric, state, params, feats, opts, width) -> dict:
    """One kernel launch on ``state`` (the pixels of a row-major image of
    ``width``) that counts its work: ``state`` (the output), ``per_ray``
    and ``trials`` (each ray's and all trial iterations), ``mean_steps``,
    ``max_steps`` (committed), and the idle-lane factor (lane turns of the
    march loop, busy or idle, over the trial iterations) of warps of 32 rays
    in index order (``idle_rows``), of 8x4 pixel tiles (``idle_tiles``) and
    of this launch (``idle_factor``: the rows' if the kernel was built with
    GRT_ROW_WARPS)."""
    import torch
    from geodesic_raytracing_tpu_torch.ops import raymarch

    n = state.position.shape[0]
    trials = torch.zeros(n, dtype=torch.int32, device=state.position.device)
    out = raymarch.trace_rays_cuda(metric, state, params, feats, opts,
                                   trials=trials, image_width=width)
    torch.cuda.synchronize()
    rows, tiled = idle_lane_factor(trials), idle_lane_factor(trials, width)
    return {"state": out, "per_ray": trials, "rays": n,
            "active": int((state.status == 0).sum()),
            "trials": int(trials.sum(dtype=torch.int64)),
            "mean_steps": float(out.steps.float().mean()),
            "max_steps": int(out.steps.max()),
            "idle_factor": (rows if "-DGRT_ROW_WARPS" in raymarch.NVCC_FLAGS
                            else tiled),
            "idle_rows": rows, "idle_tiles": tiled}


@contextlib.contextmanager
def swapped_trace(integrate, fn):
    """Inside the block ``integrate.trace_rays`` is ``fn(real, metric, state,
    params, features, opts, image_width)``, ``real`` being the function it
    replaces."""
    real = integrate.trace_rays

    def trace_rays(metric, state, params, features, opts, image_width=None):
        return fn(real, metric, state, params, features, opts, image_width)

    integrate.trace_rays = trace_rays
    try:
        yield
    finally:
        integrate.trace_rays = real


@contextlib.contextmanager
def recorded_launches(integrate):
    """Yields a list that receives ``(input state, output state, image
    width)`` of every ``integrate.trace_rays`` call made inside the block."""
    launches = []

    def record(real, metric, state, params, features, opts, image_width):
        out = real(metric, state, params, features, opts, image_width)
        launches.append((state, out, image_width))
        return out

    with swapped_trace(integrate, record):
        yield launches


def plain_marches(integrate):
    """Inside the block every march is made by the kernel's plain twin."""
    def plain(real, metric, state, params, features, opts, image_width):
        return integrate.trace_rays_reference(metric, state, params, features,
                                              opts)

    return swapped_trace(integrate, plain)


# The adaptive frame's stages, in the order a first frame runs them.
STAGES = ("camera frame", "prepass", "quarter setup", "quarter trace",
          "refine setup", "refine trace", "finish")


@contextlib.contextmanager
def stage_events(pl, integrate):
    """CUDA events around the adaptive frame's stages, as ``render_frame``
    itself runs them.  Yields a function that returns ``{stage: ms}`` of the
    frames rendered inside the block so far and forgets them; ``prepass``
    holds its own ray init and launch."""
    import torch

    spans = []

    def timed(name, fn):
        @functools.wraps(fn)
        def wrapper(*a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            spans.append((name, *ev))
            return out
        return wrapper

    targets = ((pl, "camera_frame", "camera frame"),
               (pl, "_prepass_dead_map", "prepass"),
               (pl, "_quarter_setup", "quarter setup"),
               (pl, "_refine_setup", "refine setup"),
               (pl, "_finish_shade", "finish"),
               (integrate, "trace_rays", "trace"))
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in targets]

    def read():
        torch.cuda.synchronize()
        ms = {}
        # The marches in launch order: the prepass's own (inside the prepass
        # stage) when there are three, then quarter and refine.
        marches = [s for s in spans if s[0] == "trace"]
        for name, span in zip(("quarter trace", "refine trace"),
                              marches[-2:]):
            ms[name] = span[1].elapsed_time(span[2])
        if len(marches) == 3:
            ms["prepass launch"] = marches[0][1].elapsed_time(marches[0][2])
        for name, a, b in spans:
            if name != "trace":
                ms[name] = a.elapsed_time(b)
        spans.clear()
        return ms

    for mod, attr, name in targets:
        setattr(mod, attr, timed(name, getattr(mod, attr)))
    try:
        yield read
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def born_dead_untouched(s_in, outs) -> int:
    """The number of rays of ``s_in`` that are not ACTIVE; raises unless
    every field of theirs is bit for bit the same in each state of
    ``outs``."""
    import torch

    rows = s_in.status != 0
    for out in outs:
        for name, a, b in zip(s_in._fields, s_in, out):
            if not torch.equal(a[rows].view(torch.int32),
                               b[rows].view(torch.int32)):
                raise AssertionError(f"a ray born DEAD changed its {name}")
    return int(rows.sum())


def cost_sorted_launch(metric, s_in, qsteps, sel, params, feats, opts,
                       grid_hw, rounds=5):
    """The refine launch with and without a cost sort of its rays: the key
    is the largest step count among the block's four quarter neighbours
    (``qsteps``, the quarter launch's), quantised to 64 buckets on a log
    scale over its range, descending, the rays born DEAD last; the rays are
    gathered into that order, marched and scattered back.  Returns ``{"ms":
    unsorted launch, "sorted_ms": sort + gather + launch + scatter,
    "sorted_launch_ms": that launch alone, "sorted_idle_factor",
    "identical": same bits as the unsorted launch}``, ms as medians of
    ``rounds`` in turns."""
    import torch
    from geodesic_raytracing_tpu_torch.ops import integrate, packing, raymarch

    def sorted_launch(ev=None, trials=None):
        g = qsteps.reshape(grid_hw)
        cost = torch.maximum(
            torch.maximum(g, torch.roll(g, -1, 1)),
            torch.maximum(torch.roll(g, -1, 0),
                          torch.roll(g, (-1, -1), (0, 1)))).reshape(-1)
        lc = torch.log2(torch.clamp(cost[sel].float(), min=1.0)).repeat(3)
        live = s_in.status == 0
        hi = torch.where(live, lc, -1.0).max()
        lo = torch.where(live, lc, 1e9).min()
        bucket = torch.clamp(torch.floor(
            (hi - lc) * (63 / torch.clamp(hi - lo, min=1e-3))), 0, 63)
        bucket = torch.where(live, bucket.to(torch.int32), 64)
        perm, dest = packing.bucket_sort_perm(bucket)
        packed = integrate.RayState(*(t[perm] for t in s_in))
        if ev is not None:
            ev[0].record()
        out = raymarch.trace_rays_cuda(metric, packed, params, feats, opts,
                                       trials=trials)
        if ev is not None:
            ev[1].record()
        return integrate.RayState(*(t_[dest] for t_ in out))

    def ms_of(fn):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        ev[0].record()
        out = fn(ev[2:])
        ev[1].record()
        torch.cuda.synchronize()
        return out, ev[0].elapsed_time(ev[1]), ev[2].elapsed_time(ev[3])

    def unsorted_launch(ev):
        ev[0].record()
        out = raymarch.trace_rays_cuda(metric, s_in, params, feats, opts)
        ev[1].record()
        return out

    plain, whole, inner = [], [], []
    for _ in range(rounds):
        a, ms, _ = ms_of(unsorted_launch)
        plain.append(ms)
        b, ms, launch_ms = ms_of(sorted_launch)
        whole.append(ms)
        inner.append(launch_ms)
    trials = torch.zeros_like(s_in.status)
    sorted_launch(trials=trials)
    torch.cuda.synchronize()
    return {"ms": statistics.median(plain),
            "sorted_ms": statistics.median(whole),
            "sorted_launch_ms": statistics.median(inner),
            "sorted_idle_factor": idle_lane_factor(trials),
            "identical": same_bits(a, b)}


def sass_stats(lib_path: str) -> dict:
    """Static counts from ``cuobjdump -sass`` of a kernel library:
    ``instructions`` of the kernel, ``fp32`` of them FADD, FMUL or FFMA,
    ``loop`` (instructions from the target of its longest backward branch
    to the branch: the march loop with its slow paths) and ``reductions``
    (IMAD.WIDE.U32, one per inlined copy of the trigonometric range
    reduction's slow path)."""
    import re

    from geodesic_raytracing_tpu_torch.ops import raymarch

    tool = Path(raymarch.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    lines = re.findall(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?);", sass, re.M)
    loops = [(int(at, 16) - int(m.group(1), 16)) // 16 + 1
             for at, text in lines
             if (m := re.search(r"\bBRA\b.*\b0x([0-9a-f]+)", text))
             and int(m.group(1), 16) < int(at, 16)]
    return {"instructions": len(lines), "loop": max(loops, default=0),
            "fp32": sum(bool(re.match(r"(@!?U?P\w+ )?(FADD|FMUL|FFMA)\b", t))
                        for _, t in lines),
            "reductions": sum("IMAD.WIDE.U32" in t for _, t in lines)}


def sweep(variants, metric, params, camera, settings, feats, rounds=5):
    """Build the kernel once per set of nvcc flags in ``variants`` (all at
    once), march the 1080p and the 480x270 frame's rays with each, in turns
    over ``rounds`` rounds, and print one line per variant: registers and
    stack, blocks per SM, static SASS counts (``sass_stats``: instructions,
    march loop, range reductions), median and least kernel time at both
    sizes, the
    idle-lane factor at 1080p, and how its 1080p result agrees with the
    first variant's (fates, steps, largest position difference)."""
    import concurrent.futures

    import torch
    from geodesic_raytracing_tpu_torch.ops import raymarch
    from geodesic_raytracing_tpu_torch.render import pipeline as pl

    dev = torch.device("cuda")
    default_flags = raymarch.NVCC_FLAGS
    flags = [raymarch.with_flags(*shlex.split(v)) for v in variants]
    with concurrent.futures.ThreadPoolExecutor(len(flags)) as pool:
        list(pool.map(raymarch.build, dict.fromkeys(flags)))
    small = dataclasses.replace(settings, width=480, height=270)
    states = [(pl.init_camera_rays(metric, camera, params, s, feats,
                                   device=dev)[0], s.width)
              for s in (settings, small)]
    n = states[0][0].position.shape[0]

    infos, first = [], None
    for f in flags:
        raymarch.NVCC_FLAGS = f
        work = launch_work(metric, states[0][0], params, feats,
                           settings.trace, settings.width)
        out, per_ray = work.pop("state"), work.pop("per_ray")
        if first is None:
            first = out
            by_tile = {f"{w}x{h}": idle_lane_factor(per_ray, settings.width,
                                                    (w, h))
                       for w, h in ((32, 1), (16, 2), (8, 4), (4, 8), (2, 16))}
            print("[sweep] idle-lane factor at 1080p by warp tile: "
                  + ", ".join(f"{k} {v:.4f}" for k, v in by_tile.items()))
        st, sp, err, _ = compare_states(out, first)
        same = same_bits(out, first)
        built = raymarch.BUILD_INFO[f]
        infos.append({**raymarch.ptxas_summary(built["ptxas"]),
                      **sass_stats(built["path"]),
                      **raymarch.kernel_config(), **work, "status_eq": st,
                      "steps_eq": sp, "max_dpos": err, "identical": same})
    times = [([], []) for _ in flags]
    for _ in range(rounds):
        for f, t in zip(flags, times):
            raymarch.NVCC_FLAGS = f
            for (state, width), ms in zip(states, t):
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
                ev[0].record()
                raymarch.trace_rays_cuda(metric, state, params, feats,
                                         settings.trace, image_width=width)
                ev[1].record()
                torch.cuda.synchronize()
                ms.append(ev[0].elapsed_time(ev[1]))
    bound = bound_ms(n, infos[0]["trials"])[0]
    print(f"[sweep] {n} rays, {infos[0]['trials']} trial iterations, bound "
          f"{bound:.3f} ms at {OPS_PER_TRIAL} operations each; {rounds} "
          "rounds in turns; ms = median (least)")
    for v, info, (big, sm) in zip(variants, infos, times):
        print(f"[sweep] {v or '(default)':48s} regs {info['registers']:3d} "
              f"stack {info['stack_bytes']:3d} spill "
              f"{info['spill_store_bytes']}+{info['spill_load_bytes']} "
              f"blocks/SM {info['blocks_per_sm']} x {info['threads']} | sass "
              f"{info['instructions']} fp32 {info['fp32']} loop "
              f"{info['loop']} reductions "
              f"{info['reductions']} | "
              f"1080p {statistics.median(big):7.3f} ({min(big):7.3f}) ms | "
              f"480x270 {statistics.median(sm):6.3f} ({min(sm):6.3f}) ms | "
              f"idle lanes {info['idle_factor']:.4f} | vs first: status "
              f"{info['status_eq']}/{n} steps {info['steps_eq']}/{n} max "
              f"|dpos| {info['max_dpos']:.3g} identical {info['identical']}")
    raymarch.NVCC_FLAGS = default_flags


def same_bits(a, b) -> bool:
    """Whether two RayStates hold the same bits in every field."""
    import torch

    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


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


def profile_frame(frame, frame_ms: float, what: str) -> None:
    """``torch.profiler`` over one steady frame (``what`` names it): device
    kernels, their merged busy time, and the idle share against the profiled
    wall and against the unprofiled frame time ``frame_ms``."""
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
    print(f"[6 profile] one steady {what} frame: {len(kernels)} device kernels "
          f"({len(dev) - len(kernels)} memcpy/memset), raymarch_kernel "
          f"{len(march)} launch(es) {march_ms:.3f} ms; device busy "
          f"{busy_ms:.3f} ms of {wall_ms:.3f} ms profiled wall (idle share "
          f"{1 - busy_ms / wall_ms:.4f}); against the unprofiled "
          f"{frame_ms:.3f} ms frame, idle share {1 - busy_ms / frame_ms:.4f}")
    ops = [a for a in prof.key_averages() if a.device_type == DeviceType.CPU
           and a.key.startswith("aten::")]
    top = sorted(ops, key=lambda a: -a.count)[:6]
    print(f"[6 profile] {what}: most-called host ops: " + ", ".join(
        f"{a.key} {a.count}" for a in top))


def bench_protocol_mrays(frame, n_pixels: int, passes=3, frames=4) -> float:
    """Mrays/s of ``frame`` by the protocol of the JAX package's
    ``bench.py``: ``passes`` passes of ``frames`` frames issued back to back
    and drained once, the best pass, host wall clock, ``n_pixels`` a
    frame."""
    import torch

    best = float("inf")
    for _ in range(passes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(frames):
            frame()
        torch.cuda.synchronize()
        best = min(best, (time.perf_counter() - t0) / frames)
    return n_pixels / best / 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Smoke test of the port on "
                                 "one GPU.")
    ap.add_argument("--profile", action="store_true",
                    help="trace one steady 1080p frame with torch.profiler")
    ap.add_argument("--kernel-flags", default="",
                    help="nvcc flags appended to the kernel's build")
    ap.add_argument("--sweep", nargs="?", const=";".join(SWEEP),
                    help="time kernel variants, one per ';'-separated set of "
                    "nvcc flags, and stop")
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

    # The flagship settings as they come (the adaptive frame), and their
    # dense twin for the dense path.
    metric, params, camera, asettings, feats = flagship_config(device=dev)
    assert asettings.adaptive_sampling and asettings.shade_traced_only
    settings = dataclasses.replace(asettings, adaptive_sampling=False)
    if args.sweep is not None:
        print(f"[sweep] {smi} | torch {torch.__version__} cuda "
              f"{torch.version.cuda}")
        sweep([v.strip() for v in args.sweep.split(";")], metric, params,
              camera, settings, feats)
        return 0

    # -- 1. device and build ------------------------------------------------
    raymarch.NVCC_FLAGS = raymarch.with_flags(*shlex.split(args.kernel_flags))
    t0 = time.perf_counter()
    raymarch.get_lib()
    build_s = time.perf_counter() - t0
    built = raymarch.BUILD_INFO[raymarch.NVCC_FLAGS]
    ptxas = raymarch.ptxas_summary(built["ptxas"])
    config = raymarch.kernel_config()
    print(f"[1 device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {name} | nvcc build "
          f"{built['seconds']} s (load {build_s:.2f} s)")
    print(f"[1 device] nvcc {' '.join(raymarch.NVCC_FLAGS)} | ptxas {ptxas} "
          f"| {config}")
    assert ptxas["spill_store_bytes"] == 0 and ptxas["spill_load_bytes"] == 0

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
    # so that the plain twin can march the same rays.
    with recorded_launches(integrate) as launch:
        raymarch.LAUNCHES = 0
        img = pl.render_frame(metric, camera, params, sky, settings, feats,
                              device=dev)
        torch.cuda.synchronize()
        launches = raymarch.LAUNCHES
    dense_img = img
    finite = bool(torch.isfinite(img).all())
    black = float((img == 0).all(dim=-1).float().mean())
    print(f"[3 frame] {settings.width}x{settings.height} kerr_boyer: "
          f"shape {tuple(img.shape)}, finite {finite}, kernel launches "
          f"{launches}, shadow fraction {black:.4f}")
    assert launches == 1, launches
    assert finite and tuple(img.shape) == (settings.height, settings.width, 3)
    assert SHADOW_RANGE[0] <= black <= SHADOW_RANGE[1], black
    (s_in, s_out, _), = launch
    n_rays = settings.width * settings.height
    assert s_in.position.shape == (n_rays, 4), s_in.position.shape
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ev[0].record()
    p_all = integrate.trace_rays_reference(metric, s_in, params, feats,
                                           settings.trace)
    ev[1].record()
    torch.cuda.synchronize()
    plain_ms = ev[0].elapsed_time(ev[1])
    rows = torch.from_numpy(np.sort(np.random.default_rng(1).choice(
        n_rays, 4096, replace=False))).to(dev)
    err_f = 0.0
    for what, pick in ((f"4096 of the frame's {n_rays}", rows),
                       (f"all {n_rays}", slice(None))):
        k = integrate.RayState(*(t[pick] for t in s_out))
        p = integrate.RayState(*(t[pick] for t in p_all))
        n = k.status.numel()
        st, sp, err, close = compare_states(k, p)
        print(f"[3 frame] {what} kernel rays vs plain: status equal "
              f"{st / n:.4f}, steps equal {sp / n:.4f}, max |dpos| "
              f"{err:.3g}; plain march of the frame {plain_ms:.1f} ms")
        assert st >= SET_B_MIN_STATUS_EQ * n, st
        assert sp >= SET_B_MIN_STEPS_EQ * n, sp
        assert close, err
        err_f = max(err_f, err)
    del p_all, p

    # The work of that launch, from one more launch on the same input (the
    # output must be the same again, in whatever order the warps ran).
    work = launch_work(metric, s_in, params, feats, settings.trace,
                       settings.width)
    k = work.pop("state")
    del work["per_ray"]
    assert same_bits(k, s_out), "two launches on one input disagree"
    print(f"[3 work] {n_rays} rays: committed steps mean "
          f"{work['mean_steps']:.2f} max {work['max_steps']}, trial "
          f"iterations {work['trials']} (mean {work['trials'] / n_rays:.2f});"
          f" idle-lane factor of the launch {work['idle_factor']:.4f} (a "
          f"warp per 8x4 pixel tile has {work['idle_tiles']:.4f}, per 32 "
          f"pixels of a row {work['idle_rows']:.4f})")
    del launch, s_in, s_out, k

    # -- 4. kernel frame vs plain frame at 480x270 ---------------------------
    small = dataclasses.replace(settings, width=480, height=270)
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    state, ku = pl.init_camera_rays(metric, camera, params, small, feats,
                                    device=dev)
    torch.cuda.synchronize()
    ev[0].record()
    fk = raymarch.trace_rays_cuda(metric, state, params, feats, small.trace,
                                  image_width=small.width)
    ev[1].record()
    fp = integrate.trace_rays_reference(metric, state, params, feats,
                                        small.trace)
    ev[2].record()
    torch.cuda.synchronize()
    small_ms = ev[0].elapsed_time(ev[1])
    small_plain_ms = ev[1].elapsed_time(ev[2])
    small_work = launch_work(metric, state, params, feats, small.trace,
                             small.width)
    small_bound, _, _ = bound_ms(small.width * small.height,
                                 small_work["trials"])
    imgs = [pl.shade(pl.compute_render_data(metric, f, ku, params, feats),
                     sky, small) for f in (fk, fp)]
    rmse, bad = golden_gate(to_srgb8(imgs[0]), to_srgb8(imgs[1]))
    print(f"[4 gate] 480x270 kernel vs plain frame: RMSE {rmse:.4f}, "
          f"pixels off by >32 {bad:.5f}; trace kernel {small_ms:.3f} ms, "
          f"plain {small_plain_ms:.1f} ms")
    assert rmse < GATE_RMSE and bad < GATE_BAD_FRAC, (rmse, bad)

    # -- 5. timing the 1080p frame -------------------------------------------
    def timed_frame():
        e = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
        e[0].record()
        s, ku_ = pl.init_camera_rays(metric, camera, params, settings, feats,
                                     device=dev)
        e[1].record()
        fin = integrate.trace_rays(metric, s, params, feats, settings.trace,
                                   image_width=settings.width)
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
    kernel_ms = statistics.median(s[1] for s in splits)
    bound, bound_ops, bound_bytes = bound_ms(n_rays, work["trials"])
    print(f"[5 bound] 1080p trace kernel {kernel_ms:.3f} ms (median of "
          f"{len(splits)}); bound {bound:.3f} ms = {work['trials']} trial "
          f"iterations x {OPS_PER_TRIAL} operations / "
          f"{PEAK_FP32_FLOPS / 1e12:.0f} TFLOP/s (bound by operations; the "
          f"bytes bound is {bound_bytes:.3f} ms); share of the bound "
          f"{bound / kernel_ms:.4f}; 480x270: {small_ms:.3f} ms, bound "
          f"{small_bound:.3f} ms, share {small_bound / small_ms:.4f}")
    assert bound == bound_ops
    dense_mrays = bench_protocol_mrays(
        lambda: pl.render_frame(metric, camera, params, sky, settings, feats,
                                device=dev), n_rays)
    print(f"[5 bench] dense 1080p frame by bench.py's protocol (3 passes of "
          f"4 frames issued back to back and drained once, best pass, host "
          f"wall clock): {dense_mrays:.4f} Mrays/s "
          f"({n_rays / dense_mrays / 1e3:.3f} ms a frame)")

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
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(["--bench", "kerr_boyer", "--adaptive", "--frames", "2",
                       *cli_args])
    bench = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("Frametime Elapsed: ")]
    assert rc == 0 and len(bench) == 2, buf.getvalue()
    apng = png.with_name("kerr_cli_adaptive.png")
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli.main(["--metric", "kerr_boyer", "--adaptive", *cli_args,
                       "--out", str(apng)])
    cli_aimg = read_png_rgb(apng)
    cli_black = float((cli_aimg == 0).all(axis=-1).mean())
    cli_rmse, cli_bad = golden_gate(cli_aimg, cli_img)
    print(f"[7 cli] --bench kerr_boyer --adaptive 1920x1080 on cuda: "
          f"{'; '.join(bench)}; PNG {cli_aimg.shape}, shadow fraction "
          f"{cli_black:.4f}; against the dense PNG: RMSE {cli_rmse:.4f}, "
          f"pixels off by >32 {cli_bad:.5f}")
    assert rc == 0 and cli_aimg.shape == (1080, 1920, 3), cli_aimg.shape
    assert SHADOW_RANGE[0] <= cli_black <= SHADOW_RANGE[1], cli_black


    # -- 8. the adaptive flagship frame at 1920x1080, first and steady --------
    # flagship_config as it comes, a fresh controller, six frames; the first
    # frame's three launches and a steady frame's two are recorded.
    nq = n_rays // 4
    controller = pl.RefineBudgetController()
    demands = []
    observe = controller.observe

    def observing(demand):
        demands.append(demand)
        observe(demand)

    controller.observe = observing

    def adaptive_frame():
        return pl.render_frame(metric, camera, params, sky, asettings, feats,
                               controller=controller, device=dev)

    recorded, path_launches, aimg = {}, [], None
    for i in range(6):
        with recorded_launches(integrate) as launch:
            raymarch.LAUNCHES = 0
            img = adaptive_frame()
            torch.cuda.synchronize()
            path_launches.append(raymarch.LAUNCHES)
        if i in (0, 5):
            recorded[i] = launch
        aimg = img if i == 0 else aimg
        finite = bool(torch.isfinite(img).all())
        black = float((img == 0).all(dim=-1).float().mean())
        k = launch[-1][0].status.numel() // 3
        print(f"[8 adaptive] frame {i}: kernel launches {path_launches[-1]} "
              f"({', '.join(str(s.status.numel()) for s, _, _ in launch)} "
              f"rays), k {k} of {nq} blocks, demand "
              f"{float(demands[-1]):.6f}, controller bucket "
              f"{controller.fraction(1.0):.4f}; shape {tuple(img.shape)}, "
              f"finite {finite}, shadow fraction {black:.4f}")
        assert finite and tuple(img.shape) == (1080, 1920, 3)
        assert SHADOW_RANGE[0] <= black <= SHADOW_RANGE[1], black
        del launch
    assert path_launches == [3, 2, 2, 2, 2, 2], path_launches
    assert [w for _, _, w in recorded[0]] == [120, 960, None]
    assert [w for _, _, w in recorded[5]] == [960, None]

    # -- 9. each adaptive launch against the plain twin ----------------------
    err_ad, first = 0.0, []
    for what, (s_in, s_out, width) in zip(("prepass", "quarter", "refine"),
                                          recorded[0]):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        p = integrate.trace_rays_reference(metric, s_in, params, feats,
                                           asettings.trace)
        ev[1].record()
        torch.cuda.synchronize()
        n = s_in.status.numel()
        born_dead = born_dead_untouched(s_in, (s_out, p))
        st, sp, err, close = compare_states(s_out, p)
        lw = launch_work(metric, s_in, params, feats, asettings.trace,
                           width)
        assert same_bits(lw.pop("state"), s_out)
        del lw["per_ray"]
        lw.update(name=what, plain_ms=ev[0].elapsed_time(ev[1]),
                    image_width=width, born_dead=born_dead)
        first.append(lw)
        print(f"[9 launches] first frame, {what}: {n} rays ({born_dead} born "
              f"DEAD, untouched by kernel and plain twin), kernel vs plain: "
              f"status equal {st / n:.4f}, steps equal {sp / n:.4f}, max "
              f"|dpos| {err:.3g}; plain march {lw['plain_ms']:.1f} ms")
        assert st >= SET_B_MIN_STATUS_EQ * n, st
        assert sp >= SET_B_MIN_STEPS_EQ * n, sp
        assert close, err
        err_ad = max(err_ad, err)
        del p
    assert first[0]["born_dead"] == 0 and first[2]["born_dead"] > 0

    # -- 10. adaptive against dense at 1080p ---------------------------------
    d = (aimg - dense_img).abs().max(dim=-1).values
    off_frac, median = float((d > 0.1).float().mean()), float(d.median())
    a_rmse, a_bad = golden_gate(to_srgb8(aimg), to_srgb8(dense_img))
    print(f"[10 dense] adaptive vs dense 1080p frame: pixels with a channel "
          f"off by >0.1 {off_frac:.5f} (limit {ADAPTIVE_MAX_OFF_FRAC}), "
          f"median difference {median:.3g} (limit {ADAPTIVE_MAX_MEDIAN}), "
          f"mean {float(d.mean()):.5f}; sRGB RMSE {a_rmse:.4f}, pixels off "
          f"by >32 {a_bad:.5f}")
    assert off_frac < ADAPTIVE_MAX_OFF_FRAC and median < ADAPTIVE_MAX_MEDIAN
    del d, dense_img

    # -- 11. adaptive kernel frame vs plain frame at 480x270 -----------------
    asmall = dataclasses.replace(asettings, width=480, height=270)
    raymarch.LAUNCHES = 0
    fk = pl.render_frame(metric, camera, params, sky, asmall, feats,
                         device=dev)
    small_launches = raymarch.LAUNCHES
    with plain_marches(integrate):
        fp = pl.render_frame(metric, camera, params, sky, asmall, feats,
                             device=dev)
    assert small_launches == 3 and raymarch.LAUNCHES == 3
    rmse, bad = golden_gate(to_srgb8(fk), to_srgb8(fp))
    print(f"[11 gate] 480x270 adaptive frame, kernel vs plain marches: RMSE "
          f"{rmse:.4f}, pixels off by >32 {bad:.5f}")
    assert rmse < GATE_RMSE and bad < GATE_BAD_FRAC, (rmse, bad)

    # -- 12. a steady adaptive frame never waits for the device --------------
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        adaptive_frame()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    print("[12 sync] one steady adaptive 1080p frame under "
          "set_sync_debug_mode('error'): no host synchronisation")

    # -- 13. timing and work of the adaptive frame ---------------------------
    def timed_adaptive(frame, read):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        frame()
        ev[1].record()
        ms = read()
        total = ev[0].elapsed_time(ev[1])
        ms["other"] = total - sum(ms.get(s, 0.0) for s in STAGES)
        return total, ms

    def stage_text(ms):
        return " + ".join(f"{s} {ms[s]:.3f}" for s in (*STAGES, "other")
                          if s in ms)

    with stage_events(pl, integrate) as read:
        steady = [timed_adaptive(adaptive_frame, read) for _ in range(3)]
        fresh = pl.RefineBudgetController()
        first_total, first_ms = timed_adaptive(
            lambda: pl.render_frame(metric, camera, params, sky, asettings,
                                    feats, controller=fresh, device=dev),
            read)
    for i, (total, ms) in enumerate(steady):
        print(f"[13 time] steady adaptive frame {i}: {total:.3f} ms "
              f"({n_rays / total / 1e3:.4f} Mrays/s at {n_rays} pixels) = "
              f"{stage_text(ms)} ms")
    print(f"[13 time] first adaptive frame (fresh controller): "
          f"{first_total:.3f} ms = {stage_text(first_ms)} ms (prepass launch "
          f"{first_ms['prepass launch']:.3f} ms of its stage)")
    adaptive_mrays = bench_protocol_mrays(adaptive_frame, n_rays)
    print(f"[13 bench] adaptive 1080p frame by bench.py's protocol (3 passes "
          f"of 4 frames issued back to back and drained once, best pass, "
          f"host wall clock): {adaptive_mrays:.4f} Mrays/s "
          f"({n_rays / adaptive_mrays / 1e3:.3f} ms a frame); the dense "
          f"frame in this run: {dense_mrays:.4f} Mrays/s")

    def launch_row(work, ms):
        b, b_ops, _ = bound_ms(work["rays"], work["trials"])
        assert b == b_ops
        row = {"name": work["name"], "rays": work["rays"],
               "active_rays": work["active"], "image_width":
               work["image_width"], "trial_iterations": work["trials"],
               "mean_steps": work["mean_steps"], "max_steps":
               work["max_steps"], "idle_lane_factor": work["idle_factor"],
               "ms": ms, "bound_ms": b, "share_of_bound": b / ms}
        if "plain_ms" in work:
            row["plain_ms"] = work["plain_ms"]
        print(f"[13 work] {work['name']}: {row['rays']} rays "
              f"({row['active_rays']} ACTIVE at launch), trial iterations "
              f"{row['trial_iterations']}, committed steps mean "
              f"{row['mean_steps']:.2f} max {row['max_steps']}, idle-lane "
              f"factor {row['idle_lane_factor']:.4f}; kernel {ms:.3f} ms, "
              f"bound {b:.3f} ms (by operations), share {b / ms:.4f}")
        return row

    first_rows = [launch_row(w, first_ms[t]) for w, t in zip(
        first, ("prepass launch", "quarter trace", "refine trace"))]
    steady_rows = []
    for what, (s_in, s_out, width) in zip(("quarter", "refine"),
                                          recorded[5]):
        lw = launch_work(metric, s_in, params, feats, asettings.trace,
                           width)
        assert same_bits(lw.pop("state"), s_out)
        del lw["per_ray"]
        lw.update(name=what, image_width=width)
        steady_rows.append(launch_row(lw, statistics.median(
            ms[f"{what} trace"] for _, ms in steady)))

    # A cost sort of the refine launch's rays is measured only where the
    # launch leaves more than SORT_IDLE_FACTOR of its lane turns idle.
    sort = None
    refine_idle = steady_rows[1]["idle_lane_factor"]
    if refine_idle > SORT_IDLE_FACTOR:
        # The recorded steady frame's selection, from its quarter launch.
        (_, q_out, _), (r_in, _, _) = recorded[5]
        cam_frame = pl.camera_frame(metric, camera, params)
        _, ku = pl.rays_for_pixels(metric, camera, *cam_frame, params,
                                   asettings, feats,
                                   *pl._qcoords(asettings, dev))
        _, _, _, sel, _, r_again, _ = pl._refine_setup(
            metric, camera, cam_frame, params, asettings, feats, q_out, ku,
            r_in.status.numel() // 3)
        assert same_bits(r_again, r_in)
        sort = cost_sorted_launch(metric, r_in, q_out.steps, sel, params,
                                  feats, asettings.trace, (540, 960))
        print(f"[13 sort] refine launch, idle-lane factor {refine_idle:.4f} "
              f"> {SORT_IDLE_FACTOR}: unsorted {sort['ms']:.3f} ms; cost-"
              f"sorted {sort['sorted_ms']:.3f} ms with its sort, gather and "
              f"scatter (launch alone {sort['sorted_launch_ms']:.3f} ms, "
              f"idle-lane factor {sort['sorted_idle_factor']:.4f}), same "
              f"bits {sort['identical']}; the frame marches them unsorted")
        assert sort["identical"]
    else:
        print(f"[13 sort] refine launch, idle-lane factor {refine_idle:.4f} "
              f"<= {SORT_IDLE_FACTOR}: no cost sort measured")
    steady_total = statistics.median(t for t, _ in steady)
    # Both traces come after every timing, so that the profiler cannot
    # disturb one.
    if args.profile:
        profile_frame(timed_frame, sum(totals) / len(totals), "dense")
        profile_frame(adaptive_frame, steady_total, "adaptive")
    del recorded

    table = {"kernels": [{
        "name": "raymarch_kerr_boyer",
        "route": "cuda",
        "source": "geodesic_raytracing_tpu_torch/csrc/raymarch.cu",
        "replaces": "geodesic_raytracing_tpu/ops/pallas/raymarch.py:488",
        "launches": launches,
        "max_abs_err": max(err_a, err_b, err_f, err_ad),
        # Of the main path's launch, the 1080p frame's 2,073,600 rays.
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound,
        "bound_by": "operations",
        "share_of_bound": bound / kernel_ms,
        "library_ms": None,  # no PyTorch call computes an adaptive march
        "rays": n_rays,
        "trial_iterations": work["trials"],
        "mean_steps": work["mean_steps"],
        "max_steps": work["max_steps"],
        "idle_lane_factor": work["idle_factor"],
        # Of the 480x270 frame's launch (one wave of blocks: its time is
        # that of its longest ray).
        "small": {
            "rays": small.width * small.height, "ms": small_ms,
            "plain_ms": small_plain_ms, "bound_ms": small_bound,
            "share_of_bound": small_bound / small_ms},
        "build_flags": " ".join(raymarch.NVCC_FLAGS),
        "ptxas": {**ptxas, **config},
        # Launches of one frame of each path through render_frame, counted
        # from 0 just before it; the adaptive launches one by one.
        "paths": {
            "dense": {"launches": launches, "frame_ms":
                      statistics.median(totals), "bench_mrays": dense_mrays},
            "adaptive_first": {"launches": path_launches[0], "frame_ms":
                               first_total, "stages_ms": first_ms,
                               "launch": first_rows},
            "adaptive_steady": {"launches": path_launches[-1], "frame_ms":
                                steady_total, "stages_ms": steady[-1][1],
                                "bench_mrays": adaptive_mrays,
                                "launch": steady_rows, "refine_sort": sort},
        },
    }]}
    print(json.dumps(table))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
