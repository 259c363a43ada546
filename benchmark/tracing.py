"""The traced run's instruments, all in the benchmark's own files: spans
around the calls into the program's layers, and a ``torch.profiler`` trace
of a short steady stretch of frames.

Spans: the host time of each ``render_frame`` call, a device span (CUDA
events) from the frame's dispatch to its last operation, and a device span
around each ``integrate.trace_rays`` call inside it (the function is
replaced by a timing wrapper while the traced window runs, and put back
after).  The profiler covers ``PROFILED`` frames after one frame that fills
the loop; its kernels are attributed to a frame by the host time of the
call that launched them.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from pathlib import Path
from typing import NamedTuple

import torch

PROFILED = 3
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
FRAME_MARK = "benchmark_frame_"


class _Clock:
    """Marks on the device's timeline (CUDA events) or, on the CPU, on the
    host clock."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        event = torch.cuda.Event(enable_timing=True)
        event.record()
        return event

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


class Spans:
    """The spans of every frame of the traced window."""

    def __init__(self, device):
        self.clock = _Clock(device)
        self.frames: list = []

    def frame(self, render):
        """``render`` with a frame's spans around it."""
        def traced():
            record = {"traces": []}
            self.frames.append(record)
            t0 = time.perf_counter()
            record["start"] = self.clock.mark()
            image = render()
            record["end"] = self.clock.mark()
            record["dispatch_ms"] = (time.perf_counter() - t0) * 1e3
            return image
        return traced

    @contextlib.contextmanager
    def trace_rays(self, integrate):
        """Inside the block ``integrate.trace_rays`` records a device span
        around each call into the frame being dispatched."""
        real = integrate.trace_rays

        def timed(*args, **kwargs):
            start = self.clock.mark()
            out = real(*args, **kwargs)
            self.frames[-1]["traces"].append((start, self.clock.mark()))
            return out

        integrate.trace_rays = timed
        try:
            yield
        finally:
            integrate.trace_rays = real

    def summary(self) -> list:
        """Per frame: ``dispatch_ms`` (host), ``frame_ms`` (device span) and
        ``trace_ms`` (each trace_rays span), once the device is done."""
        if self.clock.cuda:
            torch.cuda.synchronize()
        ms = self.clock.ms
        return [{"dispatch_ms": f["dispatch_ms"],
                 "frame_ms": ms(f["start"], f["end"]),
                 "trace_ms": [ms(a, b) for a, b in f["traces"]]}
                for f in self.frames]


class Profile(NamedTuple):
    """What the profiled stretch showed.  ``frames``: frames counted;
    ``kernels``: (name, start us, duration us) of each kernel launched in
    them; ``busy_s`` / ``window_s``: the union of device activity in the
    stretch and its length; ``device_ops`` / ``idle_gaps``: the result line's
    breakdown."""

    frames: int
    kernels: list
    busy_s: float
    window_s: float
    device_ops: list
    idle_gaps: list

    def kernel_s_per_frame(self, name: str) -> float | None:
        total = sum(d for n, _, d in self.kernels if name in n)
        return total / self.frames / 1e6 if total > 0 else None


def profile(stream, path: Path) -> Profile:
    """Profile ``PROFILED`` + 1 frames of ``stream``; the first fills the
    loop and is not counted.  The trace is written to ``path`` and removed
    once read."""
    from torch.profiler import ProfilerActivity, profile as torch_profile
    from torch.profiler import record_function

    activities = [ProfilerActivity.CPU]
    if stream.cuda:
        activities.append(ProfilerActivity.CUDA)
    with torch_profile(activities=activities) as prof:
        for i in range(PROFILED + 1):
            with record_function(f"{FRAME_MARK}{i}"):
                stream.step()
        stream.drain()
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    try:
        return read_trace(json.loads(path.read_text()))
    finally:
        os.remove(path)


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def read_trace(trace: dict) -> Profile:
    """Reduce a chrome trace of ``profile`` to a :class:`Profile`."""
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    marks = sorted((int(e["name"][len(FRAME_MARK):]), e["ts"],
                    e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith(FRAME_MARK))
    counted = [(a, b) for i, a, b in marks if i > 0]
    host = [e for e in events if e.get("cat") in HOST_CATS]
    launched_at = {e["args"]["correlation"]: e["ts"] for e in host
                   if "correlation" in e.get("args", {})}
    device = [e for e in events if e.get("cat") in DEVICE_CATS]

    def in_counted(e) -> bool:
        t = launched_at.get(e.get("args", {}).get("correlation"))
        return t is not None and any(a <= t <= b for a, b in counted)

    kernels = [(e["name"], e["ts"], e["dur"]) for e in device
               if e["cat"] == "kernel" and in_counted(e)]
    start = counted[0][0] if counted else 0.0
    spans = [(max(e["ts"], start), e["ts"] + e["dur"]) for e in device
             if e["ts"] + e["dur"] > start]
    busy = _union([s for s in spans if s[1] > s[0]])
    end = max([b for _, b in busy] + [b for _, b in counted] + [start])
    busy_us = sum(b - a for a, b in busy)

    by_name: dict = {}
    for e in device:
        if e["ts"] >= start:
            by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"]
    device_ops = [[n[:160], us / 1e6] for n, us in
                  sorted(by_name.items(), key=lambda kv: -kv[1])[:10]]

    edges = [start] + [x for ab in busy for x in ab] + [end]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                   for i in range(0, len(edges) - 1, 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]

    def host_at(t: float) -> str:
        inner = [e for e in host if e["ts"] <= t <= e["ts"] + e["dur"]]
        if not inner:
            return "host outside the profiled calls"
        return max(inner, key=lambda e: e["ts"])["name"][:160]

    idle_gaps = [[host_at(t0 + us / 2), us / 1e6] for us, t0 in gaps]
    return Profile(frames=len(counted), kernels=kernels,
                   busy_s=busy_us / 1e6, window_s=(end - start) / 1e6,
                   device_ops=device_ops, idle_gaps=idle_gaps)
