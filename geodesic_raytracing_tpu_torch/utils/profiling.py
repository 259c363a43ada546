"""Tracing and profiling utilities (port of
``geodesic_raytracing_tpu.utils.profiling``).

The reference's observability is a frametime timer and the ``-bench``
stdout protocol (main.cpp:1588, 2864-2871).  Here: ray statistics of a
finished trace (status counts, step percentiles), a frame timer with the
same protocol whose stops wait for the device, and a ``torch.profiler``
trace context in place of the JAX package's ``xla_profile``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch


class TraceStats(NamedTuple):
    """Summary of a finished trace batch."""

    n_rays: int
    escaped: int
    dead: int
    unfinished: int
    steps_mean: float
    steps_p50: float
    steps_p99: float
    steps_max: int

    def __str__(self) -> str:
        return (
            f"rays={self.n_rays} escaped={self.escaped} dead={self.dead} "
            f"unfinished={self.unfinished} steps(mean={self.steps_mean:.0f} "
            f"p50={self.steps_p50:.0f} p99={self.steps_p99:.0f} "
            f"max={self.steps_max})"
        )


def trace_stats(final_state) -> TraceStats:
    """Statistics of a final RayState (read on the host)."""
    status = np.asarray(final_state.status.detach().cpu()
                        if isinstance(final_state.status, torch.Tensor)
                        else final_state.status)
    steps = np.asarray(final_state.steps.detach().cpu()
                       if isinstance(final_state.steps, torch.Tensor)
                       else final_state.steps)
    return TraceStats(
        n_rays=int(status.size),
        escaped=int((status == 1).sum()),
        dead=int((status == 2).sum()),
        unfinished=int((status == 0).sum()),
        steps_mean=float(steps.mean()),
        steps_p50=float(np.percentile(steps, 50)),
        steps_p99=float(np.percentile(steps, 99)),
        steps_max=int(steps.max()),
    )


@dataclasses.dataclass
class FrameTimer:
    """Frametime tracker speaking the reference's bench protocol
    ("Frametime Elapsed: %f", main.cpp:2864-2871).  ``device``: a CUDA
    device whose work ``start`` and ``stop`` wait for, so that a frame's
    time is the device's and not its launch queue's."""

    print_protocol: bool = False
    device: object = None
    _t0: float = 0.0
    times_ms: list = dataclasses.field(default_factory=list)

    def _sync(self) -> None:
        if self.device is not None and torch.device(self.device).type \
                == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self) -> None:
        self._sync()
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        self._sync()
        ms = (time.perf_counter() - self._t0) * 1e3
        self.times_ms.append(ms)
        if self.print_protocol:
            print(f"Frametime Elapsed: {ms:f}")
        return ms

    @contextlib.contextmanager
    def frame(self):
        self.start()
        yield
        self.stop()

    @property
    def median_ms(self) -> float:
        return float(np.median(self.times_ms)) if self.times_ms else 0.0

    def mrays_per_s(self, n_rays: int) -> float:
        if not self.times_ms:
            return 0.0
        return n_rays / (self.median_ms / 1e3) / 1e6


@contextlib.contextmanager
def torch_profile(log_dir: str, device=None):
    """A ``torch.profiler`` trace of the block (the JAX package's
    ``xla_profile``): the CPU, and the card where ``device`` is a CUDA
    device.  Writes ``trace.json`` (Chrome trace format) and
    ``summary.txt`` (the operator table by total time) into ``log_dir``
    and yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    cuda = device is not None and torch.device(device).type == "cuda"
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize(device)
    prof.export_chrome_trace(str(out / "trace.json"))
    key = "self_cuda_time_total" if cuda else "self_cpu_time_total"
    (out / "summary.txt").write_text(
        prof.key_averages().table(sort_by=key, row_limit=40))
