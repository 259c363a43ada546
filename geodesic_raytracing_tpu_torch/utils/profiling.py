"""Tracing and profiling utilities (port of
``geodesic_raytracing_tpu.utils.profiling``).

The reference's observability is a frametime timer and the ``-bench``
stdout protocol (main.cpp:1588, 2864-2871).  Here: ray statistics of a
finished trace (status counts, step percentiles), a frame timer whose stops
wait for the device, a ``torch.profiler`` trace context in place of the JAX
package's ``xla_profile``, and the port's recorder of spans and counters.

**The recorder** (:class:`Recorder`; one per process, ``RECORDER``, behind
the module functions ``frame``, ``span``, ``count``, ``recent_frames``,
``first_frame``, ``setup_spans``, ``set_enabled`` and ``reset``) is on by
default.  ``render_frame`` opens a frame; the stages inside it open spans,
each with its name, its parent span, the frame's id, host start and end
(``time.perf_counter_ns``) and, on a CUDA device, a timing event from a
pool at each edge.  Nothing waits for the device: a frame's device
milliseconds are read once its last event has completed (polled when the
next frame opens), or by one ``synchronize`` in :func:`recent_frames`.
Finished frames go into a ring of ``RING`` frames.  Spans taken outside
any frame (the sky atlas, a march called on its own) are set-up spans.
While a ``torch.profiler`` session records, each span also enters
``record_function(name)``, so the stage names sit on the profiler's clock
in its trace.  Frames are dispatched from one thread.

Span names: ``frame``; dense ``ray_init`` (inside it ``camera``, the
observer at one point, and ``launch_state``, every ray's launch state),
``render_data`` (inside it ``chart``, the eager transform of the endpoints
to the polar chart, where the metric's chart is not the identity),
``shade``; adaptive ``camera``, ``prepass`` (absent where the prepass is
reused), ``quarter_setup``, ``refine_setup``, ``controller_wait``,
``finish``; ``trace`` (every ``integrate.trace_rays`` call); set-up
``setup.sky_atlas``.  Counters of a frame: ``launches`` (ray-march kernel
launches), ``render_data_kernel`` and ``render_data_eager``
(``compute_render_data`` calls served by the render-data kernel and by its
eager twin), ``camera_kernel`` and ``camera_eager``
(``camera.observer_tetrad`` calls served by the observer kernel and by its
eager twin), ``launch_state_kernel`` and ``launch_state_eager``
(``rays_for_pixels`` calls served by the launch-state kernel and by its
eager twin), ``chart_eager`` (``compute_render_data`` and planar
``rays_for_pixels`` calls that took the chart's eager transform), ``refine_share`` (the refine launch's blocks over
the quarter blocks) and ``refine_demand`` (the share of quarter blocks the
error test asked to refine, recorded against its own frame when the budget
controller reads it, ``latency`` frames later).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler


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
    """Frametime tracker.  ``device``: a CUDA device whose work ``start``
    and ``stop`` wait for, so that a frame's time is the device's and not
    its launch queue's."""

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
        return ms

    @contextlib.contextmanager
    def frame(self):
        self.start()
        yield
        self.stop()

    @property
    def median_ms(self) -> float:
        return float(np.median(self.times_ms)) if self.times_ms else 0.0


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


# ---------------------------------------------------------------------------
# The recorder of spans and counters
# ---------------------------------------------------------------------------

RING = 512  # finished frames kept


@dataclasses.dataclass
class Span:
    """One span.  ``frame``: the id of the frame it was taken in (None for
    a set-up span); ``parent``: the span it was opened inside (None at the
    top); ``device_ms``: the time between its CUDA events, None off the
    card or until they are read."""

    name: str
    frame: int | None
    parent: Span | None = dataclasses.field(repr=False)
    device: torch.device | None = dataclasses.field(repr=False)
    start_ns: int = 0
    end_ns: int = 0
    device_ms: float | None = None
    events: tuple | None = dataclasses.field(default=None, repr=False)

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


@dataclasses.dataclass
class Frame:
    """The spans (in the order they opened; the ``frame`` span first) and
    the counters of one ``render_frame`` call."""

    id: int
    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)

    def host_ms(self, name: str) -> float | None:
        """Host ms of the frame's spans called ``name``, summed; None
        where it has none."""
        hits = [s.host_ms for s in self.spans if s.name == name]
        return sum(hits) if hits else None

    def device_ms(self, name: str) -> float | None:
        """Device ms of the frame's spans called ``name``, summed; None
        where it has none or they were taken off the card."""
        hits = [s.device_ms for s in self.spans if s.name == name]
        if not hits or any(h is None for h in hits):
            return None
        return sum(hits)


def _profiler_on() -> bool:
    """Whether a ``torch.profiler`` session records (its cheap flag)."""
    return getattr(_autograd_profiler, "_is_profiler_enabled", False)


class Recorder:
    """Spans and counters of the frames a process renders (module
    docstring)."""

    def __init__(self):
        self.enabled = True
        self.reset()

    def reset(self) -> None:
        """Forget every frame and span."""
        self._ids = itertools.count()
        self._frame: Frame | None = None  # the open frame
        self._stack: list = []  # the open spans
        self._ring: collections.deque = collections.deque(maxlen=RING)
        self._setup: collections.deque = collections.deque(maxlen=RING)
        self._pending: collections.deque = collections.deque()
        self._pool: list = []  # timing events free for reuse
        self._first: Frame | None = None

    def set_enabled(self, on: bool) -> None:
        """Record (the default) or record nothing."""
        self.enabled = bool(on)

    def _event(self, device: torch.device):
        event = (self._pool.pop() if self._pool
                 else torch.cuda.Event(enable_timing=True))
        event.record(torch.cuda.current_stream(device))
        return event

    @contextlib.contextmanager
    def span(self, name: str, device=None):
        """A span of the block.  ``device``: where its work runs (CUDA:
        timing events at its edges); None takes the parent span's."""
        if not self.enabled:
            yield None
            return
        parent = self._stack[-1] if self._stack else None
        if device is not None:
            device = torch.device(device)
        elif parent is not None:
            device = parent.device
        frame = self._frame
        s = Span(name, frame.id if frame is not None else None, parent,
                 device)
        (frame.spans if frame is not None else self._setup).append(s)
        marker = None
        if _profiler_on():
            marker = _autograd_profiler.record_function(name)
            marker.__enter__()
        cuda = device is not None and device.type == "cuda"
        self._stack.append(s)
        s.start_ns = time.perf_counter_ns()
        start = self._event(device) if cuda else None
        try:
            yield s
        finally:
            if cuda:
                s.events = (start, self._event(device))
            s.end_ns = time.perf_counter_ns()
            self._stack.pop()
            if marker is not None:
                marker.__exit__(None, None, None)

    @contextlib.contextmanager
    def frame(self, device):
        """A frame of ``render_frame`` on ``device``: its ``frame`` span
        and a new frame id for every span inside.  Inside an open frame it
        is a ``frame`` span of that frame."""
        if not self.enabled or self._frame is not None:
            with self.span("frame", device) as s:
                yield s
            return
        self._poll()
        f = Frame(next(self._ids))
        self._frame = f
        try:
            with self.span("frame", device) as s:
                yield s
        finally:
            self._frame = None
            self._ring.append(f)
            if self._first is None:
                self._first = f
            if f.spans[0].events is not None:
                self._pending.append(f)

    def count(self, name: str, value: float = 1, frame: int | None = None
              ) -> None:
        """Add ``value`` to counter ``name`` of the open frame, or of the
        frame with id ``frame``; nothing outside a frame."""
        if not self.enabled:
            return
        f = self._frame
        if frame is not None and (f is None or f.id != frame):
            f = next((g for g in reversed(self._ring) if g.id == frame),
                     None)
        if f is not None:
            f.counters[name] = f.counters.get(name, 0) + value

    def current_frame(self) -> int | None:
        """The open frame's id, or None."""
        return self._frame.id if self._frame is not None else None

    def _resolve(self, spans) -> None:
        for s in spans:
            if s.events is not None:
                start, end = s.events
                s.device_ms = start.elapsed_time(end)
                s.events = None
                self._pool += [start, end]

    def _poll(self) -> None:
        """Read the device times of the finished frames whose last event
        has completed, oldest first, without waiting."""
        while self._pending and self._pending[0].spans[0].events[1].query():
            self._resolve(self._pending.popleft().spans)

    def _drain(self) -> None:
        if self._pending:
            self._pending[-1].spans[0].events[1].synchronize()
            while self._pending:
                self._resolve(self._pending.popleft().spans)

    def recent_frames(self) -> list:
        """The ring's frames, oldest first, with their device times (one
        wait for the newest frame's last event)."""
        self._drain()
        return list(self._ring)

    def first_frame(self) -> Frame | None:
        """The first frame recorded since the last reset (kept when the
        ring has moved on)."""
        self._drain()
        return self._first

    def setup_spans(self) -> list:
        """The spans taken outside any frame, oldest first, with their
        device times."""
        for s in self._setup:
            if s.events is not None:
                s.events[1].synchronize()
        self._resolve(self._setup)
        return list(self._setup)


RECORDER = Recorder()
frame = RECORDER.frame
span = RECORDER.span
count = RECORDER.count
current_frame = RECORDER.current_frame
recent_frames = RECORDER.recent_frames
first_frame = RECORDER.first_frame
setup_spans = RECORDER.setup_spans
set_enabled = RECORDER.set_enabled
reset = RECORDER.reset


def describe(f: Frame) -> str:
    """One line of a frame's spans, by name in the order they opened (host
    / device ms, summed over the spans of a name; device "-" off the card),
    its ``launches``, its render data and observer tetrad calls served by
    their kernels of all (``render_data_kernel k of n``, ``camera_kernel k
    of n``, ``launch_state_kernel k of n``, where it made any) and its other
    counters: the CLI's view of the recorder."""
    parts = []
    for name in dict.fromkeys(s.name for s in f.spans):
        dev = f.device_ms(name)
        parts.append(f"{name} {f.host_ms(name):.3f} / "
                     + ("-" if dev is None else f"{dev:.3f}"))
    counters = dict(f.counters)
    line = (f"Stages (host / device ms): {', '.join(parts)}"
            f"; launches {counters.pop('launches', 0):g}")
    for stage in ("render_data", "camera", "launch_state"):
        kernel = counters.pop(f"{stage}_kernel", 0)
        calls = kernel + counters.pop(f"{stage}_eager", 0)
        if calls:
            line += f"; {stage}_kernel {kernel:g} of {calls:g}"
    return line + "".join(f"; {k} {v:g}" for k, v in counters.items())
