"""The program's own spans and counters, for the per-layer readers: the
recorder of ``geodesic_raytracing_tpu_torch.utils.profiling``, which is on
by default and is read in the run's process after the window.  Its ring
holds the stream's last 512 frames: the warm frames, the window's and the
profiled stretch's.  A program without the recorder gives None for each
metric, and the result line leaves the metric out."""

from __future__ import annotations

import statistics


def recorder():
    """The program's recorder module, or None where it has none."""
    try:
        from geodesic_raytracing_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "recent_frames") else None


def stage_ms(name: str, device: bool = False) -> float | None:
    """Median, over the frames that have a span ``name``, of the frame's
    ms in those spans: host (``perf_counter_ns``) or device (CUDA events)."""
    rec = recorder()
    if rec is None:
        return None
    ms = [f.device_ms(name) if device else f.host_ms(name)
          for f in rec.recent_frames()]
    ms = [v for v in ms if v is not None]
    return statistics.median(ms) if ms else None


def first_frame_s() -> float | None:
    """Host seconds of the stream's first ``frame`` span."""
    rec = recorder()
    first = rec.first_frame() if rec is not None else None
    return None if first is None else first.host_ms("frame") / 1e3


def setup_s(name: str) -> float | None:
    """Host seconds of the set-up spans called ``name``, summed."""
    rec = recorder()
    if rec is None:
        return None
    ms = [s.host_ms for s in rec.setup_spans() if s.name == name]
    return sum(ms) / 1e3 if ms else None

