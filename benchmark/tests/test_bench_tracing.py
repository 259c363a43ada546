"""The traced run's reduction of a profiler trace and of its spans."""

import pytest
import torch

from benchmark import tracing


def x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    # Frame 0 fills the loop (not counted); frames 1 and 2 are counted.
    ev = [x("user_annotation", "benchmark_frame_0", 0, 100),
          x("user_annotation", "benchmark_frame_1", 100, 100),
          x("user_annotation", "benchmark_frame_2", 200, 100),
          x("cpu_op", "aten::mul", 240, 30)]
    launches = [(50, 1), (120, 2), (150, 3), (220, 4), (260, 5)]
    for ts, corr in launches:
        ev.append(x("cuda_runtime", "cudaLaunchKernel", ts, 2, corr))
    ev += [x("kernel", "vectorized_elementwise", 60, 50, 1),
           x("kernel", "raymarch_kernel<KerrBoyer>", 125, 40, 2),
           x("kernel", "vectorized_elementwise", 170, 10, 3),
           x("kernel", "raymarch_kernel<KerrBoyer>", 225, 20, 4),
           x("gpu_memcpy", "Memcpy DtoH", 290, 10, 5)]
    return {"traceEvents": ev}


def test_kernels_are_counted_by_the_frame_that_launched_them():
    p = tracing.read_trace(synthetic())
    assert p.frames == 2
    assert [k[0] for k in p.kernels] == ["raymarch_kernel<KerrBoyer>",
                                         "vectorized_elementwise",
                                         "raymarch_kernel<KerrBoyer>"]
    assert p.kernel_s_per_frame("raymarch_kernel") == pytest.approx(30e-6)


def test_busy_and_window_cover_the_stretch_from_the_first_counted_frame():
    p = tracing.read_trace(synthetic())
    # Stretch 100..300 us; busy 100-110 (frame 0's tail), 125-165, 170-180,
    # 225-245, 290-300.
    assert p.window_s == pytest.approx(200e-6)
    assert p.busy_s == pytest.approx(90e-6)
    assert p.idle_gaps[0] == ["aten::mul", pytest.approx(45e-6)]
    assert p.device_ops[0][0] == "raymarch_kernel<KerrBoyer>"
    assert len(p.idle_gaps) <= 10 and len(p.device_ops) <= 10


def test_spans_time_each_frame_and_each_march(monkeypatch):
    class Integrate:
        @staticmethod
        def trace_rays(*args, **kwargs):
            return "marched"

    spans = tracing.Spans("cpu")

    def render():
        assert Integrate.trace_rays() == "marched"
        return torch.zeros(2, 2, 3)

    with spans.trace_rays(Integrate):
        for _ in range(3):
            spans.frame(render)()
    summary = spans.summary()
    assert len(summary) == 3
    assert all(len(f["trace_ms"]) == 1 for f in summary)
    assert all(f["frame_ms"] >= sum(f["trace_ms"]) for f in summary)
    assert Integrate.trace_rays() == "marched"
