"""The readers of the program's own spans and counters
(``benchmark/program_spans.py``): each on synthetic recorder content,
none without a recorder (the program before it had one), the metrics a
traced run of each cell reports, and the recorder's device times on the
card."""

import json
import types

import pytest
from conftest import ROOT, small_root

from benchmark import manifest, program_spans, run

from geodesic_raytracing_tpu_torch.utils import profiling

DENSE = ["kerr_boyer_flagship.dense_2160", "schwarzschild_planar.dense_2160"]
NEW = {  # metric: its value on the synthetic content below
    "ray_init_dispatch_ms": 44.0, "render_data_dispatch_ms": 33.0,
    "shade_dispatch_ms": 22.0, "ray_init_ms": 31.0, "render_data_ms": 21.0,
    "shade_ms": 11.0, "first_frame_s": 2.5, "sky_atlas_s": 0.12}


def _span(name, frame, host_ms, device_ms=None):
    return profiling.Span(name, frame, None, None, 0, int(host_ms * 1e6),
                          device_ms)


def _frame(fid, frame_ms, stages, **counters):
    spans = [_span("frame", fid, frame_ms)]
    spans += [_span(n, fid, *ms) for n, ms in stages.items()]
    return profiling.Frame(fid, spans, counters)


def synthetic():
    """Three dense frames and two adaptive ones (whose spans no reader of
    a dense stage reads)."""
    frames = [
        _frame(0, 2500, {"ray_init": (40, 30), "trace": (5, 50),
                         "render_data": (30, 20), "shade": (20, 10)}),
        _frame(1, 110, {"ray_init": (50, 35), "render_data": (36, 22),
                        "shade": (22, 12)}),
        _frame(2, 105, {"ray_init": (44, 31), "render_data": (33, 21),
                        "shade": (25, 11)}),
        _frame(3, 150, {"camera": (60, 58), "refine_setup": (60, 50),
                        "finish": (70, 66)}, refine_share=0.5,
               refine_demand=0.3),
        _frame(4, 150, {"camera": (62, 59), "controller_wait": (0.02,),
                        "finish": (72, 68)}, refine_share=0.5),
    ]
    setup = [_span("setup.sky_atlas", None, 120), _span("trace", None, 3)]
    return types.SimpleNamespace(recent_frames=lambda: frames,
                                 first_frame=lambda: frames[0],
                                 setup_spans=lambda: setup)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_each_reader_reads_the_recorder(monkeypatch, metric):
    monkeypatch.setattr(program_spans, "recorder", synthetic)
    value = manifest.reader(ROOT, metric)(None)
    assert value == pytest.approx(NEW[metric])


def test_without_a_recorder_every_reader_gives_none(monkeypatch):
    """A program whose ``utils.profiling`` has no recorder (the parent of
    the recorder) gives no value, and no reader raises."""
    import geodesic_raytracing_tpu_torch.utils as utils

    assert program_spans.recorder() is profiling
    monkeypatch.setattr(utils, "profiling", types.ModuleType("profiling"))
    assert program_spans.recorder() is None
    assert all(manifest.reader(ROOT, m)(None) is None for m in NEW)


def test_the_manifest_lists_each_new_metric_with_its_cells():
    spec = manifest.load(ROOT)
    entries = {m["name"]: m for m in spec["per_layer"]}
    assert set(NEW) <= set(entries)
    for name in NEW:
        assert entries[name]["workloads"] == DENSE


# What a traced run on the CPU reports: no kernel and no CUDA event, so
# neither the profile's device metrics nor the stages' device times.
ON_CPU = {"dispatch_ms", "pipeline_self_ms", "trace_ms", "trace_roofline",
          "ray_init_dispatch_ms", "render_data_dispatch_ms",
          "shade_dispatch_ms", "first_frame_s", "sky_atlas_s"}


@pytest.mark.parametrize("cell", DENSE)
def test_a_traced_run_reports_its_metrics(tmp_path, capsys, cell):
    root = small_root(tmp_path, width=16, height=10, max_steps=64, warm=3)
    profiling.reset()
    argv = ["--workload", cell, "--seed", "2147483651", "--seconds", "1",
            "--trace", "1"]
    assert run.main(argv, root=root, device="cpu") == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == ON_CPU
    assert 0 < result["metrics"]["sky_atlas_s"]["value"] \
        < result["metrics"]["first_frame_s"]["value"]


def test_the_recorder_times_each_stage_on_the_card(cuda):
    """A small dense frame on the card: every span's device time is read
    by ``recent_frames`` and the frame counts its one kernel launch; the
    next frame reuses the timing events."""
    from geodesic_raytracing_tpu_torch import metrics
    from geodesic_raytracing_tpu_torch.camera import Camera
    from geodesic_raytracing_tpu_torch.ops.integrate import TraceOptions
    from geodesic_raytracing_tpu_torch.render import background as bg
    from geodesic_raytracing_tpu_torch.render import pipeline as pl

    m = metrics.get_metric("kerr_boyer")
    profiling.reset()
    sky = bg.checker_background(64, 128, device=cuda)
    settings = pl.RenderSettings(width=64, height=36,
                                 trace=TraceOptions(max_steps=512))
    for i in range(3):
        pl.render_frame(m, Camera.default(device=cuda), m.params(), sky,
                        settings, device=cuda)
        frames = profiling.recent_frames()
        assert len(frames) == i + 1
        # The frame's 10 events are back in the pool, the same 10 each time.
        assert len(profiling.RECORDER._pool) == 10
    for f in frames:
        assert [s.name for s in f.spans] == [
            "frame", "ray_init", "trace", "render_data", "shade"]
        assert all(s.device_ms is not None and s.device_ms >= 0
                   and s.events is None for s in f.spans)
        assert f.device_ms("frame") >= f.device_ms("trace") > 0
        assert f.counters == {"launches": 1}
    (atlas,) = profiling.setup_spans()
    assert atlas.name == "setup.sky_atlas" and atlas.device_ms is None
