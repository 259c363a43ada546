"""The port's recorder of spans and counters (``utils/profiling.py``):
nesting and frame ids, the ring, counters, the switch, the spans a dense and
an adaptive frame take, the stage names in a ``torch.profiler`` trace and
the CLI's ``--bench`` line.  On the CPU no span takes a device time (the
CUDA events are checked on the card by
``benchmark/tests/test_bench_program_spans.py``)."""

import json
import math

import pytest
import torch

from geodesic_raytracing_tpu_torch import cli, metrics
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.ops.integrate import TraceOptions
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render import pipeline as pl
from geodesic_raytracing_tpu_torch.utils import profiling

torch.set_num_threads(1)

DENSE = ["frame", "ray_init", "camera", "launch_state", "trace",
         "render_data", "shade"]
STAGES = ["ray_init", "trace", "render_data", "shade"]  # the frame's own


@pytest.fixture
def recorder():
    """The process's recorder, emptied, switched back on afterwards."""
    profiling.reset()
    yield profiling
    profiling.set_enabled(True)
    profiling.reset()


def _scene(name):
    m = metrics.get_metric(name)
    cam = Camera.default(device="cpu").rotate(pitch=-math.pi / 2)
    return m, cam, m.params(), bg.checker_background(64, 128, device="cpu")


def _frame(name, adaptive=False, controller=None, scene=None, size=16):
    m, cam, params, sky = scene or _scene(name)
    settings = pl.RenderSettings(width=size, height=size, anisotropy=2,
                                 adaptive_sampling=adaptive,
                                 trace=TraceOptions(max_steps=128))
    return pl.render_frame(m, cam, params, sky, settings,
                           controller=controller, device="cpu")


def test_spans_nest_and_share_the_frame_id():
    rec = profiling.Recorder()
    with rec.span("outside"):
        pass
    for _ in range(2):
        with rec.frame("cpu"):
            with rec.span("a") as a:
                with rec.span("b") as b:
                    assert rec.current_frame() is not None
                with rec.frame("cpu"):  # a frame inside a frame is a span
                    pass
    first, second = rec.recent_frames()
    assert second.id == first.id + 1
    assert [s.name for s in second.spans] == ["frame", "a", "b", "frame"]
    top = second.spans[0]
    assert {s.frame for s in second.spans} == {second.id}
    assert b.parent is a and a.parent is top and top.parent is None
    assert second.spans[3].parent is a
    assert all(s.start_ns <= s.end_ns and s.device_ms is None
               for s in second.spans)
    assert top.start_ns <= a.start_ns <= b.start_ns <= b.end_ns \
        <= a.end_ns <= top.end_ns
    assert [(s.name, s.frame) for s in rec.setup_spans()] == [
        ("outside", None)]
    assert rec.first_frame() is first and rec.current_frame() is None


def test_the_ring_keeps_512_frames():
    rec = profiling.Recorder()
    for _ in range(profiling.RING + 88):
        with rec.frame("cpu"):
            pass
    frames = rec.recent_frames()
    assert profiling.RING == 512 and len(frames) == 512
    assert [f.id for f in frames] == list(range(88, 600))
    assert rec.first_frame().id == 0


def test_counters_land_on_their_frame():
    rec = profiling.Recorder()
    rec.count("launches")  # outside a frame: nowhere
    with rec.frame("cpu"):
        rec.count("launches")
        rec.count("launches", 2)
        earlier = rec.current_frame()
    with rec.frame("cpu"):
        rec.count("refine_share", 0.25)
        rec.count("refine_demand", 0.125, frame=earlier)
    rec.count("late", 1, frame=earlier)
    rec.count("gone", 1, frame=10_000)
    first, second = rec.recent_frames()
    assert first.counters == {"launches": 3, "refine_demand": 0.125,
                              "late": 1}
    assert second.counters == {"refine_share": 0.25}
    assert rec.setup_spans() == []


def test_a_disabled_recorder_records_nothing(recorder):
    recorder.set_enabled(False)
    _frame("schwarzschild")
    with recorder.span("outside"):
        recorder.count("launches")
    assert recorder.recent_frames() == [] and recorder.setup_spans() == []
    assert recorder.first_frame() is None
    recorder.set_enabled(True)
    _frame("schwarzschild")
    assert len(recorder.recent_frames()) == 1


def test_a_dense_frame_takes_its_stage_spans(recorder):
    """The stages are the frame's children; ray init's two parts, the
    camera at one point and every ray's launch state, are ray init's."""
    scene = _scene("schwarzschild")
    assert [s.name for s in recorder.setup_spans()] == ["setup.sky_atlas"]
    _frame("schwarzschild", scene=scene)
    (f,) = recorder.recent_frames()
    assert [s.name for s in f.spans] == DENSE
    top, ray_init = f.spans[0], f.spans[1]
    assert [s.name for s in f.spans if s.parent is top] == STAGES
    assert [s.name for s in f.spans if s.parent is ray_init] == [
        "camera", "launch_state"]
    # No kernel launch on the CPU: the camera, the launch state and render
    # data take their eager paths; the polar chart is the identity, so no
    # eager chart transform.
    assert f.counters == {"camera_eager": 1, "render_data_eager": 1,
                          "launch_state_eager": 1}
    assert f.host_ms("frame") >= sum(f.host_ms(n) for n in STAGES)
    assert f.host_ms("ray_init") >= (f.host_ms("camera")
                                     + f.host_ms("launch_state"))
    assert f.device_ms("frame") is None and f.host_ms("prepass") is None


def test_a_cylindrical_chart_takes_the_chart_span(recorder):
    """A tiny ``double_kerr`` frame (cylindrical chart) transforms its
    endpoints to the polar chart eagerly inside render data: the ``chart``
    span and the ``chart_eager`` counter, which the CLI's line prints; a
    Schwarzschild frame (the identity chart) takes neither."""
    m = metrics.get_metric("double_kerr")
    cam = Camera.default(device="cpu").rotate(pitch=-math.pi / 2)
    sky = bg.checker_background(64, 128, device="cpu")
    settings = pl.RenderSettings(width=4, height=3, anisotropy=2,
                                 trace=TraceOptions(max_steps=4))
    pl.render_frame(m, cam, m.params(), sky, settings, device="cpu")
    _frame("schwarzschild", size=4)
    dk, schw = recorder.recent_frames()
    assert [s.name for s in dk.spans] == DENSE[:6] + ["chart", "shade"]
    (chart,) = [s for s in dk.spans if s.name == "chart"]
    assert chart.parent.name == "render_data"
    assert dk.counters == {"camera_eager": 1, "render_data_eager": 1,
                           "launch_state_eager": 1, "chart_eager": 1}
    assert profiling.describe(dk).endswith(
        "; launches 0; render_data_kernel 0 of 1; camera_kernel 0 of 1"
        "; launch_state_kernel 0 of 1; chart_eager 1")
    assert [s.name for s in schw.spans] == DENSE
    assert schw.counters == {"camera_eager": 1, "render_data_eager": 1,
                             "launch_state_eager": 1}


def test_adaptive_frames_take_their_stage_spans(recorder):
    """Two frames of one stream: the first marches the prepass, the second
    reuses it and, with a controller latency of 1, reads the first frame's
    demand (its ``controller_wait``), which lands on the first frame."""
    scene = _scene("kerr_boyer")
    controller = pl.RefineBudgetController(latency=1)
    for _ in range(2):
        _frame("kerr_boyer", adaptive=True, controller=controller,
               scene=scene)
    first, second = recorder.recent_frames()
    assert [s.name for s in first.spans] == [
        "frame", "camera", "prepass", "trace", "quarter_setup", "trace",
        "refine_setup", "trace", "finish"]
    assert [s.name for s in second.spans] == [
        "frame", "camera", "quarter_setup", "trace", "refine_setup",
        "controller_wait", "trace", "finish"]
    prepass_trace = first.spans[3]
    assert prepass_trace.parent is first.spans[2]
    assert all(s.parent is second.spans[0] for s in second.spans[1:])
    nq = 8 * 8
    share = pl._refine_k(nq, 0.375) / nq
    assert second.counters == {"camera_eager": 1, "refine_share": share,
                               "render_data_eager": 2,
                               "launch_state_eager": 2}
    assert set(first.counters) == {"camera_eager", "refine_share",
                                   "refine_demand", "render_data_eager",
                                   "launch_state_eager"}
    assert first.counters["launch_state_eager"] == 3
    assert 0.0 < first.counters["refine_demand"] <= 1.0


def test_a_profiler_trace_holds_the_stage_names(recorder, tmp_path):
    scene = _scene("schwarzschild")
    with profiling.torch_profile(str(tmp_path / "prof")):
        _frame("schwarzschild", scene=scene)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    names = [e["name"] for e in trace["traceEvents"]
             if e.get("cat") == "user_annotation"]
    assert names.count("frame") == 1
    assert set(DENSE) <= set(names)
    (f,) = recorder.recent_frames()
    assert [s.name for s in f.spans] == DENSE


def test_the_cli_bench_prints_each_frame_stages(recorder, capsys):
    assert cli.main(["--bench", "schwarzschild", "--frames", "2",
                     "--width", "16", "--height", "12", "--max-steps", "128",
                     "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    timed = [i for i, ln in enumerate(lines)
             if ln.startswith("Frametime Elapsed: ")]
    assert len(timed) == 2
    for i in timed:
        stages = lines[i + 1]
        assert stages.startswith("Stages (host / device ms): frame ")
        assert [p.split()[0] for p in stages.split(": ", 1)[1].split(
            "; ")[0].split(", ")] == DENSE
        assert stages.endswith("; launches 0; render_data_kernel 0 of 1"
                               "; camera_kernel 0 of 1"
                               "; launch_state_kernel 0 of 1")
