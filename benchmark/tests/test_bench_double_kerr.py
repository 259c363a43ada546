"""The ``double_kerr_binary`` configuration and its cell: the plain
reference (``reference/metrics/double_kerr.py``, its complex pairs and its
cylindrical chart) against the port's CPU path on a 16x9 frame, the
manifest's entries of the cell and of its four metrics, their readers on
synthetic recorder content and on a program without the spans they read,
and a traced run of the cell on the CPU."""

import json
import types

import pytest
import torch
from conftest import ROOT, small_root
from test_bench_reference import program_frame

from benchmark import check, manifest, run, scene
from benchmark.reference import frame as rframe
from benchmark.reference import spacetime

CELL = "double_kerr_binary.dense_2160"
NEW = {  # metric: (span, device clock)
    "launch_state_ms": ("launch_state", True),
    "launch_state_dispatch_ms": ("launch_state", False),
    "camera_dispatch_ms": ("camera", False),
    "chart_ms": ("chart", True),
}


def test_the_reference_matches_the_port_on_a_16x9_frame(tmp_path):
    """Bit for bit at a cut step budget: most rays are still marching after
    256 trial iterations, so every stage of a frame takes inputs away from
    the camera."""
    root = small_root(tmp_path, width=16, height=9, max_steps=256)
    spec = manifest.load(root)
    config = manifest.config(root, spec, "double_kerr_binary")
    mix = manifest.mix(root, "dense_still_2160")
    inputs = scene.inputs(config, mix, 2147483653, "cpu")
    image = program_frame(config, mix, inputs, 1)
    metric, params, settings, sky, camera = scene.reference(config, mix,
                                                            inputs, "cpu")
    ref, (launch,) = rframe.render(metric, params, settings, sky, *camera,
                                   index=1)
    assert check.compare(image, ref) == {"px_off_share": 0.0,
                                         "worst_tile_off": 0.0}
    assert torch.equal(image, ref)
    assert launch.rays == launch.active == 16 * 9 and launch.steps > 0


def test_the_reference_chart_round_trips():
    m = spacetime.load("double_kerr")
    x = torch.tensor([[0.5, -1.0], [7.0, 2.5], [1.2, 2.9], [0.3, -2.0]])
    cyl = m.from_polar(x, m.params({}))
    assert torch.allclose(m.to_polar(cyl, m.params({})), x, atol=1e-6)
    assert m.precision_weights() == (1.0, 1.0, 8.0, 1.0)


def test_the_manifest_holds_the_cell_and_its_metrics():
    spec = manifest.load(ROOT)
    cell = manifest.cell(spec, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "double_kerr_binary", "dense_still_2160", 1)
    entry = next(c for c in spec["configs"]
                 if c["name"] == "double_kerr_binary")
    assert entry["reduced"] == [] and len(entry["source"]) <= 200
    cfg = manifest.config(ROOT, spec, "double_kerr_binary")
    flagship = manifest.config(ROOT, spec, "kerr_boyer_flagship")
    assert cfg["metric"] == "double_kerr"
    assert cfg["params"] == {"R": 3.0, "M": 0.3, "a": 0.27}
    for block in ("camera", "render", "trace", "precision", "sky"):
        assert cfg[block] == flagship[block], block
    assert manifest.limits(ROOT, CELL) == {"px_off_share": 0.1,
                                           "worst_tile_off": 0.5}
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == [CELL] and m["moves"] == "mrays_per_s"
        assert m["source"] == "program_span" and m["unit"] == "ms"
    # The cell reports every accepted metric without a list of cells.
    reported = {m["name"] for m in manifest.metrics_of(spec["per_layer"],
                                                       CELL)}
    assert reported == set(NEW) | {m["name"] for m in spec["per_layer"]
                                   if "workloads" not in m}


def _recorder(with_spans: bool):
    from geodesic_raytracing_tpu_torch.utils import profiling

    def span(name, host_ms, device_ms):
        return profiling.Span(name, 0, None, None, 0, int(host_ms * 1e6),
                              device_ms)

    frames = []
    for i in range(3):
        spans = [span("frame", 400 + i, 450 + i),
                 span("ray_init", 200 + i, 190 + i)]
        if with_spans:
            spans += [span("camera", 60 + i, 20 + i),
                      span("launch_state", 140 + i, 170 + i),
                      span("chart", 3 + i, 5 + i)]
        frames.append(profiling.Frame(i, spans, {}))
    return types.SimpleNamespace(recent_frames=lambda: frames)


@pytest.mark.parametrize("metric", sorted(NEW))
def test_each_reader_reads_its_span_or_nothing(monkeypatch, metric):
    from benchmark import program_spans

    monkeypatch.setattr(program_spans, "recorder", lambda: _recorder(True))
    span, device = NEW[metric]
    want = {("camera", False): 61, ("launch_state", False): 141,
            ("launch_state", True): 171, ("chart", True): 6}[span, device]
    assert manifest.reader(ROOT, metric)(None) == pytest.approx(want)
    # A program whose frames lack the span (the parent of these spans).
    monkeypatch.setattr(program_spans, "recorder", lambda: _recorder(False))
    assert manifest.reader(ROOT, metric)(None) is None


# What a traced run of the cell reports on the CPU: no kernel and no CUDA
# event, so neither the profile's device metrics nor the spans' device
# times (``launch_state_ms``, ``chart_ms`` and the accepted ``*_ms`` of the
# dense stages, which list the other two cells).
ON_CPU = {"dispatch_ms", "pipeline_self_ms", "trace_ms", "trace_roofline",
          "launch_state_dispatch_ms", "camera_dispatch_ms"}


def test_a_traced_run_of_the_cell_reports_its_metrics(tmp_path, capsys):
    from geodesic_raytracing_tpu_torch.utils import profiling

    root = small_root(tmp_path, width=8, height=6, max_steps=32, warm=3)
    profiling.reset()
    argv = ["--workload", CELL, "--seed", "2147483655", "--seconds", "1",
            "--trace", "1"]
    assert run.main(argv, root=root, device="cpu") == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == ON_CPU
    frames = profiling.recent_frames()
    assert all(f.counters.get("chart_eager") == 1 for f in frames)
    ms = result["metrics"]
    assert 0 < ms["camera_dispatch_ms"]["value"]
    assert 0 < ms["launch_state_dispatch_ms"]["value"]
