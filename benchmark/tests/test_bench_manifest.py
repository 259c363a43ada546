"""The manifest's names and units, discovery by name, and a cell, a mix
and a per-layer metric added as new files and entries only."""

import json

import pytest
from conftest import ROOT, small_root

from benchmark import manifest, run


def test_the_manifest_keeps_the_rules_for_names_and_units():
    spec = manifest.load(ROOT)
    assert manifest.problems(spec) == []
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    for w in spec["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200


@pytest.mark.parametrize("bad", ["has space", "a,b", "a/b", "é", "x" * 65])
def test_bad_names_are_found(bad):
    spec = manifest.load(ROOT)
    spec["per_layer"][0]["name"] = bad
    assert manifest.problems(spec)


@pytest.mark.parametrize("bad", ["tokens per s", "x" * 17, "µs"])
def test_bad_units_are_found(bad):
    spec = manifest.load(ROOT)
    spec["end_to_end"][0]["unit"] = bad
    assert manifest.problems(spec)


def test_every_cell_finds_its_files_by_name():
    spec = manifest.load(ROOT)
    for w in spec["workloads"]:
        cfg = manifest.config(ROOT, spec, w["config"])
        assert cfg["name"] == w["config"]
        assert set(manifest.mix(ROOT, w["traffic"])) >= {
            "width", "height", "adaptive_sampling", "in_flight",
            "warm_frames", "seed_varies"}
        assert set(manifest.limits(ROOT, w["name"])) == {
            "px_off_share", "worst_tile_off"}
    for m in spec["per_layer"]:
        assert callable(manifest.reader(ROOT, m["name"]))
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]}


def test_a_new_cell_mix_and_metric_need_only_new_files(tmp_path, capsys):
    root = small_root(tmp_path, width=16, height=10, max_steps=64)
    bench = root / "benchmark"
    cfg = json.loads((bench / "configs" / "schwarzschild_planar.json")
                     .read_text())
    cfg["name"] = "throwaway"
    (bench / "configs" / "throwaway.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "dense_still_2160.json")
                     .read_text())
    mix.update(warm_frames=1, seed_varies=["azimuth"])
    (bench / "traffic" / "tiny.json").write_text(json.dumps(mix))
    (bench / "limits" / "throwaway.tiny.json").write_text(
        json.dumps({"px_off_share": 0.0, "worst_tile_off": 0.0}))
    (bench / "layer_metrics" / "frames_traced.py").write_text(
        "def read(run):\n    return float(len(run.frames))\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway", "source": "test",
                            "file": "benchmark/configs/throwaway.json",
                            "reduced": [], "why": "test"})
    spec["workloads"].append({"name": "throwaway.tiny", "config": "throwaway",
                              "traffic": "tiny", "chips": 1, "why": "test"})
    spec["per_layer"].append({"name": "frames_traced", "unit": "frames",
                              "better": "higher", "source": "program_span",
                              "layer": "frame loop", "moves": "mrays_per_s",
                              "workloads": ["throwaway.tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    argv = ["--workload", "throwaway.tiny", "--seed", "2147483650",
            "--seconds", "2", "--trace", "1"]
    assert run.main(argv, root=root, device="cpu") == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["metrics"]["frames_traced"]["value"] >= 1
    assert list(result)[-1] == "checks"
