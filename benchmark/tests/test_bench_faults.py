"""A whole run with the card check skipped and the timed path broken
underneath: ``correct`` comes out false for each fault a frame stream can
have.  (A frame runs on one card: there is no exchange between chips to
leave out.)"""

import json

import pytest
import torch
from conftest import small_root

from benchmark import run


def unchanged(monkeypatch, pipeline, integrate):
    """The march returns the launch state as it is."""
    monkeypatch.setattr(integrate, "trace_rays",
                        lambda metric, state, *a, **k: state)


def half_left_out(monkeypatch, pipeline, integrate):
    """The march takes the first half of the rays; the rest keep their
    launch state."""
    real = integrate.trace_rays

    def half(metric, state, params, *args, **kwargs):
        kwargs.pop("image_width", None)
        n = state.position.shape[0] // 2
        out = real(metric, type(state)(*(t[:n] for t in state)), params,
                   *args, **kwargs)
        return type(state)(*(torch.cat([o, t[n:]])
                             for o, t in zip(out, state)))

    monkeypatch.setattr(integrate, "trace_rays", half)


def answer_altered(monkeypatch, pipeline, integrate):
    """Each frame leaves ``render_frame`` with one 16x16 tile altered."""
    real = pipeline.render_frame

    def altered(*args, **kwargs):
        image = real(*args, **kwargs).clone()
        image[:16, :16] += 0.5
        return image

    monkeypatch.setattr(pipeline, "render_frame", altered)


@pytest.mark.parametrize("fault", [unchanged, half_left_out, answer_altered])
@pytest.mark.parametrize("cell", ["kerr_boyer_flagship.dense_2160",
                                  "schwarzschild_planar.dense_2160"])
def test_a_broken_timed_path_is_not_correct(tmp_path, capsys, monkeypatch,
                                            cell, fault):
    root = small_root(tmp_path, max_steps=512, warm=1)
    argv = ["--workload", cell, "--seed", "2147483648", "--seconds", "12",
            "--trace", "0"]
    assert run.main(argv, root=root, device="cpu",
                    fault=lambda p, i: fault(monkeypatch, p, i)) == 0
    captured = capsys.readouterr()
    result = json.loads(captured.out.strip().splitlines()[-1])
    assert result["correct"] is False
    assert result["failed"] == 1
    assert captured.err.strip().splitlines()[-1].startswith("check ")


def test_the_sound_path_is_correct(tmp_path, capsys):
    root = small_root(tmp_path, max_steps=512, warm=1)
    argv = ["--workload", "kerr_boyer_flagship.dense_2160", "--seed",
            "2147483648", "--seconds", "12", "--trace", "0"]
    assert run.main(argv, root=root, device="cpu") == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    assert set(result["metrics"]) == {"mrays_per_s", "frame_ms_p90",
                                      "setup_s"}
