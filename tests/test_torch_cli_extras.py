"""The rest of the single-device CLI and its application pieces, held to the
JAX package: ``utils/profiling`` (``trace_stats``, ``FrameTimer``,
``torch_profile`` with the recorder's ``frame`` span), ``--supersample``, ``--trace-method``,
``RenderSettings.flip_geodesic_direction`` and ``probe_bilinear``,
``settings.py`` (a file written by either package loads in the other),
the viewer's scripted camera and ``runtime.AsyncFrameWriter``.

Tolerances: the trace statistics equal JAX's on the same final state; the
64x64 frames (planar ``schwarzschild``, 2048 steps) within the gate of
``tests/test_torch_render_simple.py::test_frame_matches_jax`` (sRGB RMSE
< 0.5, under 0.5% of pixels off by more than 32); the viewer's camera after
each key within 1e-5 of JAX's (float32 trigonometry of the two packages).
"""

import dataclasses
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geodesic_raytracing_tpu import cli as jcli
from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu import settings as jsettings
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.ops import integrate as jint
from geodesic_raytracing_tpu.render import background as jbg
from geodesic_raytracing_tpu.render import colour as jcolour
from geodesic_raytracing_tpu.render import pipeline as jpl
from geodesic_raytracing_tpu.utils import profiling as jprof
from geodesic_raytracing_tpu_torch import carry, cli, metrics, runtime
from geodesic_raytracing_tpu_torch import settings as tsettings
from geodesic_raytracing_tpu_torch import viewer
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.ops import integrate as tint
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render import colour
from geodesic_raytracing_tpu_torch.render import pipeline as pl
from geodesic_raytracing_tpu_torch.utils import profiling
from test_integrator import make_rays

torch.set_num_threads(1)


def _u8(srgb):
    return (np.clip(np.asarray(srgb), 0, 1) * 255).astype(np.uint8)


def _gate(a, b, rmse_max=0.5, bad_max=0.005):
    d = np.abs(a.astype(int) - b.astype(int))
    rmse = float(np.sqrt((d.astype(float) ** 2).mean()))
    assert rmse < rmse_max, rmse
    assert (d > 32).mean() < bad_max
    return rmse


def test_trace_stats_matches_jax():
    jm = jmetrics.get_metric("schwarzschild")
    pos, vel = make_rays(64)
    jf = jint.Features.for_metric(jm)
    st = jint.init_ray_state(jm, jnp.asarray(pos), jnp.asarray(vel),
                             params=jm.params(), features=jf)
    st = st._replace(status=st.status.at[::9].set(jint.DEAD))
    fin = jint.trace_rays(jm, st, jm.params(), features=jf,
                          opts=jint.TraceOptions(max_steps=300))
    ours = profiling.trace_stats(carry.ray_state_from_jax(fin, device="cpu")[0])
    theirs = jprof.trace_stats(fin)
    assert ours == theirs and str(ours) == str(theirs)
    assert ours.dead > 0 and ours.escaped > 0


def test_frame_timer_and_profile(tmp_path):
    """The frame timer, and the recorder's ``frame`` span inside a
    ``torch_profile`` trace: one frame in the ring, its span on the
    profiler's clock."""
    t = profiling.FrameTimer()
    with t.frame():
        torch.ones(4).sum()
    t.start()
    assert t.stop() >= 0.0 and len(t.times_ms) == 2
    assert t.median_ms >= 0.0
    rec = profiling.Recorder()
    with profiling.torch_profile(str(tmp_path / "prof")):
        with rec.frame("cpu"):
            torch.ones(64).cumsum(0)
    (f,) = rec.recent_frames()
    assert [s.name for s in f.spans] == ["frame"] and f.host_ms("frame") > 0
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert [e["name"] for e in trace["traceEvents"]
            if e.get("cat") == "user_annotation"] == ["frame"]
    assert "cumsum" in (tmp_path / "prof" / "summary.txt").read_text()


def _port_frame(**kw):
    tm = metrics.get_metric("schwarzschild")
    return pl.render_frame(
        tm, Camera.default(device="cpu").rotate(pitch=-math.pi / 2),
        tm.params(), bg.checker_background(128, 256, device="cpu"),
        pl.RenderSettings(width=64, height=64, anisotropy=2,
                          trace=tint.TraceOptions(max_steps=2048), **kw),
        device="cpu")


def _jax_frame(**kw):
    jm = jmetrics.get_metric("schwarzschild")
    return jpl.render_frame(
        jm, JCamera.default().rotate(pitch=-np.pi / 2), jm.params(),
        jbg.checker_background(128, 256),
        jpl.RenderSettings(width=64, height=64, anisotropy=2,
                           trace=jint.TraceOptions(max_steps=2048,
                                                   method="while"), **kw))


@pytest.mark.parametrize("kw", [dict(flip_geodesic_direction=True),
                                dict(probe_bilinear=True)])
def test_settings_frames_match_jax(kw):
    ours = _u8(colour.lin_to_srgb(_port_frame(**kw)))
    theirs = _u8(jcolour.lin_to_srgb(_jax_frame(**kw)))
    assert ours.max() > 0
    _gate(ours, theirs)
    if "probe_bilinear" in kw:
        plain = _u8(colour.lin_to_srgb(_port_frame()))
        assert not np.array_equal(ours, plain)  # the taps change the frame
    else:
        # A static, spherical spacetime looks the same either way; the rays
        # themselves run forwards in affine time.
        tm = metrics.get_metric("schwarzschild")
        cam = Camera.default(device="cpu").rotate(pitch=-math.pi / 2)
        feats = tint.Features.for_metric(tm)
        v = [pl.init_camera_rays(tm, cam, tm.params(), pl.RenderSettings(
            width=8, height=8, planar=False, **k), feats,
            device="cpu")[0].velocity[:, 0] for k in ({}, kw)]
        assert bool((v[0] * v[1] < 0).all())


def test_supersample_cli_matches_jax(tmp_path):
    """``--supersample 2`` at 32x32: a 64x64 frame box-filtered down, in
    both CLIs."""
    args = ["--metric", "schwarzschild", "--width", "32", "--height", "32",
            "--pitch", "-90", "--max-steps", "2048", "--anisotropy", "2",
            "--supersample", "2"]
    assert cli.main([*args, "--device", "cpu", "--out",
                     str(tmp_path / "t.png")]) == 0
    assert jcli.main([*args, "--cpu", "--out", str(tmp_path / "j.png")]) == 0
    ours, theirs = cli.read_png(tmp_path / "t.png"), cli.read_png(
        tmp_path / "j.png")
    assert ours.shape == (32, 32, 3)
    _gate(ours, theirs)


def test_trace_method_flags(tmp_path, capsys):
    args = ["--metric", "schwarzschild", "--width", "16", "--height", "16",
            "--pitch", "-90", "--max-steps", "1024", "--device", "cpu"]
    assert cli.main([*args, "--out", str(tmp_path / "a.png")]) == 0
    assert cli.main([*args, "--trace-method", "while", "--trace-stats",
                     "--out", str(tmp_path / "w.png")]) == 0
    assert "rays=256 " in capsys.readouterr().out
    np.testing.assert_array_equal(cli.read_png(tmp_path / "a.png"),
                                  cli.read_png(tmp_path / "w.png"))
    with pytest.raises(SystemExit, match="needs --device cuda"):
        cli.main([*args, "--trace-method", "cuda"])
    with pytest.raises(SystemExit):
        cli.main([*args, "--dump-hlo", str(tmp_path / "x.txt")])
    assert "no meaning in the PyTorch port" in capsys.readouterr().err
    opts = tint.TraceOptions(method="plain")
    assert opts.method == "plain"
    with pytest.raises(ValueError, match="unknown trace method"):
        tint.TraceOptions(method="pallas")


def test_settings_files_load_across_packages(tmp_path):
    ours = tsettings.AppSettings()
    ours.video.width, ours.video.workgroup_size = 640, (16, 4)
    ours.control.fov, ours.keybinds["forward"] = 75.0, "up"
    ours.background_path = "sky.png"
    ours.save(tmp_path / "t.json")
    loaded = jsettings.AppSettings.load(tmp_path / "t.json")
    assert dataclasses.asdict(loaded) == dataclasses.asdict(ours)
    theirs = jsettings.AppSettings()
    theirs.video.anisotropy, theirs.control.invert_mouse = 4, True
    theirs.background_path2 = "far.png"
    theirs.save(tmp_path / "j.json")
    back = tsettings.AppSettings.load(tmp_path / "j.json")
    assert dataclasses.asdict(back) == dataclasses.asdict(theirs)
    assert json.loads(back.to_json()) == json.loads(theirs.to_json())
    (tmp_path / "bad.json").write_text("{not json")
    assert tsettings.AppSettings.load(tmp_path / "bad.json") == \
        tsettings.AppSettings()
    assert tsettings.DEFAULT_KEYBINDS == jsettings.DEFAULT_KEYBINDS


def _jax_apply_key(camera, k, speed):
    """The JAX viewer's frame loop's response to one key."""
    move = {"w": (0, 0, 1), "s": (0, 0, -1), "a": (-1, 0, 0),
            "d": (1, 0, 0), "q": (0, -1, 0), "e": (0, 1, 0)}
    turn = {"i": ("pitch", -1), "k": ("pitch", 1), "j": ("yaw", -1),
            "l": ("yaw", 1), "u": ("roll", -1), "o": ("roll", 1)}
    if k in move:
        camera = camera.translate(jnp.asarray(move[k], jnp.float32), speed)
    elif k in turn:
        axis, sgn = turn[k]
        camera = camera.rotate(**{axis: sgn * 0.15})
    elif k in ("r", "f"):
        camera = camera._replace(polar_position=camera.polar_position.at[
            0].add(speed if k == "r" else -speed))
    elif k == "[":
        speed /= 2
    elif k == "]":
        speed *= 2
    return camera, speed


def test_viewer_scripted_camera_matches_jax():
    ours = Camera.default(device="cpu").rotate(pitch=-math.pi / 2)
    theirs = JCamera.default().rotate(pitch=-np.pi / 2)
    s1 = s2 = 0.5
    for k in "wwajd]qeilkjuo[rrfs":
        ours, s1 = viewer.apply_key(ours, k, s1)
        theirs, s2 = _jax_apply_key(theirs, k, s2)
        assert s1 == s2
        np.testing.assert_allclose(ours.polar_position.numpy(),
                                   np.asarray(theirs.polar_position),
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(ours.quat.numpy(),
                                   np.asarray(theirs.quat), atol=1e-5,
                                   err_msg=k)


def test_viewer_scripted_frames(capsys):
    assert viewer.main(["--metric", "schwarzschild", "--width", "12",
                        "--height", "8", "--max-steps", "512", "--device",
                        "cpu", "--script", "wj", "--frames", "2"]) == 0
    out = capsys.readouterr().out
    assert "viewer: 2 frames" in out and "▀" in out
    ansi = viewer.frame_to_ansi(np.zeros((3, 2, 3), np.uint8))
    assert ansi.count("\n") == 0 and ansi.count("▀") == 2


def test_async_frame_writer_round_trip(tmp_path, capsys):
    rng = np.random.default_rng(4)
    frame = rng.integers(0, 256, (9, 7, 3)).astype(np.uint8)
    with runtime.AsyncFrameWriter(threads=2) as w:
        w.submit(tmp_path / "f.png", frame)
        w.submit(tmp_path / "no_such_dir" / "g.png", frame)
        frame[:] = 0  # the writer keeps its own copy
    assert w.pending == 0 and w.failures == 1
    assert "frame write to" in capsys.readouterr().err
    np.testing.assert_array_equal(cli.read_png(tmp_path / "f.png"),
                                  rng.__class__(np.random.PCG64(4)).integers(
                                      0, 256, (9, 7, 3)).astype(np.uint8))
    with pytest.raises(ValueError):
        runtime.AsyncFrameWriter().submit(tmp_path / "x.png",
                                          np.zeros((4, 4), np.uint8))
