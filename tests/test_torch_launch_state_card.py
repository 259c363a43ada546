"""The launch-state kernel on the card against its eager twin.

Every test takes the fixture ``cuda`` and skips without a CUDA device.  On
the card the kernel's state (position, velocity, acceleration, step seed,
running dlambda, status, steps), ku_uobsu and planar inverse quaternions
equal ``rays_for_pixels_reference`` bit for bit: on the 3840x2160 frames of
the benchmark's three configurations (4-D Kerr, planar Schwarzschild, the
two-body metric in its cylindrical chart), a planar metric whose chart is not
the identity (the kernel's generic input), a camera on a recorded geodesic
whose tetrad is not contiguous, a moving camera traced forwards, and every
ray set of two adaptive frames (prepass, quarter grid, refine set).  A dense
frame counts one ``launch_state_kernel`` and no ``launch_state_eager``; a
gradient takes the twin; a metric without a kernel instance raises.  Run
them on the card with

    python -m pytest --noconftest tests/test_torch_launch_state_card.py

(this file imports no JAX; ``tests/conftest.py`` does).
"""

import dataclasses
import math

import pytest
import torch

from geodesic_raytracing_tpu_torch import bench_config, metrics
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.ops import integrate
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render import pipeline as pl
from geodesic_raytracing_tpu_torch.utils import profiling

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def recorder():
    """The process's recorder, emptied, switched back on afterwards."""
    profiling.reset()
    yield profiling
    profiling.set_enabled(True)
    profiling.reset()


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, or NaN on both sides."""
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(a) & torch.isnan(b)
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | nan).all())


def assert_same_launch(got, ref):
    (gs, gku, gq), (rs, rku, rq) = got, ref
    for field in integrate.RayState._fields:
        assert same_bits(getattr(gs, field), getattr(rs, field)), field
    assert same_bits(gku, rku)
    assert (gq is None) == (rq is None)
    if rq is not None:
        assert same_bits(gq, rq)


def kernel_and_twin(m, camera, params, settings, feats, cx, cy):
    """``(kernel's, twin's)`` launch state of the pixels ``cx``, ``cy``;
    only the kernel's call is in a recorded frame (the camera is not)."""
    position, es = pl.camera_frame(m, camera, params)
    planar = pl._planar_enabled(m, settings)
    with profiling.frame(camera.quat.device):
        got = pl.rays_for_pixels(m, camera, position, es, params, settings,
                                 feats, cx, cy, planar=planar)
    ref = pl.rays_for_pixels_reference(m, camera, position, es, params,
                                       settings, feats, cx, cy, planar)
    return got, ref


@pytest.mark.parametrize("name", ["kerr_boyer", "schwarzschild",
                                  "double_kerr"])
def test_kernel_equals_eager_on_2160_frames(cuda, recorder, name):
    """The benchmark configurations' 3840x2160 dense frames, every ray."""
    m, params, camera, settings, feats = bench_config.flagship_config(
        3840, 2160, device=cuda, metric=name)
    settings = dataclasses.replace(settings, adaptive_sampling=False)
    cx, cy = pl._grid_coords(3840, 2160, 1.0, cuda)
    got, ref = kernel_and_twin(m, camera.to(cuda), params, settings, feats,
                               cx, cy)
    assert_same_launch(got, ref)
    assert (ref[2] is not None) == (name == "schwarzschild")
    assert torch.isfinite(ref[0].acceleration).all()
    (f,) = recorder.recent_frames()
    assert f.counters == {"launch_state_kernel": 1}


@pytest.mark.parametrize("case", ["ingoing_ef_planar", "geodesic_camera",
                                  "moving_forwards"])
def test_kernel_equals_eager_on_other_inputs(cuda, recorder, case):
    """A 480x270 frame: planar ingoing Eddington-Finkelstein Schwarzschild
    (the chart's eager to_planar, then the kernel's generic input; it counts
    ``chart_eager``), a Kerr camera on a recorded geodesic with a tetrad
    that is not contiguous, a Kerr camera with a frame 3-speed traced
    forwards."""
    name = "schwarzschild_ingoing_ef" if case.startswith("ingoing") else \
        "kerr_boyer"
    m = metrics.get_metric(name)
    params = m.params()
    camera = Camera.default(device=cuda).rotate(pitch=-math.pi / 2)
    settings = pl.RenderSettings(
        width=480, height=270,
        flip_geodesic_direction=case == "moving_forwards")
    if case == "moving_forwards":
        camera = camera._replace(
            basis_speed=torch.tensor([0.2, -0.1, 0.3], device=cuda))
    if case == "geodesic_camera":
        position, es = pl.camera_frame(
            m, camera._replace(basis_speed=torch.tensor(
                [0.0, 0.3, 0.0], device=cuda)), params)
        camera = camera.on_geodesic(position, es.T.contiguous().T)
        assert not camera.frame_override[1].is_contiguous()
    cx, cy = pl._grid_coords(480, 270, 1.0, cuda)
    feats = integrate.Features.for_metric(m)
    got, ref = kernel_and_twin(m, camera, params, settings, feats, cx, cy)
    assert_same_launch(got, ref)
    (f,) = recorder.recent_frames()
    expect = {"launch_state_kernel": 1}
    if case.startswith("ingoing"):
        expect["chart_eager"] = 1
        assert ref[2] is not None
    assert f.counters == expect


def test_a_dense_card_frame_takes_the_kernel_once(cuda, recorder):
    m = metrics.get_metric("kerr_boyer")
    sky = bg.checker_background(64, 128, device=cuda)
    camera = Camera.default(device=cuda).rotate(pitch=-math.pi / 2)
    settings = pl.RenderSettings(width=64, height=36,
                                 trace=integrate.TraceOptions(max_steps=512))
    for _ in range(2):
        pl.render_frame(m, camera, m.params(), sky, settings, device=cuda)
    frames = recorder.recent_frames()
    assert [f.counters.get("launch_state_kernel") for f in frames] == [1, 1]
    assert all("launch_state_eager" not in f.counters for f in frames)


def test_kernel_equals_eager_on_adaptive_sets(cuda, recorder, monkeypatch):
    """An adaptive 960x540 Kerr frame and its successor (prepass reused):
    every launch state (the prepass, the quarter grid, the refine set)
    equals the twin on the same inputs, and each counts one kernel call."""
    calls = []
    real = pl.rays_for_pixels

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(pl, "rays_for_pixels", record)
    m, params, camera, settings, feats = bench_config.flagship_config(
        960, 540, device=cuda)
    sky = bg.checker_background(64, 128, device=cuda)
    controller = pl.RefineBudgetController()
    for _ in range(2):
        pl.render_frame(m, camera, params, sky, settings, feats,
                        controller=controller, device=cuda)
    frames = recorder.recent_frames()
    launches = [f.counters.get("launch_state_kernel") for f in frames]
    assert launches == [3, 2]
    assert all("launch_state_eager" not in f.counters for f in frames)
    sizes = set()
    for args, kwargs, out in calls:
        assert_same_launch(out, pl.rays_for_pixels_reference(*args,
                                                              **kwargs))
        sizes.add(args[7].shape[0])
    assert len(sizes) >= 2  # the quarter grid and a refine set


def test_the_card_runs_a_gradient_eager_and_refuses_no_instance(cuda,
                                                              recorder):
    """A parameter that requires grad takes the twin on the card, and the
    frame counts it; a metric whose config differs from its kernel
    instance's raises, as the march does."""
    m = metrics.get_metric("kerr_boyer")
    params = m.params()
    camera = Camera.default(device=cuda).rotate(pitch=-math.pi / 2)
    settings = pl.RenderSettings(width=64, height=36)
    cx, cy = pl._grid_coords(64, 36, 1.0, cuda)
    position, es = pl.camera_frame(m, camera, params)
    feats = integrate.Features.for_metric(m)
    a = torch.tensor(params["a"], device=cuda, requires_grad=True)
    other = dataclasses.replace(
        m, config=dataclasses.replace(m.config, singular=True))
    with profiling.frame(cuda):
        sa, kua, _ = pl.rays_for_pixels(m, camera, position, es,
                                        {**params, "a": a}, settings, feats,
                                        cx, cy)
        with pytest.raises(NotImplementedError):
            pl.rays_for_pixels(other, camera, position, es, params,
                               settings, feats, cx, cy)
        got = pl.rays_for_pixels(m, camera, position, es, params, settings,
                                 feats, cx, cy)
    assert sa.acceleration.requires_grad and kua.requires_grad
    assert not got[1].requires_grad
    assert_same_launch(got, pl.rays_for_pixels_reference(
        m, camera, position, es, params, settings, feats, cx, cy))
    (f,) = recorder.recent_frames()
    assert f.counters == {"launch_state_eager": 1, "launch_state_kernel": 1}

