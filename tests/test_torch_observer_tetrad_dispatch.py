"""Which path ``camera.observer_tetrad`` takes, and the observer kernel on
the card against its eager twin.

On the CPU every call takes the eager twin (``observer_tetrad_reference``)
and counts ``camera_eager``; a position, a speed or a parameter that
requires grad asks for the twin on any device (``raymarch.asks_for_grad``),
and a gradient flows through it.  A camera riding a recorded geodesic
(``frame_override``) computes no tetrad at all.  The tests that take a
fixture ``cuda`` need a CUDA device and skip without one: there the kernel
equals the twin bit for bit at the benchmark cells' cameras (three seeded
azimuths each, Kerr also in its ergosphere and with a frame 3-speed; the
same cameras in the charts whose one-point jvp promotes to float64), a
dense frame counts one ``camera_kernel`` and no ``camera_eager``, a gradient
takes the twin and a metric without a kernel instance raises.  Run them on
the card with

    python -m pytest --noconftest tests/test_torch_observer_tetrad_dispatch.py

(this file imports no JAX; ``tests/conftest.py`` does).
"""

import dataclasses
import math

import pytest
import torch

from geodesic_raytracing_tpu_torch import camera as cam
from geodesic_raytracing_tpu_torch import metrics
from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
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
    nan = torch.isnan(a) & torch.isnan(b)
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | nan).all())


def cell_camera(azimuth: float, device, r=7.0, speed=None,
                t=0.0) -> cam.Camera:
    """The benchmark cells' camera (``benchmark/scene.py``): r on the
    equator at phi -pi/2 + azimuth, pitched at the hole, turned by the
    azimuth (at time ``t``)."""
    f32 = dict(dtype=torch.float32, device=device)
    camera = cam.Camera(
        polar_position=torch.tensor(
            [t, r, math.pi / 2, -math.pi / 2 + azimuth], **f32),
        quat=cam.quat_identity(device=device),
        basis_speed=torch.tensor(speed or [0.0] * 3, **f32)).rotate(
            pitch=-math.pi / 2)
    turn = cam.axis_angle_quat(torch.tensor([0.0, 0.0, 1.0], **f32),
                               torch.tensor(azimuth, **f32))
    return camera._replace(quat=cam.quat_multiply(turn, camera.quat))


def azimuths(seed: int) -> list:
    g = torch.Generator().manual_seed(seed)
    return [2 * math.pi * float(t) for t in torch.rand(3, generator=g)]


def tetrads(name, camera, params=None):
    """``(metric, params, position, observer_tetrad, its eager twin)``."""
    m = metrics.get_metric(name)
    params = m.params() if params is None else params
    position = pl.camera_to_generic(m, camera, params)
    got = cam.observer_tetrad(m, position, params, camera.basis_speed)
    ref = cam.observer_tetrad_reference(m, position, params,
                                        camera.basis_speed)
    return m, params, position, got, ref


@pytest.mark.parametrize("name", ["kerr_boyer", "double_kerr",
                                  "schwarzschild_ingoing_ef",
                                  "kerr_ingoing_ef", "misner_4d"])
def test_the_axes_come_out_in_the_positions_dtype(name):
    """The chart part's three axes are float32 as the position is, also
    where the chart's one-point jvp promotes to float64 (the ingoing
    Eddington-Finkelstein charts, Misner's): the kernel reads float32."""
    m = metrics.get_metric(name)
    params = m.params()
    t = -2.0 if name == "misner_4d" else 0.0  # off Misner's branch cut
    position = pl.camera_to_generic(m, cell_camera(0.4, "cpu", t=t), params)
    for axis in cam.generic_axes(m, position, params):
        assert axis.dtype == torch.float32 and axis.shape == (4,)
        assert torch.isfinite(axis).all()


def test_the_cpu_takes_the_eager_path_and_counts_it(recorder):
    camera = cell_camera(azimuths(1)[0], "cpu")
    with profiling.frame("cpu"):
        _, _, _, got, ref = tetrads("kerr_boyer", camera)
    assert torch.equal(got, ref)
    (f,) = recorder.recent_frames()
    assert f.counters == {"camera_eager": 1}


def test_a_gradient_keeps_the_eager_path_and_flows():
    """Grad mode with the position, the speed or a parameter requiring grad
    asks for the eager twin whatever the device; without grad mode nothing
    does.  Through the twin the tetrad differentiates by the spin."""
    m = metrics.get_metric("kerr_boyer")
    camera = cell_camera(0.4, "cpu", speed=[0.1, 0.0, -0.2])
    params = m.params()
    position = pl.camera_to_generic(m, camera, params)
    a = torch.tensor(params["a"], requires_grad=True)
    assert not raymarch.asks_for_grad(position, camera.basis_speed,
                                      params=params)
    assert raymarch.asks_for_grad(position, None, params={**params, "a": a})
    for t in (position, camera.basis_speed):
        assert raymarch.asks_for_grad(t.clone().requires_grad_(), None,
                                      params=params)
    with torch.no_grad():
        assert not raymarch.asks_for_grad(position, None,
                                          params={**params, "a": a})
    es = cam.observer_tetrad(m, position, {**params, "a": a},
                             camera.basis_speed)
    (grad,) = torch.autograd.grad(es[0].sum(), a)
    assert torch.isfinite(grad) and grad != 0


def test_a_frame_override_camera_computes_no_tetrad(recorder):
    """A camera on a recorded geodesic hands back its own position and
    tetrad: no eager twin, no kernel."""
    m = metrics.get_metric("schwarzschild")
    pos, es = torch.arange(4.0), torch.eye(4)
    camera = cell_camera(0.0, "cpu").on_geodesic(pos, es)
    with profiling.frame("cpu"):
        got = pl.camera_frame(m, camera, m.params())
    assert got[0] is pos and got[1] is es
    (f,) = recorder.recent_frames()
    assert f.counters == {}


def test_the_wrapper_refuses_cpu_tensors():
    m = metrics.get_metric("kerr_boyer")
    params = m.params()
    position = pl.camera_to_generic(m, cell_camera(0.0, "cpu"), params)
    axes = cam.generic_axes(m, position, params)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        raymarch.observer_tetrad_cuda(m, position, axes, params)


def test_the_bench_line_prints_the_camera_kernel_share():
    f = profiling.Frame(0, counters={"launches": 1, "render_data_kernel": 1,
                                     "camera_kernel": 1, "camera_eager": 1})
    assert profiling.describe(f) == (
        "Stages (host / device ms): ; launches 1; render_data_kernel 1 of 1"
        "; camera_kernel 1 of 2")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,seed", [("kerr_boyer", 21),
                                       ("schwarzschild", 22),
                                       ("double_kerr", 23),
                                       ("schwarzschild_ingoing_ef", 24),
                                       ("kerr_ingoing_ef", 25),
                                       ("misner_4d", 26)])
def test_kernel_equals_eager_at_the_cells_cameras(cuda, recorder, name,
                                                  seed):
    """The benchmark cells' cameras at three seeded azimuths (the two-body
    metric's in its cylindrical chart), Kerr's also inside its ergosphere
    (the frame basis' second pass) and with a frame 3-speed, and the same
    cameras in the charts whose one-point jvp comes out in float64: the
    kernel's tetrad is the eager twin's bit for bit, and each call counts
    one kernel call."""
    turns, t = azimuths(seed), 0.0
    if name == "misner_4d":
        # Misner's chart needs x > t: at t = -2, off its branch cut, and
        # on the side of the hole where x >= 0.
        turns, t = [a / 2 for a in turns], -2.0
    cameras = [cell_camera(a, cuda, t=t) for a in turns]
    if name == "kerr_boyer":
        cameras += [cell_camera(0.3, cuda, r=0.8),
                    cell_camera(1.0, cuda, speed=[-0.3, 0.1, 0.2])]
    with profiling.frame(cuda):
        for camera in cameras:
            *_, got, ref = tetrads(name, camera)
            assert torch.isfinite(ref).all()
            assert same_bits(got, ref), (name, camera.polar_position)
    (f,) = recorder.recent_frames()
    assert f.counters == {"camera_kernel": len(cameras)}


def test_a_dense_card_frame_takes_the_kernel_once(cuda, recorder):
    """Every dense frame on the card computes its camera by one kernel
    launch (``camera_kernel`` 1, no ``camera_eager``), from that frame's
    camera: two frames of different azimuths get different tetrads."""
    m = metrics.get_metric("kerr_boyer")
    sky = bg.checker_background(64, 128, device=cuda)
    settings = pl.RenderSettings(width=64, height=36,
                                 trace=integrate.TraceOptions(max_steps=512))
    for azimuth in (0.0, 1.0):
        pl.render_frame(m, cell_camera(azimuth, cuda), m.params(), sky,
                        settings, device=cuda)
    frames = recorder.recent_frames()
    assert [f.counters.get("camera_kernel") for f in frames] == [1, 1]
    assert all("camera_eager" not in f.counters for f in frames)
    a, b = (pl.camera_frame(m, cell_camera(z, cuda), m.params())[1]
            for z in (0.0, 1.0))
    assert not torch.equal(a, b)


def test_the_card_runs_a_gradient_eager_and_refuses_no_instance(cuda,
                                                              recorder):
    """A parameter or the position requiring grad takes the eager twin on
    the card, and a gradient flows; a metric whose config differs from its
    kernel instance's raises, as the march does."""
    m = metrics.get_metric("kerr_boyer")
    camera = cell_camera(0.7, cuda)
    params = m.params()
    position = pl.camera_to_generic(m, camera, params)
    a = torch.tensor(params["a"], device=cuda, requires_grad=True)
    other = dataclasses.replace(
        m, config=dataclasses.replace(m.config, singular=True))
    with profiling.frame(cuda):
        es_a = cam.observer_tetrad(m, position, {**params, "a": a})
        es_x = cam.observer_tetrad(m, position.clone().requires_grad_(),
                                   params)
        with pytest.raises(NotImplementedError):
            cam.observer_tetrad(other, position, params)
        es = cam.observer_tetrad(m, position, params)
    assert es_a.requires_grad and es_x.requires_grad
    assert not es.requires_grad
    (grad,) = torch.autograd.grad(es_a[0].sum(), a)
    assert torch.isfinite(grad)
    assert same_bits(es, cam.observer_tetrad_reference(m, position, params))
    (f,) = recorder.recent_frames()
    assert f.counters == {"camera_eager": 2, "camera_kernel": 1}
