"""Which path ``rays_for_pixels`` takes, and what it counts.

On the CPU every call takes the eager twin (``rays_for_pixels_reference``)
and counts ``launch_state_eager``; the rule that sends a call that asks for a
gradient to the twin on the card too is tested through its predicate
(``raymarch.asks_for_grad``) and a gradient through the twin.  The
``launch_state`` span stays inside the dense frame's ``ray_init``, and a
planar metric whose chart is not the identity counts the chart's eager
``to_planar`` (``chart_eager``) on either path.  The kernel against its twin
on the card is ``test_torch_launch_state_card.py``.
"""

import dataclasses
import math

import pytest
import torch

from geodesic_raytracing_tpu_torch import metrics
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render import pipeline as pl
from geodesic_raytracing_tpu_torch.utils import profiling

torch.set_num_threads(1)


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


def launch(name, width=16, height=12, device="cpu", planar=True):
    """``(metric, params, features, camera, settings, position, es, cx,
    cy)`` of a width x height frame from r = 7 pitched at the origin."""
    m = metrics.get_metric(name)
    params = m.params()
    camera = Camera.default(device=device).rotate(pitch=-math.pi / 2)
    settings = pl.RenderSettings(width=width, height=height, planar=planar)
    position, es = pl.camera_frame(m, camera, params)
    cx, cy = pl._grid_coords(width, height, 1.0, device)
    return (m, params, integrate.Features.for_metric(m), camera, settings,
            position, es, cx, cy)


@pytest.mark.parametrize("name", ["kerr_boyer", "schwarzschild",
                                  "double_kerr"])
def test_the_cpu_takes_the_eager_twin_and_counts_it(recorder, name):
    m, params, feats, camera, settings, position, es, cx, cy = launch(name)
    planar = pl._planar_enabled(m, settings)
    assert not raymarch.asks_for_grad(position, es, camera.quat,
                                      params=params)
    with profiling.frame("cpu"):
        got = pl.rays_for_pixels(m, camera, position, es, params, settings,
                                 feats, cx, cy, planar=planar)
    ref = pl.rays_for_pixels_reference(m, camera, position, es, params,
                                       settings, feats, cx, cy, planar)
    for g, r in zip((*got[0], got[1]), (*ref[0], ref[1])):
        assert same_bits(g, r)
    assert (got[2] is None) == (ref[2] is None) == (not planar)
    (f,) = recorder.recent_frames()
    assert f.counters == {"launch_state_eager": 1}


def test_a_gradient_keeps_the_eager_twin():
    """Grad mode with a parameter, the camera's position, its tetrad or its
    quaternion requiring grad asks for the twin whatever the device (so on
    the card too); without grad mode the device decides.  Through the twin
    the launch energy differentiates by the mass."""
    m, params, feats, camera, settings, position, es, cx, cy = launch(
        "schwarzschild", 8, 4)
    rs = torch.tensor(params["rs"], requires_grad=True)
    assert raymarch.asks_for_grad(position, es, camera.quat,
                                  params={"rs": rs})
    for i in range(3):
        ts = [position, es, camera.quat]
        ts[i] = ts[i].clone().requires_grad_()
        assert raymarch.asks_for_grad(*ts, params=params)
    with torch.no_grad():
        assert not raymarch.asks_for_grad(position, es, camera.quat,
                                          params={"rs": rs})
    state, ku, _ = pl.rays_for_pixels(m, camera, position, es, {"rs": rs},
                                      settings, feats, cx, cy, planar=True)
    (grad,) = torch.autograd.grad(ku.sum() + state.acceleration.sum(), rs)
    assert torch.isfinite(grad) and grad != 0


def test_the_launch_state_span_sits_inside_ray_init(recorder):
    """A dense frame's ray init has its two parts, the camera and every
    ray's launch state, as children; the launch state is counted once."""
    m = metrics.get_metric("kerr_boyer")
    camera = Camera.default(device="cpu").rotate(pitch=-math.pi / 2)
    sky = bg.checker_background(64, 128, device="cpu")
    settings = pl.RenderSettings(width=4, height=3, anisotropy=2,
                                 trace=integrate.TraceOptions(max_steps=4))
    pl.render_frame(m, camera, m.params(), sky, settings, device="cpu")
    (f,) = recorder.recent_frames()
    (ray_init,) = [s for s in f.spans if s.name == "ray_init"]
    (state,) = [s for s in f.spans if s.name == "launch_state"]
    assert state.parent is ray_init and ray_init.parent.name == "frame"
    assert [s.name for s in f.spans if s.parent is ray_init] == [
        "camera", "launch_state"]
    assert f.counters["launch_state_eager"] == 1
    assert "launch_state_kernel" not in f.counters


@pytest.mark.parametrize("name,planar,charts", [
    ("schwarzschild_ingoing_ef", True, 1),
    ("schwarzschild_ingoing_ef", False, 0),
    ("schwarzschild", True, 0),
    ("double_kerr", True, 0),
])
def test_a_planar_chart_that_is_not_the_identity_counts_chart_eager(
        recorder, name, planar, charts):
    """Only a planar launch in a chart that is not the identity takes the
    chart's eager ``to_planar`` (on the card before the kernel): the
    ingoing Eddington-Finkelstein chart in planar mode, not in 4-D, not the
    identity chart, not a metric that is not traced planar."""
    m, params, feats, camera, settings, position, es, cx, cy = launch(
        name, 4, 3, planar=planar)
    assert pl._identity_chart(m) == (name == "schwarzschild")
    with profiling.frame("cpu"):
        pl.rays_for_pixels(m, camera, position, es, params, settings, feats,
                           cx, cy, planar=pl._planar_enabled(m, settings))
    (f,) = recorder.recent_frames()
    assert f.counters.get("chart_eager", 0) == charts
    assert f.counters["launch_state_eager"] == 1


def test_the_wrapper_refuses_cpu_tensors_and_mixed_rays():
    m, params, feats, camera, settings, position, es, cx, cy = launch(
        "kerr_boyer", 4, 2)
    f_stop = torch.tensor(8.0)
    pixels = (cx, cy, 4, 2, f_stop, camera.quat)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        raymarch.launch_state_cuda(m, params, feats, position, es, sign=-1.0,
                                   pixels=pixels)
    generic = (position[:, None].expand(4, 8), es[1][:, None].expand(4, 8))
    for kw in ({}, {"pixels": pixels, "generic": generic}):
        with pytest.raises(ValueError, match="pixels or generic"):
            raymarch.launch_state_cuda(m, params, feats, position, es,
                                       sign=-1.0, **kw)


def test_an_unregistered_metric_raises_before_the_tensors():
    """A metric whose config differs from its kernel instance's raises, as
    the march does, before the wrapper looks at the tensors."""
    m, params, feats, camera, settings, position, es, cx, cy = launch(
        "kerr_boyer", 4, 2)
    other = dataclasses.replace(
        m, config=dataclasses.replace(m.config, singular=True))
    with pytest.raises(NotImplementedError):
        raymarch.launch_state_cuda(other, params, feats, position, es,
                                   sign=-1.0, generic=(cx, cy))


def test_the_bench_line_prints_the_kernel_share():
    f = profiling.Frame(0, counters={"launches": 1, "camera_kernel": 1,
                                     "launch_state_kernel": 2,
                                     "launch_state_eager": 1})
    assert profiling.describe(f) == (
        "Stages (host / device ms): ; launches 1; camera_kernel 1 of 1"
        "; launch_state_kernel 2 of 3")
