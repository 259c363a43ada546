"""Which path ``compute_render_data`` takes, and the render-data kernel on
the card against its eager twin.

On the CPU every call takes the eager path (``compute_render_data_reference``)
and counts ``render_data_eager``; the rule that sends a call that asks for a
gradient to the eager path on the card too is tested through its predicate
(``raymarch.asks_for_grad``).  The tests that take a fixture ``cuda`` need a
CUDA device and skip without one: there the kernel equals the eager path bit for
bit on the 3840x2160 final states of the benchmark's three configurations
(the two-body metric's in its cylindrical chart) and on an adaptive frame's
quarter and refine sets, each call counts one
``render_data_kernel``, a gradient takes the eager path and a metric without
a kernel instance raises.  Run them on the card with

    python -m pytest --noconftest tests/test_torch_render_data_dispatch.py

(this file imports no JAX; ``tests/conftest.py`` does).
"""

import dataclasses
import math

import pytest
import torch

from geodesic_raytracing_tpu_torch import bench_config, metrics
from geodesic_raytracing_tpu_torch.camera import Camera
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
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(a) & torch.isnan(b)
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | nan).all())


def assert_same_render_data(got, ref):
    for field in pl.RenderData._fields:
        assert same_bits(getattr(got, field), getattr(ref, field)), field


def marched(name, width, height, device, max_steps=None):
    """``(metric, params, features, final, ku, inv_quat)``: the dense frame
    of ``bench_config.flagship_config`` for ``name`` marched."""
    m, params, cam, settings, feats = bench_config.flagship_config(
        width, height, device=device, metric=name)
    settings = dataclasses.replace(settings, adaptive_sampling=False)
    if max_steps is not None:
        settings = dataclasses.replace(
            settings, trace=integrate.TraceOptions(max_steps=max_steps))
    state, ku, iquat = pl.init_camera_rays(m, cam, params, settings, feats,
                                           device=device)
    final = integrate.trace_rays(m, state, params, feats,
                                 pl._trace_opts(m, settings),
                                 image_width=width)
    return m, params, feats, final, ku, iquat


@pytest.mark.parametrize("name", ["kerr_boyer", "schwarzschild"])
def test_the_cpu_takes_the_eager_path_and_counts_it(recorder, name):
    m, params, feats, final, ku, iquat = marched(name, 16, 12, "cpu", 64)
    assert not raymarch.asks_for_grad(*final, ku, iquat, params=params)
    with profiling.frame("cpu"):
        got = pl.compute_render_data(m, final, ku, params, feats, iquat)
    ref = pl.compute_render_data_reference(m, final, ku, params, feats,
                                           iquat)
    assert_same_render_data(got, ref)
    (f,) = recorder.recent_frames()
    assert f.counters == {"render_data_eager": 1}


def test_a_gradient_keeps_the_eager_path():
    """Grad mode with a parameter, the launch energy or the quaternions
    requiring grad sends the call to the eager path whatever the device (so
    on the card too); without grad mode the device decides."""
    m, params, feats, final, ku, iquat = marched("schwarzschild", 8, 4,
                                                 "cpu", 16)
    rs = torch.tensor(params["rs"], requires_grad=True)
    assert raymarch.asks_for_grad(*final, ku, iquat, params={"rs": rs})
    for k, q in ((ku.clone().requires_grad_(), iquat),
                 (ku, iquat.clone().requires_grad_())):
        assert raymarch.asks_for_grad(*final, k, q, params=params)
    with torch.no_grad():
        assert not raymarch.asks_for_grad(*final, ku, iquat,
                                          params={"rs": rs})


def test_the_wrapper_refuses_cpu_tensors():
    m, params, feats, final, ku, _ = marched("kerr_boyer", 4, 2, "cpu", 8)
    pos = final.position.T
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        raymarch.render_data_cuda(m, final, ku, pos, final.velocity.T,
                                  params, feats)


def test_the_bench_line_prints_the_kernel_share():
    f = profiling.Frame(0, counters={"launches": 3, "render_data_kernel": 2,
                                     "render_data_eager": 1,
                                     "refine_share": 0.5})
    assert profiling.describe(f) == (
        "Stages (host / device ms): ; launches 3; render_data_kernel 2 of 3"
        "; refine_share 0.5")


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["kerr_boyer", "schwarzschild"])
def test_kernel_equals_eager_on_2160_frames(cuda, recorder, name):
    """The benchmark configurations' 3840x2160 dense frames (Kerr 4-D,
    planar Schwarzschild with its quaternions), every ray."""
    m, params, feats, final, ku, iquat = marched(name, 3840, 2160, cuda)
    assert not raymarch.asks_for_grad(*final, ku, iquat, params=params)
    assert (iquat is not None) == (name == "schwarzschild")
    with profiling.frame(cuda):
        got = pl.compute_render_data(m, final, ku, params, feats, iquat)
    ref = pl.compute_render_data_reference(m, final, ku, params, feats,
                                           iquat)
    assert_same_render_data(got, ref)
    (f,) = recorder.recent_frames()
    assert f.counters == {"render_data_kernel": 1}


def test_kernel_equals_eager_on_the_double_kerr_2160_frame(cuda, recorder):
    """The benchmark's ``double_kerr_binary`` frame at 3840x2160 (two Kerr
    holes on a strut, the flagship camera at azimuth 0), every ray: the
    cylindrical chart's eager transform before the kernel, the complex-pair
    metric in the kernel's two-pass frame basis.  The call counts one
    kernel call and one eager chart transform."""
    m, params, feats, final, ku, iquat = marched("double_kerr", 3840, 2160,
                                                 cuda)
    assert iquat is None and m.config.to_polar == "cylindrical_to_polar"
    with profiling.frame(cuda):
        got = pl.compute_render_data(m, final, ku, params, feats, iquat)
    ref = pl.compute_render_data_reference(m, final, ku, params, feats,
                                           iquat)
    assert_same_render_data(got, ref)
    # Both fates reach the frame basis.
    st = ref.terminated
    assert (st == integrate.ESCAPED).any() and (st == integrate.DEAD).any()
    (f,) = recorder.recent_frames()
    assert f.counters == {"render_data_kernel": 1, "chart_eager": 1}
    assert [s.name for s in f.spans] == ["frame", "chart"]


def test_kernel_equals_eager_on_adaptive_sets(cuda, recorder, monkeypatch):
    """An adaptive 960x540 Kerr frame and its successor (prepass reused):
    every render data call (the quarter grid, the refine set) equals the
    eager path on the same inputs, and each counts one kernel call."""
    calls = []
    real = pl.compute_render_data

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, kwargs, out))
        return out

    monkeypatch.setattr(pl, "compute_render_data", record)
    m, params, cam, settings, feats = bench_config.flagship_config(
        960, 540, device=cuda)
    sky = bg.checker_background(64, 128, device=cuda)
    controller = pl.RefineBudgetController()
    for _ in range(2):
        pl.render_frame(m, cam, params, sky, settings, feats,
                        controller=controller, device=cuda)
    frames = recorder.recent_frames()
    assert [f.counters.get("render_data_kernel") for f in frames] == [2, 2]
    assert all("render_data_eager" not in f.counters for f in frames)
    assert len(calls) == 4
    refine_sizes = set()
    for args, kwargs, out in calls:
        ref = pl.compute_render_data_reference(*args, **kwargs)
        assert_same_render_data(out, ref)
        refine_sizes.add(args[1].position.shape[0])
    assert len(refine_sizes) >= 2  # the quarter grid and a refine set


def test_the_card_runs_a_gradient_eager_and_refuses_no_instance(cuda,
                                                              recorder):
    """A parameter that requires grad takes the eager path on the card, and
    the frame counts it; a metric whose config differs from its kernel
    instance's raises, as the march does, and counts nothing."""
    m, params, feats, final, ku, iquat = marched("kerr_boyer", 64, 36, cuda,
                                                 512)
    rs = torch.tensor(params["rs"], device=cuda, requires_grad=True)
    other = dataclasses.replace(
        m, config=dataclasses.replace(m.config, singular=True))
    with profiling.frame(cuda):
        a = pl.compute_render_data(m, final, ku, {**params, "rs": rs}, feats)
        with pytest.raises(NotImplementedError):
            pl.compute_render_data(other, final, ku, params, feats)
        c = pl.compute_render_data(m, final, ku, params, feats)
    assert a.z_shift.requires_grad and not c.z_shift.requires_grad
    assert_same_render_data(
        c, pl.compute_render_data_reference(m, final, ku, params, feats))
    (f,) = recorder.recent_frames()
    assert f.counters == {"render_data_eager": 1, "render_data_kernel": 1}


def test_a_camera_frame_on_the_card_counts_one_kernel_call(cuda, recorder):
    m = metrics.get_metric("schwarzschild")
    cam = Camera.default(device=cuda).rotate(pitch=-math.pi / 2)
    sky = bg.checker_background(64, 128, device=cuda)
    settings = pl.RenderSettings(width=64, height=36,
                                 trace=integrate.TraceOptions(max_steps=512))
    pl.render_frame(m, cam, m.params(), sky, settings, device=cuda)
    (f,) = recorder.recent_frames()
    assert f.counters == {"launches": 1, "render_data_kernel": 1,
                          "camera_kernel": 1, "launch_state_kernel": 1}
