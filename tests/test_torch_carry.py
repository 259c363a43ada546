"""Carrying state from the JAX reference into the PyTorch port: the sky
atlas words are bit-identical, parameters, cameras, render settings and ray
states (with their planar quaternions) carry unchanged (CPU).  Exact comparisons: these are copies and integer packing, not
arithmetic, except the camera quaternion (a few float32 trig ops, rtol
1e-6)."""

import math

import numpy as np
import pytest
import torch

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.ops import integrate as jint
from geodesic_raytracing_tpu.render import pipeline as jpl
from geodesic_raytracing_tpu.render import background as jbg
from geodesic_raytracing_tpu_torch import carry
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.ops import integrate as tint
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render import pipeline as pl

torch.set_num_threads(1)


def _words(t):
    return t.numpy().view(np.uint32)


def _assert_same_atlas(ours, theirs):
    np.testing.assert_array_equal(_words(ours.packed),
                                  np.asarray(theirs.packed))
    np.testing.assert_array_equal(_words(ours.quad), np.asarray(theirs.quad))
    assert (ours.level_w, ours.level_h, ours.level_x) == (
        theirs.level_w, theirs.level_h, theirs.level_x)
    assert ours.pow2 == theirs.pow2


@pytest.mark.parametrize("shape", [(64, 128), (48, 80)])
def test_atlas_words_equal_jax(shape):
    """A seeded two-sided image, power-of-two and not."""
    rng = np.random.default_rng(shape[0])
    img = rng.uniform(0.0, 1.0, shape + (3,)).astype(np.float32)
    img2 = rng.uniform(0.0, 1.0, shape + (3,)).astype(np.float32)
    _assert_same_atlas(bg.build_background(img, img2, device="cpu"),
                       jbg.build_background(img, img2))


def test_checker_atlas_and_carry_equal_jax():
    theirs = jbg.checker_background()
    _assert_same_atlas(bg.checker_background(device="cpu"), theirs)
    _assert_same_atlas(carry.background_from_jax(theirs, device="cpu"), theirs)


def test_params_carry():
    jm = jmetrics.get_metric("kerr_boyer")
    tm = tmetrics.get_metric("kerr_boyer")
    assert carry.params_from_jax(jm.params()) == tm.params()
    over = carry.params_from_jax(jm.params(a=0.9, rs=1.3))
    assert over == tm.params(a=0.9, rs=1.3)
    assert over["a"] == float(np.float32(0.9))
    with pytest.raises(KeyError):
        tm.params(q=1.0)
    with pytest.raises(KeyError):
        tmetrics.get_metric("alcubierre")


def test_camera_carry():
    jc = JCamera.default().rotate(pitch=-np.pi / 2)
    tc = Camera.default(device="cpu").rotate(pitch=-math.pi / 2)
    carried = carry.camera_from_jax(jc, device="cpu")
    assert carried.frame_override is None and tc.frame_override is None
    for a, b in zip(carried[:3], tc[:3]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(carried.quat.numpy(), np.asarray(jc.quat))
    # A camera on a geodesic carries its (position, tetrad) frame.
    pos, tet = np.arange(4, dtype=np.float32), np.eye(4, dtype=np.float32)
    on = carry.camera_from_jax(jc.on_geodesic(pos, tet), device="cpu")
    np.testing.assert_array_equal(on.frame_override[0].numpy(), pos)
    np.testing.assert_array_equal(on.frame_override[1].numpy(), tet)


@pytest.mark.parametrize("name", sorted(tmetrics.REGISTRY))
def test_params_carry_every_ported_metric(name):
    """Parameters by name, for each ported metric."""
    jm, tm = jmetrics.get_metric(name), tmetrics.get_metric(name)
    assert carry.params_from_jax(jm.params()) == tm.params()
    assert set(tm.params()) == set(jm.defaults)


def test_settings_carry():
    js = jpl.RenderSettings(width=64, height=48, anisotropy=4, redshift=True,
                            old_redshift=True, spectral_redshift=False,
                            dominant_colour=True, planar=False,
                            adaptive_sampling=True, refine_budget=0.5,
                            probe_segments=((0.11, 7),),
                            trace=jint.TraceOptions(
                                max_steps=512, integrator="euler",
                                reparameterisation=True, method="pallas",
                                planar=True))
    ts = carry.settings_from_jax(js)
    assert ts == pl.RenderSettings(
        width=64, height=48, anisotropy=4, redshift=True, old_redshift=True,
        dominant_colour=True, planar=False, adaptive_sampling=True,
        refine_budget=0.5, probe_segments=((0.11, 7),),
        trace=tint.TraceOptions(max_steps=512, integrator="euler",
                                reparameterisation=True))
    # The defaults agree field for field, planar mode on.
    assert carry.settings_from_jax(jpl.RenderSettings()) == pl.RenderSettings()
    assert pl.RenderSettings().planar


def test_ray_state_carry_with_planar_quaternions():
    """JAX's planar rays of a small schwarzschild frame, handed to the
    port's march: same bits in, and the port's planar march on them ends
    as JAX's own does."""
    jm, tm = (g("schwarzschild") for g in (jmetrics.get_metric,
                                           tmetrics.get_metric))
    jf = jint.Features.for_metric(jm)
    settings = jpl.RenderSettings(width=8, height=8,
                                  trace=jint.TraceOptions(max_steps=1024))
    jst, jku, jq = jpl.init_camera_rays(
        jm, JCamera.default().rotate(pitch=-np.pi / 2), jm.params(), settings,
        jf)
    assert jq is not None and jq.shape == (4, 64)
    tst, tq = carry.ray_state_from_jax(jst, jq, device="cpu")
    for name in tint.RayState._fields:
        a, b = getattr(tst, name), np.asarray(getattr(jst, name))
        assert a.dtype in (torch.float32, torch.int32)
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert carry.ray_state_from_jax(jst, device="cpu")[1] is None
    jfin = jint.trace_rays(jm, jst, jm.params(), features=jf,
                           opts=jint.TraceOptions(max_steps=1024,
                                                  planar=True))
    tfin = tint.trace_rays(tm, tst, tm.params(),
                           tint.Features.for_metric(tm),
                           tint.TraceOptions(max_steps=1024, planar=True))
    np.testing.assert_array_equal(tfin.status.numpy(),
                                  np.asarray(jfin.status))
    np.testing.assert_array_equal(tfin.steps.numpy(), np.asarray(jfin.steps))
    np.testing.assert_allclose(tfin.position.numpy(),
                               np.asarray(jfin.position), rtol=1e-4,
                               atol=1e-4)
