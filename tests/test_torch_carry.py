"""Carrying state from the JAX reference into the PyTorch port: the sky
atlas words are bit-identical, parameters and cameras carry unchanged
(CPU).  Exact comparisons: these are copies and integer packing, not
arithmetic, except the camera quaternion (a few float32 trig ops, rtol
1e-6)."""

import math

import numpy as np
import pytest
import torch

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.render import background as jbg
from geodesic_raytracing_tpu_torch import carry
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.render import background as bg

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
        tmetrics.get_metric("schwarzschild")


def test_camera_carry():
    jc = JCamera.default().rotate(pitch=-np.pi / 2)
    tc = Camera.default(device="cpu").rotate(pitch=-math.pi / 2)
    carried = carry.camera_from_jax(jc, device="cpu")
    for a, b in zip(carried, tc):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_array_equal(carried.quat.numpy(), np.asarray(jc.quat))
