"""Port parity: whole frames of the PyTorch port against the JAX reference
and the checked-in golden, plus the grouping permutation and the CLI (CPU).

Images are compared with the golden gate of tests/test_parity_images.py on
sRGB uint8: RMSE < 4 and fewer than 1% of pixels off by more than 32 (fp
differences move isolated texels at checker edges and photon-ring rays;
real regressions blow past these).
"""

import math
import os
import sys

import numpy as np
import pytest
import torch

import imageio.v3 as iio
import jax.numpy as jnp

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.bench_config import PRODUCTION_PROBE_SEGMENTS
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.ops import packing as jpacking
from geodesic_raytracing_tpu.ops.integrate import Features as JFeatures
from geodesic_raytracing_tpu.ops.integrate import TraceOptions as JTrace
from geodesic_raytracing_tpu.render import background as jbg
from geodesic_raytracing_tpu.render import colour as jcolour
from geodesic_raytracing_tpu.render.pipeline import RenderSettings as JSettings
from geodesic_raytracing_tpu.render.pipeline import render_frame as jrender
from geodesic_raytracing_tpu_torch import cli
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.ops import packing
from geodesic_raytracing_tpu_torch.ops.integrate import Features, TraceOptions
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render import colour
from geodesic_raytracing_tpu_torch.render.pipeline import (
    RenderSettings,
    render_frame,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _u8(srgb):
    return (np.clip(np.asarray(srgb), 0, 1) * 255).astype(np.uint8)


def _gate(a, b):
    d = np.abs(a.astype(int) - b.astype(int))
    rmse = float(np.sqrt((d.astype(float) ** 2).mean()))
    bad = float((d > 32).mean())
    assert rmse < 4.0, rmse
    assert bad < 0.01, bad


def _port_frame(settings):
    m = tmetrics.get_metric("kerr_boyer")
    return render_frame(m, Camera.default().rotate(pitch=-math.pi / 2),
                        m.params(), bg.checker_background(), settings,
                        Features.for_metric(m), device="cpu")


def test_flagship_camera_frame_matches_jax():
    """A 64x36 frame of the flagship camera and settings (anisotropy 8,
    production probe segments, nearest mip level), non-adaptive, 4096
    steps, through both pipelines."""
    W, H, steps = 64, 36, 4096
    jm = jmetrics.get_metric("kerr_boyer")
    jimg = jrender(
        jm, JCamera.default().rotate(pitch=-np.pi / 2), jm.params(),
        jbg.checker_background(),
        JSettings(width=W, height=H, anisotropy=8,
                  probe_segments=PRODUCTION_PROBE_SEGMENTS, trilinear=False,
                  adaptive_sampling=False, trace=JTrace(max_steps=steps)),
        JFeatures.for_metric(jm))
    img = _port_frame(RenderSettings(
        width=W, height=H, anisotropy=8,
        probe_segments=PRODUCTION_PROBE_SEGMENTS, trilinear=False,
        trace=TraceOptions(max_steps=steps)))
    assert img.shape == (H, W, 3) and img.dtype == torch.float32
    ours = _u8(colour.lin_to_srgb(img))
    theirs = _u8(jcolour.lin_to_srgb(jimg))
    assert ours.max() > 0 and (ours.sum(-1) == 0).any()  # sky and shadow
    _gate(ours, theirs)


def test_kerr_boyer_catalogue_golden():
    """The 128^2 kerr_boyer scene of scripts/make_goldens.py (anisotropy 4,
    8192 steps, default trilinear settings) against the checked-in PNG."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import make_goldens

    name, params_over, sets_over, _ = make_goldens.scene_configs()[
        "kerr_boyer"][:4]
    assert name == "kerr_boyer" and not params_over and not sets_over
    img = _port_frame(RenderSettings(
        width=make_goldens.SIZE, height=make_goldens.SIZE, anisotropy=4,
        trace=TraceOptions(max_steps=8192)))
    golden = iio.imread(os.path.join(REPO, "tests/golden/catalogue/"
                                           "kerr_boyer.png"))
    _gate(_u8(colour.lin_to_srgb(img)), golden)


@pytest.mark.parametrize("n_buckets", [2, 9, 65])
def test_bucket_sort_perm_matches_jax(n_buckets):
    keys = np.random.default_rng(n_buckets).integers(
        0, n_buckets, 5000).astype(np.int32)
    jperm, jdest = jpacking.bucket_sort_perm(jnp.asarray(keys), n_buckets)
    perm, dest = packing.bucket_sort_perm(torch.from_numpy(keys))
    np.testing.assert_array_equal(perm.numpy(), np.asarray(jperm))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))


def test_cli_writes_the_frame(tmp_path):
    """The CLI on the CPU writes the frame render_frame returns as a PNG
    (standard-library writer), readable back bit for bit."""
    out = tmp_path / "kerr.png"
    rc = cli.main(["--metric", "kerr_boyer", "--width", "24", "--height",
                   "16", "--pitch", "-90", "--max-steps", "256",
                   "--device", "cpu", "--out", str(out)])
    assert rc == 0
    img = _port_frame(RenderSettings(width=24, height=16, anisotropy=8,
                                     trace=TraceOptions(max_steps=256)))
    np.testing.assert_array_equal(iio.imread(out),
                                  _u8(colour.lin_to_srgb(img)))
