"""Port parity, the adaptive frame as a whole: 64x64 ``kerr_boyer`` frames
through ``render_frame`` of the port against the JAX package's and against
the port's own dense frame, the budget controller over a frame stream, and
the CLI (CPU).

Against JAX (``method="while"``), both finish paths: sRGB uint8 RMSE under
1.0 of 255 and under 0.5% of pixels off by more than 32 (float32 differences
move single texels at checker edges and photon-ring rays).  Against the dense
frame: the thresholds of the JAX package's own tests of its adaptive path
(``tests/test_adaptive.py``), unchanged; where those tests render
``schwarzschild`` (traced in planar mode, which is not ported) these render
``kerr_boyer``.

The eager march is slow on a CPU, so every march is made once: a module
fixture keeps the marched states by the bytes of their launch state, and the
frames that share a launch (the dense frame at two anisotropies, the prepass
and the quarter grid of every adaptive frame) share its result.
"""

import dataclasses
import hashlib
import math

import numpy as np
import pytest
import torch

import imageio.v3 as iio

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.ops.integrate import TraceOptions as JTrace
from geodesic_raytracing_tpu.render import background as jbg
from geodesic_raytracing_tpu.render import colour as jcolour
from geodesic_raytracing_tpu.render import pipeline as jpl
from geodesic_raytracing_tpu_torch import bench_config, cli
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.ops import integrate
from geodesic_raytracing_tpu_torch.ops.integrate import TraceOptions
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render import colour
from geodesic_raytracing_tpu_torch.render import pipeline as pl

torch.set_num_threads(1)

STEPS = 2048


@pytest.fixture(scope="module", autouse=True)
def marches():
    """Every distinct launch of this module is marched once.  Yields the
    list of launches made: (rays, rays born DEAD) each."""
    trace_rays = integrate.trace_rays
    done, log = {}, []

    def once(metric, state, params, features=integrate.Features(),
             opts=TraceOptions(), image_width=None):
        h = hashlib.sha1()
        for t in (state.position, state.velocity, state.status):
            h.update(t.numpy().tobytes())
        key = (h.hexdigest(), opts, tuple(features))
        if key not in done:
            done[key] = trace_rays(metric, state, params, features, opts,
                                   image_width)
        log.append((state.status.numel(),
                    int((state.status == integrate.DEAD).sum())))
        return integrate.RayState(*(t.clone() for t in done[key]))

    integrate.trace_rays = once
    try:
        yield log
    finally:
        integrate.trace_rays = trace_rays


def _scene():
    m = tmetrics.get_metric("kerr_boyer")
    cam = Camera.default(device="cpu").rotate(pitch=-math.pi / 2)
    return m, cam, m.params(), bg.checker_background(128, 256, device="cpu")


def _settings(anisotropy=2, **kw):
    return pl.RenderSettings(width=64, height=64, anisotropy=anisotropy,
                             trace=TraceOptions(max_steps=STEPS), **kw)


def _frame(settings, controller=None):
    m, cam, params, sky = _scene()
    return pl.render_frame(m, cam, params, sky, settings,
                           controller=controller, device="cpu").numpy()


def _frames(anisotropy=2, **adaptive_kw):
    """(dense, adaptive) frames, as ``_frames`` of tests/test_adaptive.py."""
    adaptive_kw.setdefault("shade_traced_only", False)
    return (_frame(_settings(anisotropy)),
            _frame(_settings(anisotropy, adaptive_sampling=True,
                             **adaptive_kw)))


def _u8(srgb):
    return (np.clip(np.asarray(srgb), 0, 1) * 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shade_traced_only", [True, False])
def test_adaptive_frame_matches_jax(shade_traced_only):
    jm = jmetrics.get_metric("kerr_boyer")
    jimg = jpl.render_frame(
        jm, JCamera.default().rotate(pitch=-np.pi / 2), jm.params(),
        jbg.checker_background(128, 256),
        jpl.RenderSettings(width=64, height=64, anisotropy=2,
                           adaptive_sampling=True,
                           shade_traced_only=shade_traced_only,
                           trace=JTrace(max_steps=STEPS, method="while")))
    img = _frame(_settings(adaptive_sampling=True,
                           shade_traced_only=shade_traced_only))
    assert img.shape == (64, 64, 3) and np.isfinite(img).all()
    ours = _u8(colour.lin_to_srgb(torch.from_numpy(img)))
    theirs = _u8(jcolour.lin_to_srgb(jimg))
    assert ours.max() > 0 and (ours.sum(-1) == 0).any()  # sky and shadow
    d = np.abs(ours.astype(int) - theirs.astype(int))
    rmse, bad = float(np.sqrt((d.astype(float) ** 2).mean())), float(
        (d > 32).mean())
    print(f"shade_traced_only={shade_traced_only}: sRGB RMSE {rmse:.4f}, "
          f"pixels off by >32 {bad:.5f}, max linear difference "
          f"{np.abs(img - np.asarray(jimg)).max():.3g}")
    assert rmse < 1.0, rmse
    assert bad < 0.005, bad


# ---------------------------------------------------------------------------
# Against the dense frame: the reference's own tests of its adaptive path
# ---------------------------------------------------------------------------

def test_adaptive_matches_dense_kerr():
    dense, adap = _frames()
    assert np.isfinite(adap).all()
    # Refined/traced pixels are exact; interpolated ones sit below the
    # angular threshold, so the images must agree except on a small
    # fraction of edge pixels.
    d = np.abs(dense - adap).max(axis=-1)
    assert (d > 0.1).mean() < 0.06, (d > 0.1).mean()
    assert np.median(d) < 1e-3


def test_adaptive_full_budget_kerr():
    """The reference's test renders ``schwarzschild`` (planar mode, not
    ported); ``kerr_boyer`` here."""
    dense, adap = _frames(refine_budget=1.0)
    d = np.abs(dense - adap).max(axis=-1)
    # Full budget: every block refines -> odd/even-offset pixels traced
    # exactly; only interpolated-but-below-threshold cells may differ.
    assert (d > 0.1).mean() < 0.05, (d > 0.1).mean()


def test_traced_only_shading_corners_exact():
    """shade_traced_only: quarter corners and refined pixels are shaded off
    their own traced render data, so at anisotropy 1 (no probe-budget
    prefix, whose membership legitimately differs between the full-res and
    per-set pixel orderings) they must match the dense render wherever the
    dense path agrees with the data-interpolating adaptive path."""
    dense, adap = _frames(anisotropy=1, shade_traced_only=True)
    assert np.isfinite(adap).all()
    # Tolerance: the corner's EWA lod uses the quarter-grid derivative
    # (halved), the dense render its true full-res neighbour: a small lod
    # delta under trilinear blending, never a structural difference.
    corners = np.abs(dense[0::2, 0::2] - adap[0::2, 0::2]).max(axis=-1)
    assert (corners > 0.05).mean() < 0.03, (corners > 0.05).mean()
    # Interpolated pixels are bilinear RGB blends of the quarter corners:
    # softer on hard texture edges, never structurally wrong: the mean error
    # stays small and the median pixel is exact.
    d = np.abs(dense - adap).max(axis=-1)
    assert np.median(d) < 0.01
    assert d.mean() < 0.06, d.mean()


def test_traced_only_black_mask_semantics():
    """Interpolated pixels take the block centre's terminated flag
    (cl.cl:5111-5133): inside the shadow every pixel must be black in both
    paths.  (``kerr_boyer`` for the reference test's ``schwarzschild``.)"""
    dense, adap = _frames(anisotropy=1, shade_traced_only=True)
    black_d = (dense.max(axis=-1) == 0.0)
    black_a = (adap.max(axis=-1) == 0.0)
    assert 0.05 < black_d.mean() < 0.6
    # Shadow interiors agree; only block-boundary pixels may differ.
    disagree = black_d != black_a
    assert disagree.mean() < 0.02, disagree.mean()


def test_refine_budget_controller_render_stream():
    """A controlled frame stream renders identically to the fixed budget
    when the settled bucket covers the frame's demand.
    (``kerr_boyer`` for the reference test's ``schwarzschild``.)"""
    settings = _settings(adaptive_sampling=True)
    ref = _frame(settings)

    c = pl.RefineBudgetController(latency=0)
    last = None
    for _ in range(3):
        last = _frame(settings, controller=c)
    assert c.fraction(1.0) in c.BUCKETS
    # The settled render must stay finite and close to the full-budget one
    # (identical when demand fits the bucket; interpolated otherwise).
    assert np.isfinite(last).all()
    assert np.abs(last - ref).mean() < 0.01


# ---------------------------------------------------------------------------
# Frame streams: prepass reuse
# ---------------------------------------------------------------------------

@pytest.fixture()
def prepass_calls(monkeypatch):
    calls = []
    real = pl._prepass_dead_map

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)

    monkeypatch.setattr(pl, "_prepass_dead_map", counting)
    return calls


@pytest.mark.parametrize("shade_traced_only", [True, False])
def test_identical_stream_skips_the_prepass(prepass_calls, marches,
                                            shade_traced_only):
    """Three frames from the same camera / params / features objects: the
    prepass runs once, frames 2 and 3 take their kill mask from the frame
    before (3, then 2 launches a frame) and equal frame 1."""
    m, cam, params, sky = _scene()
    feats = integrate.Features.for_metric(m)
    settings = _settings(adaptive_sampling=True,
                         shade_traced_only=shade_traced_only)
    c = pl.RefineBudgetController()
    frames, launches = [], []
    for _ in range(3):
        before = len(marches)
        frames.append(pl.render_frame(m, cam, params, sky, settings, feats,
                                      controller=c, device="cpu").numpy())
        launches.append(len(marches) - before)
    assert len(prepass_calls) == 1
    assert launches == [3, 2, 2]
    np.testing.assert_array_equal(frames[1], frames[0])
    np.testing.assert_array_equal(frames[2], frames[0])
    assert c.qsteps.shape == c.rsteps.shape == c.qterm.shape == (32 * 32,)
    # The reused kill mask skips shadow rays, the 4x4 prepass none.
    assert marches[-2][1] > 0 and marches[-2][0] == 32 * 32


def test_rebuilt_camera_reruns_the_prepass(prepass_calls):
    m, _, params, sky = _scene()
    feats = integrate.Features.for_metric(m)
    settings = _settings(adaptive_sampling=True)
    c = pl.RefineBudgetController()
    frames = []
    for _ in range(3):
        cam = Camera.default(device="cpu").rotate(pitch=-math.pi / 2)
        frames.append(pl.render_frame(m, cam, params, sky, settings, feats,
                                      controller=c, device="cpu").numpy())
    assert len(prepass_calls) == 3
    np.testing.assert_array_equal(frames[2], frames[0])


def test_no_controller_runs_the_prepass_every_frame(prepass_calls):
    for _ in range(2):
        _frame(_settings(adaptive_sampling=True))
    assert len(prepass_calls) == 2


# ---------------------------------------------------------------------------
# The flagship settings and the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("controlled", [False, True])
@pytest.mark.parametrize("shade_traced_only", [True, False])
def test_flagship_settings_render_unchanged(shade_traced_only, controlled):
    """``flagship_config`` as it comes (adaptive, traced-only shading,
    production probe schedules), cut only in size and depth, and its
    ``shade_traced_only=False`` twin, with and without a controller."""
    metric, params, camera, settings, feats = bench_config.flagship_config(
        64, 36, device="cpu")
    assert settings.adaptive_sampling and settings.shade_traced_only
    settings = dataclasses.replace(
        settings, shade_traced_only=shade_traced_only,
        trace=TraceOptions(max_steps=512))
    c = pl.RefineBudgetController() if controlled else None
    img = pl.render_frame(metric, camera, params,
                          bg.checker_background(128, 256, device="cpu"),
                          settings, feats, controller=c, device="cpu")
    assert img.shape == (36, 64, 3) and bool(torch.isfinite(img).all())
    black = float((img == 0).all(dim=-1).float().mean())
    assert 0.10 <= black <= 0.60, black
    if controlled:
        assert c.rsteps is not None and c.stream_key is not None


def test_cli_adaptive_frame_and_bench(tmp_path, capsys):
    """``--adaptive`` writes the frame ``render_frame`` returns for the
    CLI's settings; ``--bench --adaptive`` prints one line per timed frame
    after its four warm frames."""
    out = tmp_path / "kerr.png"
    args = ["--width", "24", "--height", "16", "--pitch", "-90",
            "--max-steps", "128", "--device", "cpu", "--adaptive"]
    assert cli.main(["--metric", "kerr_boyer", *args, "--out", str(out)]) == 0
    m, cam, params, _ = _scene()
    img = pl.render_frame(
        m, cam, params, bg.checker_background(device="cpu"),
        pl.RenderSettings(width=24, height=16, anisotropy=8,
                          adaptive_sampling=True,
                          trace=TraceOptions(max_steps=128)), device="cpu")
    np.testing.assert_array_equal(iio.imread(out),
                                  _u8(colour.lin_to_srgb(img)))
    capsys.readouterr()
    assert cli.main(["--bench", "kerr_boyer", "--frames", "2", *args]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert len([ln for ln in lines
                if ln.startswith("Frametime Elapsed: ")]) == 2
