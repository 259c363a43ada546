"""Port parity: the eight metrics of catalogue slice A, their three new
charts, ``geometry.arccos`` and the frame basis at Misner events, against
the JAX package (CPU).  Also the helpers the slice's march, frame and golden
tests share (``test_torch_metrics_catalogue_a_*.py``).

The same numpy events, made from a seed, go through both packages.
Tolerances: the metric and its partials rtol 1e-5 (atol 1e-6 for partials
that are a structural zero on one side and a rounding on the other); a
chart's transform, its inverse and both velocity push-forwards rtol 1e-5
and 1e-6 of the value's scale; ``arccos`` and its derivative in forward and
reverse mode rtol 1e-6; the frame basis at Misner events (g_TT = 0, so the
timelike leg is found by the swap passes) the same timelike index and legs
within 1e-5.
"""

import dataclasses
import functools
import math
import os
import sys

import numpy as np
import pytest
import torch

import imageio.v3 as iio
import jax
import jax.numpy as jnp

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.coordinates import transforms as jtr
from geodesic_raytracing_tpu.ops import geometry as jgeometry
from geodesic_raytracing_tpu.ops import integrate as jint
from geodesic_raytracing_tpu.ops import tetrad as jtetrad
from geodesic_raytracing_tpu.render import background as jbg
from geodesic_raytracing_tpu.render import colour as jcolour
from geodesic_raytracing_tpu.render import pipeline as jpl
from geodesic_raytracing_tpu_torch import carry, cli
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.coordinates import transforms as ttr
from geodesic_raytracing_tpu_torch.ops import geometry as tgeometry
from geodesic_raytracing_tpu_torch.ops import integrate as tint
from geodesic_raytracing_tpu_torch.ops import tetrad as ttetrad
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render import colour
from geodesic_raytracing_tpu_torch.render import pipeline as pl
from test_torch_raymarch_host import generic_rays

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CATALOGUE_A = ("wormhole (morris-thorne)", "black_hole_cosmic_string",
               "ernst", "kerr_newman_boyer", "kerr_ingoing_ef",
               "kerr_rational_polynomial", "misner_4d",
               "cosmic_string_spinning")


def _events(name, n=256, seed=0):
    """Seeded (4, n) events in the chart of metric ``name``: polar
    (t, r in [1.2, 25], theta, phi), with r of either sign through the
    wormhole's throat; X = cos(theta) in the rational chart; cylindrical
    (t, p, phi, z); Misner (T, phi, y, z)."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(-5, 5, n)
    r = np.exp(rng.uniform(np.log(1.2), np.log(25.0), n))
    th = rng.uniform(0.05, np.pi - 0.05, n)
    ph = rng.uniform(-np.pi, np.pi, n)
    if name.startswith("wormhole"):
        r = r * rng.choice([-1.0, 1.0], n)
    if name == "kerr_rational_polynomial":
        x = np.stack([t, r, np.cos(th), ph])
    elif name == "cosmic_string_spinning":
        x = np.stack([t, rng.uniform(0.1, 20, n), ph, rng.uniform(-20, 20, n)])
    elif name == "misner_4d":
        x = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                      *rng.uniform(-10, 10, (2, n))])
    else:
        x = np.stack([t, r, th, ph])
    return x.astype(np.float32)


# ---------------------------------------------------------------------------
# Helpers of the march, frame and golden tests
# ---------------------------------------------------------------------------

def u8(srgb):
    return (np.clip(np.asarray(srgb), 0, 1) * 255).astype(np.uint8)


def gate(a, b):
    """(sRGB RMSE, fraction of pixels off by more than 32) of two uint8
    images."""
    d = np.abs(a.astype(int) - b.astype(int))
    return float(np.sqrt((d.astype(float) ** 2).mean())), float(
        (d > 32).mean())


@functools.lru_cache(maxsize=None)
def scene(name):
    """The scene of scripts/make_goldens.py for ``name``: (params override,
    settings override, the JAX camera).  ``misner_4d``'s camera sits at
    t = -2 (its reference preset): at t = 0 the camera is on the branch cut
    of ``polar_to_misner_4d``."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import make_goldens

    key = name.replace(" ", "_").replace("(", "").replace(")", "")
    spec = make_goldens.scene_configs()[name]
    assert os.path.exists(os.path.join(REPO, "tests/golden/catalogue",
                                       f"{key}.png"))
    params_over, sets_over, camera = spec[1], spec[2], spec[3]
    assert not params_over and not sets_over and len(spec) == 4
    return key, camera


def march_both(name, planar=False, max_steps=4096):
    """(JAX final, port final) of the 64-ray set of ``generic_rays`` in the
    chart of ``name``, every 7th ray born DEAD, after holding the two launch
    states to each other."""
    jm, tm = jmetrics.get_metric(name), tmetrics.get_metric(name)
    pos, vel = (t.numpy() for t in generic_rays(tm, tm.params()))
    jf, tf = jint.Features.for_metric(jm), tint.Features.for_metric(tm)
    assert tuple(jf) == tuple(tf)
    jst = jint.init_ray_state(jm, jnp.asarray(pos), jnp.asarray(vel),
                              jm.params(), jf)
    tst = tint.init_ray_state(tm, torch.from_numpy(pos),
                              torch.from_numpy(vel), tm.params(), tf)
    jst = jst._replace(status=jst.status.at[::7].set(2))
    tst.status[::7] = tint.DEAD
    for field in ("position", "velocity", "acceleration", "next_ds"):
        np.testing.assert_allclose(getattr(tst, field).numpy(),
                                   np.asarray(getattr(jst, field)),
                                   rtol=1e-5, atol=1e-6, err_msg=field)
    jfin = jint.trace_rays(jm, jst, jm.params(), features=jf,
                           opts=jint.TraceOptions(max_steps=max_steps,
                                                  planar=planar))
    tfin = tint.trace_rays(tm, tst, tm.params(), tf,
                           tint.TraceOptions(max_steps=max_steps,
                                             planar=planar))
    return jfin, tfin


# A ray killed this close to r = 0 met the ring singularity.
SINGULAR_R = 0.05


def assert_march_parity(name, jfin, tfin, min_escaped=8):
    """Fates equal on every ray; step counts equal on every ray and escaped
    positions within 1e-4 (rtol and atol), except on two classes of
    ill-conditioned rays, where an ulp of the metric (JAX's ``c / x``
    against the port's ``c * recip(x)``, XLA's sin and cos against torch's)
    is amplified (ROADMAP Queue 3):

    * a ray the step controller kills within |r| < ``SINGULAR_R``, where
      1 / (r^2 + a^2 cos^2 theta) grows without bound: its step count within
      2% (``kerr_ingoing_ef``'s rays that cross its traversable horizon,
      killed at |r| 0.010-0.025: up to 4 of 325 steps apart on 11 of 36);
    * an escaped ray that takes more than 1.5 times the median step count of
      the escaped rays: it lingered near the photon sphere, where the last
      ulp grows by about a bit a step; its fate and step count only
      (``kerr_newman_boyer``'s rays next to its boundary ray, 831 and 797
      steps against a median of 480, end 0.39 and 2.2e-3 apart).

    At most 8 of the 64 rays may be so long."""
    m = tmetrics.get_metric(name)
    rs = np.asarray(jfin.status)
    np.testing.assert_array_equal(tfin.status.numpy(), rs)
    polar = m.to_polar(torch.from_numpy(np.asarray(jfin.position)).T,
                       m.params()).numpy()
    js, ts = np.asarray(jfin.steps), tfin.steps.numpy()
    singular = (rs == jint.DEAD) & (np.abs(polar[1]) < SINGULAR_R)
    np.testing.assert_array_equal(ts[~singular], js[~singular])
    assert (np.abs(ts - js)[singular] <= 0.02 * js[singular]).all()
    escaped = rs == jint.ESCAPED
    long_ = escaped & (js > 1.5 * np.median(js[escaped]))
    esc = escaped & ~long_
    assert esc.sum() >= min_escaped and long_.sum() <= 8, (esc.sum(),
                                                           long_.sum())
    np.testing.assert_allclose(tfin.position.numpy()[esc],
                               np.asarray(jfin.position)[esc], rtol=1e-4,
                               atol=1e-4)


FRAME = dict(width=64, height=64, anisotropy=2)
FRAME_STEPS = 2048


@functools.lru_cache(maxsize=None)
def jax_frame(name, adaptive=False):
    """JAX's 64x64 frame of the scene of ``name`` (``method="while"``,
    anisotropy 2, the 128x256 checker sky), dense or adaptive as
    tests/test_adaptive.py renders it (data-interpolating shading,
    ``shade_traced_only=False``), as linear RGB numpy."""
    jm = jmetrics.get_metric(name)
    _, camera = scene(name)
    return np.asarray(jpl.render_frame(
        jm, camera, jm.params(), jbg.checker_background(128, 256),
        jpl.RenderSettings(**FRAME, adaptive_sampling=adaptive,
                           shade_traced_only=False,
                           trace=jint.TraceOptions(max_steps=FRAME_STEPS,
                                                   method="while"))))


def port_frame(name, size=64, anisotropy=2, sky=(128, 256),
               max_steps=FRAME_STEPS):
    """The port's dense frame of the scene of ``name`` on the CPU."""
    tm = tmetrics.get_metric(name)
    _, camera = scene(name)
    return pl.render_frame(
        tm, carry.camera_from_jax(camera, device="cpu"), tm.params(),
        bg.checker_background(*sky, device="cpu"),
        pl.RenderSettings(width=size, height=size, anisotropy=anisotropy,
                          trace=tint.TraceOptions(max_steps=max_steps)),
        device="cpu")


def assert_frame_matches_jax(name):
    """The port's 64x64 frame against JAX's: sRGB uint8 RMSE under 0.5 of
    255 and under 0.5% of pixels off by more than 32 (float32 differences
    move single texels at checker edges and photon-ring rays)."""
    img = port_frame(name)
    assert img.shape == (64, 64, 3) and bool(torch.isfinite(img).all())
    ours = u8(colour.lin_to_srgb(img))
    theirs = u8(jcolour.lin_to_srgb(jax_frame(name)))
    assert ours.max() > 0
    rmse, bad = gate(ours, theirs)
    print(f"{name}: 64x64 sRGB RMSE {rmse:.4f}, pixels off by >32 {bad:.5f}")
    assert rmse < 0.5 and bad < 0.005, (rmse, bad)


def adaptive_pair_numbers(name):
    """(share of pixels whose largest channel differs by more than 0.1,
    median of that difference) of JAX's own adaptive 64x64 frame against its
    dense one: the numbers of the gate of tests/test_adaptive.py."""
    d = np.abs(jax_frame(name) - jax_frame(name, adaptive=True)).max(-1)
    return float((d > 0.1).mean()), float(np.median(d))


def assert_adaptive_pair(name):
    """JAX's own pair passes the gate chip_smoke.py holds the port's 1080p
    pair of the metric to (phase 26): fewer than 6% of pixels off by more
    than 0.1, median under 0.01 (tests/test_adaptive.py's thresholds)."""
    sys.path.insert(0, REPO)
    import chip_smoke

    off, med = adaptive_pair_numbers(name)
    print(f"{name}: JAX's adaptive vs dense 64x64 frame: off by >0.1 "
          f"{off:.5f}, median {med:.4g}")
    assert np.isfinite(jax_frame(name, adaptive=True)).all()
    assert off < chip_smoke.ADAPTIVE_MAX_OFF_FRAC, off
    assert med < chip_smoke.ADAPTIVE_MAX_MEDIAN, med


def assert_golden(name):
    """The 128^2 scene of scripts/make_goldens.py (anisotropy 4, 8192
    steps, the default 2048x1024 checker sky, the scene's camera) through
    the port's plain path against the checked-in PNG, with the golden gate
    of tests/test_parity_images.py: RMSE < 4, < 1% of pixels off by > 32."""
    key, _ = scene(name)
    img = port_frame(name, size=128, anisotropy=4, sky=(), max_steps=8192)
    path = os.path.join(REPO, "tests/golden/catalogue", f"{key}.png")
    golden = cli.read_png(path)
    np.testing.assert_array_equal(golden, iio.imread(path)[..., :3])
    rmse, bad = gate(u8(colour.lin_to_srgb(img)), golden)
    print(f"{key}: golden RMSE {rmse:.4f}, pixels off by >32 {bad:.5f}")
    assert rmse < 4.0 and bad < 0.01, (rmse, bad)


# ---------------------------------------------------------------------------
# Metrics, charts, arccos, frame basis
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CATALOGUE_A)
def test_metric_and_partials_match_jax(name):
    jm, tm = jmetrics.get_metric(name), tmetrics.get_metric(name)
    x = _events(name)
    jg, jd = jgeometry.metric_and_partials_batched(
        jm.fn, jnp.asarray(x), jm.params(), deps=jm.depends_on)
    tg, td = tgeometry.metric_and_partials_batched(
        tm.fn, torch.from_numpy(x), tm.params(), deps=tm.depends_on)
    jg = np.broadcast_to(np.asarray(jg).reshape(4, 4, -1), (4, 4, x.shape[1]))
    tg = np.broadcast_to(tg.numpy().reshape(4, 4, -1), (4, 4, x.shape[1]))
    np.testing.assert_allclose(tg, jg, rtol=1e-5, atol=0)
    for c in range(4):
        assert (td[c] is None) == (jd[c] is None) == (c not in tm.depends_on)
        if td[c] is not None:
            jdc = np.broadcast_to(np.asarray(jd[c]).reshape(4, 4, -1),
                                  (4, 4, x.shape[1]))
            np.testing.assert_allclose(td[c].numpy(), jdc, rtol=1e-5,
                                       atol=1e-6)


@pytest.mark.parametrize("name", CATALOGUE_A)
def test_metric_declarations_match_jax(name):
    jm, tm = jmetrics.get_metric(name), tmetrics.get_metric(name)
    assert tm.depends_on == jm.depends_on
    assert tm.nonzeros() == jm.nonzeros()
    assert tm.diagonal == jm.diagonal
    assert tm.spherically_symmetric == jm.spherically_symmetric
    assert tm.precision_weights() == jm.precision_weights()
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    assert tm.params() == {k: float(v) for k, v in jm.params().items()}
    # The declared structure holds every entry that is ever nonzero.
    g = tm.fn(torch.from_numpy(_events(name)), tm.params())
    g = g.reshape(4, 4, -1).abs().amax(dim=-1).numpy()
    assert {(i, j) for i in range(4) for j in range(i, 4)
            if g[i, j] != 0} == set(tm.nonzeros())


def test_precision_weights_of_the_new_charts():
    """(1, 1, 8, 1) for the cylindrical chart, ones for Misner's (OTHER),
    (1, 1, 8, 32) for the rational chart, which is X_Y_THETA_PHI."""
    w = {n: tmetrics.get_metric(n).precision_weights() for n in CATALOGUE_A}
    assert w["cosmic_string_spinning"] == (1.0, 1.0, 8.0, 1.0)
    assert w["misner_4d"] == (1.0, 1.0, 1.0, 1.0)
    assert w["kerr_rational_polynomial"] == (1.0, 1.0, 8.0, 32.0)
    assert w["wormhole (morris-thorne)"] == (1.0, 1.0, 8.0, 8.0)


PAIRS = [("cylindrical_to_polar", "polar_to_cylindrical",
          "cosmic_string_spinning"),
         ("rational_to_polar", "polar_to_rational",
          "kerr_rational_polynomial"),
         ("misner_4d_to_polar", "polar_to_misner_4d", "misner_4d")]


@pytest.mark.parametrize("to_polar,from_polar,name", PAIRS)
def test_transforms_match_jax(to_polar, from_polar, name):
    """A chart's transform to polar coordinates, the inverse on its result
    (a round trip), and both velocity push-forwards, against JAX."""
    x = _events(name, seed=1)
    v = np.random.default_rng(2).uniform(-1, 1, x.shape).astype(np.float32)
    jp, tp = jmetrics.get_metric(name).params(), \
        tmetrics.get_metric(name).params()
    jf, tf = jtr.get_transform(to_polar), ttr.get_transform(to_polar)
    jb, tb = jtr.get_transform(from_polar), ttr.get_transform(from_polar)
    jy = np.asarray(jf(jnp.asarray(x), jp))
    ty = tf(torch.from_numpy(x), tp)
    np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tb(ty, tp).numpy(), x, rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(tb(ty, tp).numpy(),
                               np.asarray(jb(jnp.asarray(jy), jp)),
                               rtol=1e-5, atol=1e-5)
    for jfn, tfn, at in ((jf, tf, x), (jb, tb, jy)):
        jv = np.asarray(jtr.velocity_transform(
            jfn, jnp.asarray(at), jnp.asarray(v), jp))
        tv = ttr.velocity_transform(tfn, torch.from_numpy(np.array(at)),
                                    torch.from_numpy(v), tp).numpy()
        scale = max(1.0, float(np.abs(jv).max()))
        np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6 * scale)


def test_arccos_matches_jax():
    """``geometry.arccos`` (the polynomial atan2 of sqrt(1 - x^2) and x)
    and its derivative, forward and reverse, against JAX's; within 1e-6 of
    numpy's acos (the polynomial's 2 ulp, amplified where x is near +-1)."""
    x = np.concatenate([np.random.default_rng(3).uniform(-1, 1, 509),
                        [-1.0, 0.0, 1.0]]).astype(np.float32)
    tx = torch.from_numpy(x)
    got = tgeometry.arccos(tx).numpy()
    np.testing.assert_allclose(got, np.asarray(jgeometry.arccos(
        jnp.asarray(x))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, np.arccos(x.astype(np.float64)),
                               atol=1e-6)
    inner = np.abs(x) < 0.999
    xi = x[inner]
    want = np.asarray(jax.vmap(jax.grad(jgeometry.arccos))(jnp.asarray(xi)))
    ti = torch.from_numpy(xi).requires_grad_()
    g, = torch.autograd.grad(tgeometry.arccos(ti).sum(), ti)
    np.testing.assert_allclose(g.numpy(), want, rtol=1e-6, atol=1e-6)
    _, jvp = torch.func.jvp(tgeometry.arccos, (torch.from_numpy(xi),),
                            (torch.ones(len(xi)),))
    np.testing.assert_allclose(jvp.numpy(), want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(want, -1 / np.sqrt(1 - xi.astype(np.float64)
                                                  ** 2), rtol=1e-5)


def test_frame_basis_at_misner_events():
    """``frame_basis_batched`` against JAX's ``frame_basis`` at Misner
    events, where g_TT = 0: the first pass seeds Gram-Schmidt with the
    first coordinate whose g_ii is not 0 and finds the timelike leg in the
    phi slot (T > 0, where g_phiphi = -T < 0) or among the others (T < 0);
    the second pass starts from it.  Same timelike index, legs within
    1e-5, and each tetrad orthonormal with leg 0 timelike."""
    m = tmetrics.get_metric("misner_4d")
    x = _events("misner_4d", n=64, seed=4)
    x[0, :4] = [2.5, -2.5, 1e-3, -0.75]
    gab = m.fn(torch.from_numpy(x), m.params())
    es, tl = ttetrad.frame_basis_batched(gab)
    jm = jmetrics.get_metric("misner_4d")
    jg = jm.fn(jnp.asarray(x), jm.params())
    jes, jtl = jax.vmap(jtetrad.frame_basis, in_axes=2, out_axes=(2, 0))(jg)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jtl))
    assert set(tl.numpy().tolist()) == {0, 1}
    np.testing.assert_allclose(es.numpy(), np.asarray(jes), rtol=1e-5,
                               atol=1e-5)
    eta = torch.einsum("uvn,aun,bvn->abn", gab, es, es).numpy()
    np.testing.assert_allclose(eta, np.broadcast_to(
        np.diag([-1.0, 1, 1, 1])[..., None], eta.shape), atol=1e-4)


def test_misner_camera_frame_matches_jax():
    """The observer tetrad of ``misner_4d``'s scene camera (t = -2, at
    Misner T = -1, where g_TT = 0 makes the first pass start Gram-Schmidt
    from the phi slot) and the launch state of its 8x8 frame, against
    JAX."""
    jm, tm = jmetrics.get_metric("misner_4d"), tmetrics.get_metric(
        "misner_4d")
    _, jcam = scene("misner_4d")
    tcam = carry.camera_from_jax(jcam, device="cpu")
    jpos, jes = jpl.camera_frame(jm, jcam, jm.params())
    tpos, tes = pl.camera_frame(tm, tcam, tm.params())
    np.testing.assert_allclose(tpos.numpy(), np.asarray(jpos), rtol=1e-6)
    np.testing.assert_allclose(tes.numpy(), np.asarray(jes), rtol=1e-5,
                               atol=1e-6)
    assert float(jm.fn(jpos, jm.params())[0, 0]) == 0.0
    assert float(tpos[0]) == pytest.approx(-1.0)
    settings = dict(width=8, height=8)
    jst, _, _ = jpl.init_camera_rays(
        jm, jcam, jm.params(), jpl.RenderSettings(**settings),
        jint.Features.for_metric(jm))
    tst, _, _ = pl.init_camera_rays(
        tm, tcam, tm.params(), pl.RenderSettings(**settings),
        tint.Features.for_metric(tm), device="cpu")
    for field in ("position", "velocity", "acceleration", "next_ds"):
        np.testing.assert_allclose(getattr(tst, field).numpy(),
                                   np.asarray(getattr(jst, field)),
                                   rtol=1e-5, atol=1e-6, err_msg=field)


@pytest.mark.parametrize("name", CATALOGUE_A)
def test_cli_renders_each_metric(name, tmp_path, capsys):
    """``--list`` names the metric, and an adaptive 8x8 frame of it renders
    on the CPU with ``--param`` (its first parameter 1% off its default) and
    ``--camera`` at r = 18, near the universe sphere, where the rays escape
    within 256 steps (at ``misner_4d``'s scene time t = -2); the name with a
    space and parentheses goes through as one argument."""
    assert cli.main(["--list"]) == 0
    assert name in capsys.readouterr().out.split("\n")
    m = tmetrics.get_metric(name)
    key, value = next(iter(m.defaults.items()))
    t = "-2" if name == "misner_4d" else "0"
    out = tmp_path / "frame.png"
    rc = cli.main(["--metric", name, "--adaptive", "--width", "8",
                   "--height", "8", "--max-steps", "256", "--device", "cpu",
                   "--param", f"{key}={1.01 * value}", "--camera", t, "18",
                   str(math.pi / 2), str(-math.pi / 2), "--out", str(out)])
    assert rc == 0 and name in capsys.readouterr().out
    img = cli.read_png(out)
    assert img.shape == (8, 8, 3) and img.max() > 0
