"""Port parity: the nine metrics of catalogue slice B, the identity
ingoing-EF chart, ``alcubierre_origin``, ``geometry.pow_pos`` and the slice's
registration, against the JAX package (CPU).  Also the helpers the slice's
march, frame and golden tests share (``test_torch_metrics_catalogue_b_*.py``,
one file per family).

The same numpy events, made from a seed, go through both packages.
Tolerances: the metric and its partials rtol 1e-5, and atol 1e-6 of the
largest magnitude of the entry over the batch (a partial that is a
structural zero on one side and a rounding on the other; and the tanh steps
of the Alcubierre bubble and the Krasnikov tubes, where 1 + tanh cancels, so
that one ulp of tanh, XLA's against torch's, moves the value by 1e-7 of its
scale; both packages are that far from the float64 evaluation); the origin
distance rtol 1e-5.  ``krasnikov_cylindrical``'s partials atol 2e-5: its
literal e = 0.1 makes the slope of its step 4 / e = 40, and a partial that
is the product of a saturated step's 1 - tanh^2 (0 in one package, one ulp,
1.2e-7, in the other) with that slope and the other factors (up to 2)
differs by up to 1e-5.
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
import jax.numpy as jnp

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.coordinates import transforms as jtr
from geodesic_raytracing_tpu.metrics import base as jbase
from geodesic_raytracing_tpu.ops import geometry as jgeometry
from geodesic_raytracing_tpu.ops import integrate as jint
from geodesic_raytracing_tpu.render import background as jbg
from geodesic_raytracing_tpu.render import colour as jcolour
from geodesic_raytracing_tpu.render import pipeline as jpl
from geodesic_raytracing_tpu_torch import carry, cli
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.coordinates import transforms as ttr
from geodesic_raytracing_tpu_torch.metrics import base as tbase
from geodesic_raytracing_tpu_torch.ops import geometry as tgeometry
from geodesic_raytracing_tpu_torch.ops import integrate as tint
from geodesic_raytracing_tpu_torch.ops import raymarch
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render import colour
from geodesic_raytracing_tpu_torch.render import pipeline as pl
from test_torch_metrics_catalogue_a import gate, u8
from test_torch_raymarch_host import generic_rays

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CATALOGUE_B = ("janis_newman_winicour", "schwarzschild_ingoing_ef_hawking",
               "configurable_wormhole", "ellis_drainhole",
               "symmetric_warp_drive", "alcubierre", "krasnikov_tube",
               "krasnikov_cylindrical", "godel_cylindrical")


def events(name, n=256, seed=0):
    """Seeded (4, n) events in the chart of metric ``name``, where its
    metric is real: polar (t, r in [1.7, 25], theta, phi), r of either sign
    through the configurable wormhole's throat, the advanced time v over
    the hawking hole's life and past it, t in [0, 20] for the warp drive
    (whose shell is t-dependent); cartesian events (t in [0, 25]) inside and
    around the Krasnikov tube and the Alcubierre bubble; cylindrical
    (t, p, phi, z), half of them in and around the cylindrical Krasnikov
    tube."""
    rng = np.random.default_rng(seed)
    cs = tmetrics.get_metric(name).config.coordinate_system
    if cs == "X_Y_THETA_PHI":
        x = np.stack([rng.uniform(0, 20, n),
                      np.exp(rng.uniform(np.log(1.7), np.log(25.0), n)),
                      rng.uniform(0.05, np.pi - 0.05, n),
                      rng.uniform(-np.pi, np.pi, n)])
        if name == "configurable_wormhole":
            x[1] *= rng.choice([-1.0, 1.0], n)
        if name == "schwarzschild_ingoing_ef_hawking":
            x[0] = rng.uniform(-10, 1100, n)
    elif cs == "CARTESIAN":
        x = np.stack([rng.uniform(0, 25, n), rng.uniform(-2, 7, n),
                      *rng.uniform(-3, 3, (2, n))])
    else:
        x = np.stack([rng.uniform(-3, 12, n), rng.uniform(0.1, 20, n),
                      rng.uniform(-np.pi, np.pi, n), rng.uniform(-3, 3, n)])
        if name == "krasnikov_cylindrical":
            # Half of them in and around its narrow tube (p < 1,
            # 0 < x < 2) while it forms.
            h = n // 2
            x[:, :h] = np.stack([rng.uniform(0, 4, h),
                                 rng.uniform(0.1, 1.5, h),
                                 rng.uniform(-np.pi, np.pi, h),
                                 rng.uniform(-0.5, 2.5, h)])
    return x.astype(np.float32)


# Partials of a saturated tanh step (see the module docstring).
PARTIAL_ATOL = {"krasnikov_cylindrical": 2e-5}


def assert_close_scaled(got, want, rtol=1e-5, scale_atol=1e-6, atol=0.0,
                        err_msg=""):
    """rtol, and atol ``scale_atol`` of the largest |want| (at least 1), or
    ``atol`` where that is larger."""
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=max(scale_atol * scale, atol),
                               err_msg=err_msg)


# ---------------------------------------------------------------------------
# Helpers of the march, frame and golden tests
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def scene(key):
    """The scene of scripts/make_goldens.py under ``key``: (metric name,
    the JAX camera, Features overrides).  ``alcubierre`` (side-on at
    r = 4), ``alcubierre_paper`` (on the travel axis), the Krasnikov tubes
    (t = 20, 10) and ``symmetric_warp_drive`` (t = 10, universe and
    precision radius 100) have their presets; the rest the flagship
    camera."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import make_goldens

    spec = make_goldens.scene_configs()[key]
    name, params_over, sets_over, camera = spec[:4]
    assert not params_over and not sets_over
    assert os.path.exists(os.path.join(REPO, "tests/golden/catalogue",
                                       f"{key}.png"))
    return name, camera, dict(spec[4]) if len(spec) > 4 else {}


def assert_scene_matches_smoke(key):
    """chip_smoke.py's restated preset of the scene (``SCENES``) is the
    script's: the same camera position and Features."""
    sys.path.insert(0, REPO)
    import chip_smoke

    name, camera, feats_over = scene(key)
    pos, over = chip_smoke.SCENES.get(key, ((0.0, 7.0, math.pi / 2,
                                             -math.pi / 2), {}))
    np.testing.assert_array_equal(np.float32(pos),
                                  np.asarray(camera.polar_position))
    assert over == feats_over


# Where the acceleration at launch is a cancellation: outside the Alcubierre
# bubble (the flat region of the scene's rays) f is the difference of two
# tanh near 1, so an ulp of tanh, XLA's against torch's, moves the launch
# acceleration by 0.13% of its 5e-4 and the step seeded from it by 7e-4 of
# itself.
LAUNCH_NEXT_DS_RTOL = {"alcubierre": 1e-3}
# Metrics whose rays cross a tanh wall (the Alcubierre bubble, the forming
# Krasnikov tube): 1 + tanh cancels there, and the float32 marches of both
# packages part from the float64 march by up to 3.2e-3 (alcubierre) and
# 0.19 (krasnikov_tube) in position (ROADMAP Queue 3).
TANH_WALL = ("alcubierre", "krasnikov_tube")


def march_both(name, planar=False, max_steps=4096):
    """(JAX launch state, JAX final, port final) of the 64-ray set of
    ``generic_rays`` in the chart of ``name``, every 7th ray born DEAD: the
    port's own launch state is held to JAX's (rtol 1e-5, atol 1e-6;
    ``next_ds`` rtol ``LAUNCH_NEXT_DS_RTOL``), then both march from JAX's,
    so that the marches take the same inputs."""
    jm, tm = jmetrics.get_metric(name), tmetrics.get_metric(name)
    pos, vel = (t.numpy() for t in generic_rays(tm, tm.params()))
    jf, tf = jint.Features.for_metric(jm), tint.Features.for_metric(tm)
    assert tuple(jf) == tuple(tf)
    jst = jint.init_ray_state(jm, jnp.asarray(pos), jnp.asarray(vel),
                              jm.params(), jf)
    tst = tint.init_ray_state(tm, torch.from_numpy(pos),
                              torch.from_numpy(vel), tm.params(), tf)
    for field in ("position", "velocity", "acceleration", "next_ds"):
        rtol = LAUNCH_NEXT_DS_RTOL.get(name, 1e-5) if field == "next_ds" \
            else 1e-5
        np.testing.assert_allclose(getattr(tst, field).numpy(),
                                   np.asarray(getattr(jst, field)),
                                   rtol=rtol, atol=1e-6, err_msg=field)
    jst = jst._replace(status=jst.status.at[::7].set(2))
    tst = tint.RayState(*(torch.from_numpy(np.array(getattr(jst, f)))
                          for f in tint.RayState._fields))
    jfin = jint.trace_rays(jm, jst, jm.params(), features=jf,
                           opts=jint.TraceOptions(max_steps=max_steps,
                                                  planar=planar))
    opts = tint.TraceOptions(max_steps=max_steps, planar=planar)
    tfin = tint.trace_rays(tm, tst, tm.params(), tf, opts)
    return tst, jfin, tfin


def assert_march_parity(name, tst, jfin, tfin, planar=False):
    """Fates and step counts equal on every ray, and at least 16 escaped.
    Escaped positions within 1e-4 (rtol and atol), but on the rays of a
    ``TANH_WALL`` metric: there the port's float32 march must be as close to
    the float64 march (the port's, from the same launch state) as JAX's
    float32 march is, ray set against ray set: its largest position error
    no larger than JAX's largest (or 1e-4 of the scale, if that is
    larger)."""
    tm = tmetrics.get_metric(name)
    js, rs = np.asarray(jfin.steps), np.asarray(jfin.status)
    np.testing.assert_array_equal(tfin.status.numpy(), rs)
    np.testing.assert_array_equal(tfin.steps.numpy(), js)
    esc = rs == jint.ESCAPED
    assert esc.sum() >= 16, esc.sum()
    got, want = tfin.position.numpy()[esc], np.asarray(jfin.position)[esc]
    if name not in TANH_WALL:
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        return
    st64 = tint.RayState(*(t.double() if t.dtype == torch.float32 else t
                           for t in tst))
    f64 = tint.trace_rays(tm, st64, tm.params(), tint.Features.for_metric(tm),
                          tint.TraceOptions(max_steps=4096, planar=planar))
    np.testing.assert_array_equal(f64.status.numpy(), rs)
    truth = f64.position.numpy()[esc]
    port_err = np.abs(got - truth).max()
    jax_err = np.abs(want - truth).max()
    print(f"{name}: largest position error against the float64 march: port "
          f"{port_err:.3g}, JAX {jax_err:.3g}; port vs JAX "
          f"{np.abs(got - want).max():.3g}")
    assert port_err <= max(jax_err, 1e-4 * max(1.0, np.abs(truth).max()))


FRAME = dict(width=64, height=64, anisotropy=2)
FRAME_STEPS = 2048


@functools.lru_cache(maxsize=None)
def jax_frame(key):
    """JAX's dense 64x64 frame of the scene ``key`` (``method="while"``,
    anisotropy 2, the 128x256 checker sky), as linear RGB numpy."""
    name, camera, over = scene(key)
    jm = jmetrics.get_metric(name)
    return np.asarray(jpl.render_frame(
        jm, camera, jm.params(), jbg.checker_background(128, 256),
        jpl.RenderSettings(**FRAME, trace=jint.TraceOptions(
            max_steps=FRAME_STEPS, method="while")),
        jint.Features.for_metric(jm, **over)))


def port_frame(key, size=64, anisotropy=2, sky=(128, 256),
               max_steps=FRAME_STEPS):
    """The port's dense frame of the scene ``key`` on the CPU."""
    name, camera, over = scene(key)
    tm = tmetrics.get_metric(name)
    return pl.render_frame(
        tm, carry.camera_from_jax(camera, device="cpu"), tm.params(),
        bg.checker_background(*sky, device="cpu"),
        pl.RenderSettings(width=size, height=size, anisotropy=anisotropy,
                          trace=tint.TraceOptions(max_steps=max_steps)),
        tint.Features.for_metric(tm, **over), device="cpu")


def assert_frame_matches_jax(key):
    """The port's 64x64 frame against JAX's: sRGB uint8 RMSE under 0.5 of
    255 and under 0.5% of pixels off by more than 32 (float32 differences
    move single texels at checker edges and photon-ring rays)."""
    img = port_frame(key)
    assert img.shape == (64, 64, 3) and bool(torch.isfinite(img).all())
    ours = u8(colour.lin_to_srgb(img))
    theirs = u8(jcolour.lin_to_srgb(jax_frame(key)))
    assert ours.max() > 0
    rmse, bad = gate(ours, theirs)
    print(f"{key}: 64x64 sRGB RMSE {rmse:.4f}, pixels off by >32 {bad:.5f}")
    assert rmse < 0.5 and bad < 0.005, (rmse, bad)


def assert_golden(key):
    """The 128^2 scene ``key`` of scripts/make_goldens.py (anisotropy 4,
    8192 steps, the default 2048x1024 checker sky, the scene's camera and
    Features) through the port's plain path against the checked-in PNG,
    with the golden gate of tests/test_parity_images.py: RMSE < 4, < 1% of
    pixels off by > 32."""
    assert_scene_matches_smoke(key)
    img = port_frame(key, size=128, anisotropy=4, sky=(), max_steps=8192)
    path = os.path.join(REPO, "tests/golden/catalogue", f"{key}.png")
    golden = cli.read_png(path)
    np.testing.assert_array_equal(golden, iio.imread(path)[..., :3])
    rmse, bad = gate(u8(colour.lin_to_srgb(img)), golden)
    print(f"{key}: golden RMSE {rmse:.4f}, pixels off by >32 {bad:.5f}")
    assert rmse < 4.0 and bad < 0.01, (rmse, bad)


# ---------------------------------------------------------------------------
# Metrics, the chart, the origin distance, pow_pos, registration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CATALOGUE_B)
def test_metric_and_partials_match_jax(name):
    jm, tm = jmetrics.get_metric(name), tmetrics.get_metric(name)
    x = events(name)
    n = x.shape[1]
    jg, jd = jgeometry.metric_and_partials_batched(
        jm.fn, jnp.asarray(x), jm.params(), deps=jm.depends_on)
    tg, td = tgeometry.metric_and_partials_batched(
        tm.fn, torch.from_numpy(x), tm.params(), deps=tm.depends_on)
    jg = np.broadcast_to(np.asarray(jg).reshape(4, 4, -1), (4, 4, n))
    tg = np.broadcast_to(tg.numpy().reshape(4, 4, -1), (4, 4, n))
    assert np.isfinite(tg).all()
    assert_close_scaled(tg, jg, err_msg="g")
    for c in range(4):
        assert (td[c] is None) == (jd[c] is None) == (c not in tm.depends_on)
        if td[c] is not None:
            jdc = np.broadcast_to(np.asarray(jd[c]).reshape(4, 4, -1),
                                  (4, 4, n))
            assert np.isfinite(td[c].numpy()).all()
            assert_close_scaled(td[c].numpy(), jdc,
                                atol=PARTIAL_ATOL.get(name, 0.0),
                                err_msg=f"d{c} g")


@pytest.mark.parametrize("name", CATALOGUE_B)
def test_metric_declarations_match_jax(name):
    """Registered, with a config equal to the JAX package's field by field,
    the same declarations and parameters, and a kernel instance whose
    parameter order is the metric's."""
    jm, tm = jmetrics.get_metric(name), tmetrics.get_metric(name)
    assert name in tmetrics.list_metrics()
    assert tm.depends_on == jm.depends_on
    assert tm.nonzeros() == jm.nonzeros()
    assert tm.diagonal == jm.diagonal
    assert tm.spherically_symmetric == jm.spherically_symmetric
    assert tm.precision_weights() == jm.precision_weights()
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    assert tm.params() == {k: float(v) for k, v in jm.params().items()}
    assert set(raymarch.INSTANCES[name][1]) <= set(tm.params())
    raymarch.check_compiled_metric(tm)
    g = tm.fn(torch.from_numpy(events(name)), tm.params())
    g = g.reshape(4, 4, -1).abs().amax(dim=-1).numpy()
    assert {(i, j) for i in range(4) for j in range(i, 4)
            if g[i, j] != 0} == set(tm.nonzeros())


def test_kernel_instances_left_are_slice_c():
    """Catalogue slice C is done: all 31 metrics of the JAX registry have a
    kernel instance, and ``trace_rays_cuda`` raises NotImplementedError for
    a name outside them, before it looks at the tensors (a stand-in metric
    of a made-up name), with no fallback to the plain march."""
    assert len(raymarch.INSTANCES) == 31
    assert set(raymarch.INSTANCES) == set(jmetrics.REGISTRY)
    state = tint.RayState(*(torch.zeros(1) for _ in range(7)))
    stand_in = tmetrics.get_metric("schwarzschild")
    fake = dataclasses.replace(stand_in, name="schwarzschild_spinless")
    with pytest.raises(NotImplementedError, match="no ray-march kernel"):
        raymarch.trace_rays_cuda(fake, state, {}, None, None)


def test_ingoing_ef_variable_chart_matches_jax():
    """The identity pair of the hawking hole's chart, registered under the
    reference's names: 17 of its transforms ported."""
    x = events("schwarzschild_ingoing_ef_hawking", seed=1)
    for name in ("ingoing_ef_variable_to_polar",
                 "polar_to_ingoing_ef_variable"):
        np.testing.assert_array_equal(
            ttr.get_transform(name)(torch.from_numpy(x), {}).numpy(),
            np.asarray(jtr.get_transform(name)(jnp.asarray(x), {})))
    ported = set(ttr.TRANSFORMS)
    assert len(ported) == 17 and ported <= set(jtr.TRANSFORMS)
    assert tbase.BASE_CONFIGS["ingoing_ef_variable_base"] == \
        jbase.BASE_CONFIGS["ingoing_ef_variable_base"]


def test_alcubierre_origin_matches_jax():
    """``alcubierre_origin`` of the cartesian chart's polar events (the
    distance to the bubble at x = v t) against JAX's, and against the
    distance itself."""
    m = tmetrics.get_metric("alcubierre")
    x = events("alcubierre", seed=2)
    polar = m.to_polar(torch.from_numpy(x), m.params())
    got = m.origin_distance(polar, m.params()).numpy()
    jm = jmetrics.get_metric("alcubierre")
    want = np.asarray(jm.origin_distance(jm.to_polar(jnp.asarray(x),
                                                     jm.params()),
                                         jm.params()))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    direct = np.sqrt((x[1] - 2.0 * x[0]) ** 2 + x[2] ** 2 + x[3] ** 2)
    np.testing.assert_allclose(got, direct, rtol=1e-4, atol=1e-4)


def test_pow_pos_matches_jax():
    """``pow_pos`` and its tangent against JAX's, with base <= 0 mapped to
    exactly 0 (value and tangent) and a Python float evaluated in double."""
    b = np.concatenate([np.random.default_rng(3).uniform(0, 50, 253),
                        [0.0, -1.0, 1e-30]]).astype(np.float32)
    tb = torch.from_numpy(b)
    y, dy = torch.func.jvp(lambda v: tgeometry.pow_pos(v, 1.0 / 3.0), (tb,),
                           (torch.ones_like(tb),))
    import jax

    jy, jdy = jax.jvp(lambda v: jgeometry.pow_pos(v, 1.0 / 3.0),
                      (jnp.asarray(b),), (jnp.ones_like(jnp.asarray(b)),))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-6)
    np.testing.assert_allclose(dy.numpy(), np.asarray(jdy), rtol=1e-5)
    assert y[253] == 0 and y[254] == 0 and dy[253] == 0 and dy[254] == 0
    assert tgeometry.pow_pos(0.0, 0.5) == 0.0
    assert tgeometry.pow_pos(8.0, 1.0 / 3.0) == math.exp(
        math.log(8.0) * (1.0 / 3.0))


def test_janis_gradient_through_the_exponent_matches_jax():
    """With ``mu`` a tensor that requires grad, ``janis_newman_winicour``'s
    metric takes torch's pow with a Python-number exponent (the float
    path's bits) and still carries the gradient through the exponents
    1/mu, 1/mu + 1 and 1/mu - 1: d(sum of g)/d mu and d/d r0 equal
    ``jax.grad``'s (rtol 1e-5)."""
    import jax

    x = events("janis_newman_winicour", n=64, seed=5)
    tm = tmetrics.get_metric("janis_newman_winicour")
    jm = jmetrics.get_metric("janis_newman_winicour")
    tp = {k: torch.tensor(v, requires_grad=True)
          for k, v in tm.params().items()}
    total = tm.fn(torch.from_numpy(x), tp).sum()
    g = torch.autograd.grad(total, [tp["mu"], tp["r0"]])

    def jsum(mu, r0):
        return jnp.sum(jm.fn(jnp.asarray(x), {"mu": mu, "r0": r0}))

    jg = jax.grad(jsum, argnums=(0, 1))(jnp.float32(4.0), jnp.float32(1.0))
    assert float(total) == float(tm.fn(torch.from_numpy(x),
                                       tm.params()).sum())
    for a, b in zip(g, jg):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5)
