"""Port parity: the seven metrics of ``metrics/catalogue_simple.py``, their
charts and configs against the JAX package (CPU).

The same numpy events, made from a seed, go through both.  Tolerances: the
metric and its partials rtol 1e-6 (atol 1e-6 for the partials that are
structural zeros on one side and a rounding on the other); a transform, its
inverse and its velocity push-forward 1e-6 of the value's scale (the polar
angles of a cartesian chart go through the reference's polynomial arctan
on both sides).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.coordinates import transforms as jtr
from geodesic_raytracing_tpu.metrics import base as jbase
from geodesic_raytracing_tpu.ops import geometry as jgeometry
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.coordinates import transforms as ttr
from geodesic_raytracing_tpu_torch.metrics import base as tbase
from geodesic_raytracing_tpu_torch.ops import geometry as tgeometry

torch.set_num_threads(1)

SEVEN = ("minkowski", "minkowski_skew", "schwarzschild",
         "schwarzschild_fast", "schwarzschild_skewed",
         "schwarzschild_ingoing_ef", "de_sitter")
# Catalogue slice B (tests/test_torch_metrics_catalogue_b.py).
CATALOGUE_B = ("janis_newman_winicour", "schwarzschild_ingoing_ef_hawking",
               "configurable_wormhole", "ellis_drainhole",
               "symmetric_warp_drive", "alcubierre", "krasnikov_tube",
               "krasnikov_cylindrical", "godel_cylindrical")
CATALOGUE_C = ("kerr_schild", "kerr_newman_schild", "double_schwarzschild",
               "double_kerr", "double_kerr_alt", "double_unequal_kerr")
# The eight metrics of catalogue slice A (tests/test_torch_metrics_catalogue_a.py).
CATALOGUE_A = ("wormhole (morris-thorne)", "black_hole_cosmic_string", "ernst",
               "kerr_newman_boyer", "kerr_ingoing_ef",
               "kerr_rational_polynomial", "misner_4d",
               "cosmic_string_spinning")


def _events(name, n=256, seed=0):
    """Seeded (4, n) events in the chart of metric ``name``, outside its
    horizon: polar (t, r in [1.2, 25], theta, phi), with r in the slot the
    chart keeps it in; cartesian for the flat metrics.  ``de_sitter`` stops
    at r = 15, inside its cosmological horizon at sqrt(3 / Lambda) = 17.3,
    where 1 - Lambda r^2 / 3 cancels to nothing and the two packages' last
    ulp of r^2 / 3 is all that is left of it."""
    rng = np.random.default_rng(seed)
    t = rng.uniform(-5, 5, n)
    r_max = 15.0 if name == "de_sitter" else 25.0
    r = np.exp(rng.uniform(np.log(1.2), np.log(r_max), n))
    th = rng.uniform(0.05, np.pi - 0.05, n)
    ph = rng.uniform(-np.pi, np.pi, n)
    if name.startswith("minkowski"):
        x = np.stack([t, *rng.uniform(-20, 20, (3, n))])
    elif name == "schwarzschild_skewed":
        x = np.stack([r, t, th, ph])
    else:
        x = np.stack([t, r, th, ph])
    return x.astype(np.float32)


@pytest.mark.parametrize("name", SEVEN)
def test_metric_and_partials_match_jax(name):
    jm, tm = jmetrics.get_metric(name), tmetrics.get_metric(name)
    x = _events(name)
    jg, jd = jgeometry.metric_and_partials_batched(
        jm.fn, jnp.asarray(x), jm.params(), deps=jm.depends_on)
    tg, td = tgeometry.metric_and_partials_batched(
        tm.fn, torch.from_numpy(x), tm.params(), deps=tm.depends_on)
    jg = np.broadcast_to(np.asarray(jg).reshape(4, 4, -1), (4, 4, x.shape[1]))
    tg = np.broadcast_to(tg.numpy().reshape(4, 4, -1), (4, 4, x.shape[1]))
    np.testing.assert_allclose(tg, jg, rtol=1e-6, atol=0)
    for c in range(4):
        assert (td[c] is None) == (jd[c] is None) == (c not in tm.depends_on)
        if td[c] is not None:
            np.testing.assert_allclose(td[c].numpy(), np.asarray(jd[c]),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", SEVEN)
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


def test_symmetric_polar_precision_weights():
    """(1, 1, 8, 8) for a spherically symmetric polar metric, (1, 1, 8, 32)
    for a polar one that is not flagged so, ones for a cartesian chart."""
    w = {n: tmetrics.get_metric(n).precision_weights() for n in SEVEN}
    assert w["schwarzschild"] == w["de_sitter"] == (1.0, 1.0, 8.0, 8.0)
    assert w["schwarzschild_ingoing_ef"] == (1.0, 1.0, 8.0, 8.0)
    assert w["schwarzschild_skewed"] == (1.0, 1.0, 8.0, 32.0)
    assert w["minkowski"] == w["minkowski_skew"] == (1.0, 1.0, 1.0, 1.0)


@pytest.mark.parametrize("base", ["polar_base", "cartesian_base",
                                  "cartesian_skew_base", "cylindrical_base",
                                  "ingoing_ef_base", "skewed_polar_base"])
def test_base_configs_match_jax(base):
    assert tbase.BASE_CONFIGS[base] == jbase.BASE_CONFIGS[base]


PAIRS = [("cartesian_to_polar", "polar_to_cartesian", "minkowski"),
         ("cartesian_skew_to_polar", "polar_to_cartesian_skew",
          "minkowski_skew"),
         ("ingoing_ef_to_polar", "polar_to_ingoing_ef",
          "schwarzschild_ingoing_ef"),
         ("skewed_polar_to_polar", "polar_to_skewed_polar",
          "schwarzschild_skewed")]


@pytest.mark.parametrize("to_polar,from_polar,name", PAIRS)
def test_transforms_match_jax(to_polar, from_polar, name):
    """A chart's transform to polar coordinates, the inverse on its result
    (a round trip), and both velocity push-forwards, against JAX."""
    x = _events(name, seed=1)
    v = np.random.default_rng(2).uniform(-1, 1, x.shape).astype(np.float32)
    jp, tp = jmetrics.get_metric(name).params(), \
        tmetrics.get_metric(name).params()
    for fwd, back in ((to_polar, from_polar),):
        jf, tf = jtr.get_transform(fwd), ttr.get_transform(fwd)
        jb, tb = jtr.get_transform(back), ttr.get_transform(back)
        jy = np.asarray(jf(jnp.asarray(x), jp))
        ty = tf(torch.from_numpy(x), tp)
        np.testing.assert_allclose(ty.numpy(), jy, rtol=1e-6, atol=1e-5)
        # The round trip, each side on its own polar event.
        np.testing.assert_allclose(tb(ty, tp).numpy(), x, rtol=1e-5,
                                   atol=2e-5)
        np.testing.assert_allclose(tb(ty, tp).numpy(),
                                   np.asarray(jb(jnp.asarray(jy), jp)),
                                   rtol=1e-5, atol=2e-5)
        for jfn, tfn, at in ((jf, tf, x), (jb, tb, jy)):
            jv = np.asarray(jtr.velocity_transform(
                jfn, jnp.asarray(at), jnp.asarray(v), jp))
            tv = ttr.velocity_transform(tfn, torch.from_numpy(np.array(at)),
                                        torch.from_numpy(v), tp).numpy()
            scale = max(1.0, float(np.abs(jv).max()))
            np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-6 * scale)


def test_constant_metric_has_no_batch_axis():
    """``minkowski_fn`` returns a (4, 4) for any batch (the reference's
    shape); the ray init and the render data add the batch axis."""
    m = tmetrics.get_metric("minkowski")
    g = m.fn(torch.zeros((4, 7)), m.params())
    assert g.shape == (4, 4)
    np.testing.assert_array_equal(g.numpy(), np.diag([-1.0, 1, 1, 1]))
    gs = tmetrics.get_metric("minkowski_skew").fn(torch.zeros((4, 7)), {})
    np.testing.assert_array_equal(gs.numpy(), np.diag([1.0, -1, 1, 1]))


def test_diag_metric_matches_jax():
    d = [np.float32(v) for v in (-0.5, 2.0, 9.0, 4.5)]
    np.testing.assert_array_equal(
        tbase.diag_metric(*(torch.tensor(v) for v in d)).numpy(),
        np.asarray(jbase.diag_metric(*d)))
    b = tbase.diag_metric(torch.arange(3.0), 1.0, 1.0, 2.0)
    assert b.shape == (4, 4, 3) and float(b[3, 3, 1]) == 2.0


def test_unported_metric_is_a_key_error():
    """A name neither package registers is a KeyError; the port registers
    all 31 of the reference's metrics."""
    with pytest.raises(KeyError, match="unknown metric"):
        tmetrics.get_metric("kerr_schild_spinless")
    assert set(SEVEN) | {"kerr_boyer"} | set(CATALOGUE_A) | set(
        CATALOGUE_B) | set(CATALOGUE_C) == set(tmetrics.list_metrics())
    assert set(tmetrics.list_metrics()) == set(jmetrics.REGISTRY)
    assert jax.default_backend() == "cpu"
