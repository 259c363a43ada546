"""Port parity: the six metrics of catalogue slice C, the rank-1 Kerr-Schild
acceleration and the complex pairs of ``ops.complexify``, against the JAX
package (CPU).  Also the helpers the slice's march, frame and golden tests
share (``test_torch_metrics_catalogue_c_*.py``, one file per family).

The same numpy inputs, made from a seed, go through both packages.
Tolerances:

- the metric and its partials: rtol 1e-5, and atol 1e-6 of the entry's
  scale (the largest |g_ij| of that entry over the batch, at least 1): a
  partial of an entry of size S carries rounding of order S times an ulp,
  and the double-Kerr potentials cancel to entries 100 times smaller than
  their terms (g_phiphi's z partial: both packages are up to 6e-6 from the
  float64 evaluation where the entry is 400); for ``double_schwarzschild``
  that atol times the condition number of its Y_k = R_k + a_k - z
  (``double_schwarzschild_kappa``): near the axis beyond a rod's end Y_k
  cancels (p = 0.58, z = 4.95: kappa 760, and both packages are 1.5e-5 and
  2.5e-5 from the float64 partial -0.0055); where the packages differ by
  more, the port must be at least as near as JAX's float32 to the
  reference's own formulas evaluated in float64 (``reference_float64``),
  still within 1e-5 of the scale, on at most ``FALLBACK_ENTRIES`` entries
  of an array (``double_unequal_kerr``'s g_tphi, 2 entries of 4,096, near
  p = 7.9, z = 1.3: JAX's float32 cube root for its constant a leaves it
  1.0e-6 of the scale off; no other metric needs it);
- ``minkowski_plus(*rank1) == fn``: equal (the port defines ``fn`` so); l is
  eta-null within 2e-5, the reference's bound;
- the rank-1 acceleration: against JAX's ``acceleration_batched_rank1``
  within 2e-5 of each ray's largest component (measured: 4.3e-6; the two
  sum the gradient term in different orders), and against the port's own
  dense path within 2e-5 (measured: 2.0e-6; the reference holds its two
  paths to 2e-3);
- the pair ops on float32 tensors against numpy complex128: within 4 ulp of
  the operands' magnitudes (the products and sums), 8 ulp of the quotient's
  (``cdiv`` rounds |b|^2, its reciprocal and two products); ``csqrt``
  within 8 ulp of sqrt|a| plus sqrt(4 ulp |a|): the half-angle form takes
  the root of |a| -+ re, which cancels where the root's other part is
  small (the reference's algorithm; held to it at rtol 1e-6 below); on
  Python floats (double) within 1e-14;
- ``csqrt`` and ``cabs`` tangents and cotangents against ``jax.jvp`` and
  ``jax.grad`` of the reference's ``_csqrt2`` and ``_cabs2``: rtol 1e-6 and
  atol 1e-6 of the largest magnitude (the same float32 formulas), but
  where the half-angle form cancels (see the test).
"""

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.metrics import base as jmbase
from geodesic_raytracing_tpu.metrics import catalogue_multibody as jmulti
from geodesic_raytracing_tpu.ops import complexify as jcx
from geodesic_raytracing_tpu.ops import geometry as jgeometry
from geodesic_raytracing_tpu.ops import integrate as jint
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.metrics import base as tbase
from geodesic_raytracing_tpu_torch.metrics.catalogue_kerr import (
    _kerr_schild_r)
from geodesic_raytracing_tpu_torch.ops import complexify as cx
from geodesic_raytracing_tpu_torch.ops import geometry as tgeometry
from geodesic_raytracing_tpu_torch.ops import integrate as tint
from geodesic_raytracing_tpu_torch.ops import raymarch

torch.set_num_threads(1)

CATALOGUE_C = ("kerr_schild", "kerr_newman_schild", "double_schwarzschild",
               "double_kerr", "double_kerr_alt", "double_unequal_kerr")
RANK1 = ("kerr_schild", "kerr_newman_schild")
# The most entries of one array (of 4 x 4 x 256) on which the metric test
# takes the float64 witness instead of the tolerance.
FALLBACK_ENTRIES = 8
# The most escaped rays of a 64-ray march that the march tests hold to the
# float64 witness instead of the tolerance.
FALLBACK_RAYS = 8


def events(name, n=256, seed=0):
    """Seeded (4, n) events in the chart of metric ``name``: cartesian
    (t in [0, 25], x, y, z in [-8, 8], moved off the Kerr-Schild ring: the
    reference's own test moves |x| < 2 by 4 along x); cylindrical
    (t, p, phi, z) with p in [0.1, 20] and z in [-8, 8], across the two
    bodies on the axis."""
    rng = np.random.default_rng(seed)
    if tmetrics.get_metric(name).config.coordinate_system == "CARTESIAN":
        x = np.stack([rng.uniform(0, 25, n), *rng.uniform(-8, 8, (3, n))])
        near = (x[1:] ** 2).sum(0) < 4.0
        x[1] = np.where(near, x[1] + 4.0, x[1])
    else:
        x = np.stack([rng.uniform(-3, 12, n), rng.uniform(0.1, 20, n),
                      rng.uniform(-np.pi, np.pi, n), rng.uniform(-8, 8, n)])
    return x.astype(np.float32)


def double_schwarzschild_kappa(x, params):
    """The condition number max_k (R_k + |z - a_k|) / |Y_k| of
    ``double_schwarzschild``'s Y_k = R_k + a_k - z at the (4, n) events
    ``x``, in float64."""
    M1, M2, z0 = params["M1"], params["M2"], params["z"]
    e, M = M2 - M1, M1 + M2
    aks = np.array([-0.5 * (M - e) - z0, 0.5 * (M - e) - z0,
                    -0.5 * (M + e) + z0, 0.5 * (M + e) + z0])[:, None]
    p, z = x[1].astype(np.float64), x[3].astype(np.float64)
    R = np.sqrt(p * p + (z - aks) ** 2)
    return ((R + np.abs(z - aks)) / np.abs(R + aks - z)).max(0)


class _Jnp64:
    """``jax.numpy`` with its ``float32`` and ``complex64`` read as
    ``float64`` and ``complex128``."""

    def __getattr__(self, name):
        wide = {"float32": jnp.float64, "complex64": jnp.complex128}
        return wide.get(name) or getattr(jnp, name)


# The double-Kerr formulas of the reference before ``realify`` (native
# complex arithmetic, which JAX's forward mode differentiates directly).
_COMPLEX_FNS = {"double_kerr": jmulti.double_kerr_fn,
                "double_kerr_alt": jmulti.double_kerr_alt_fn,
                "double_unequal_kerr": jmulti.double_unequal_kerr_fn}


@contextlib.contextmanager
def reference_float64(name):
    """The JAX package's metric ``name`` and its parameters, evaluated in
    float64: a witness of the reference's own formulas, independent of the
    port.  Under ``jax.enable_x64``, with the float32 and complex64 casts of
    its ``metrics/base.py`` and ``catalogue_multibody.py`` read as float64
    and complex128 for the duration, and the double-Kerr formulas on native
    complex128 rather than ``realify``'s float32 pairs."""
    jm = jmetrics.get_metric(name)
    if name in _COMPLEX_FNS:
        jm = dataclasses.replace(jm, fn=_COMPLEX_FNS[name])
    with jax.enable_x64(), mock.patch.object(jmbase, "jnp", _Jnp64()), \
            mock.patch.object(jmulti, "jnp", _Jnp64()):
        yield jm, {k: jnp.asarray(float(v)) for k, v in jm.params().items()}


# ---------------------------------------------------------------------------
# Helpers of the march tests
# ---------------------------------------------------------------------------

# A ray the step controller kills this close to the Kerr-Schild ring (its
# Kerr-Schild radius r -> 0, where 1 / r and z / r grow without bound).
RING_R = 0.05


def assert_march_parity_c(name, tst, jfin, tfin, min_escaped=16):
    """Fates equal on every ray; step counts equal on every ray, but on a
    ray the step controller kills at the Kerr-Schild ring (its radius
    r < ``RING_R``, where 1 / r and z / r grow without bound): there within
    2% (``kerr_schild``: 37 rays die at |x| = 0.5000-0.5003, 8 of them one
    step apart).  Escaped positions within 1e-4 (rtol and atol); where an
    escaped ray is further apart, the escaped rays are held to the
    reference's float64 march from the same launch state (``tst``, JAX's
    ``while`` driver on ``reference_float64``): the port's largest position
    error no larger than JAX's largest (or 1e-4 of the scale), no ray
    further apart than 5e-4 of the scale and at most ``FALLBACK_RAYS`` rays
    apart.  Those are rays that lingered near the photon sphere, where the
    last ulp grows by about a bit a step (``kerr_newman_schild``: 7 rays of
    931-1,726 steps, against a median of 840, end up to 0.015 apart, 2.6e-4
    of the scale 57; the port is up to 0.020 from the float64 march, JAX up
    to 0.034).  Returns the number of rays at the ring and of escaped rays
    further apart than 1e-4."""
    m = tmetrics.get_metric(name)
    rs = np.asarray(jfin.status)
    np.testing.assert_array_equal(tfin.status.numpy(), rs)
    js, ts = np.asarray(jfin.steps), tfin.steps.numpy()
    ring = np.zeros_like(rs, dtype=bool)
    if m.rank1 is not None:
        x = torch.from_numpy(np.asarray(jfin.position)).T
        r = _kerr_schild_r(x, m.params()["a"])[1].numpy()
        ring = (rs == jint.DEAD) & (r < RING_R)
    np.testing.assert_array_equal(ts[~ring], js[~ring])
    assert (np.abs(ts - js)[ring] <= 0.02 * js[ring]).all()
    esc = rs == jint.ESCAPED
    assert esc.sum() >= min_escaped, esc.sum()
    got, want = tfin.position.numpy()[esc], np.asarray(jfin.position)[esc]
    apart = (np.abs(got - want) > 1e-4 + 1e-4 * np.abs(want)).any(axis=1)
    if apart.any():
        with reference_float64(name) as (jm64, p64):
            st64 = jint.RayState(*(
                jnp.asarray(t.numpy().astype(np.float64)
                            if t.dtype == torch.float32 else t.numpy())
                for t in tst))
            f64 = jint.trace_rays(jm64, st64, p64,
                                  features=jint.Features.for_metric(jm64),
                                  opts=jint.TraceOptions(max_steps=4096))
            status64, truth = np.asarray(f64.status), np.asarray(f64.position)
        assert truth.dtype == np.float64
        np.testing.assert_array_equal(status64, rs)
        truth = truth[esc]
        scale = max(1.0, np.abs(truth).max())
        port_err = np.abs(got - truth).max()
        jax_err = np.abs(want - truth).max()
        print(f"{name}: {int(apart.sum())} escaped rays apart by more than "
              f"1e-4, by up to {np.abs(got - want).max():.3g}; largest "
              f"position error against the reference's float64 march: port "
              f"{port_err:.3g}, JAX {jax_err:.3g}")
        assert port_err <= max(jax_err, 1e-4 * scale)
        assert np.abs(got - want).max() <= 5e-4 * scale
        assert apart.sum() <= FALLBACK_RAYS
    return int(ring.sum()), int(apart.sum())


# ---------------------------------------------------------------------------
# Metrics, declarations, registration
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CATALOGUE_C)
def test_metric_and_partials_match_jax(name):
    jm, tm = jmetrics.get_metric(name), tmetrics.get_metric(name)
    x = events(name)
    n = x.shape[1]
    jg, jd = jgeometry.metric_and_partials_batched(
        jm.fn, jnp.asarray(x), jm.params(), deps=jm.depends_on)
    tg, td = tgeometry.metric_and_partials_batched(
        tm.fn, torch.from_numpy(x), tm.params(), deps=tm.depends_on)
    jg = np.broadcast_to(np.asarray(jg).reshape(4, 4, -1), (4, 4, n))
    tg = tg.numpy()
    scale = np.maximum(np.abs(jg).max(axis=-1, keepdims=True), 1.0)
    if name == "double_schwarzschild":
        scale = scale * double_schwarzschild_kappa(x, tm.params())
    pairs = [("g", tg, jg)]
    for c in range(4):
        assert (td[c] is None) == (jd[c] is None) == (c not in tm.depends_on)
        if td[c] is not None:
            pairs.append((f"d{c} g", td[c].numpy(), np.asarray(jd[c])))
    # Where the packages differ by more, the port must be at least as near
    # as JAX to the reference's formulas in float64, within 1e-5 of the
    # scale, on at most FALLBACK_ENTRIES entries.
    with reference_float64(name) as (jm64, p64):
        g64, d64 = jgeometry.metric_and_partials_batched(
            jm64.fn, jnp.asarray(x, jnp.float64), p64, deps=jm.depends_on)
        truth = [np.asarray(g64).reshape(4, 4, -1)] + [
            np.asarray(d64[c]) for c in tm.depends_on]
    for (what, got, want), f64 in zip(pairs, truth):
        assert f64.dtype == np.float64, what
        f64 = np.broadcast_to(f64, got.shape)
        assert np.isfinite(got).all(), what
        off = np.abs(got - want)
        bad = off > 1e-5 * np.abs(want) + 1e-6 * scale
        nearer = np.abs(got - f64) <= np.abs(want - f64)
        assert (nearer | ~bad).all(), (what, np.argwhere(bad & ~nearer)[:8])
        assert (off <= 1e-5 * scale).all(), (what, (off / scale).max())
        assert bad.sum() <= FALLBACK_ENTRIES, (what, int(bad.sum()))


@pytest.mark.parametrize("name", CATALOGUE_C)
def test_metric_declarations_match_jax(name):
    """Registered, with a config equal to the JAX package's field by field,
    the same declarations (a rank-1 decomposition where the reference has
    one) and parameters, and a kernel instance (``check_compiled_metric``
    accepts it)."""
    jm, tm = jmetrics.get_metric(name), tmetrics.get_metric(name)
    assert name in tmetrics.list_metrics()
    assert tm.depends_on == jm.depends_on
    assert tm.nonzeros() == jm.nonzeros()
    assert (tm.rank1 is None) == (jm.rank1 is None) == (name not in RANK1)
    assert tm.spherically_symmetric == jm.spherically_symmetric
    assert tm.precision_weights() == jm.precision_weights()
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(jm.config)
    assert tm.params() == {k: float(v) for k, v in jm.params().items()}
    raymarch.check_compiled_metric(tm)
    g = tm.fn(torch.from_numpy(events(name)), tm.params())
    g = g.abs().amax(dim=-1).numpy()
    nz = tm.nonzeros() or {(i, j) for i in range(4) for j in range(i, 4)}
    assert {(i, j) for i in range(4) for j in range(i, 4)
            if g[i, j] != 0} == set(nz)


def test_a_replaced_decomposition_has_no_kernel_instance():
    """A Kerr-Schild metric without its decomposition would march by the
    dense path in the plain march and by the rank-1 path in the kernel: it
    has no instance."""
    m = dataclasses.replace(tmetrics.get_metric("kerr_schild"), rank1=None)
    with pytest.raises(NotImplementedError, match="rank1"):
        raymarch.check_compiled_metric(m)


# ---------------------------------------------------------------------------
# The rank-1 path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", RANK1)
def test_rank1_decomposition(name):
    """fn equals minkowski_plus(f, l), minkowski_plus is eta + f l l as JAX
    builds it, and l is eta-null (tests/test_metrics_catalogue.py:177)."""
    m, jm = tmetrics.get_metric(name), jmetrics.get_metric(name)
    x = torch.from_numpy(events(name, n=64, seed=7))
    f, lv = m.rank1(x, m.params())
    g = tbase.minkowski_plus(f, lv)
    assert torch.equal(g, m.fn(x, m.params()))
    jg = jbase_minkowski_plus(f.numpy(), lv.numpy())
    np.testing.assert_array_equal(g.numpy(), jg)
    eta_ll = -lv[0] ** 2 + lv[1] ** 2 + lv[2] ** 2 + lv[3] ** 2
    np.testing.assert_allclose(eta_ll.numpy(), 0.0, atol=2e-5)
    jf, jl = jm.rank1(jnp.asarray(x.numpy()), jm.params())
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(lv.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-7)


def jbase_minkowski_plus(f, lv):
    from geodesic_raytracing_tpu.metrics.base import minkowski_plus

    return np.asarray(minkowski_plus(jnp.asarray(f), jnp.asarray(lv)))


@pytest.mark.parametrize("name", RANK1)
def test_rank1_acceleration_matches_jax_and_dense(name):
    """The port's rank-1 acceleration against JAX's and against the port's
    dense contraction of the same metric, each ray scaled by its largest
    component (see the module docstring); ``integrate.metric_acceleration``
    takes the rank-1 path."""
    m, jm = tmetrics.get_metric(name), jmetrics.get_metric(name)
    rng = np.random.default_rng(11)
    x = events(name, n=512, seed=3)
    v = np.concatenate([np.ones((1, 512)), rng.normal(size=(3, 512))]
                       ).astype(np.float32)
    tx, tv = torch.from_numpy(x), torch.from_numpy(v)
    got = tgeometry.acceleration_batched_rank1(m.rank1, tx, tv,
                                               m.params()).numpy()
    want = np.asarray(jgeometry.acceleration_batched_rank1(
        jm.rank1, jnp.asarray(x), jnp.asarray(v), jm.params()))
    dense = tgeometry.acceleration_batched(m.fn, tx, tv, m.params(),
                                           deps=m.depends_on).numpy()
    scale = np.maximum(np.abs(want).max(axis=0), 1e-30)
    jax_err = (np.abs(got - want) / scale).max()
    dense_err = (np.abs(got - dense) / scale).max()
    print(f"{name}: rank-1 acceleration vs JAX's {jax_err:.3g}, vs the "
          f"dense path {dense_err:.3g} of each ray's scale")
    assert np.isfinite(got).all()
    assert jax_err < 2e-5 and dense_err < 2e-5
    assert torch.equal(tint.metric_acceleration(m, tx, tv, m.params()),
                       torch.from_numpy(got))


# ---------------------------------------------------------------------------
# The complex pairs
# ---------------------------------------------------------------------------

def _pairs(n=4096, seed=5):
    """Seeded float32 pairs a, b over many magnitudes and all quadrants, and
    their complex128 values; a few on the axes (positive and negative
    reals, imaginary parts +0 and -0)."""
    rng = np.random.default_rng(seed)
    mag = np.exp(rng.uniform(-4, 4, (4, n)))
    v = (mag * rng.choice([-1.0, 1.0], (4, n))).astype(np.float32)
    v[1, :4] = [0.0, -0.0, 0.0, -0.0]
    v[0, :2] = np.abs(v[0, :2])
    v[0, 2:4] = -np.abs(v[0, 2:4])
    a = (torch.from_numpy(v[0]), torch.from_numpy(v[1]))
    b = (torch.from_numpy(v[2]), torch.from_numpy(v[3]))
    # numpy's branch cut follows the sign of a zero imaginary part; the
    # reference's does not (-0 is not below 0), so compare with +0.
    za = v[0].astype(np.complex128) + 1j * (v[1] + 0.0)
    zb = v[2].astype(np.complex128) + 1j * v[3]
    return a, b, za, zb


def _close(got, want, tol):
    """A pair against complex128 within ``tol`` (an array of magnitudes)."""
    np.testing.assert_array_less(np.abs(got[0].numpy() - want.real), tol)
    np.testing.assert_array_less(np.abs(got[1].numpy() - want.imag), tol)


ULP = 2.0 ** -23


def test_pair_ops_match_complex128():
    a, b, za, zb = _pairs()
    ma, mb = np.abs(za), np.abs(zb)
    _close(cx.cadd(a, b), za + zb, 4 * ULP * (ma + mb))
    _close(cx.csub(a, b), za - zb, 4 * ULP * (ma + mb))
    _close(cx.cmul(a, b), za * zb, 4 * ULP * ma * mb)
    _close(cx.cdiv(a, b), za / zb, 8 * ULP * ma / mb)
    _close(cx.conj(a), np.conj(za), np.full_like(ma, 1e-30))
    _close(cx.cneg(a), -za, np.full_like(ma, 1e-30))
    _close(cx.csqrt(a), np.sqrt(za),
           8 * ULP * np.sqrt(ma) + np.sqrt(4 * ULP * ma))
    np.testing.assert_array_less(np.abs(cx.scm(a).numpy() - ma ** 2),
                                 4 * ULP * ma ** 2)
    np.testing.assert_array_less(np.abs(cx.cabs(a).numpy() - ma),
                                 4 * ULP * ma)
    # A real denominator takes its reciprocal alone; a None part folds.
    q = cx.cdiv(a, (b[0], None))
    _close(q, za / b[0].numpy(), 4 * ULP * ma / np.abs(b[0].numpy()))
    assert cx.cmul((a[0], None), (b[0], None))[1] is None
    assert cx.cadd((a[0], None), (None, b[1]))[0] is a[0]
    # The principal branch on the axes, -0 imaginary parts included (the
    # reference's where(im < 0, -im, im): -0 is not below 0).
    ws = cx.csqrt(a)
    assert float(ws[1][2]) > 0 and float(ws[1][3]) > 0
    assert float(ws[1][0]) == 0.0 and float(ws[1][1]) == 0.0


def test_pair_ops_on_python_floats_are_double():
    """Parameter expressions: the same functions on Python floats compute in
    double; ``cpow`` by the polar form, ``cabs`` of a real part its |re|."""
    za, zb = 0.3 - 1.7j, -2.1 + 0.4j
    a, b = (za.real, za.imag), (zb.real, zb.imag)
    for got, want in ((cx.cmul(a, b), za * zb), (cx.cdiv(a, b), za / zb),
                      (cx.csqrt(a), np.sqrt(za)),
                      (cx.csqrt((-4.0, None)), 2j),
                      (cx.cpow(a, 1.0 / 3.0), za ** (1.0 / 3.0))):
        assert isinstance(got[0], float) and isinstance(got[1], float)
        assert abs(complex(*got) - want) < 1e-14 * max(1.0, abs(want))
    assert cx.cabs((-2.5, None)) == 2.5
    assert abs(cx.cabs(a) - abs(za)) < 1e-15


def _jvp_both(tfn, jfn, x, t):
    """Value and tangent of ``tfn`` (torch) and ``jfn`` (JAX) at the pair
    ``x`` along the pair tangent ``t``."""
    y, dy = torch.func.jvp(tfn, tuple(map(torch.from_numpy, x)),
                           tuple(map(torch.from_numpy, t)))
    jy, jdy = jax.jvp(jfn, tuple(map(jnp.asarray, x)),
                      tuple(map(jnp.asarray, t)))
    return y, dy, jy, jdy


def _assert_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * scale)


def test_csqrt_and_cabs_derivatives_match_jax():
    """``csqrt`` and ``cabs`` in forward mode (``torch.func.jvp``) and in
    reverse mode (``torch.autograd.grad``) against ``jax.jvp`` and
    ``jax.grad`` of the reference's ``_csqrt2`` and ``_cabs2``, on the
    seeded pairs and on positive reals (imaginary part 0), where the
    half-angle form's own derivative would be NaN."""
    (ar, ai), _, _, _ = _pairs(n=1024, seed=9)
    rng = np.random.default_rng(10)
    x = (ar.numpy(), ai.numpy().copy())
    x[1][:256] = 0.0
    x[0][:256] = np.abs(x[0][:256])
    t = tuple(rng.normal(size=(2, 1024)).astype(np.float32))
    y, dy, jy, jdy = _jvp_both(lambda u, w: cx.csqrt((u, w)), jcx._csqrt2,
                               x, t)
    # Where the half-angle form cancels (|a| -+ re below 1e-3 |a|, but not
    # 0: a real a takes an exact 0), an ulp
    # of the modulus (torch's CPU sqrt is not correctly rounded, XLA's is)
    # moves the small part of the root by up to sqrt(4 ulp |a|), and its
    # tangent dz / (2 w) by |dz| times that over |a|.
    m = np.abs(x[0] + 1j * x[1].astype(np.float64))
    cancel = (np.minimum(m - x[0], m + x[0]) < 1e-3 * m) & (x[1] != 0)
    assert cancel.any() and (~cancel).sum() > 512
    dw = np.sqrt(4 * ULP * m) + 8 * ULP * np.sqrt(m)
    dt = np.hypot(*t) * dw / m
    for k in range(2):
        assert np.isfinite(dy[k].numpy()).all()
        _assert_rel(y[k].numpy()[~cancel], np.asarray(jy[k])[~cancel])
        _assert_rel(dy[k].numpy()[~cancel], np.asarray(jdy[k])[~cancel])
        np.testing.assert_array_less(
            np.abs(y[k].numpy() - jy[k])[cancel], dw[cancel])
        np.testing.assert_array_less(
            np.abs(dy[k].numpy() - jdy[k])[cancel], dt[cancel] + 1e-6)
    m, dm, jm_, jdm = _jvp_both(lambda u, w: cx.cabs((u, w)), jcx._cabs2,
                                x, t)
    _assert_rel(m.numpy(), jm_)
    _assert_rel(dm.numpy(), jdm)

    c = rng.normal(size=(2, 1024)).astype(np.float32)
    tu, tw = (torch.tensor(v, requires_grad=True) for v in x)
    re, im = cx.csqrt((tu, tw))
    loss = (re * torch.from_numpy(c[0]) + im * torch.from_numpy(c[1])).sum()
    gu, gw = torch.autograd.grad(loss, (tu, tw))
    jgu, jgw = jax.grad(lambda u, w: jnp.sum(
        jcx._csqrt2(u, w)[0] * c[0] + jcx._csqrt2(u, w)[1] * c[1]),
        argnums=(0, 1))(*map(jnp.asarray, x))
    assert np.isfinite(gu.numpy()).all() and np.isfinite(gw.numpy()).all()
    _assert_rel(gu.numpy(), jgu)
    _assert_rel(gw.numpy(), jgw)

    tu, tw = (torch.tensor(v, requires_grad=True) for v in x)
    gu, gw = torch.autograd.grad((cx.cabs((tu, tw))
                                  * torch.from_numpy(c[0])).sum(), (tu, tw))
    jgu, jgw = jax.grad(lambda u, w: jnp.sum(jcx._cabs2(u, w) * c[0]),
                        argnums=(0, 1))(*map(jnp.asarray, x))
    _assert_rel(gu.numpy(), jgu)
    _assert_rel(gw.numpy(), jgw)


def test_csqrt_and_cabs_reverse_over_float64_parameters():
    """The parameter path: float64 tensors that require grad (a fitted
    parameter) through ``csqrt`` of a positive real and ``cabs``: finite
    gradients equal to the analytic ones, 1 / (2 sqrt(x)) and x / |x|."""
    x = torch.tensor(0.0816, dtype=torch.float64, requires_grad=True)
    re, im = cx.csqrt(x)
    g, = torch.autograd.grad(re + im, x)
    assert float(im) == 0.0
    assert abs(float(g) - 0.5 / np.sqrt(0.0816)) < 1e-12
    y = torch.tensor(-1.5, dtype=torch.float64, requires_grad=True)
    g, = torch.autograd.grad(cx.cabs((y, 0.0)), y)
    assert float(g) == -1.0
