"""Port parity: the metric layer, geometry and tetrads of the PyTorch port
against the JAX reference on the same seeded numpy inputs (CPU).

Tolerances: g and its partials are a few float32 ops deep, so rtol 1e-5 /
atol 1e-6.  The acceleration, null fix, frame basis and observer tetrad
divide by metric combinations (1/D, 1/det) whose sin/cos ulps grow near the
horizon, so rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geodesic_raytracing_tpu import camera as jcam
from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.ops import geometry as jgeo
from geodesic_raytracing_tpu.ops import tetrad as jtet
from geodesic_raytracing_tpu_torch import camera as tcam
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.ops import geometry as tgeo
from geodesic_raytracing_tpu_torch.ops import tetrad as ttet

torch.set_num_threads(1)

TIGHT = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5)
N = 256


@pytest.fixture(scope="module")
def kerr():
    jm = jmetrics.get_metric("kerr_boyer")
    tm = tmetrics.get_metric("kerr_boyer")
    return jm, jm.params(), tm, tm.params()


@pytest.fixture(scope="module")
def events():
    """(x, v) component-first (4, N) float32: r in [1.6, 20], theta in
    [0.05, pi - 0.05], random t, phi and velocity."""
    rng = np.random.default_rng(0)
    x = np.stack([
        rng.uniform(-5.0, 5.0, N),
        rng.uniform(1.6, 20.0, N),
        rng.uniform(0.05, np.pi - 0.05, N),
        rng.uniform(-np.pi, np.pi, N),
    ]).astype(np.float32)
    v = rng.normal(size=(4, N)).astype(np.float32)
    return x, v


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_metric_and_partials(kerr, events):
    jm, jp, tm, tp = kerr
    x, _ = events
    jg, jdg = jgeo.metric_and_partials_batched(jm.fn, jnp.asarray(x), jp,
                                               deps=jm.depends_on)
    tg, tdg = tgeo.metric_and_partials_batched(tm.fn, torch.from_numpy(x), tp,
                                               deps=tm.depends_on)
    np.testing.assert_allclose(_np(tg), _np(jg), **TIGHT)
    for c in range(4):
        assert (tdg[c] is None) == (jdg[c] is None), c
        if tdg[c] is not None:
            np.testing.assert_allclose(_np(tdg[c]), _np(jdg[c]), **TIGHT)


def test_acceleration_batched(kerr, events):
    jm, jp, tm, tp = kerr
    x, v = events
    ja = jgeo.acceleration_batched(jm.fn, jnp.asarray(x), jnp.asarray(v), jp,
                                   deps=jm.depends_on, nz=jm.nonzeros())
    ta = tgeo.acceleration_batched(tm.fn, torch.from_numpy(x),
                                   torch.from_numpy(v), tp,
                                   deps=tm.depends_on, nz=tm.nonzeros())
    np.testing.assert_allclose(_np(ta), _np(ja), **LOOSE)


def test_fix_null_batched(kerr, events):
    jm, jp, tm, tp = kerr
    x, v = events
    jv = jgeo.fix_null_batched(jm.fn(jnp.asarray(x), jp), jnp.asarray(v))
    tv = tgeo.fix_null_batched(tm.fn(torch.from_numpy(x), tp),
                               torch.from_numpy(v))
    np.testing.assert_allclose(_np(tv), _np(jv), **LOOSE)


def test_frame_basis_batched(kerr, events):
    jm, jp, tm, tp = kerr
    x, _ = events
    jes, jtl = jtet.frame_basis_batched(jm.fn(jnp.asarray(x), jp))
    tes, ttl = ttet.frame_basis_batched(tm.fn(torch.from_numpy(x), tp))
    np.testing.assert_array_equal(_np(ttl), _np(jtl))
    np.testing.assert_allclose(_np(tes), _np(jes), **LOOSE)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_observer_tetrad(kerr, seed):
    """Default flagship camera position (seed 0) and seeded positions with a
    seeded observer 3-velocity."""
    jm, jp, tm, tp = kerr
    rng = np.random.default_rng(seed)
    if seed == 0:
        pos = np.array([0.0, 7.0, np.pi / 2, -np.pi / 2], np.float32)
        speed = np.zeros(3, np.float32)
    else:
        pos = np.array([0.0, rng.uniform(3.0, 15.0),
                        rng.uniform(0.3, np.pi - 0.3),
                        rng.uniform(-np.pi, np.pi)], np.float32)
        speed = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    jes = jcam.observer_tetrad(jm, jnp.asarray(pos), jp,
                               basis_speed3=jnp.asarray(speed))
    tes = tcam.observer_tetrad(tm, torch.from_numpy(pos), tp,
                               basis_speed3=torch.from_numpy(speed))
    np.testing.assert_allclose(_np(tes), _np(jes), **LOOSE)


def test_camera_rotate_and_arctan2():
    """Camera.rotate quaternions, and the reference's polynomial arctan2
    over all quadrants and the axes."""
    jq = jcam.Camera.default().rotate(yaw=0.3, pitch=-np.pi / 2, roll=0.1)
    tq = tcam.Camera.default(device="cpu").rotate(yaw=0.3, pitch=-np.pi / 2,
                                                  roll=0.1)
    np.testing.assert_allclose(_np(tq.quat), _np(jq.quat), rtol=1e-6,
                               atol=1e-7)
    rng = np.random.default_rng(3)
    y = np.concatenate([rng.normal(size=64), [0.0, 1.0, -1.0, 0.0]])
    x = np.concatenate([rng.normal(size=64), [0.0, 0.0, 0.0, -2.0]])
    y, x = y.astype(np.float32), x.astype(np.float32)
    np.testing.assert_allclose(
        _np(tgeo.arctan2(torch.from_numpy(y), torch.from_numpy(x))),
        _np(jgeo.arctan2(jnp.asarray(y), jnp.asarray(x))), **TIGHT)


def _arctan2_points():
    """Points in all four quadrants, on both axes, at the origin and with
    |y/x| around 1 (the polynomial's reduction boundary)."""
    rng = np.random.default_rng(4)
    y = np.concatenate([rng.normal(size=32), [0.0, 1.0, -1.0, 0.0, 0.0],
                        [1.0, -1.0, 1.0001, -0.9999, 2.0, -3.0]])
    x = np.concatenate([rng.normal(size=32), [0.0, 0.0, 0.0, -2.0, 3.0],
                        [1.0, 1.0, -1.0, -1.0, 2.0000002, -3.0]])
    return y.astype(np.float32), x.astype(np.float32)


def test_arctan2_reverse_mode_matches_jax_grad():
    """``arctan2``'s reverse rule is the transpose of its exact tangent, as
    ``jax.grad`` forms it from the reference's ``defjvp``: the gradient of a
    weighted sum, d/dy and d/dx, equals JAX's bit for bit in float32 (TIGHT
    bounds it), the origin included (d clamped to 1e-37 gives 0)."""
    import jax

    y, x = _arctan2_points()
    w = np.random.default_rng(5).normal(size=y.shape).astype(np.float32)
    jg = jax.grad(lambda a, b: jnp.sum(jgeo.arctan2(a, b) * w),
                  argnums=(0, 1))(jnp.asarray(y), jnp.asarray(x))
    ty = torch.from_numpy(y).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    tg = torch.autograd.grad(
        torch.sum(tgeo.arctan2(ty, tx) * torch.from_numpy(w)), (ty, tx))
    for t, j in zip(tg, jg):
        assert np.isfinite(_np(t)).all()
        np.testing.assert_allclose(_np(t), _np(j), **TIGHT)
    # A scalar y against a batch of x: the gradient sums over the broadcast.
    ty0 = torch.tensor(0.7, requires_grad=True)
    g0, = torch.autograd.grad(torch.sum(tgeo.arctan2(ty0, tx.detach())), ty0)
    j0 = jax.grad(lambda a: jnp.sum(jgeo.arctan2(a, jnp.asarray(x))))(
        jnp.float32(0.7))
    np.testing.assert_allclose(float(g0), float(j0), **TIGHT)


def test_arctan2_reverse_over_forward_matches_jax():
    """The integrator differentiates its charts in forward mode and the fit
    takes the gradient of that in reverse: the reverse pass of
    ``torch.func.jvp(arctan2)``'s tangent equals ``jax.grad`` of
    ``jax.jvp``'s."""
    import jax

    y, x = _arctan2_points()
    rng = np.random.default_rng(6)
    dy, dx, w = (rng.normal(size=y.shape).astype(np.float32)
                 for _ in range(3))

    def jloss(a, b):
        _, t = jax.jvp(jgeo.arctan2, (a, b), (jnp.asarray(dy),
                                              jnp.asarray(dx)))
        return jnp.sum(t * w)

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(y), jnp.asarray(x))
    ty = torch.from_numpy(y).requires_grad_()
    tx = torch.from_numpy(x).requires_grad_()
    _, tt = torch.func.jvp(tgeo.arctan2, (ty, tx), (torch.from_numpy(dy),
                                                     torch.from_numpy(dx)))
    tg = torch.autograd.grad(torch.sum(tt * torch.from_numpy(w)), (ty, tx))
    # Away from the origin, where 1/d^2 overflows float32 in both.
    ok = (x * x + y * y) > 1e-6
    for t, j in zip(tg, jg):
        np.testing.assert_allclose(_np(t)[ok], _np(j)[ok], **LOOSE)


def _arctan_points():
    """Both signs, |x| either side of 1 and of tan(pi/8) (the polynomial's
    two reduction boundaries), 0, and a spread of magnitudes."""
    rng = np.random.default_rng(7)
    edges = [1.0, 0.99999, 1.00001, 0.41421357, 0.4142135, 0.4142137, 0.0,
             1e-3, 30.0, 1e4]
    x = np.concatenate([rng.normal(size=48) * 3, edges,
                        [-e for e in edges]])
    return x.astype(np.float32)


def test_arctan_matches_jax():
    """``arctan`` (the reference's polynomial) against JAX's: the value
    bit for bit in float32 (TIGHT bounds it), within 2e-7 of numpy's atan,
    and its tangent dx / (1 + x^2) in forward mode."""
    import jax

    x = _arctan_points()
    tx = torch.from_numpy(x)
    got = _np(tgeo.arctan(tx))
    np.testing.assert_allclose(got, _np(jgeo.arctan(jnp.asarray(x))),
                               **TIGHT)
    np.testing.assert_allclose(got, np.arctan(x.astype(np.float64)),
                               atol=2e-7, rtol=2e-7)
    dx = np.random.default_rng(8).normal(size=x.shape).astype(np.float32)
    _, tt = torch.func.jvp(tgeo.arctan, (tx,), (torch.from_numpy(dx),))
    _, jt = jax.jvp(jgeo.arctan, (jnp.asarray(x),), (jnp.asarray(dx),))
    np.testing.assert_allclose(_np(tt), _np(jt), **TIGHT)


def test_arctan_reverse_mode_matches_jax_grad():
    """``arctan``'s reverse rule is the transpose of its exact tangent, as
    ``jax.grad`` forms it from the reference's ``defjvp``: the gradient of
    a weighted sum equals JAX's, and so does the reverse pass of its
    ``torch.func.jvp`` tangent (reverse over forward, as the fit takes
    it)."""
    import jax

    x = _arctan_points()
    w = np.random.default_rng(9).normal(size=x.shape).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jgeo.arctan(a) * w))(jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_()
    tg, = torch.autograd.grad(torch.sum(tgeo.arctan(tx)
                                        * torch.from_numpy(w)), tx)
    assert np.isfinite(_np(tg)).all()
    np.testing.assert_allclose(_np(tg), _np(jg), **TIGHT)
    dx = np.random.default_rng(10).normal(size=x.shape).astype(np.float32)

    def jloss(a):
        _, t = jax.jvp(jgeo.arctan, (a,), (jnp.asarray(dx),))
        return jnp.sum(t * w)

    jg2 = jax.grad(jloss)(jnp.asarray(x))
    _, tt = torch.func.jvp(tgeo.arctan, (tx,), (torch.from_numpy(dx),))
    tg2, = torch.autograd.grad(torch.sum(tt * torch.from_numpy(w)), tx)
    np.testing.assert_allclose(_np(tg2), _np(jg2), **LOOSE)


def test_pow_pos_at_and_below_zero():
    """``pow_pos``: the reference's exp(log(max(b, 1e-37)) e), and exactly
    0, value and derivatives in both modes, where b <= 0, as JAX's."""
    import jax

    b = np.array([0.0, -2.0, 8.0, 1e-3, 2.5], np.float32)
    tb = torch.from_numpy(b).requires_grad_()
    y = tgeo.pow_pos(tb, 1.0 / 3.0)
    g, = torch.autograd.grad(y.sum(), tb)
    jy = jgeo.pow_pos(jnp.asarray(b), 1.0 / 3.0)
    jg = jax.grad(lambda a: jnp.sum(jgeo.pow_pos(a, 1.0 / 3.0)))(
        jnp.asarray(b))
    np.testing.assert_allclose(_np(y), _np(jy), **TIGHT)
    np.testing.assert_allclose(_np(g), _np(jg), **TIGHT)
    assert _np(y)[0] == 0 and _np(y)[1] == 0
    assert _np(g)[0] == 0 and _np(g)[1] == 0
    np.testing.assert_allclose(_np(y)[2], 2.0, rtol=1e-6)
