"""Port parity: ``ops/planar.py`` against the JAX package (CPU).

The same numpy rays, made from a seed, go through ``to_planar`` and
``unrotate_angles`` of both packages: positions, velocities and inverse
quaternions within atol 1e-5 (rtol 1e-5).  The set holds a ray already in
the equatorial plane (the degenerate axis fallback) and one with no spatial
velocity (the fallback direction).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.ops import planar as jplanar
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.ops import planar as tplanar

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)


def _rays(n=96, seed=0):
    """(4, n) polar positions and velocities; ray 0 lies in the equator and
    moves in it, ray 1 has no spatial velocity, ray 2 is at r < 0."""
    rng = np.random.default_rng(seed)
    pos = np.stack([rng.uniform(-3, 3, n), rng.uniform(2, 12, n),
                    rng.uniform(0.3, np.pi - 0.3, n),
                    rng.uniform(-np.pi, np.pi, n)])
    vel = np.stack([np.ones(n), rng.uniform(-1, 1, n),
                    rng.uniform(-0.2, 0.2, n), rng.uniform(-0.2, 0.2, n)])
    pos[2, 0], vel[2, 0] = np.pi / 2, 0.0
    vel[1:, 1] = 0.0
    pos[1, 2] = -pos[1, 2]
    return pos.astype(np.float32), vel.astype(np.float32)


@pytest.mark.parametrize("name", ["schwarzschild",
                                  "schwarzschild_ingoing_ef"])
def test_to_planar_matches_jax(name):
    jm, tm = jmetrics.get_metric(name), tmetrics.get_metric(name)
    pos, vel = _rays()
    # The rays in the metric's own chart.
    gp = np.asarray(jm.from_polar(jnp.asarray(pos), jm.params()))
    gv = np.asarray(jm.from_polar_velocity(jnp.asarray(pos),
                                           jnp.asarray(vel), jm.params()))
    jp, jv, jq = jplanar.to_planar(jm, jnp.asarray(gp), jnp.asarray(gv),
                                   jm.params())
    tp, tv, tq = tplanar.to_planar(tm, torch.from_numpy(gp),
                                   torch.from_numpy(gv), tm.params())
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), **TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    # The exact pin: theta is the float pi/2 and v_theta exactly 0.
    assert (tp[2].numpy() == np.float32(np.pi / 2)).all()
    assert (tv[2].numpy() == 0).all()
    # The ray that was in the equator stays at its radius (its plane's
    # normal points along -z, so it is turned by pi about an axis of the
    # equator, not left alone).
    np.testing.assert_allclose(tp[1, 0].numpy(), gp[1, 0], rtol=1e-5)
    np.testing.assert_allclose(np.abs(tq[:, 0].numpy()[[2, 3]]), 0.0,
                               atol=1e-6)
    assert np.isfinite(tq.numpy()).all() and np.isfinite(tp.numpy()).all()


def test_theta_adjustment_quat_matches_jax():
    rng = np.random.default_rng(3)
    v = rng.normal(size=(3, 64)).astype(np.float32)
    c = rng.normal(size=(3, 64)).astype(np.float32) * 5
    v[:, 0] = 0.0                      # no velocity: the fallback direction
    v[:, 1], c[:, 1] = (1, 0, 0), (0, -4, 0)   # plane already equatorial
    for sign in (1.0, -1.0):
        want = np.asarray(jplanar.theta_adjustment_quat(
            jnp.asarray(v), jnp.asarray(c), sign))
        got = tplanar.theta_adjustment_quat(torch.from_numpy(v),
                                            torch.from_numpy(c), sign).numpy()
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_allclose((got * got).sum(0), 1.0, atol=1e-5)


def test_unrotate_angles_round_trip_and_jax():
    """``unrotate_angles`` of the planar position gives back the ray's own
    (r, theta, phi), and equals JAX's on the same inputs."""
    tm = tmetrics.get_metric("schwarzschild")
    pos, vel = _rays(seed=5)
    tp, _, tq = tplanar.to_planar(tm, torch.from_numpy(pos),
                                  torch.from_numpy(vel), tm.params())
    back = tplanar.unrotate_angles(tp[1:], tq).numpy()
    want = np.asarray(jplanar.unrotate_angles(jnp.asarray(tp[1:].numpy()),
                                              jnp.asarray(tq.numpy())))
    np.testing.assert_allclose(back, want, **TOL)
    np.testing.assert_allclose(back[0], pos[1], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(back[1], pos[2], atol=2e-5)
    dphi = np.angle(np.exp(1j * (back[2] - pos[3])))
    np.testing.assert_allclose(dphi, 0.0, atol=2e-5)
