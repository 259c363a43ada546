"""Port parity: every branch of the integrator step, the plain torch march
(``trace_rays_reference``, the CUDA kernel's twin) against the JAX package's
``while`` method and its Pallas kernel in interpret mode (CPU).

The rays are ``make_rays(64)`` of tests/test_integrator.py, moved once into
each metric's own chart (numpy arrays that both packages then take as they
are), every 7th born DEAD.  Tolerances: fates equal on every ray, step
counts equal on every ray, positions of escaped rays within 1e-4 (rtol and
atol).  The rays lie in the equator, where theta keeps the one float value
pi/2, so no transcendental of a differing last ulp enters the march; the
off-equator set allows two step counts in 32 to differ, as the
``kerr_boyer`` tests do.

Positions are held where the march is well-conditioned: a ray that escapes
at the universe sphere ends at |r| of 20 to 25.  With a scheduled step (a
config without adaptive precision, or the Euler integrator) a ray can step
across a horizon, where g_rr changes sign, and is flung out to |r| of 1e3
to 1e5 in a few more steps (so can a ``de_sitter`` ray at its cosmological
horizon, r = 17.3, inside the universe sphere).  Both packages fling the
same rays after the same number of steps, but where to amplifies the last
ulp to 1e-3 and more: of those rays the fate and the step count are held,
not the position, and the rays of such a march that do end at the universe
sphere are held to 1e-3 (``SCHEDULED_TOL``; measured up to 4.8e-4), since
some of them grazed the horizon on the way.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.ops import integrate as jint
from geodesic_raytracing_tpu.ops.pallas import trace_rays_pallas
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.ops import integrate as tint
from test_integrator import make_rays

torch.set_num_threads(1)

SEVEN = ("minkowski", "minkowski_skew", "schwarzschild",
         "schwarzschild_fast", "schwarzschild_skewed",
         "schwarzschild_ingoing_ef", "de_sitter")
SYMMETRIC = tuple(n for n in SEVEN
                  if tmetrics.get_metric(n).spherically_symmetric)


def _rays(name, n=64, tilt=0.0):
    """``make_rays(n)`` in the chart of metric ``name`` as numpy (N, 4)."""
    m = tmetrics.get_metric(name)
    pos, vel = (np.array(a) for a in make_rays(n))
    vel[:, 2] = tilt
    p, v = torch.from_numpy(pos).T, torch.from_numpy(vel).T
    return (m.from_polar(p, m.params()).T.contiguous().numpy(),
            m.from_polar_velocity(p, v, m.params()).T.contiguous().numpy())


def _both(name, opts_kw, config=None, n=64, tilt=0.0, max_steps=4096,
          kill=True):
    """(JAX final, port final, JAX launch state, JAX metric, features) of
    one march of both packages on the same rays."""
    jm, tm = jmetrics.get_metric(name), tmetrics.get_metric(name)
    if config:
        jm = dataclasses.replace(jm, config=jm.config.replace(**config))
        tm = dataclasses.replace(
            tm, config=dataclasses.replace(tm.config, **config))
    pos, vel = _rays(name, n, tilt)
    jf, tf = jint.Features.for_metric(jm), tint.Features.for_metric(tm)
    assert tuple(jf) == tuple(tf)
    jst = jint.init_ray_state(jm, jnp.asarray(pos), jnp.asarray(vel),
                              jm.params(), jf)
    tst = tint.init_ray_state(tm, torch.from_numpy(pos),
                              torch.from_numpy(vel), tm.params(), tf)
    if kill:
        jst = jst._replace(status=jst.status.at[::7].set(2))
        tst.status[::7] = tint.DEAD
    for name_ in ("position", "velocity", "acceleration", "next_ds"):
        np.testing.assert_allclose(getattr(tst, name_).numpy(),
                                   np.asarray(getattr(jst, name_)),
                                   rtol=1e-5, atol=1e-6, err_msg=name_)
    jfin = jint.trace_rays(jm, jst, jm.params(), features=jf,
                           opts=jint.TraceOptions(max_steps=max_steps,
                                                  **opts_kw))
    tfin = tint.trace_rays(tm, tst, tm.params(), tf,
                           tint.TraceOptions(max_steps=max_steps, **opts_kw))
    return jfin, tfin, jst, jm, jf


def _polar_r(fin, name):
    """|r| of the port's final positions, through the chart of ``name``."""
    m = tmetrics.get_metric(name)
    return np.abs(m.to_polar(fin.position.T, m.params())[1].numpy())


SCHEDULED_TOL = 1e-3


def _assert_parity(ref, fin, name="schwarzschild", min_steps_eq=None,
                   min_escaped=8, pos_tol=1e-4, only=None):
    rs = np.asarray(ref.status)
    np.testing.assert_array_equal(fin.status.numpy(), rs)
    assert (rs != jint.ACTIVE).all()
    steps_eq = fin.steps.numpy() == np.asarray(ref.steps)
    if min_steps_eq is None:
        np.testing.assert_array_equal(fin.steps.numpy(),
                                      np.asarray(ref.steps))
    else:
        assert steps_eq.sum() >= min_steps_eq, steps_eq.sum()
    ok = (rs == jint.ESCAPED) & steps_eq & (
        _polar_r(fin, name) <= 2 * jint.Features().universe_size)
    if only is not None:
        ok &= only
    assert ok.sum() >= min_escaped, ok.sum()
    np.testing.assert_allclose(fin.position.numpy()[ok],
                               np.asarray(ref.position)[ok], rtol=pos_tol,
                               atol=pos_tol)
    np.testing.assert_allclose(fin.running_dlambda_dnew.numpy()[ok],
                               np.asarray(ref.running_dlambda_dnew)[ok],
                               rtol=pos_tol)


CASES = [(n, False) for n in SEVEN] + [(n, True) for n in SYMMETRIC]


@pytest.mark.parametrize("name,planar", CASES)
def test_plain_march_matches_jax_while(name, planar):
    """Each of the seven metrics 4-D, the spherically symmetric ones in
    planar mode too: between them the adaptive and the scheduled step, the
    singular terminator, no tangent at all, time in slot 1, an
    off-diagonal entry."""
    jfin, tfin, *_ = _both(name, dict(planar=planar))
    _assert_parity(jfin, tfin, name,
                   pos_tol=SCHEDULED_TOL if name == "de_sitter" else 1e-4)
    # Rays born DEAD are never marched.
    assert (tfin.steps.numpy()[::7] == 0).all()


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("option", [dict(integrator="euler"),
                                    dict(reparameterisation=True)])
def test_step_options_match_jax(option, planar):
    jfin, tfin, *_ = _both("schwarzschild", dict(planar=planar, **option),
                           max_steps=2048)
    # Euler (a scheduled step): positions of the rays that escape under the
    # adaptive Verlet march too, which never came near the hole.
    verlet = _both("schwarzschild", dict(planar=planar), max_steps=2048)[1]
    _assert_parity(jfin, tfin, pos_tol=SCHEDULED_TOL if "integrator" in option
                   else 1e-4, only=verlet.status.numpy() == tint.ESCAPED)
    if "reparameterisation" in option:
        assert (tfin.running_dlambda_dnew.numpy() != 1.0).any()
    else:
        # The Euler step takes the scheduled ds and never rejects a trial.
        assert (tfin.next_ds.numpy()[1] ==
                np.asarray(_both("schwarzschild", {}, max_steps=1)[2]
                           .next_ds)[1])


@pytest.mark.parametrize("config", [
    dict(has_cylindrical_singularity=True, cylindrical_terminator=3.0),
    dict(unconditionally_nonsingular=True),
    dict(singular=True, singular_terminator=1.5),
    dict(adaptive_precision=False),
    dict(detect_singularities=False),
])
def test_replaced_config_branches_match_jax(config):
    """The cylindrical terminator and ``unconditionally_nonsingular`` (which
    no ported metric's config sets) and the other config bits, each flipped
    on ``schwarzschild`` in both packages."""
    jfin, tfin, *_ = _both("schwarzschild", {}, config=config,
                           max_steps=2048)
    _assert_parity(jfin, tfin, pos_tol=SCHEDULED_TOL
                   if config.get("adaptive_precision") is False else 1e-4)
    plain = _both("schwarzschild", {}, max_steps=2048)[1]
    if "has_cylindrical_singularity" in config:
        dead = tfin.status.numpy() == tint.DEAD
        assert (tfin.position.numpy()[dead & (tfin.steps.numpy() > 0), 1]
                < 3.1).all()
        assert (tfin.steps.numpy()[dead] <= plain.steps.numpy()[dead]).all()
    if config.get("singular"):
        # Rays that reach r < 1.5 escape there instead of dying.
        fell = plain.status.numpy() == tint.DEAD
        fell[::7] = False
        assert (tfin.status.numpy()[fell] == tint.ESCAPED).all()


def test_off_equator_rays_match_jax():
    """The 4-D ``schwarzschild`` march with a theta velocity: the theta
    partials and the live sine and cosine."""
    jfin, tfin, *_ = _both("schwarzschild", {}, n=32, tilt=0.03, kill=False)
    _assert_parity(jfin, tfin, min_steps_eq=30)
    assert np.abs(tfin.position.numpy()[:, 2] - np.pi / 2).max() > 0.05


def test_planar_march_matches_pallas_interpret():
    """``schwarzschild`` in planar mode against the TPU kernel as
    tests/test_integrator.py runs it on the CPU (interpret mode)."""
    jfin, tfin, jst, jm, jf = _both("schwarzschild", dict(planar=True),
                                    n=32, max_steps=1024, kill=False)
    pal = trace_rays_pallas(jm, jst, jm.params(), features=jf,
                            opts=jint.TraceOptions(max_steps=1024,
                                                   planar=True),
                            tile=16, interpret=True)
    _assert_parity(pal, tfin)
    _assert_parity(jfin, tfin)


def test_trace_options_reject_unknown_integrator():
    with pytest.raises(ValueError, match="unknown integrator"):
        tint.TraceOptions(integrator="rk4")


def test_schedule_constants_are_float32():
    inv_span, slope = tint.schedule_constants(tint.Features())
    assert inv_span == float(np.float32(1.0) / np.float32(7.0))
    assert slope == float(np.float32(0.3))
