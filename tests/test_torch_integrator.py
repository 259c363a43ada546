"""Port parity: the plain torch ray march (``trace_rays_reference``, the CUDA
kernel's twin) against the JAX reference's ``while`` driver and its Pallas
kernel in interpret mode, on the Kerr ``make_rays(64)`` set of
tests/test_integrator.py with every 7th ray killed (CPU).

Tolerances: fates equal on every ray; step counts equal on at least 62 of
64 (transcendental ulps differ between the frameworks and photon-ring rays
amplify them by ~1 bit per step); escaped positions within 1e-4 (rtol and
atol) where the step counts agree.
"""

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

MAX_STEPS = 4096
MIN_STEPS_EQ = 62


def _kerr_rays(n=64, r0=7.0, angles=None):
    pos, vel = make_rays(n, r0, angles)
    return np.asarray(pos), np.asarray(vel)


@pytest.fixture(scope="module")
def jax_state():
    m = jmetrics.get_metric("kerr_boyer")
    pos, vel = _kerr_rays()
    feats = jint.Features.for_metric(m)
    st = jint.init_ray_state(m, jnp.asarray(pos), jnp.asarray(vel),
                             m.params(), feats)
    return m, feats, st._replace(status=st.status.at[::7].set(2))


@pytest.fixture(scope="module")
def torch_final():
    m = tmetrics.get_metric("kerr_boyer")
    pos, vel = _kerr_rays()
    feats = tint.Features.for_metric(m)
    st = tint.init_ray_state(m, torch.from_numpy(pos), torch.from_numpy(vel),
                             m.params(), feats)
    st.status[::7] = tint.DEAD
    fin = tint.trace_rays(m, st, m.params(), feats,
                          tint.TraceOptions(max_steps=MAX_STEPS))
    return st, fin


def _assert_parity(ref, fin):
    rs = np.asarray(ref.status)
    np.testing.assert_array_equal(fin.status.numpy(), rs)
    steps_eq = fin.steps.numpy() == np.asarray(ref.steps)
    assert steps_eq.sum() >= MIN_STEPS_EQ, steps_eq.sum()
    ok = (rs == jint.ESCAPED) & steps_eq
    assert ok.sum() >= 16  # 22 of the 64 rays escape
    np.testing.assert_allclose(fin.position.numpy()[ok],
                               np.asarray(ref.position)[ok],
                               rtol=1e-4, atol=1e-4)


def test_init_ray_state_matches_jax(jax_state, torch_final):
    _, _, jst = jax_state
    tst, _ = torch_final
    for name in ("position", "velocity", "acceleration", "next_ds",
                 "running_dlambda_dnew"):
        np.testing.assert_allclose(getattr(tst, name).numpy(),
                                   np.asarray(getattr(jst, name)),
                                   rtol=1e-5, atol=1e-6, err_msg=name)
    np.testing.assert_array_equal(tst.status.numpy(), np.asarray(jst.status))


def test_plain_march_matches_jax_while(jax_state, torch_final):
    m, feats, st = jax_state
    ref = jint.trace_rays(m, st, m.params(), features=feats,
                          opts=jint.TraceOptions(max_steps=MAX_STEPS))
    _assert_parity(ref, torch_final[1])


def test_plain_march_matches_pallas_interpret(jax_state, torch_final):
    """The TPU kernel as tests/test_integrator.py runs it on the CPU."""
    m, feats, st = jax_state
    opts = jint.TraceOptions(max_steps=MAX_STEPS, queue_depth=4,
                             check_every=8)
    key = jnp.abs(st.velocity[:, 0])
    pal = trace_rays_pallas(m, st, m.params(), features=feats, opts=opts,
                            tile=16, interpret=True, sort_key=key)
    _assert_parity(pal, torch_final[1])


def test_kerr_conserved_quantities():
    """E = -g_t.v and L = g_phi.v are Killing invariants along Kerr
    geodesics: their drift stays within 2e-2 on escaped rays."""
    m = tmetrics.get_metric("kerr_boyer")
    params = m.params()
    pos, vel = _kerr_rays(6, 7.0, np.linspace(0.35, 0.5, 6))
    feats = tint.Features.for_metric(m)
    st = tint.init_ray_state(m, torch.from_numpy(pos), torch.from_numpy(vel),
                             params, feats)

    def invariants(state):
        x = state.position.T
        v = state.velocity.T / state.running_dlambda_dnew[None, :]
        g = m.fn(x, params)
        E = -(g[0, 0] * v[0] + g[0, 1] * v[1] + g[0, 2] * v[2]
              + g[0, 3] * v[3])
        L = (g[3, 0] * v[0] + g[3, 1] * v[1] + g[3, 2] * v[2]
             + g[3, 3] * v[3])
        return E.numpy(), L.numpy()

    E0, L0 = invariants(st)
    fin = tint.trace_rays(m, st, params, feats,
                          tint.TraceOptions(max_steps=16384))
    E1, L1 = invariants(fin)
    esc = fin.status.numpy() == tint.ESCAPED
    assert esc.any()
    np.testing.assert_allclose(E1[esc], E0[esc], rtol=2e-2)
    np.testing.assert_allclose(L1[esc], L0[esc], rtol=2e-2)
