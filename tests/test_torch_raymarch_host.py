"""The ray-march kernel's per-ray arithmetic, compiled as host code.

``csrc/march.cuh`` (the step with all its branches, the loop, the typed
metric entries and their dual partials) is plain C++ when compiled by g++
(its CUDA qualifier macros are empty).  The kernel's metric is a struct
that ``ops/emit.py`` writes from the torch metric; ``torch_emit_host``
builds such structs with ``SHIM`` below (the march loop over an (N,)-ray
state) into a temporary shared library, loaded with ctypes, and runs them
against the plain torch march: the only check of the kernel's arithmetic
that runs without a GPU.  This file holds the march's own branches
(``kerr_boyer``'s 64 rays and step budget, a tilted ``schwarzschild``
set, the Euler and reparameterised steps, the config branches no
registered metric sets); every registered metric's struct, dynamic,
baked, 4-D and planar, is held by the ``test_torch_emit_builtins_*``
files.

Tolerances.  ``kerr_boyer`` (those of ray set (a) in chip_smoke.py): fates
equal on all 64 rays, step counts on at least 62, escaped positions within
1e-4 where the step counts agree (libm's sin/cos and torch's may differ in
the last ulp).  The other instances: fates and step counts equal on every
ray, positions of all rays within 1e-4 (rtol and atol).
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import ray_set
from geodesic_raytracing_tpu_torch import metrics
from geodesic_raytracing_tpu_torch.ops import emit, integrate
from test_integrator import make_rays

torch.set_num_threads(1)

CSRC = Path(integrate.__file__).resolve().parents[1] / "csrc"

# The march loop of the host build: every ray of an (N,)-ray state in index
# order through ``march_ray`` with a metric struct (an emitted header comes
# in before it) and the step options of the arguments.
SHIM = r"""
#include "march.cuh"

namespace {

struct Arrays {
  float *pos, *vel, *acc, *next_ds, *rdl;
  int *status, *steps;
  const float* f_in_x;
};

template <class Opt, class M>
void march_all(const M& m, const grt::Features& f, int n, int max_steps,
               const Arrays& a) {
  for (int i = 0; i < n; ++i) {
    if (a.status[i] != grt::ACTIVE) continue;
    grt::Ray s;
    for (int c = 0; c < 4; ++c) {
      s.pos[c] = a.pos[4 * i + c];
      s.vel[c] = a.vel[4 * i + c];
      s.acc[c] = a.acc[4 * i + c];
    }
    s.next_ds = a.next_ds[i];
    s.rdl = a.rdl[i];
    s.status = a.status[i];
    s.steps = a.steps[i];
    grt::march_ray<Opt>(m, f, a.f_in_x[i], max_steps, s);
    for (int c = 0; c < 4; ++c) {
      a.pos[4 * i + c] = s.pos[c];
      a.vel[4 * i + c] = s.vel[c];
      a.acc[4 * i + c] = s.acc[c];
    }
    a.next_ds[i] = s.next_ds;
    a.rdl[i] = s.rdl;
    a.status[i] = s.status;
    a.steps[i] = s.steps;
  }
}

template <class M>
void march_options(const float* mparams, const grt::Features& f, int planar,
                   int euler, int reparam, int n, int max_steps,
                   const Arrays& a) {
  const M m = M::from_params(mparams);
#define GO(P, E, R) \
  march_all<grt::StepOptions<P, E, R>>(m, f, n, max_steps, a)
  if (euler) return planar ? GO(true, true, false) : GO(false, true, false);
  if (reparam) return planar ? GO(true, false, true) : GO(false, false, true);
  return planar ? GO(true, false, false) : GO(false, false, false);
#undef GO
}

}  // namespace
"""

# Schwarzschild with a replaced config: the cylindrical terminator at r < 3,
# and no blow-up test, which no registered metric's config sets.
REPLACED = {
    "cylindrical": dict(has_cylindrical_singularity=True,
                        cylindrical_terminator=3.0),
    "nonsingular": dict(unconditionally_nonsingular=True),
}


def replaced(key):
    base = metrics.get_metric("schwarzschild")
    return dataclasses.replace(base, config=dataclasses.replace(
        base.config, **REPLACED[key]))


@pytest.fixture(scope="module")
def host_march(tmp_path_factory):
    """``run(key, state, params, features, opts)``: the host march of the
    emitted dynamic struct of ``kerr_boyer``, ``schwarzschild`` or a
    ``REPLACED`` config of it, with any trace option."""
    import torch_emit_host as eh

    ms = {n: metrics.get_metric(n) for n in ("kerr_boyer", "schwarzschild")}
    ms.update((k, replaced(k)) for k in REPLACED)
    headers = {k: emit.emit_metric(m) for k, m in ms.items()}
    lib = eh.build(list(headers.values()),
                   tmp_path_factory.mktemp("march_host"),
                   every_option=[h.struct for h in headers.values()])

    def run(key, state, params, features, opts):
        h = headers[key]
        return eh.host_march(lib[h.struct], h, state, params, features, opts)

    return run


def test_host_march_matches_plain_torch(host_march):
    m = metrics.get_metric("kerr_boyer")
    params = m.params()
    feats = integrate.Features.for_metric(m)
    pos, vel = (np.asarray(a) for a in make_rays(64))
    st = integrate.init_ray_state(m, torch.from_numpy(pos),
                                  torch.from_numpy(vel), params, feats)
    st.status[::7] = integrate.DEAD
    opts = integrate.TraceOptions(max_steps=4096)
    host = host_march("kerr_boyer", st, params, feats, opts)
    ref = integrate.trace_rays_reference(m, st, params, feats, opts)

    np.testing.assert_array_equal(host.status.numpy(), ref.status.numpy())
    steps_eq = host.steps.numpy() == ref.steps.numpy()
    assert steps_eq.sum() >= 62, steps_eq.sum()
    ok = (ref.status.numpy() == integrate.ESCAPED) & steps_eq
    assert ok.sum() >= 16
    np.testing.assert_allclose(host.position.numpy()[ok],
                               ref.position.numpy()[ok], rtol=1e-4,
                               atol=1e-4)


def test_host_march_step_budget(host_march):
    """The budget counts trial iterations (the while driver's), not
    committed steps: with a budget of 5 no ray commits more than 5 steps
    and the rays still marching stay ACTIVE, exactly as the plain march."""
    m = metrics.get_metric("kerr_boyer")
    params = m.params()
    feats = integrate.Features.for_metric(m)
    pos, vel = (np.asarray(a) for a in make_rays(16))
    st = integrate.init_ray_state(m, torch.from_numpy(pos),
                                  torch.from_numpy(vel), params, feats)
    opts = integrate.TraceOptions(max_steps=5)
    host = host_march("kerr_boyer", st, params, feats, opts)
    ref = integrate.trace_rays_reference(m, st, params, feats, opts)
    np.testing.assert_array_equal(host.status.numpy(), ref.status.numpy())
    np.testing.assert_array_equal(host.steps.numpy(), ref.steps.numpy())
    assert (host.steps.numpy() <= 5).all()
    assert (host.status.numpy() == integrate.ACTIVE).all()


def generic_rays(m, params, n=64, tilt=0.0):
    """``make_rays(n)`` (polar position and velocity) in the chart of
    ``m``, through its ``from_polar``; ``tilt`` adds a theta velocity, so
    that the rays leave the equator; ``chip_smoke.RAY_SET`` adapts the set
    to a metric where it would have no escaped ray or miss a branch (as
    ``chip_smoke.chart_rays``)."""
    pos, vel = ray_set(m.name, n, tilt)
    p, v = torch.from_numpy(pos).T, torch.from_numpy(vel).T
    return (m.from_polar(p, params).T.contiguous(),
            m.from_polar_velocity(p, v, params).T.contiguous())


def _assert_same_march(host, ref, min_escaped, dead_velocity_rtol=1e-4):
    np.testing.assert_array_equal(host.status.numpy(), ref.status.numpy())
    np.testing.assert_array_equal(host.steps.numpy(), ref.steps.numpy())
    assert (ref.status.numpy() == integrate.ESCAPED).sum() >= min_escaped
    dead = ref.status.numpy() == integrate.DEAD
    for name in ("position", "velocity", "next_ds", "running_dlambda_dnew"):
        a, b = getattr(host, name).numpy(), getattr(ref, name).numpy()
        if name == "velocity":
            np.testing.assert_allclose(a[dead], b[dead],
                                       rtol=dead_velocity_rtol, atol=1e-4,
                                       err_msg="velocity of DEAD rays")
            a, b = a[~dead], b[~dead]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)


# The Kerr family is held as kerr_boyer is
# (torch_emit_host.assert_kerr_family).
KERR_FAMILY = ("kerr_boyer", "kerr_newman_boyer", "kerr_ingoing_ef",
               "kerr_rational_polynomial", "kerr_schild", "kerr_newman_schild")


# Metrics whose rays the blow-up test stops at a horizon, where |v^t| has
# grown past 1000 within the last steps and carries an ulp of torch's CPU
# sqrt (not correctly rounded) against glibc's sqrtf, amplified by that
# growth: double_schwarzschild's velocities of 4 such rays differ by up to
# 2.8e-4 of themselves (positions, fates and step counts agree).
BLOW_UP_DEAD_VELOCITY_RTOL = {"double_schwarzschild": 1e-3}


# Metrics whose rays cross a tanh wall (the Alcubierre bubble, the forming
# Krasnikov tube), where 1 + tanh cancels: there glibc's tanhf (the host
# build's) and torch's CPU tanh, which differ on 7% of float32 inputs, part
# the marches by more than float32 resolves (the float32 plain march itself
# is up to 2.3e-3 and 0.048 from the float64 one).
TANH_WALL = ("alcubierre", "krasnikov_tube")


def _assert_same_march_tanh_wall(host, ref, m, st, params, feats, opts):
    """Fates and step counts equal on every ray; positions within 1e-4 on
    the escaped rays that float32 resolves to 1e-4 (the float32 plain march
    within 1e-4 of the float64 one), of which there are at least 4
    (alcubierre: 5 of 54, its flat region's acceleration being the
    cancellation; krasnikov_tube: 34 of 54, all but the rays through the
    tube's wall)."""
    np.testing.assert_array_equal(host.status.numpy(), ref.status.numpy())
    np.testing.assert_array_equal(host.steps.numpy(), ref.steps.numpy())
    st64 = integrate.RayState(*(t.double() if t.dtype == torch.float32
                                else t for t in st))
    r64 = integrate.trace_rays_reference(m, st64, params, feats, opts)
    np.testing.assert_array_equal(r64.status.numpy(), ref.status.numpy())
    esc = ref.status.numpy() == integrate.ESCAPED
    err32 = np.abs(ref.position.numpy() - r64.position.numpy()).max(1)
    well = esc & (err32 <= 1e-4)
    assert esc.sum() >= 16 and well.sum() >= 4, (esc.sum(), well.sum())
    np.testing.assert_allclose(host.position.numpy()[well],
                               ref.position.numpy()[well], rtol=1e-4,
                               atol=1e-4)


def test_host_instance_off_the_equator(host_march):
    """The 4-D schwarzschild instance on rays with a theta velocity: the
    theta tangent and both trigonometric values are live (fates equal on
    all 32 rays, step counts on at least 30, as for kerr_boyer)."""
    m = metrics.get_metric("schwarzschild")
    params = m.params()
    feats = integrate.Features.for_metric(m)
    st = integrate.init_ray_state(m, *generic_rays(m, params, 32, tilt=0.03),
                                  params, feats)
    opts = integrate.TraceOptions(max_steps=4096)
    host = host_march("schwarzschild", st, params, feats, opts)
    ref = integrate.trace_rays_reference(m, st, params, feats, opts)
    np.testing.assert_array_equal(host.status.numpy(), ref.status.numpy())
    steps_eq = host.steps.numpy() == ref.steps.numpy()
    assert steps_eq.sum() >= 30, steps_eq.sum()
    ok = (ref.status.numpy() == integrate.ESCAPED) & steps_eq
    assert ok.sum() >= 8
    assert np.abs(ref.position.numpy()[ok, 2] - np.pi / 2).max() > 0.05
    np.testing.assert_allclose(host.position.numpy()[ok],
                               ref.position.numpy()[ok], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("option", [dict(integrator="euler"),
                                    dict(reparameterisation=True)])
def test_host_step_options_match_plain_torch(host_march, option, planar):
    """The Euler integrator and Verlet with affine reparameterisation on
    schwarzschild, 4-D and planar."""
    m = metrics.get_metric("schwarzschild")
    params = m.params()
    feats = integrate.Features.for_metric(m)
    st = integrate.init_ray_state(m, *generic_rays(m, params), params, feats)
    opts = integrate.TraceOptions(max_steps=2048, planar=planar, **option)
    host = host_march("schwarzschild", st, params, feats, opts)
    ref = integrate.trace_rays_reference(m, st, params, feats, opts)
    _assert_same_march(host, ref, 16)
    if option.get("reparameterisation"):
        assert (ref.running_dlambda_dnew.numpy() != 1.0).any()


@pytest.mark.parametrize("key", sorted(REPLACED))
def test_host_replaced_config_branches(host_march, key):
    """The cylindrical terminator and ``unconditionally_nonsingular``, which
    no registered metric's config sets: the struct emitted from
    schwarzschild with a replaced config against the plain march of that
    metric."""
    base = metrics.get_metric("schwarzschild")
    m = replaced(key)
    params = m.params()
    feats = integrate.Features.for_metric(m)
    st = integrate.init_ray_state(m, *generic_rays(m, params), params, feats)
    opts = integrate.TraceOptions(max_steps=2048)
    host = host_march(key, st, params, feats, opts)
    ref = integrate.trace_rays_reference(m, st, params, feats, opts)
    _assert_same_march(host, ref, 16)
    plain = integrate.trace_rays_reference(base, st, params, feats, opts)
    if key == "cylindrical":
        # Rays that the plain config lets fall further die at r < 3.
        dead = ref.status.numpy() == integrate.DEAD
        assert dead.any() and (ref.steps.numpy()[dead]
                               < plain.steps.numpy()[dead]).all()
    else:
        # Without the blow-up test the same rays die, by the controller.
        np.testing.assert_array_equal(ref.status.numpy(),
                                      plain.status.numpy())
