"""The ray-march kernel's per-ray arithmetic, compiled as host code.

``csrc/march.cuh`` (the step with all its branches, the loop, the typed
metric entries and their dual partials) is plain C++ when compiled by g++
(its CUDA qualifier macros are empty).  This test builds it into a temporary
shared library through a small C shim, loads it with ctypes and runs every
metric instance and every trace option against the plain torch march: the
only check of the kernel's arithmetic that runs without a GPU.

Tolerances.  ``kerr_boyer`` (those of ray set (a) in chip_smoke.py): fates
equal on all 64 rays, step counts on at least 62, escaped positions within
1e-4 where the step counts agree (libm's sin/cos and torch's may differ in
the last ulp).  The other instances: fates and step counts equal on every
ray, positions of all rays within 1e-4 (rtol and atol).
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from chip_smoke import ray_set
from geodesic_raytracing_tpu_torch import metrics
from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
from test_integrator import make_rays

torch.set_num_threads(1)

CSRC = Path(integrate.__file__).resolve().parents[1] / "csrc"

# The metric structs in the order of the shim's dispatch; the last two are
# Schwarzschild with a replaced config (the cylindrical terminator at
# r < 3, and no blow-up test), which no ported metric sets.
STRUCTS = [raymarch.INSTANCES[n][0] for n in sorted(raymarch.INSTANCES)]
STRUCTS += ["CylindricalSchwarzschild", "NonsingularSchwarzschild"]

SHIM = r"""
#include <string.h>

#include "march.cuh"

namespace {

struct CylindricalSchwarzschild : grt::Schwarzschild {
  static constexpr const char* name = "cylindrical";
  static constexpr bool has_cylindrical_singularity = true;
  static constexpr float cylindrical_terminator = 3.0f;
  static CylindricalSchwarzschild from_params(const float* p) {
    CylindricalSchwarzschild m;
    m.rs = p[0];
    return m;
  }
};

struct NonsingularSchwarzschild : grt::Schwarzschild {
  static constexpr const char* name = "nonsingular";
  static constexpr bool unconditionally_nonsingular = true;
  static NonsingularSchwarzschild from_params(const float* p) {
    NonsingularSchwarzschild m;
    m.rs = p[0];
    return m;
  }
};

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

// Every instance: `metric` is the struct's name, `feats` the 8 floats of
// grt::Features.  Returns 0, or 1 for an unknown struct.
extern "C" int grt_host_march(const char* metric, const float* mparams,
                              const float* feats, int planar, int euler,
                              int reparam, int n, int max_steps, float* pos,
                              float* vel, float* acc, float* next_ds,
                              float* rdl, int* status, int* steps,
                              const float* f_in_x) {
  const Arrays a{pos, vel, acc, next_ds, rdl, status, steps, f_in_x};
  const grt::Features f = grt::features_from(feats);
#define TRY(M, NAME)                                                      \
  if (strcmp(metric, NAME) == 0) {                                        \
    march_options<M>(mparams, f, planar, euler, reparam, n, max_steps, a); \
    return 0;                                                             \
  }
  TRY(grt::KerrBoyer, "KerrBoyer")
  TRY(grt::Schwarzschild, "Schwarzschild")
  TRY(grt::SchwarzschildFast, "SchwarzschildFast")
  TRY(grt::SchwarzschildSkewed, "SchwarzschildSkewed")
  TRY(grt::SchwarzschildIngoingEF, "SchwarzschildIngoingEF")
  TRY(grt::DeSitter, "DeSitter")
  TRY(grt::Minkowski, "Minkowski")
  TRY(grt::MinkowskiSkew, "MinkowskiSkew")
  TRY(grt::Wormhole, "Wormhole")
  TRY(grt::BlackHoleCosmicString, "BlackHoleCosmicString")
  TRY(grt::Ernst, "Ernst")
  TRY(grt::KerrNewmanBoyer, "KerrNewmanBoyer")
  TRY(grt::KerrIngoingEF, "KerrIngoingEF")
  TRY(grt::KerrRationalPolynomial, "KerrRationalPolynomial")
  TRY(grt::Misner4D, "Misner4D")
  TRY(grt::CosmicStringSpinning, "CosmicStringSpinning")
  TRY(grt::JanisNewmanWinicour, "JanisNewmanWinicour")
  TRY(grt::SchwarzschildIngoingEFHawking, "SchwarzschildIngoingEFHawking")
  TRY(grt::ConfigurableWormhole, "ConfigurableWormhole")
  TRY(grt::EllisDrainhole, "EllisDrainhole")
  TRY(grt::SymmetricWarpDrive, "SymmetricWarpDrive")
  TRY(grt::Alcubierre, "Alcubierre")
  TRY(grt::KrasnikovTube, "KrasnikovTube")
  TRY(grt::KrasnikovCylindrical, "KrasnikovCylindrical")
  TRY(grt::GodelCylindrical, "GodelCylindrical")
  TRY(grt::KerrSchild, "KerrSchild")
  TRY(grt::KerrNewmanSchild, "KerrNewmanSchild")
  TRY(grt::DoubleSchwarzschild, "DoubleSchwarzschild")
  TRY(grt::DoubleKerr, "DoubleKerr")
  TRY(grt::DoubleKerrAlt, "DoubleKerrAlt")
  TRY(grt::DoubleUnequalKerr, "DoubleUnequalKerr")
  TRY(CylindricalSchwarzschild, "CylindricalSchwarzschild")
  TRY(NonsingularSchwarzschild, "NonsingularSchwarzschild")
#undef TRY
  return 1;
}

// The kerr_boyer instance of the default options alone (the six reference
// Features; the adaptive Verlet step reads no schedule constant).
extern "C" void grt_host_march_kerr_boyer(
    float rs, float a, const float* feats, int n, int max_steps, float* pos,
    float* vel, float* acc, float* next_ds, float* rdl, int* status,
    int* steps, const float* f_in_x) {
  const grt::KerrBoyer m{{}, {}, rs, a};
  const grt::Features f{feats[0], feats[1], feats[2], feats[3],
                        feats[4], feats[5], 0.0f,     0.0f};
  march_all<grt::DefaultOptions>(
      m, f, n, max_steps,
      Arrays{pos, vel, acc, next_ds, rdl, status, steps, f_in_x});
}
"""


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of march.cuh "
                    "needs it")
    d = tmp_path_factory.mktemp("march_host")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libmarch_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-Wall",
                    "-Werror", "-shared", "-fPIC", "-I", str(CSRC),
                    str(d / "shim.cpp"), "-o", str(lib)], check=True,
                   capture_output=True, timeout=600)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host_march(host_lib):
    fn = host_lib.grt_host_march_kerr_boyer
    fn.restype = None
    fn.argtypes = ([ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                    ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8)

    def run(metric, state, params, features, max_steps):
        arrs = [t.numpy().copy() for t in state]
        fx = np.abs(arrs[1][:, 0]).copy()
        feats = (ctypes.c_float * 6)(*features)
        fn(params["rs"], params["a"], feats, len(fx), max_steps,
           *[a.ctypes.data for a in arrs], fx.ctypes.data)
        return integrate.RayState(*(torch.from_numpy(a) for a in arrs))

    return run


@pytest.fixture(scope="module")
def host_march_any(host_lib):
    """``run(struct, metric, state, params, features, opts)``: the host
    march of any instance and trace option."""
    fn = host_lib.grt_host_march
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p]
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 8)

    def run(struct, param_names, state, params, features, opts):
        arrs = [t.numpy().copy() for t in state]
        fx = np.abs(arrs[1][:, 0]).copy()
        feats = np.array([*features, *integrate.schedule_constants(features)],
                         np.float32)
        mp = np.array([params[k] for k in param_names] + [0.0], np.float32)
        rc = fn(struct.encode(), mp.ctypes.data, feats.ctypes.data,
                int(opts.planar), int(opts.integrator == "euler"),
                int(opts.reparameterisation), len(fx), opts.max_steps,
                *[a.ctypes.data for a in arrs], fx.ctypes.data)
        assert rc == 0, struct
        return integrate.RayState(*(torch.from_numpy(a) for a in arrs))

    return run


def test_host_march_matches_plain_torch(host_march):
    m = metrics.get_metric("kerr_boyer")
    params = m.params()
    feats = integrate.Features.for_metric(m)
    pos, vel = (np.asarray(a) for a in make_rays(64))
    st = integrate.init_ray_state(m, torch.from_numpy(pos),
                                  torch.from_numpy(vel), params, feats)
    st.status[::7] = integrate.DEAD
    host = host_march(m, st, params, feats, 4096)
    ref = integrate.trace_rays_reference(
        m, st, params, feats, integrate.TraceOptions(max_steps=4096))

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
    host = host_march(m, st, params, feats, 5)
    ref = integrate.trace_rays_reference(
        m, st, params, feats, integrate.TraceOptions(max_steps=5))
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


# The Kerr family is held as kerr_boyer is (test_host_kerr_family below).
KERR_FAMILY = ("kerr_boyer", "kerr_newman_boyer", "kerr_ingoing_ef",
               "kerr_rational_polynomial", "kerr_schild", "kerr_newman_schild")
INSTANCE_CASES = [(n, False) for n in sorted(raymarch.INSTANCES)
                  if n not in KERR_FAMILY]
INSTANCE_CASES += [(n, True) for n in sorted(raymarch.INSTANCES)
                   if metrics.get_metric(n).spherically_symmetric]


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


@pytest.mark.parametrize("name,planar", INSTANCE_CASES)
def test_host_instance_matches_plain_torch(host_march_any, name, planar):
    """Every kernel instance but kerr_boyer's (above), 4-D, and in planar
    mode where the metric is spherically symmetric: 64 rays, every 7th born
    DEAD, against the plain torch march (the ``TANH_WALL`` metrics by
    ``_assert_same_march_tanh_wall``)."""
    m = metrics.get_metric(name)
    params = m.params()
    feats = integrate.Features.for_metric(m)
    struct, names = raymarch.INSTANCES[name]
    st = integrate.init_ray_state(m, *generic_rays(m, params), params, feats)
    st.status[::7] = integrate.DEAD
    opts = integrate.TraceOptions(max_steps=4096, planar=planar)
    host = host_march_any(struct, names, st, params, feats, opts)
    ref = integrate.trace_rays_reference(m, st, params, feats, opts)
    if name in TANH_WALL:
        _assert_same_march_tanh_wall(host, ref, m, st, params, feats, opts)
    else:
        _assert_same_march(host, ref, 16, BLOW_UP_DEAD_VELOCITY_RTOL.get(
            name, 1e-4))
    if name == "godel_cylindrical":
        # The rays launched next to the axis and aimed at it die at the
        # cylindrical terminator.
        axis = ray_set(name, 64)[0][:, 1] < 0.1
        dead = host.status.numpy() == integrate.DEAD
        assert (dead[axis][1:]).all()
        assert (host.position.numpy()[axis][1:, 1] < 0.005).all()
    # Rays born DEAD are untouched.
    for a, b in zip(host, st):
        np.testing.assert_array_equal(a.numpy()[::7], b.numpy()[::7])


@pytest.mark.parametrize("name", KERR_FAMILY[1:])
def test_host_kerr_family_matches_plain_torch(host_march_any, name):
    """The other Kerr-family instances as kerr_boyer's above: 64 rays in the
    metric's chart, every 7th born DEAD; fates equal on all, step counts on
    at least 62, escaped positions within 1e-4 where the step counts agree
    (libm's sin/cos and torch's may differ in the last ulp, and torch's CPU
    sqrt is not correctly rounded: it differs from IEEE sqrt on about 0.7%
    of float32 inputs), except on a ray that takes more than 1.5 times the
    median step count of the escaped rays: it lingered near the photon
    sphere, where the last ulp grows by about a bit a step
    (kerr_newman_boyer's boundary ray, 884 steps against a median of 480,
    ends 7.2e-3 apart; kerr_newman_schild's ray of 1,726 steps against a
    median of 840, 0.025).  The Kerr-Schild instances (the rank-1
    acceleration) are held so too: their chain takes two square roots.  On
    the card every instance equals the plain march bit for bit
    (chip_smoke.py phase 14)."""
    m = metrics.get_metric(name)
    params = m.params()
    feats = integrate.Features.for_metric(m)
    struct, names = raymarch.INSTANCES[name]
    st = integrate.init_ray_state(m, *generic_rays(m, params), params, feats)
    st.status[::7] = integrate.DEAD
    opts = integrate.TraceOptions(max_steps=4096)
    host = host_march_any(struct, names, st, params, feats, opts)
    ref = integrate.trace_rays_reference(m, st, params, feats, opts)
    np.testing.assert_array_equal(host.status.numpy(), ref.status.numpy())
    steps_eq = host.steps.numpy() == ref.steps.numpy()
    assert steps_eq.sum() >= 62, steps_eq.sum()
    escaped = ref.status.numpy() == integrate.ESCAPED
    steps = ref.steps.numpy()
    long_ = escaped & (steps > 1.5 * np.median(steps[escaped]))
    ok = escaped & steps_eq & ~long_
    assert ok.sum() >= 16 and long_.sum() <= 8, (ok.sum(), long_.sum())
    np.testing.assert_allclose(host.position.numpy()[ok],
                               ref.position.numpy()[ok], rtol=1e-4,
                               atol=1e-4)
    for a, b in zip(host, st):
        np.testing.assert_array_equal(a.numpy()[::7], b.numpy()[::7])


def test_host_instance_off_the_equator(host_march_any):
    """The 4-D schwarzschild instance on rays with a theta velocity: the
    theta tangent and both trigonometric values are live (fates equal on
    all 32 rays, step counts on at least 30, as for kerr_boyer)."""
    m = metrics.get_metric("schwarzschild")
    params = m.params()
    feats = integrate.Features.for_metric(m)
    st = integrate.init_ray_state(m, *generic_rays(m, params, 32, tilt=0.03),
                                  params, feats)
    opts = integrate.TraceOptions(max_steps=4096)
    host = host_march_any("Schwarzschild", ("rs",), st, params, feats, opts)
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
def test_host_step_options_match_plain_torch(host_march_any, option, planar):
    """The Euler integrator and Verlet with affine reparameterisation on
    schwarzschild, 4-D and planar."""
    m = metrics.get_metric("schwarzschild")
    params = m.params()
    feats = integrate.Features.for_metric(m)
    st = integrate.init_ray_state(m, *generic_rays(m, params), params, feats)
    opts = integrate.TraceOptions(max_steps=2048, planar=planar, **option)
    host = host_march_any("Schwarzschild", ("rs",), st, params, feats, opts)
    ref = integrate.trace_rays_reference(m, st, params, feats, opts)
    _assert_same_march(host, ref, 16)
    if option.get("reparameterisation"):
        assert (ref.running_dlambda_dnew.numpy() != 1.0).any()


@pytest.mark.parametrize("struct,override", [
    ("CylindricalSchwarzschild", dict(has_cylindrical_singularity=True,
                                      cylindrical_terminator=3.0)),
    ("NonsingularSchwarzschild", dict(unconditionally_nonsingular=True)),
])
def test_host_replaced_config_branches(host_march_any, struct, override):
    """The cylindrical terminator and ``unconditionally_nonsingular``, which
    no ported metric's config sets: schwarzschild with a replaced config
    against the same struct with the same flag."""
    base = metrics.get_metric("schwarzschild")
    m = dataclasses.replace(base, config=dataclasses.replace(base.config,
                                                             **override))
    params = m.params()
    feats = integrate.Features.for_metric(m)
    st = integrate.init_ray_state(m, *generic_rays(m, params), params, feats)
    opts = integrate.TraceOptions(max_steps=2048)
    host = host_march_any(struct, ("rs",), st, params, feats, opts)
    ref = integrate.trace_rays_reference(m, st, params, feats, opts)
    _assert_same_march(host, ref, 16)
    plain = integrate.trace_rays_reference(base, st, params, feats, opts)
    if "has_cylindrical_singularity" in override:
        # Rays that the plain config lets fall further die at r < 3.
        dead = ref.status.numpy() == integrate.DEAD
        assert dead.any() and (ref.steps.numpy()[dead]
                               < plain.steps.numpy()[dead]).all()
    else:
        # Without the blow-up test the same rays die, by the controller.
        np.testing.assert_array_equal(ref.status.numpy(),
                                      plain.status.numpy())
