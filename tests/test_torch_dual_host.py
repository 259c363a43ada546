"""The kernel's pruned dual numbers, compiled as host code.

``csrc/dual.cuh`` gives a dual the set of its live tangents as a type
parameter and drops every term on a dead one.  This test builds
``kerr_boyer_g`` with g++ (the route of ``test_torch_raymarch_host.py``) in
both forms, pruned seeds (r: tangent 0, theta: tangent 1) and all tangents
live on both, and holds the five metric entries and their ten partials

- pruned against unpruned: equal exactly (np.array_equal, so only the sign
  of a zero may differ);
- against the JAX package's ``metric_and_partials_batched``: 1e-6 relative,
  element by element (the same float32 operations in the same order; room
  for an ulp of difference between libm's sin/cos and the framework's);
- against ``torch.func.jvp`` of ``kerr_boyer_fn``: 1e-6 relative plus 1e-6
  absolute (torch sums a product rule's terms in its own order, which
  leaves an ulp of O(1) terms in a partial that cancels to a small value);

and the whole host march built with ``-DGRT_FULL_TANGENTS`` against the
pruned one: every output equal exactly.
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geodesic_raytracing_tpu.metrics import get_metric as jax_get_metric
from geodesic_raytracing_tpu.ops import geometry as jgeometry
from geodesic_raytracing_tpu_torch import metrics
from geodesic_raytracing_tpu_torch.ops import complexify as cx
from geodesic_raytracing_tpu_torch.ops import geometry as tgeometry
from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
from test_integrator import make_rays
from test_torch_raymarch_host import SHIM as MARCH_SHIM

torch.set_num_threads(1)

CSRC = Path(integrate.__file__).resolve().parents[1] / "csrc"

# out[i] = 15 floats: g (tt, rr, thth, phph, tph), d_r g, d_theta g.
SHIM = r"""
#include "kerr_boyer.cuh"
// The two tangents the Kerr metric's seeds use (r: 0, theta: 1).
constexpr unsigned kRTheta = 3u;
template <class R, class Th>
static void entries(const R& r, const Th& theta, float rs, float a,
                    float* out) {
  grt::Dual<kRTheta> g[5];
  grt::kerr_boyer_g(r, theta, rs, a, g);
  for (int e = 0; e < 5; ++e) {
    out[e] = g[e].v;
    out[5 + e] = g[e].d[0];
    out[10 + e] = g[e].d[1];
  }
}
extern "C" void grt_host_kerr_g(float rs, float a, int n, const float* r,
                                const float* theta, int full, float* out) {
  using namespace grt;
  for (int i = 0; i < n; ++i) {
    const auto rd = dual_seed<0>(r[i]);
    const auto td = dual_seed<1>(theta[i]);
    if (full)
      entries(widen<kRTheta>(rd), widen<kRTheta>(td), rs, a, out + 15 * i);
    else
      entries(rd, td, rs, a, out + 15 * i);
  }
}
// Values alone through the same template with T = float.
extern "C" void grt_host_kerr_g_float(float rs, float a, int n,
                                      const float* r, const float* theta,
                                      float* out) {
  for (int i = 0; i < n; ++i)
    grt::kerr_boyer_g(r[i], theta[i], rs, a, out + 5 * i);
}
"""

ENTRIES = ((0, 0), (1, 1), (2, 2), (3, 3), (0, 3))

# Every metric struct's g and its partials at a batch of events, and each
# dual op of catalogue slice B with its tangent, through the same headers.
# Built twice: with pruned tangents, and with -DGRT_FULL_TANGENTS (every
# seeding coordinate widened to all the seeded tangents).
METRIC_SHIM = r"""
#include <string.h>

#include <utility>

#include "march.cuh"

namespace {

constexpr int kI[10] = {0, 0, 0, 0, 1, 1, 1, 2, 2, 3};
constexpr int kJ[10] = {0, 1, 2, 3, 1, 2, 3, 2, 3, 3};

// out[50 i + e] = g_e, out[50 i + 10 (1 + c) + e] = d g_e / d x^c.
template <class M, class G, int... E>
void put(const G& g, float* out, std::integer_sequence<int, E...>) {
  ((out[E] = grt::to_float(grt::gval<kI[E], kJ[E]>(g))), ...);
  auto tangents = [&](auto k) {
    constexpr int K = decltype(k)::value;
    if constexpr (K < M::n_deps) {
      float* o = out + 10 * (1 + M::dep(K));
      ((o[E] = grt::to_float(grt::gtan<K, kI[E], kJ[E]>(g))), ...);
    }
  };
  tangents(std::integral_constant<int, 0>{});
  tangents(std::integral_constant<int, 1>{});
  tangents(std::integral_constant<int, 2>{});
  tangents(std::integral_constant<int, 3>{});
}

template <class M>
void eval(const float* mparams, int n, const float* x, float* out) {
  const M m = M::from_params(mparams);
  for (int i = 0; i < n; ++i) {
    const float* xi = x + 4 * i;
    const auto g = m.g(grt::coordinate<M, false, 0>(xi[0]),
                       grt::coordinate<M, false, 1>(xi[1]),
                       grt::coordinate<M, false, 2>(xi[2]),
                       grt::coordinate<M, false, 3>(xi[3]));
    memset(out + 50 * i, 0, 50 * sizeof(float));
    put<M>(g, out + 50 * i, std::make_integer_sequence<int, 10>{});
  }
}

}  // namespace

extern "C" int grt_host_metric(const char* metric, const float* mparams,
                               int n, const float* x, float* out) {
#define TRY(M)                              \
  if (strcmp(metric, #M) == 0) {            \
    eval<grt::M>(mparams, n, x, out);       \
    return 0;                               \
  }
  TRY(JanisNewmanWinicour)
  TRY(SchwarzschildIngoingEFHawking)
  TRY(ConfigurableWormhole)
  TRY(EllisDrainhole)
  TRY(SymmetricWarpDrive)
  TRY(Alcubierre)
  TRY(KrasnikovTube)
  TRY(KrasnikovCylindrical)
  TRY(GodelCylindrical)
  TRY(DoubleSchwarzschild)
  TRY(DoubleKerr)
  TRY(DoubleKerrAlt)
  TRY(DoubleUnequalKerr)
#undef TRY
  return 1;
}

// A Kerr-Schild struct's decomposition: out[16 i + 4 j] = (f, l1, l2,
// l3)[j], out[16 i + 4 j + 1 + k] its partial by coordinate k + 1.
template <class M>
void eval_rank1(const float* mparams, int n, const float* x, float* out) {
  const M m = M::from_params(mparams);
  for (int i = 0; i < n; ++i) {
    const float* xi = x + 4 * i;
    const auto d = m.fl(grt::coordinate<M, false, 1>(xi[1]),
                        grt::coordinate<M, false, 2>(xi[2]),
                        grt::coordinate<M, false, 3>(xi[3]));
    const grt::Dual<7u> parts[4] = {grt::widen<7u>(d.f), grt::widen<7u>(d.l1),
                                    grt::widen<7u>(d.l2),
                                    grt::widen<7u>(d.l3)};
    for (int j = 0; j < 4; ++j) {
      out[16 * i + 4 * j] = parts[j].v;
      for (int k = 0; k < 3; ++k) out[16 * i + 4 * j + 1 + k] = parts[j].d[k];
    }
  }
}

extern "C" int grt_host_rank1(const char* metric, const float* mparams,
                              int n, const float* x, float* out) {
#define TRY(M)                                  \
  if (strcmp(metric, #M) == 0) {                \
    eval_rank1<grt::M>(mparams, n, x, out);     \
    return 0;                                   \
  }
  TRY(KerrSchild)
  TRY(KerrNewmanSchild)
#undef TRY
  return 1;
}

// Each pair op of complex.cuh on duals of four live tangents: a = (x[4 i],
// x[4 i + 1]), b = (x[4 i + 2], x[4 i + 3]), tangent k of input j at
// t[16 i + 4 j + k]; out[10 i] the real part, out[10 i + 1 + k] its tangent
// k, out[10 i + 5] the imaginary part, out[10 i + 6 + k] its tangent k.
extern "C" int grt_host_pair_op(const char* op, int n, const float* x,
                                const float* t, float* out) {
  using namespace grt;
  for (int i = 0; i < n; ++i) {
    Dual<kAllTangents> v[4];
    for (int j = 0; j < 4; ++j) {
      v[j].v = x[4 * i + j];
      for (int k = 0; k < kTangents; ++k) v[j].d[k] = t[16 * i + 4 * j + k];
    }
    const auto a = make_cx(v[0], v[1]);
    const auto b = make_cx(v[2], v[3]);
    Cx<Dual<kAllTangents>, Dual<kAllTangents>> r;
    if (strcmp(op, "cadd") == 0) r = cadd(a, b);
    else if (strcmp(op, "csub") == 0) r = csub(a, b);
    else if (strcmp(op, "cmul") == 0) r = cmul(a, b);
    else if (strcmp(op, "cdiv") == 0) r = cdiv(a, b);
    else if (strcmp(op, "conj") == 0) r = conj(a);
    else if (strcmp(op, "csqrt") == 0) r = csqrt(a);
    else if (strcmp(op, "scm") == 0)
      r = make_cx(scm(a), dual_constant(0.0f) * v[0]);
    else if (strcmp(op, "cdiv_real") == 0) {
      const auto q = cdiv(a, v[2]);
      r = make_cx(q.re, q.im);
    } else return 1;
    out[10 * i] = r.re.v;
    out[10 * i + 5] = r.im.v;
    for (int k = 0; k < kTangents; ++k) {
      out[10 * i + 1 + k] = r.re.d[k];
      out[10 * i + 6 + k] = r.im.d[k];
    }
  }
  return 0;
}

// Each op of a dual of four live tangents, seeded with t (4 floats a
// value): out[5 i] the value, out[5 i + 1 + k] tangent k.  `e` is the
// exponent of pow and pow_pos, `c` the constant x of arctan2(y, c).
extern "C" int grt_host_op(const char* op, double e, float c, int n,
                           const float* x, const float* t, float* out) {
  using namespace grt;
  for (int i = 0; i < n; ++i) {
    Dual<kAllTangents> a;
    a.v = x[i];
    for (int k = 0; k < kTangents; ++k) a.d[k] = t[4 * i + k];
    Dual<kAllTangents> r;
    if (strcmp(op, "sqrt") == 0) r = grt_sqrt(a);
    else if (strcmp(op, "exp") == 0) r = grt_exp(a);
    else if (strcmp(op, "log1p") == 0) r = grt_log1p(a);
    else if (strcmp(op, "tanh") == 0) r = grt_tanh(a);
    else if (strcmp(op, "pow") == 0) r = grt_pow(a, pow_rule(e));
    else if (strcmp(op, "pow_pos") == 0)
      r = grt_pow_pos(a, static_cast<float>(e));
    else if (strcmp(op, "arctan") == 0) r = grt_arctan(a);
    else if (strcmp(op, "arctan2") == 0) r = grt_arctan2(a, c);
    else if (strcmp(op, "abs") == 0) r = grt_abs(a);
    else return 1;
    out[5 * i] = r.v;
    for (int k = 0; k < kTangents; ++k) out[5 * i + 1 + k] = r.d[k];
  }
  return 0;
}
"""


def _gxx():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of the kernel's "
                    "headers needs it")
    return gxx


def _build(d: Path, name: str, source: str, *flags: str) -> ctypes.CDLL:
    (d / f"{name}.cpp").write_text(source)
    lib = d / f"lib{name}.so"
    subprocess.run([_gxx(), "-O2", "-std=c++17", "-ffp-contract=off",
                    "-Wall", "-Werror", *flags, "-shared", "-fPIC", "-I",
                    str(CSRC), str(d / f"{name}.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=300)
    return ctypes.CDLL(str(lib))


def _events(n=512, seed=0):
    """Seeded (4, n) events outside the horizon: r in [0.6, 25] (the outer
    horizon of rs = 1, a = -0.5 is at r = 0.5), theta over (0, pi) with some
    beyond it (the march lets theta wander) and some at the equator."""
    rng = np.random.default_rng(seed)
    x = np.zeros((4, n), np.float32)
    x[0] = rng.uniform(-5, 5, n)
    x[1] = np.exp(rng.uniform(np.log(0.6), np.log(25.0), n))
    x[2] = rng.uniform(0.05, np.pi - 0.05, n)
    x[2, : n // 8] = rng.uniform(-2 * np.pi, 3 * np.pi, n // 8)
    x[2, n // 8: n // 8 + 8] = np.float32(np.pi / 2)
    x[3] = rng.uniform(-np.pi, np.pi, n)
    return x


@pytest.fixture(scope="module")
def host_g(tmp_path_factory):
    so = _build(tmp_path_factory.mktemp("dual_host"), "dual_host", SHIM)
    fp = ctypes.c_void_p
    so.grt_host_kerr_g.restype = None
    so.grt_host_kerr_g.argtypes = [ctypes.c_float, ctypes.c_float,
                                   ctypes.c_int, fp, fp, ctypes.c_int, fp]
    so.grt_host_kerr_g_float.restype = None
    so.grt_host_kerr_g_float.argtypes = [ctypes.c_float, ctypes.c_float,
                                         ctypes.c_int, fp, fp, fp]

    def run(x, params, full):
        """(15, n): the five entries, their r partials, their theta
        partials; ``full=None`` gives the (5, n) float instantiation."""
        n = x.shape[1]
        r, th = np.ascontiguousarray(x[1]), np.ascontiguousarray(x[2])
        if full is None:
            out = np.zeros((n, 5), np.float32)
            so.grt_host_kerr_g_float(params["rs"], params["a"], n,
                                     r.ctypes.data, th.ctypes.data,
                                     out.ctypes.data)
        else:
            out = np.zeros((n, 15), np.float32)
            so.grt_host_kerr_g(params["rs"], params["a"], n, r.ctypes.data,
                               th.ctypes.data, int(full), out.ctypes.data)
        return out.T.copy()

    return run


def _pick(gab, dr, dth):
    """(15, n) from (4, 4, n) arrays, in the kernel's entry order."""
    return np.stack([np.asarray(t)[i, j] for t in (gab, dr, dth)
                     for i, j in ENTRIES]).astype(np.float32)


def test_pruned_equals_unpruned_exactly(host_g):
    m = metrics.get_metric("kerr_boyer")
    x = _events()
    pruned = host_g(x, m.params(), full=False)
    full = host_g(x, m.params(), full=True)
    assert np.isfinite(full).all()
    np.testing.assert_array_equal(pruned, full)
    # The float instantiation of the same template gives the same values.
    np.testing.assert_array_equal(host_g(x, m.params(), full=None),
                                  pruned[:5])


def test_pruned_dual_matches_torch_jvp(host_g):
    m = metrics.get_metric("kerr_boyer")
    params = m.params()
    x = _events(seed=1)
    xt = torch.from_numpy(x)
    fn = lambda y: m.fn(y, params)
    seed = lambda c: torch.zeros_like(xt).index_fill_(
        0, torch.tensor([c]), 1.0)
    gab, dr = torch.func.jvp(fn, (xt,), (seed(1),))
    _, dth = torch.func.jvp(fn, (xt,), (seed(2),))
    want = _pick(gab.numpy(), dr.numpy(), dth.numpy())
    np.testing.assert_allclose(host_g(x, params, full=False), want,
                               rtol=1e-6, atol=1e-6)


def test_pruned_dual_matches_jax_partials(host_g):
    m = metrics.get_metric("kerr_boyer")
    jm = jax_get_metric("kerr_boyer")
    x = _events(seed=2)
    gab, dgs = jgeometry.metric_and_partials_batched(
        jm.fn, jnp.asarray(x), jm.params(), deps=jm.depends_on)
    assert dgs[0] is None and dgs[3] is None
    want = _pick(gab, dgs[1], dgs[2])
    np.testing.assert_allclose(host_g(x, m.params(), full=False), want,
                               rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def host_marches(tmp_path_factory):
    d = tmp_path_factory.mktemp("march_pruned_full")
    libs = (_build(d, "march_pruned", MARCH_SHIM),
            _build(d, "march_full", MARCH_SHIM, "-DGRT_FULL_TANGENTS"))

    def run(so, state, params, features, max_steps):
        fn = so.grt_host_march_kerr_boyer
        fn.restype = None
        fn.argtypes = ([ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                        ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 8)
        arrs = [t.numpy().copy() for t in state]
        fx = np.abs(arrs[1][:, 0]).copy()
        feats = (ctypes.c_float * 6)(*features)
        fn(params["rs"], params["a"], feats, len(fx), max_steps,
           *[a.ctypes.data for a in arrs], fx.ctypes.data)
        return arrs

    return lambda *a: tuple(run(so, *a) for so in libs)


def test_pruned_march_equals_unpruned_march(host_marches):
    m = metrics.get_metric("kerr_boyer")
    params = m.params()
    feats = integrate.Features.for_metric(m)
    pos, vel = (np.asarray(a) for a in make_rays(64))
    st = integrate.init_ray_state(m, torch.from_numpy(pos),
                                  torch.from_numpy(vel), params, feats)
    pruned, full = host_marches(st, params, feats, 4096)
    assert (pruned[5] != integrate.ACTIVE).all()
    assert pruned[6].max() > 100
    for a, b in zip(pruned, full):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Catalogue slice B: the new dual ops, four live tangents, the nine structs
# ---------------------------------------------------------------------------

CATALOGUE_B = ("janis_newman_winicour", "schwarzschild_ingoing_ef_hawking",
               "configurable_wormhole", "ellis_drainhole",
               "symmetric_warp_drive", "alcubierre", "krasnikov_tube",
               "krasnikov_cylindrical", "godel_cylindrical")


@pytest.fixture(scope="module")
def host_b(tmp_path_factory):
    """``(pruned, unpruned)`` builds of ``METRIC_SHIM``."""
    d = tmp_path_factory.mktemp("dual_host_b")
    libs = (_build(d, "metric_pruned", METRIC_SHIM),
            _build(d, "metric_full", METRIC_SHIM, "-DGRT_FULL_TANGENTS"))
    for so in libs:
        so.grt_host_metric.restype = ctypes.c_int
        so.grt_host_metric.argtypes = [ctypes.c_char_p] + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        for fn in (so.grt_host_rank1, so.grt_host_pair_op):
            fn.restype = ctypes.c_int
        so.grt_host_rank1.argtypes = [ctypes.c_char_p] + [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        so.grt_host_pair_op.argtypes = [ctypes.c_char_p, ctypes.c_int] + [
            ctypes.c_void_p] * 3
        so.grt_host_op.restype = ctypes.c_int
        so.grt_host_op.argtypes = [ctypes.c_char_p, ctypes.c_double,
                                   ctypes.c_float, ctypes.c_int,
                                   ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_void_p]
    return libs


def _host_op(so, op, x, t, e=0.0, c=0.0):
    """(5, n): the value and the four tangents of ``op`` on the host."""
    x = np.ascontiguousarray(x, np.float32)
    t = np.ascontiguousarray(t.T, np.float32)
    out = np.zeros((len(x), 5), np.float32)
    assert so.grt_host_op(op.encode(), e, c, len(x), x.ctypes.data,
                          t.ctypes.data, out.ctypes.data) == 0, op
    return out.T


# op -> (the port's torch form, the reference's jnp form, the domain of x,
# the exponent e or arctan2's constant x).
_OPS = {
    "sqrt": (torch.sqrt, jnp.sqrt, "positive", 0.0),
    "exp": (torch.exp, jnp.exp, "signed", 0.0),
    "log1p": (torch.log1p, jnp.log1p, "positive", 0.0),
    "tanh": (torch.tanh, jnp.tanh, "signed", 0.0),
    "abs": (torch.abs, jnp.abs, "signed", 0.0),
    "arctan": (tgeometry.arctan, jgeometry.arctan, "signed", 0.0),
}
_POW = (1.5, 4.0, 0.25, -0.75, 1.25, 0.5, 2.0, 3.0)


def _op_cases():
    cases = [(op, None) for op in _OPS]
    cases += [("pow", e) for e in _POW]
    cases += [("pow_pos", 1.0 / 3.0), ("arctan2", 0.8660254)]
    return cases


def _op_inputs(domain, n=4096, seed=7):
    """Seeded x and four tangents: positive x in (0.01, 50); signed x in
    (-8, 8) with |x| either side of 1 and of tan(pi/8); pow_pos's base with
    some at and below 0."""
    rng = np.random.default_rng(seed)
    if domain == "positive":
        x = np.exp(rng.uniform(np.log(0.01), np.log(50.0), n))
    else:
        x = rng.uniform(-8, 8, n)
        x[:8] = [1.0, -1.0, 0.999, 1.001, 0.41421357, -0.41421354, 0.0, 3.0]
    t = rng.normal(size=(4, n))
    return x.astype(np.float32), t.astype(np.float32)


@pytest.mark.parametrize("op,e", _op_cases())
def test_new_dual_op_matches_torch_jvp_and_jax(host_b, op, e):
    """Each dual op of catalogue slice B with four live tangents, on the
    host build, against ``torch.func.jvp`` of the port's form, tangent by
    tangent, and against ``jax.jvp`` of the reference's: rtol 1e-6 and
    atol 1e-6 of the largest |value| (libm's float functions and torch's
    and XLA's CPU ones differ in the last ulp; tanh's tangent 1 - y^2 moves
    by 1.2e-7 where tanh saturates)."""
    import jax

    so = host_b[0]
    if op == "pow":
        tfn = lambda v: v ** e  # noqa: E731
        jfn = lambda v: v ** e  # noqa: E731
        domain = "positive"
    elif op == "pow_pos":
        tfn = lambda v: tgeometry.pow_pos(v, e)  # noqa: E731
        jfn = lambda v: jgeometry.pow_pos(v, e)  # noqa: E731
        domain = "signed"
    elif op == "arctan2":
        c = np.float32(e)
        tfn = lambda v: tgeometry.arctan2(v, torch.full_like(v, c))  # noqa
        jfn = lambda v: jgeometry.arctan2(v, jnp.full_like(v, c))  # noqa
        domain = "signed"
    else:
        tfn, jfn, domain, _ = _OPS[op]
    x, t = _op_inputs(domain)
    got = _host_op(so, op, x, t, e=e if op in ("pow", "pow_pos") else 0.0,
                   c=e if op == "arctan2" else 0.0)
    tx = torch.from_numpy(x)
    want = [tfn(tx).numpy()]
    jwant = [np.asarray(jfn(jnp.asarray(x)))]
    for k in range(4):
        want.append(torch.func.jvp(tfn, (tx,), (torch.from_numpy(t[k]),))[1]
                    .numpy())
        jwant.append(np.asarray(jax.jvp(jfn, (jnp.asarray(x),),
                                        (jnp.asarray(t[k]),))[1]))
    assert np.isfinite(got).all()
    # JAX's |x| takes the tangent t at x = 0, torch's (and the kernel's)
    # t * sgn(0) = 0.
    keep = x != 0 if op == "abs" else slice(None)
    for ref, cols in ((np.stack(want), slice(None)), (np.stack(jwant), keep)):
        for row in range(5):
            scale = max(1.0, float(np.abs(ref[row]).max()))
            np.testing.assert_allclose(got[row][cols], ref[row][cols],
                                       rtol=1e-6, atol=1e-6 * scale,
                                       err_msg=f"{row}")
    if op == "pow_pos":
        off = x <= 0
        assert off.any() and (got[:, off] == 0).all()


def _b_events(name, n=512, seed=11):
    """Seeded (n, 4) events where the metric is real, in its chart (as
    test_torch_metrics_catalogue_b.events)."""
    from test_torch_metrics_catalogue_b import events

    return np.ascontiguousarray(events(name, n, seed).T)


_IDX = ((0, 0), (0, 1), (0, 2), (0, 3), (1, 1), (1, 2), (1, 3), (2, 2),
        (2, 3), (3, 3))


def _host_metric(so, name, x):
    struct, names = raymarch.INSTANCES[name]
    params = metrics.get_metric(name).params()
    mp = np.array([params[k] for k in names] + [0.0], np.float32)
    out = np.zeros((len(x), 50), np.float32)
    assert so.grt_host_metric(struct.encode(), mp.ctypes.data, len(x),
                              x.ctypes.data, out.ctypes.data) == 0
    return out


@pytest.mark.parametrize("name", CATALOGUE_B)
def test_catalogue_b_pruned_equals_unpruned(host_b, name):
    """Each slice B struct's entries and partials with pruned tangents
    (``alcubierre`` and ``krasnikov_tube`` carry four live ones through
    their entries) equal the unpruned computation (every seeding coordinate
    widened to all the seeded tangents), bit for bit."""
    x = _b_events(name)
    pruned, full = (_host_metric(so, name, x) for so in host_b)
    assert np.isfinite(pruned).all()
    np.testing.assert_array_equal(pruned, full)
    live = metrics.get_metric(name).depends_on
    assert len(live) < 4 or name in ("alcubierre", "krasnikov_tube")
    for c in live:
        assert np.abs(pruned[:, 10 * (1 + c):10 * (2 + c)]).max() > 0, c


@pytest.mark.parametrize("name", CATALOGUE_B)
def test_catalogue_b_host_partials_match_torch_jvp(host_b, name):
    """Each slice B struct's 10 entries and their partials against
    ``torch.func.jvp`` of the torch metric: rtol 1e-5 and atol 1e-6 of the
    largest magnitude of the entry (measured: within 3.1e-7 of it)."""
    m = metrics.get_metric(name)
    x = _b_events(name)
    got = _host_metric(host_b[0], name, x)
    gab, dg = tgeometry.metric_and_partials_batched(
        m.fn, torch.from_numpy(np.ascontiguousarray(x.T)), m.params(),
        deps=m.depends_on)
    n = len(x)
    want = np.zeros_like(got)
    for e, (i, j) in enumerate(_IDX):
        want[:, e] = torch.broadcast_to(gab.reshape(4, 4, -1),
                                        (4, 4, n))[i, j].numpy()
        for c in m.depends_on:
            want[:, 10 * (1 + c) + e] = torch.broadcast_to(
                dg[c].reshape(4, 4, -1), (4, 4, n))[i, j].numpy()
    scale = np.maximum(np.abs(want).max(0), 1.0)
    assert (np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-6 * scale).all()


# ---------------------------------------------------------------------------
# Catalogue slice C: the complex pairs, the Kerr-Schild decompositions, the
# two-body structs
# ---------------------------------------------------------------------------

CATALOGUE_C_DENSE = ("double_schwarzschild", "double_kerr", "double_kerr_alt",
                     "double_unequal_kerr")
RANK1 = ("kerr_schild", "kerr_newman_schild")

_PAIR_OPS = {
    "cadd": lambda a, b: cx.cadd(a, b),
    "csub": lambda a, b: cx.csub(a, b),
    "cmul": lambda a, b: cx.cmul(a, b),
    "cdiv": lambda a, b: cx.cdiv(a, b),
    "cdiv_real": lambda a, b: cx.cdiv(a, (b[0], None)),
    "conj": lambda a, b: cx.conj(a),
    "csqrt": lambda a, b: cx.csqrt(a),
    "scm": lambda a, b: (cx.scm(a), 0.0 * a[0]),
}


@pytest.mark.parametrize("op", sorted(_PAIR_OPS))
def test_pair_op_matches_torch_jvp(host_b, op):
    """Each pair op of ``csrc/complex.cuh`` on duals of four live tangents,
    on the host build, against ``torch.func.jvp`` of the port's torch form
    (``ops.complexify``), tangent by tangent: rtol 1e-6 and atol 1e-6 of the
    largest |value| (glibc's sqrtf is correctly rounded, torch's CPU sqrt
    not always; ``csqrt``'s cancelling part is held to 1e-5 of the largest
    |value|, the half-angle form's cancellation amplifying that ulp)."""
    rng = np.random.default_rng(13)
    n = 2048
    x = (np.exp(rng.uniform(-3, 3, (n, 4))) * rng.choice([-1.0, 1.0], (n, 4))
         ).astype(np.float32)
    x[:8, 1] = 0.0
    t = rng.normal(size=(n, 4, 4)).astype(np.float32)
    out = np.zeros((n, 10), np.float32)
    assert host_b[0].grt_host_pair_op(op.encode(), n, x.ctypes.data,
                                      t.ctypes.data, out.ctypes.data) == 0
    assert np.isfinite(out).all()
    fn = _PAIR_OPS[op]

    def torch_fn(ar, ai, br, bi):
        re, im = fn((ar, ai), (br, bi))
        return re, im

    cols = tuple(torch.from_numpy(np.ascontiguousarray(x[:, j]))
                 for j in range(4))
    atol = 1e-5 if op == "csqrt" else 1e-6
    for k in range(4):
        tan = tuple(torch.from_numpy(np.ascontiguousarray(t[:, j, k]))
                    for j in range(4))
        (re, im), (dre, dim) = torch.func.jvp(torch_fn, cols, tan)
        for got, want in ((out[:, 0], re), (out[:, 1 + k], dre),
                          (out[:, 5], im), (out[:, 6 + k], dim)):
            want = want.numpy()
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=1e-6,
                                       atol=atol * scale, err_msg=op)


def _c_events(name, n=512, seed=11):
    from test_torch_metrics_catalogue_c import events

    return np.ascontiguousarray(events(name, n, seed).T)


@pytest.mark.parametrize("name", CATALOGUE_C_DENSE)
def test_catalogue_c_pruned_equals_unpruned(host_b, name):
    """Each two-body struct's entries and partials with pruned tangents
    (the pairs' parts carry only their own) equal the unpruned computation,
    bit for bit, and both tangents are live."""
    x = _c_events(name)
    pruned, full = (_host_metric(so, name, x) for so in host_b)
    assert np.isfinite(pruned).all()
    np.testing.assert_array_equal(pruned, full)
    for c in (1, 3):
        assert np.abs(pruned[:, 10 * (1 + c):10 * (2 + c)]).max() > 0, c


@pytest.mark.parametrize("name", CATALOGUE_C_DENSE)
def test_catalogue_c_host_partials_match_torch_jvp(host_b, name):
    """Each two-body struct's 10 entries and their partials against
    ``torch.func.jvp`` of the torch metric: rtol 1e-5 and atol 1e-6 of the
    largest magnitude of the entry (its value and partials; glibc's sqrtf
    against torch's CPU sqrt), times ``double_schwarzschild``'s condition
    number where its Y_k cancel (``test_torch_metrics_catalogue_c``)."""
    from test_torch_metrics_catalogue_c import double_schwarzschild_kappa

    m = metrics.get_metric(name)
    x = _c_events(name)
    got = _host_metric(host_b[0], name, x)
    gab, dg = tgeometry.metric_and_partials_batched(
        m.fn, torch.from_numpy(np.ascontiguousarray(x.T)), m.params(),
        deps=m.depends_on)
    n = len(x)
    want = np.zeros_like(got)
    for e, (i, j) in enumerate(_IDX):
        want[:, e] = gab[i, j].numpy()
        for c in m.depends_on:
            want[:, 10 * (1 + c) + e] = dg[c][i, j].numpy()
    scale = np.tile(np.maximum(np.abs(want[:, :10]).max(0), 1.0), 5)
    scale = scale[None, :] * np.ones((n, 1))
    if name == "double_schwarzschild":
        scale = scale * double_schwarzschild_kappa(
            np.ascontiguousarray(x.T), m.params())[:, None]
    assert (np.abs(got - want) <= 1e-5 * np.abs(want) + 1e-6 * scale).all()


@pytest.mark.parametrize("name", RANK1)
def test_rank1_decomposition_host_matches_torch_jvp(host_b, name):
    """Each Kerr-Schild struct's f and l with their partials by x, y, z:
    pruned equal to unpruned bit for bit, and against ``torch.func.jvp`` of
    the torch decomposition (``geometry.rank1_partials_batched``): rtol 1e-5
    and atol 1e-6 of the largest magnitude of each part."""
    struct, names = raymarch.INSTANCES[name]
    m = metrics.get_metric(name)
    params = m.params()
    x = _c_events(name)
    mp = np.array([params[k] for k in names] + [0.0], np.float32)
    outs = []
    for so in host_b:
        out = np.zeros((len(x), 16), np.float32)
        assert so.grt_host_rank1(struct.encode(), mp.ctypes.data, len(x),
                                 x.ctypes.data, out.ctypes.data) == 0
        outs.append(out)
    np.testing.assert_array_equal(*outs)
    f, lv, df, dl = tgeometry.rank1_partials_batched(
        m.rank1, torch.from_numpy(np.ascontiguousarray(x.T)), params)
    want = np.zeros_like(outs[0])
    for j, (v, d) in enumerate([(f, df)] + [
            (lv[b], [dl[k][b] for k in range(3)]) for b in (1, 2, 3)]):
        want[:, 4 * j] = v.numpy()
        for k in range(3):
            want[:, 4 * j + 1 + k] = d[k].numpy()
    scale = np.repeat(np.maximum(np.abs(want[:, ::4]).max(0), 1.0), 4)
    assert (np.abs(outs[0] - want)
            <= 1e-5 * np.abs(want) + 1e-6 * scale[None, :]).all()
