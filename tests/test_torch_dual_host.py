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
from geodesic_raytracing_tpu_torch.ops import integrate
from test_integrator import make_rays
from test_torch_raymarch_host import SHIM as MARCH_SHIM

torch.set_num_threads(1)

CSRC = Path(integrate.__file__).resolve().parents[1] / "csrc"

# out[i] = 15 floats: g (tt, rr, thth, phph, tph), d_r g, d_theta g.
SHIM = r"""
#include "kerr_boyer.cuh"
template <class R, class Th>
static void entries(const R& r, const Th& theta, float rs, float a,
                    float* out) {
  grt::Dual<grt::kAllTangents> g[5];
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
      entries(widen<kAllTangents>(rd), widen<kAllTangents>(td), rs, a,
              out + 15 * i);
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
