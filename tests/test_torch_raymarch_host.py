"""The ray-march kernel's per-ray arithmetic, compiled as host code.

``csrc/march.cuh`` (the step, the loop, the Dual<2> metric partials) is
plain C++ when compiled by g++ (its CUDA qualifier macros are empty).  This
test builds it into a temporary shared library through a small C shim,
loads it with ctypes and runs it against the plain torch march — the only
check of the kernel's arithmetic that runs without a GPU.

Tolerances (those of ray set (a) in chip_smoke.py): fates equal on all 64
rays, step counts on at least 62, escaped positions within 1e-4 where the
step counts agree (libm's sin/cos and torch's may differ in the last ulp).
"""

import ctypes
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from geodesic_raytracing_tpu_torch import metrics
from geodesic_raytracing_tpu_torch.ops import integrate
from test_integrator import make_rays

torch.set_num_threads(1)

CSRC = Path(integrate.__file__).resolve().parents[1] / "csrc"

SHIM = r"""
#include "march.cuh"
extern "C" void grt_host_march_kerr_boyer(
    float rs, float a, const float* feats, int n, int max_steps, float* pos,
    float* vel, float* acc, float* next_ds, float* rdl, int* status,
    int* steps, const float* f_in_x) {
  const grt::KerrBoyer m{rs, a};
  const grt::Features f{feats[0], feats[1], feats[2],
                        feats[3], feats[4], feats[5]};
  for (int i = 0; i < n; ++i) {
    if (status[i] != grt::ACTIVE) continue;
    grt::Ray s;
    for (int c = 0; c < 4; ++c) {
      s.pos[c] = pos[4 * i + c];
      s.vel[c] = vel[4 * i + c];
      s.acc[c] = acc[4 * i + c];
    }
    s.next_ds = next_ds[i];
    s.rdl = rdl[i];
    s.status = status[i];
    s.steps = steps[i];
    grt::march_ray(m, f, f_in_x[i], max_steps, s);
    for (int c = 0; c < 4; ++c) {
      pos[4 * i + c] = s.pos[c];
      vel[4 * i + c] = s.vel[c];
      acc[4 * i + c] = s.acc[c];
    }
    next_ds[i] = s.next_ds;
    rdl[i] = s.rdl;
    status[i] = s.status;
    steps[i] = s.steps;
  }
}
"""


@pytest.fixture(scope="module")
def host_march(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of march.cuh "
                    "needs it")
    d = tmp_path_factory.mktemp("march_host")
    (d / "shim.cpp").write_text(SHIM)
    lib = d / "libmarch_host.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-shared",
                    "-fPIC", "-I", str(CSRC), str(d / "shim.cpp"), "-o",
                    str(lib)], check=True, capture_output=True, timeout=300)
    so = ctypes.CDLL(str(lib))
    fn = so.grt_host_march_kerr_boyer
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
