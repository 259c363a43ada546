"""The render-data kernel's per-ray arithmetic, compiled as host code.

``csrc/render_data.cuh`` (the snap to the universe or terminator sphere, the
planar rays' rotation back, the frame basis at the endpoint, z_shift and the
texture coordinates) is plain C++ when g++ compiles it.  This test builds it
with a small C shim (the route of ``test_torch_raymarch_host.py``) and holds
every output, for every ray, to the eager ``compute_render_data_reference``
on the same endpoints: the ends of a short march of a 16x12 camera frame
plus hand-placed rays (escaped beyond the universe sphere, escaped inside
|r| <= 1, dead, at negative r, near a singular metric's terminator).

Exact, with two stated exceptions:

- The eager path's sin, cos, atan2 and sqrt are torch's CPU kernels, which
  differ from glibc's in the last ulp of a few percent of their values (on
  the card torch's and the kernel's are one libdevice function).  While the
  eager path runs, a torch function mode hands those four to the shim's
  libm loops, so that both sides take each transcendental from one library.
- ``angle_to_tex`` divides by the Python scalars 2 pi and pi.  torch's CPU
  kernel divides; its CUDA kernel, which the kernel follows, multiplies by
  the float32 reciprocal.  The texture coordinates are held to 1 ulp; the
  card test (``test_torch_render_data_card.py``) holds them exactly.
"""

import ctypes
import dataclasses
import math
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from geodesic_raytracing_tpu_torch import content, metrics
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.ops import emit, integrate
from geodesic_raytracing_tpu_torch.render import pipeline as pl
import torch_emit_host as eh

torch.set_num_threads(1)

CSRC = Path(integrate.__file__).resolve().parents[1] / "csrc"
PACK = Path(__file__).resolve().parents[1] / "examples" / "pack_torch"

SHIM = r"""
#include <math.h>
#include <string.h>

#include "render_data.cuh"
INCLUDES
namespace {

struct Arrays {
  const float *pos, *vel, *rdl;
  const int* status;
  const float *ku, *polar, *polar_vel, *inv_quat;
  float *tex, *z_shift;
  int *side, *terminated;
  float* angles;
};

// Every ray; the (4, N) polar arrays and quaternions are row-major.
template <class M>
void render_all(const float* mparams, const grt::RenderConsts& c, int n,
                const Arrays& a) {
  const M m = M::from_params(mparams);
  for (int i = 0; i < n; ++i) {
    grt::RayEnd e;
    for (int k = 0; k < 4; ++k) {
      e.pos[k] = a.pos[4 * i + k];
      e.vel[k] = a.vel[4 * i + k];
      e.inv_quat[k] = a.inv_quat ? a.inv_quat[k * n + i] : 0.0f;
    }
    for (int k = 0; k < 3; ++k) {
      e.polar[k] = a.polar[(k + 1) * n + i];
      e.polar_vel[k] = a.polar_vel[(k + 1) * n + i];
    }
    e.rdl = a.rdl[i];
    e.status = a.status[i];
    e.ku_uobsu = a.ku[i];
    e.planar = a.inv_quat != nullptr;
    grt::RayRender o;
    grt::render_ray(m, c, e, o);
    a.tex[2 * i] = o.tex[0];
    a.tex[2 * i + 1] = o.tex[1];
    a.z_shift[i] = o.z_shift;
    a.side[i] = o.side;
    a.terminated[i] = o.terminated;
    a.angles[2 * i] = o.angles[0];
    a.angles[2 * i + 1] = o.angles[1];
  }
}

}  // namespace

extern "C" int grt_host_render_data(
    const char* metric, const float* mparams, const float* consts,
    int singular, int traversable, int n, const float* pos, const float* vel,
    const float* rdl, const int* status, const float* ku, const float* polar,
    const float* polar_vel, const float* inv_quat, float* tex, float* z_shift,
    int* side, int* terminated, float* angles) {
  const Arrays a{pos,     vel, rdl,  status,     ku,    polar, polar_vel,
                 inv_quat, tex, z_shift, side, terminated, angles};
  const grt::RenderConsts c{consts[0], consts[1], consts[2], singular,
                            traversable};
#define TRY(M)                                  \
  if (strcmp(metric, #M) == 0) {                \
    render_all<grt::M>(mparams, c, n, a);       \
    return 0;                                   \
  }
TRYS#undef TRY
  return 1;
}

// The libm functions the eager path takes under LibmMode: op 0 sinf,
// 1 cosf, 2 sqrtf, 3 atan2f(a, b).
extern "C" void grt_host_libm(int op, int n, const float* a, const float* b,
                              float* out) {
  for (int i = 0; i < n; ++i) {
    switch (op) {
      case 0: out[i] = sinf(a[i]); break;
      case 1: out[i] = cosf(a[i]); break;
      case 2: out[i] = sqrtf(a[i]); break;
      default: out[i] = atan2f(a[i], b[i]); break;
    }
  }
}
"""


def rn_metric():
    return content.load_pack(PACK, register=False).metrics[
        "reissner_nordstrom"]


@pytest.fixture(scope="module")
def emitted():
    """``{name: Header}``: the emitted structs of the cases' metrics (None:
    the pack metric's; ``ops/emit.py``)."""
    return {name: emit.emit_metric(rn_metric() if name is None
                                   else metrics.get_metric(name))
            for name in dict.fromkeys(c[1] for c in CASES)}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory, emitted):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of "
                    "render_data.cuh needs it")
    d = tmp_path_factory.mktemp("render_data_host")
    hs = list(emitted.values())
    (d / "shim.cpp").write_text(SHIM.replace("INCLUDES", eh.includes(hs, d))
                                .replace("TRYS", eh.dispatch(hs)))
    lib = d / "librender_data_host.so"
    # No sincosf: glibc's sinf and cosf, as the libm loops call them.
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-Wall",
                    "-Werror", "-Wno-unused-function", "-fno-builtin-sinf",
                    "-fno-builtin-cosf", "-shared", "-fPIC", "-I", str(CSRC),
                    "-I", str(d), str(d / "shim.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=600)
    dll = ctypes.CDLL(str(lib))
    vp = ctypes.c_void_p
    dll.grt_host_render_data.restype = ctypes.c_int
    dll.grt_host_render_data.argtypes = [ctypes.c_char_p, vp, vp,
                                         *[ctypes.c_int] * 3, *[vp] * 13]
    dll.grt_host_libm.restype = None
    dll.grt_host_libm.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp, vp]
    return dll


class LibmMode(TorchFunctionMode):
    """torch.sin, cos, sqrt and atan2 (functions and methods) of float32 CPU
    tensors from the shim's libm loops.  Tensors inside a functorch
    transform (the jvp of a chart's velocity) keep torch's kernels: both
    sides take the same polar velocity from the same calls."""

    def __init__(self, lib):
        super().__init__()
        self.lib = lib
        self.ops = {}
        for i, name in enumerate(("sin", "cos", "sqrt", "atan2")):
            self.ops[getattr(torch, name)] = i
            self.ops[getattr(torch.Tensor, name)] = i

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = self.ops.get(func)
        tensors = [a for a in args if isinstance(a, torch.Tensor)]
        if (op is None or kwargs or not tensors
                or any(torch._C._functorch.is_functorch_wrapped_tensor(t)
                       or t.dtype != torch.float32 or t.requires_grad
                       for t in tensors)):
            return func(*args, **kwargs)
        a = args[0]
        b = args[1] if op == 3 else a
        a, b = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(b))
        a = a.contiguous().numpy()
        b = b.contiguous().numpy()
        out = np.empty_like(a)
        self.lib.grt_host_libm(op, a.size, a.ctypes.data, b.ctypes.data,
                               out.ctypes.data)
        return torch.from_numpy(out)


def host_render(lib, header, metric, state, ku, params, features,
                inv_quat=None):
    """The host build's render data of ``state`` by the emitted struct of
    ``header`` (the polar position and velocity from the same torch calls
    as the eager path), as a ``RenderData``."""
    pos, vel = state.position.T, state.velocity.T
    polar = metric.to_polar(pos, params).contiguous().numpy()
    polar_vel = metric.to_polar_velocity(pos, vel, params).contiguous()
    polar_vel = polar_vel.numpy()
    n = state.position.shape[0]
    cfg = metric.config
    u, t = float(features.universe_size), float(cfg.singular_terminator)
    consts = np.array([u * u, t * t, 0.5 * (u + t)], np.float32)
    mp = np.array([params[k] for k in header.params] + [0.0], np.float32)
    ins = [state.position.contiguous().numpy(),
           state.velocity.contiguous().numpy(),
           state.running_dlambda_dnew.contiguous().numpy(),
           state.status.contiguous().numpy(), ku.contiguous().numpy(), polar,
           polar_vel]
    quat = None if inv_quat is None else inv_quat.contiguous().numpy()
    outs = [np.empty((n, 2), np.float32), np.empty(n, np.float32),
            np.empty(n, np.int32), np.empty(n, np.int32),
            np.empty((n, 2), np.float32)]
    rc = lib.grt_host_render_data(
        header.struct.encode(), mp.ctypes.data, consts.ctypes.data,
        int(cfg.singular), int(cfg.traversable_event_horizon), n,
        *[a.ctypes.data for a in ins], None if quat is None else
        quat.ctypes.data, *[o.ctypes.data for o in outs])
    assert rc == 0, header.struct
    return pl.RenderData(*(torch.from_numpy(o) for o in outs),
                         steps=state.steps)


def same_bits(a: torch.Tensor, b: torch.Tensor, ulps: int = 0) -> bool:
    """Equal bit for bit (within ``ulps`` float32 steps), or NaN on both
    sides."""
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(a) & torch.isnan(b)
    d = (a.view(torch.int32).to(torch.int64)
         - b.view(torch.int32).to(torch.int64)).abs()
    return bool(((d <= ulps) | nan).all())


def endpoints(m, params, features, planar, n_placed=18, max_steps=128):
    """The ends of a ``max_steps``-step march of a 16x12 frame from r = 7
    pitched at the origin, with the last ``n_placed`` rays replaced by
    hand-placed endpoints (polar r 20.5, -20.5, 0.5, -0.8, 1.02, 1.08, 3
    and, inside Kerr's ergosphere, where the frame basis takes its second
    pass, 0.8 and 0.7; escaped, dead or still active).  Returns ``(state, ku,
    inv_quat)``."""
    cam = Camera.default(device="cpu").rotate(pitch=-math.pi / 2)
    settings = pl.RenderSettings(width=16, height=12, planar=planar)
    state, ku, iquat = pl.init_camera_rays(m, cam, params, settings,
                                           features, device="cpu")
    opts = integrate.TraceOptions(max_steps=max_steps,
                                  planar=pl._planar_enabled(m, settings))
    state = integrate.trace_rays_reference(m, state, params, features, opts)

    g = torch.Generator().manual_seed(7)
    radii = torch.tensor([20.5, -20.5, 0.5, -0.8, 1.02, 1.08, 3.0, 0.8, 0.7])
    r = radii[torch.arange(n_placed) % len(radii)]
    theta = 0.2 + 2.7 * torch.rand(n_placed, generator=g)
    phi = -3.0 + 6.0 * torch.rand(n_placed, generator=g)
    p = torch.stack([torch.zeros(n_placed), r, theta, phi])
    v = torch.randn((4, n_placed), generator=g)
    fates = torch.tensor([integrate.ESCAPED, integrate.ESCAPED,
                          integrate.DEAD, integrate.ACTIVE],
                         dtype=torch.int32)[torch.arange(n_placed) % 4]
    k = slice(-n_placed, None)
    pos, vel = state.position.clone(), state.velocity.clone()
    pos[k] = m.from_polar(p, params).T
    vel[k] = m.from_polar_velocity(p, v, params).T
    status = state.status.clone()
    status[k] = fates
    return state._replace(position=pos, velocity=vel, status=status), ku, \
        iquat


def _traversable(m):
    cfg = dataclasses.replace(m.config, traversable_event_horizon=True)
    return dataclasses.replace(m, config=cfg)


# (case, metric or None for the pack, planar): 4-D Kerr; planar
# Schwarzschild with its quaternions; a singular metric without a traversable
# horizon (planar and 4-D) and with one (the same struct: the branch is the
# config's); flat space's constant metric in a cartesian chart; charts whose
# to_polar is not the identity; the rank-1 Kerr-Schild struct; a null
# coordinate (no g_rr) with a traversable horizon; the pack's struct; the
# cylindrical chart of the complex-pair two-body metric, whose g_{t phi}
# puts the frame basis' Gram-Schmidt through an off-diagonal entry (its
# eager march costs ~36 ms a step on one core, so its endpoints march 32
# steps).
CASES = [
    ("kerr_boyer", "kerr_boyer", True),
    ("schwarzschild_planar", "schwarzschild", True),
    ("schwarzschild_fast_planar", "schwarzschild_fast", True),
    ("schwarzschild_fast_4d", "schwarzschild_fast", False),
    ("schwarzschild_fast_traversable", "schwarzschild_fast", True),
    ("minkowski", "minkowski", True),
    ("schwarzschild_skewed", "schwarzschild_skewed", True),
    ("kerr_schild", "kerr_schild", True),
    ("schwarzschild_ingoing_ef", "schwarzschild_ingoing_ef", True),
    ("pack_reissner_nordstrom", None, True),
    ("double_kerr", "double_kerr", True),
]
MARCH_STEPS = {"double_kerr": 32}


@pytest.mark.parametrize("case,name,planar", CASES, ids=[c[0] for c in CASES])
def test_host_render_data_matches_eager(host_lib, emitted, case, name,
                                        planar):
    m = rn_metric() if name is None else metrics.get_metric(name)
    if case.endswith("traversable"):
        m = _traversable(m)
    params = m.params()
    features = integrate.Features.for_metric(m)
    state, ku, iquat = endpoints(m, params, features, planar,
                                 max_steps=MARCH_STEPS.get(case, 128))
    assert (iquat is not None) == (planar and m.spherically_symmetric)
    with LibmMode(host_lib):
        ref = pl.compute_render_data_reference(m, state, ku, params,
                                               features, inv_quat=iquat)
        got = host_render(host_lib, emitted[name], m, state, ku, params,
                          features, iquat)
    for field in ("z_shift", "side", "terminated", "angles", "steps"):
        assert same_bits(getattr(got, field), getattr(ref, field)), field
    assert same_bits(got.tex_coord, ref.tex_coord, ulps=1)
    # The inputs reach every branch the case has.
    st = ref.terminated
    assert (st == integrate.ESCAPED).any() and (st == integrate.DEAD).any()
    assert torch.isfinite(ref.z_shift).sum() > 150
    if m.config.to_polar == "polar_to_polar":
        assert (ref.side == 0).any() and (ref.side == 1).any()
    if m.config.singular and not m.config.traversable_event_horizon:
        # A placed escaped ray inside |r| <= 1 keeps its raw endpoint and
        # is black.
        assert ((state.status == integrate.ESCAPED)
                & (st == integrate.DEAD)).any()


def test_host_tex_differs_from_the_cpu_division_by_at_most_an_ulp(host_lib):
    """The one op where the kernel follows the card's torch and not the
    CPU's: x / c for a Python scalar c is x * float32(1 / float32(c)) there,
    which can differ from the CPU's quotient by an ulp (and does on some of
    these angles)."""
    x = torch.linspace(-7.0, 7.0, 20001)
    quotient = x / (2 * math.pi)
    inv = np.float32(1.0) / np.float32(2 * math.pi)
    product = x * float(inv)
    assert same_bits(product, quotient, ulps=1)
    assert not torch.equal(product, quotient)
