"""The launch-state kernel's per-ray arithmetic, compiled as host code.

``csrc/launch_state.cuh`` (the pixel's direction, the velocity from the
observer tetrad, the planar rotation into the equator, the null fix, the
launch acceleration, the step seed and ku_uobsu) is plain C++ when g++
compiles it.  This test builds it with a small C shim (the route of
``test_torch_render_data_host.py``) and holds every output field of every
ray bit for bit to the eager ``rays_for_pixels_reference`` on the same
camera: the pixels of a 16x12 frame pitched at the origin (its centre pixel
looks straight at it: the rotation's plane of that ray is decided by the
last bits of its arithmetic) plus the image's corners and centre and points
beyond its edge, for
4-D Kerr, planar Schwarzschild (its inverse quaternions), the two-body
metric in its cylindrical chart, the rank-1 Kerr-Schild struct, a metric
without adaptive precision, flat space (no dependent coordinate), a camera
with a frame 3-speed traced forwards, and a planar metric whose chart is
not the identity, whose rays come in through the kernel's generic input
after the chart's eager ``to_planar``; and the planar rotation alone on
rays that take each of its guards.

Exact, with the render-data host test's one stated exception: the eager
path's transcendentals are torch's CPU kernels, which differ from glibc's in
the last ulp of a few percent of their values (on the card torch's and the
kernel's are one libdevice function).  While the eager path runs, a torch
dispatch mode hands sin, cos, sqrt, rsqrt, atan2 and acos of float32 CPU
tensors to the shim's libm loops; it sits below the functorch transforms,
so the metric's jvp (the acceleration's partials) takes them from there too.
"""

import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from geodesic_raytracing_tpu_torch import camera as cam
from geodesic_raytracing_tpu_torch import metrics
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.ops import emit, integrate
from geodesic_raytracing_tpu_torch.render import pipeline as pl
import torch_emit_host as eh
from test_torch_render_data_host import CSRC, same_bits

torch.set_num_threads(1)

SHIM = r"""
#include <math.h>
#include <string.h>

#include "launch_state.cuh"
INCLUDES
namespace {

struct Arrays {
  const float *cx, *cy, *f_stop, *quat, *gpos, *gvel, *x, *es;
  float *pos, *vel, *acc, *next_ds, *rdl;
  int *status, *steps;
  float *ku, *inv_quat;
};

// Every ray; gpos, gvel and inv_quat are (4, N) row-major.
template <class M>
void launch_all(const float* mparams, const grt::LaunchConsts& c, int n,
                const Arrays& a) {
  const M m = M::from_params(mparams);
  float obs_low[4];
  grt::observer_low(m, a.x, a.es, obs_low);
  for (int i = 0; i < n; ++i) {
    grt::Ray s;
    float ku, iq[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (a.gpos != nullptr) {
      float pos[4], vel[4];
      for (int k = 0; k < 4; ++k) {
        pos[k] = a.gpos[k * n + i];
        vel[k] = a.gvel[k * n + i];
      }
      grt::launch_ray(m, c, obs_low, pos, vel, s, ku);
    } else {
      grt::launch_pixel(m, c, obs_low, a.cx[i], a.cy[i], *a.f_stop, a.quat,
                        a.x, a.es, s, ku, iq);
    }
    for (int k = 0; k < 4; ++k) {
      a.pos[4 * i + k] = s.pos[k];
      a.vel[4 * i + k] = s.vel[k];
      a.acc[4 * i + k] = s.acc[k];
      if (a.inv_quat != nullptr) a.inv_quat[k * n + i] = iq[k];
    }
    a.next_ds[i] = s.next_ds;
    a.rdl[i] = s.rdl;
    a.status[i] = s.status;
    a.steps[i] = s.steps;
    a.ku[i] = ku;
  }
}

}  // namespace

extern "C" int grt_host_launch_state(
    const char* metric, const float* mparams, const float* consts,
    int planar, int n, const float* cx, const float* cy, const float* f_stop,
    const float* quat, const float* gpos, const float* gvel, const float* x,
    const float* es, float* pos, float* vel, float* acc, float* next_ds,
    float* rdl, int* status, int* steps, float* ku, float* inv_quat) {
  const Arrays a{cx,  cy,  f_stop,  quat, gpos,   gvel,  x,  es,       pos,
                 vel, acc, next_ds, rdl,  status, steps, ku, inv_quat};
  const grt::LaunchConsts c{consts[0], consts[1], consts[2], consts[3],
                            planar};
#define TRY(M)                                  \
  if (strcmp(metric, #M) == 0) {                \
    launch_all<grt::M>(mparams, c, n, a);       \
    return 0;                                   \
  }
TRYS#undef TRY
  return 1;
}

// The planar rotation alone of n generic rays (4, N) row-major, in place,
// with their inverse quaternions (4, N).
extern "C" void grt_host_rotate(int n, float* pos, float* vel,
                                float* inv_quat) {
  for (int i = 0; i < n; ++i) {
    float p[4], v[4], q[4];
    for (int k = 0; k < 4; ++k) {
      p[k] = pos[k * n + i];
      v[k] = vel[k * n + i];
    }
    grt::rotate_into_equator(p, v, q);
    for (int k = 0; k < 4; ++k) {
      pos[k * n + i] = p[k];
      vel[k * n + i] = v[k];
      inv_quat[k * n + i] = q[k];
    }
  }
}

// The libm functions the eager path takes under LibmDispatch: op 0 sinf,
// 1 cosf, 2 sqrtf, 3 atan2f(a, b), 4 acosf, 5 1 / sqrtf (grt_rsqrt).
extern "C" void grt_host_libm(int op, int n, const float* a, const float* b,
                              float* out) {
  for (int i = 0; i < n; ++i) {
    switch (op) {
      case 0: out[i] = sinf(a[i]); break;
      case 1: out[i] = cosf(a[i]); break;
      case 2: out[i] = sqrtf(a[i]); break;
      case 3: out[i] = atan2f(a[i], b[i]); break;
      case 4: out[i] = acosf(a[i]); break;
      default: out[i] = grt::grt_rsqrt(a[i]); break;
    }
  }
}
"""

# (case, metric, planar, camera speed, flip): 4-D Kerr; planar
# Schwarzschild; the complex-pair two-body metric (cylindrical chart); the
# rank-1 Kerr-Schild struct (cartesian chart); planar Schwarzschild without
# adaptive precision (the scheduled step's seed); flat space's constant
# metric (no dependent coordinate); Kerr with a moving camera traced
# forwards; planar ingoing Eddington-Finkelstein Schwarzschild, whose chart
# is not the identity (the kernel's generic input).
CASES = [
    ("kerr_boyer", "kerr_boyer", False, None, False),
    ("schwarzschild_planar", "schwarzschild", True, None, False),
    ("double_kerr", "double_kerr", False, None, False),
    ("kerr_schild", "kerr_schild", False, None, False),
    ("schwarzschild_fast_planar", "schwarzschild_fast", True, None, False),
    ("minkowski", "minkowski", False, None, False),
    ("kerr_boyer_moving_forwards", "kerr_boyer", False, (0.2, -0.1, 0.3),
     True),
    ("schwarzschild_ingoing_ef_planar", "schwarzschild_ingoing_ef", True,
     None, False),
]

W, H = 16, 12


@pytest.fixture(scope="module")
def emitted():
    """``{name: Header}``: the emitted structs of the cases' metrics
    (``ops/emit.py``)."""
    return {name: emit.emit_metric(metrics.get_metric(name))
            for name in dict.fromkeys(c[1] for c in CASES)}


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory, emitted):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of "
                    "launch_state.cuh needs it")
    d = tmp_path_factory.mktemp("launch_state_host")
    hs = list(emitted.values())
    (d / "shim.cpp").write_text(SHIM.replace("INCLUDES", eh.includes(hs, d))
                                .replace("TRYS", eh.dispatch(hs)))
    lib = d / "liblaunch_state_host.so"
    # No sincosf: glibc's sinf and cosf, as the libm loops call them.
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-Wall",
                    "-Werror", "-Wno-unused-function", "-fno-builtin-sinf",
                    "-fno-builtin-cosf", "-shared", "-fPIC", "-I", str(CSRC),
                    "-I", str(d), str(d / "shim.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=600)
    dll = ctypes.CDLL(str(lib))
    vp = ctypes.c_void_p
    dll.grt_host_launch_state.restype = ctypes.c_int
    dll.grt_host_launch_state.argtypes = [ctypes.c_char_p, vp, vp,
                                          *[ctypes.c_int] * 2, *[vp] * 17]
    dll.grt_host_rotate.restype = None
    dll.grt_host_rotate.argtypes = [ctypes.c_int, vp, vp, vp]
    dll.grt_host_libm.restype = None
    dll.grt_host_libm.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp, vp]
    return dll


class LibmDispatch(TorchDispatchMode):
    """aten's sin, cos, sqrt, rsqrt, atan2 and acos of float32 CPU tensors
    from the shim's libm loops, also under ``torch.func.jvp`` (a dispatch
    mode sees the transforms' unwrapped tensors)."""

    OPS = {torch.ops.aten.sin.default: 0, torch.ops.aten.cos.default: 1,
           torch.ops.aten.sqrt.default: 2, torch.ops.aten.atan2.default: 3,
           torch.ops.aten.acos.default: 4, torch.ops.aten.rsqrt.default: 5}

    def __init__(self, lib):
        super().__init__()
        self.lib = lib
        self.seen = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        op = self.OPS.get(func)
        if (op is None or kwargs
                or any(not isinstance(t, torch.Tensor)
                       or t.dtype != torch.float32 or t.device.type != "cpu"
                       for t in args)):
            return func(*args, **kwargs)
        self.seen.add(op)
        a = args[0]
        b = args[1] if op == 3 else a
        a, b = torch.broadcast_tensors(a, b)
        a = a.contiguous().numpy()
        b = b.contiguous().numpy()
        out = np.empty_like(a)
        self.lib.grt_host_libm(op, a.size, a.ctypes.data, b.ctypes.data,
                               out.ctypes.data)
        return torch.from_numpy(out)


def scene(name, speed, flip):
    """``(metric, params, features, camera, settings)``: a W x H frame from
    r = 7 on the equator pitched at the origin (the render-data host
    test's camera), with the frame 3-speed ``speed`` and ``flip``."""
    m = metrics.get_metric(name)
    camera = Camera.default(device="cpu").rotate(pitch=-math.pi / 2)
    if speed is not None:
        camera = camera._replace(basis_speed=torch.tensor(speed))
    settings = pl.RenderSettings(width=W, height=H,
                                 flip_geodesic_direction=flip)
    return (m, m.params(), integrate.Features.for_metric(m), camera,
            settings)


def pixels():
    """Every pixel of the W x H frame, then the image's corners and centre
    and points beyond its edge and between pixels."""
    cx, cy = pl._grid_coords(W, H, 1.0, "cpu")
    extra = torch.tensor([[0.0, 0.0], [W, 0.0], [0.0, H], [W, H],
                          [W / 2, H / 2], [W / 2 + 0.5, H / 2 - 0.5],
                          [-3.0, H + 2.0], [W + 7.0, -1.0]])
    return torch.cat([cx, extra[:, 0]]), torch.cat([cy, extra[:, 1]])


def host_launch(lib, header, m, params, features, camera, settings, position,
                es, cx, cy, planar, generic=None):
    """The host build's ``(state, ku, inv_quat)`` of the pixels ``cx``,
    ``cy`` or, given, the generic rays ``(pos, vel)`` (4, N)."""
    n = cx.shape[0]
    mp = np.array([params[k] for k in header.params] + [0.0], np.float32)
    sign = pl._trace_sign(m, settings.flip_geodesic_direction)
    consts = np.array([settings.width / 2.0, settings.height / 2.0, sign,
                       features.max_acceleration_change], np.float32)
    f_stop = cam.focal_length(settings.width, settings.fov_degrees,
                              torch.device("cpu")).reshape(1)
    ins = [cx, cy, f_stop, camera.quat]
    ins += [None, None] if generic is None else list(generic)
    ins += [position, es]
    ins = [None if t is None else t.contiguous().numpy() for t in ins]
    outs = [np.empty((n, 4), np.float32) for _ in range(3)]
    outs += [np.empty(n, np.float32) for _ in range(2)]
    outs += [np.empty(n, np.int32) for _ in range(2)]
    outs += [np.empty(n, np.float32)]
    quat = (np.empty((4, n), np.float32) if planar and generic is None
            else None)
    rc = lib.grt_host_launch_state(
        header.struct.encode(), mp.ctypes.data, consts.ctypes.data,
        int(planar), n, *[None if a is None else a.ctypes.data for a in ins],
        *[o.ctypes.data for o in outs],
        None if quat is None else quat.ctypes.data)
    assert rc == 0, header.struct
    state = integrate.RayState(*(torch.from_numpy(o) for o in outs[:7]))
    return (state, torch.from_numpy(outs[7]),
            None if quat is None else torch.from_numpy(quat))


@pytest.mark.parametrize("case,name,planar,speed,flip", CASES,
                         ids=[c[0] for c in CASES])
def test_host_launch_state_matches_eager(host_lib, emitted, case, name,
                                         planar, speed, flip):
    m, params, features, camera, settings = scene(name, speed, flip)
    assert pl._planar_enabled(m, settings) == planar
    identity = pl._identity_chart(m)
    cx, cy = pixels()
    with LibmDispatch(host_lib) as libm:
        position, es = pl.camera_frame(m, camera, params)
        ref = pl.rays_for_pixels_reference(m, camera, position, es, params,
                                           settings, features, cx, cy,
                                           planar)
        generic = None
        if planar and not identity:
            # The kernel's generic input: the chart's eager to_planar.
            dirs = cam.directions_for_pixels(cx, cy, W, H, camera.quat,
                                             settings.fov_degrees)
            vel = pl._launch_velocity(dirs, es, pl._trace_sign(m, flip))
            pos = position[:, None].expand(4, vel.shape[1]).contiguous()
            p_t, v_t, _ = pl.pl_planar.to_planar(m, pos, vel, params)
            generic = (p_t, v_t)
    got = host_launch(host_lib, emitted[name], m, params, features, camera,
                      settings, position, es, cx, cy, planar, generic)
    (rstate, rku, riquat), (gstate, gku, giquat) = ref, got
    for field in integrate.RayState._fields:
        assert same_bits(getattr(gstate, field), getattr(rstate, field)), \
            field
    assert same_bits(gku, rku)
    assert (riquat is not None) == planar
    if planar and identity:
        assert same_bits(giquat, riquat)
    # The rays are real: finite, null where the metric is regular, and the
    # transcendentals the case takes ran in the shim.
    assert torch.isfinite(rstate.acceleration).all()
    assert torch.isfinite(rku).all() and (rku != 0).all()
    assert (rstate.acceleration != 0).any() == (name != "minkowski")
    assert {2, 5} <= libm.seen
    if planar and identity:
        assert {0, 1, 3, 4} <= libm.seen
        assert (rstate.position[:, 2] == np.float32(math.pi / 2)).all()
        assert (rstate.velocity[:, 2] == 0).all()


def test_the_equator_rotation_takes_the_guards(host_lib):
    """The planar rotation alone against ``to_planar`` of an identity chart,
    on rays that take every guard of ``theta_adjustment_quat``: a radial
    ray on the polar axis (its plane is undefined: the rejection and the
    normal normalise zero vectors, the axis is degenerate), rays with no
    spatial velocity (the small-velocity fallback), rays at negative and
    zero r, and random rays around them."""
    m = metrics.get_metric("schwarzschild")
    g = torch.Generator().manual_seed(11)
    n_rand = 64
    pos = torch.stack([torch.randn(n_rand, generator=g),
                       -8.0 + 16.0 * torch.rand(n_rand, generator=g),
                       3.1 * torch.rand(n_rand, generator=g),
                       -3.0 + 6.0 * torch.rand(n_rand, generator=g)])
    vel = torch.randn((4, n_rand), generator=g)
    placed_p = torch.tensor([[0.0, 5.0, 0.0, 0.3], [0.0, -5.0, 0.0, 1.0],
                             [1.0, 4.0, 1.2, -0.7], [0.0, 0.0, 1.0, 2.0],
                             [0.0, 6.0, math.pi, 0.0]]).T
    placed_v = torch.tensor([[1.0, -1.0, 0.0, 0.0], [1.0, 2.0, 0.0, 0.0],
                             [1.0, 0.0, 0.0, 0.0], [1.0, 0.5, 0.1, 0.2],
                             [-1.0, 0.7, 0.0, 0.0]]).T
    pos = torch.cat([pos, placed_p], dim=1).contiguous()
    vel = torch.cat([vel, placed_v], dim=1).contiguous()
    with LibmDispatch(host_lib):
        ref_p, ref_v, ref_q = pl.pl_planar.to_planar(m, pos, vel, {})
    n = pos.shape[1]
    got_p, got_v = pos.numpy().copy(), vel.numpy().copy()
    got_q = np.empty((4, n), np.float32)
    host_lib.grt_host_rotate(n, got_p.ctypes.data, got_v.ctypes.data,
                             got_q.ctypes.data)
    for got, ref in ((got_p, ref_p), (got_v, ref_v), (got_q, ref_q)):
        assert same_bits(torch.from_numpy(got), ref.contiguous())
    # The pole rays' quaternions are the degenerate axis' (x), the
    # still ray's rotation is finite.
    assert torch.isfinite(ref_q).all() and torch.isfinite(ref_p).all()
    assert (ref_q[1:3, n_rand:n_rand + 2] == 0).all()
