"""The observer kernel's arithmetic, compiled as host code.

``csrc/observer.cuh`` (the metric at the camera's one point, the two-pass
frame basis with all four legs, its inverse, the orientation of the chart's
three axes and the Lorentz boost) is plain C++ when g++ compiles it.  This
test builds it with a small C shim (the route of
``test_torch_render_data_host.py``) and holds the tetrad ``es`` of every
camera bit for bit to the eager ``camera.observer_tetrad_reference`` on the
same position, axes and speed: the benchmark cells' cameras (r = 7 on the
equator at three seeded azimuths) for Kerr, Schwarzschild and the two-body
metric in its cylindrical chart, a Kerr camera inside the ergosphere (where
the frame basis takes its second pass), cameras off the equator and with a
frame 3-speed, a wormhole camera at negative r, the three charts whose
axes come out of their jvp in float64 (ingoing Eddington-Finkelstein
Schwarzschild and Kerr, Misner), an emitted content-pack struct and a baked
build (the parameters compiled in).

Exact, with one stated exception, the one of the render-data host test: the
eager path's sin, cos, atan2 and sqrt are torch's CPU kernels, which differ
from glibc's in the last ulp of a few percent of their values, so while the
eager path runs a torch function mode hands those four to the shim's libm
loops (``test_torch_render_data_host.LibmMode``).  The tetrad has no
division by a Python scalar, so nothing is held to an ulp.
"""

import ctypes
import math
import shutil
import subprocess

import numpy as np
import pytest
import torch

from geodesic_raytracing_tpu_torch import camera as cam
from geodesic_raytracing_tpu_torch import metrics
from geodesic_raytracing_tpu_torch.ops import emit, raymarch, tetrad
from geodesic_raytracing_tpu_torch.runtime import hotswap
import torch_emit_host as eh
from test_torch_render_data_host import CSRC, LibmMode, rn_metric, same_bits

torch.set_num_threads(1)

SHIM = r"""
#include <string.h>

#include "observer.cuh"
INCLUDES
namespace {

template <class M>
void tetrad_of(const M& m, const float* x, const float* gx, const float* gy,
               const float* gz, const float* speed, float* es) {
  const float zero[3] = {0.0f, 0.0f, 0.0f};
  float out[4][4];
  grt::observer_tetrad(m, x, gx, gy, gz, speed ? speed : zero, out);
  for (int a = 0; a < 4; ++a)
    for (int mu = 0; mu < 4; ++mu) es[4 * a + mu] = out[a][mu];
}

}  // namespace

extern "C" int grt_host_observer(const char* metric, const float* mparams,
                                 const float* x, const float* gx,
                                 const float* gy, const float* gz,
                                 const float* speed, float* es) {
#define TRY(M)                                                          \
  if (strcmp(metric, #M) == 0) {                                        \
    tetrad_of(grt::M::from_params(mparams), x, gx, gy, gz, speed, es);  \
    return 0;                                                           \
  }
TRYS#undef TRY
  return 1;
}

// The baked build: the baked struct made from the compile-time values, as
// raymarch.cu's kernels make it.
extern "C" void grt_host_observer_baked(const float* x, const float* gx,
                                        const float* gy, const float* gz,
                                        const float* speed, float* es) {
  constexpr float kBaked[] = {GRT_BAKED_PARAMS 0.0f};
  tetrad_of(grt::BAKED_STRUCT::from_params(kBaked), x, gx, gy, gz, speed, es);
}

// The frame basis alone, every leg, of n row-major 4x4 metrics.
extern "C" void grt_host_frame_basis(int n, const float* g, float* es) {
  for (int i = 0; i < n; ++i) {
    float gi[4][4], out[4][4];
    for (int a = 0; a < 16; ++a) gi[a / 4][a % 4] = g[16 * i + a];
    grt::frame_basis_all(gi, out);
    for (int a = 0; a < 16; ++a) es[16 * i + a] = out[a / 4][a % 4];
  }
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

# The baked build's metric and its compiled-in parameters (not the
# defaults, so that a build that read the launch's values would part).
BAKED = ("kerr_boyer", {"rs": 1.0, "a": 0.3})


@pytest.fixture(scope="module")
def emitted():
    """``{name: Header}``: the emitted dynamic structs of the cases'
    metrics (None: the pack metric's) and, under "baked", the baked struct
    of ``BAKED`` (``ops/emit.py``)."""
    out = {name: emit.emit_metric(rn_metric() if name is None
                                  else metrics.get_metric(name))
           for case, name, _ in CASES if not case.startswith("baked")}
    out["baked"] = emit.emit_metric(metrics.get_metric(BAKED[0]), BAKED[1])
    return out


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory, emitted):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of "
                    "observer.cuh needs it")
    d = tmp_path_factory.mktemp("observer_host")
    baked = emitted["baked"]
    hs = list(emitted.values())
    (d / "baked.h").write_text(raymarch.baked_define(baked.baked) + "\n")
    (d / "shim.cpp").write_text(SHIM.replace("INCLUDES", eh.includes(hs, d))
                                .replace("TRYS", eh.dispatch(hs))
                                .replace("BAKED_STRUCT", baked.struct))
    lib = d / "libobserver_host.so"
    # No sincosf: glibc's sinf and cosf, as the libm loops call them.
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-Wall",
                    "-Werror", "-Wno-unused-function", "-fno-builtin-sinf",
                    "-fno-builtin-cosf", "-shared", "-fPIC", "-I", str(CSRC),
                    "-I", str(d), "-include", str(d / "baked.h"),
                    str(d / "shim.cpp"), "-o", str(lib)],
                   check=True, capture_output=True, timeout=600)
    dll = ctypes.CDLL(str(lib))
    vp = ctypes.c_void_p
    dll.grt_host_observer.restype = ctypes.c_int
    dll.grt_host_observer.argtypes = [ctypes.c_char_p, *[vp] * 7]
    dll.grt_host_observer_baked.restype = None
    dll.grt_host_observer_baked.argtypes = [vp] * 6
    dll.grt_host_frame_basis.restype = None
    dll.grt_host_frame_basis.argtypes = [ctypes.c_int, vp, vp]
    dll.grt_host_libm.restype = None
    dll.grt_host_libm.argtypes = [ctypes.c_int, ctypes.c_int, vp, vp, vp]
    return dll


def _ptr(a: np.ndarray):
    return a.ctypes.data


def host_tetrad(lib, header, metric, position, params, speed=None):
    """The host build's tetrad at ``position`` by the emitted struct of
    ``header`` (from the compile-time values where it is baked), the axes
    from the same torch calls as the eager path."""
    axes = [a.contiguous().numpy()
            for a in cam.generic_axes(metric, position, params)]
    x = position.contiguous().numpy()
    s = None if speed is None else speed.contiguous().numpy()
    es = np.empty((4, 4), np.float32)
    args = [_ptr(x), *map(_ptr, axes), None if s is None else _ptr(s),
            _ptr(es)]
    if header.baked is not None:
        lib.grt_host_observer_baked(*args)
    else:
        mp = np.array([params[k] for k in header.params] + [0.0], np.float32)
        assert lib.grt_host_observer(header.struct.encode(), _ptr(mp),
                                     *args) == 0
    return torch.from_numpy(es)


def cell_cameras(seed: int):
    """The benchmark cells' camera (r 7 on the equator, phi -pi/2 plus a
    seeded azimuth) at three azimuths: ``[(polar position, speed)]``."""
    turns = torch.rand(3, generator=torch.Generator().manual_seed(seed))
    return [([0.0, 7.0, math.pi / 2, -math.pi / 2 + 2 * math.pi * float(t)],
             None) for t in turns]


# (case, metric or None for the pack, cameras): the cells' three
# metrics; Kerr also inside its ergosphere (r 0.8: g_tt > 0, so the first
# pass finds its timelike leg elsewhere than at 0) and off the equator with
# a frame 3-speed; Schwarzschild with a speed; the two-body metric off the
# plane between its holes; the wormhole's far side (r < 0) and near side;
# the ingoing Eddington-Finkelstein and Misner charts, whose one-point jvp
# comes out in float64 (``camera.generic_axes`` casts it back; Misner's at
# t = -2, off the branch cut of its chart at t = 0, and where x >= 0, as
# its chart needs x > t); the emitted
# pack struct and the baked build off the equator.
SPEED = [-0.3, 0.1, 0.2]
OFF = [0.0, 5.0, 1.1, 0.4]
CASES = [
    ("kerr_boyer", "kerr_boyer",
     cell_cameras(11) + [([0.0, 0.8, math.pi / 2, 0.3], None),
                         (OFF, SPEED)]),
    ("schwarzschild", "schwarzschild", cell_cameras(12) + [(OFF, SPEED)]),
    ("double_kerr", "double_kerr",
     cell_cameras(13) + [([0.0, 6.0, 0.7, 1.3], SPEED)]),
    ("wormhole", "wormhole (morris-thorne)",
     [([0.0, -5.0, 1.2, 0.5], None), ([0.0, -3.0, 2.0, -1.0], SPEED),
      ([0.0, 4.0, 1.0, 2.0], None)]),
    ("schwarzschild_ingoing_ef", "schwarzschild_ingoing_ef",
     cell_cameras(16) + [(OFF, SPEED)]),
    ("kerr_ingoing_ef", "kerr_ingoing_ef", cell_cameras(17) + [(OFF, SPEED)]),
    ("misner_4d", "misner_4d",
     [([-2.0, 7.0, math.pi / 2, -math.pi / 2 + math.pi * float(t)], None)
      for t in torch.rand(3, generator=torch.Generator().manual_seed(18))]
     + [([-2.0, *OFF[1:]], SPEED)]),
    ("pack_reissner_nordstrom", None, cell_cameras(14) + [(OFF, SPEED)]),
    ("baked_kerr_boyer", BAKED[0], cell_cameras(15) + [(OFF, SPEED)]),
]


@pytest.mark.parametrize("case,name,cameras", CASES,
                         ids=[c[0] for c in CASES])
def test_host_observer_tetrad_matches_eager(host_lib, emitted, case, name,
                                            cameras):
    m = rn_metric() if name is None else metrics.get_metric(name)
    params = m.params()
    header = emitted[name]
    if case.startswith("baked"):
        m, header = hotswap.bake(m, BAKED[1]), emitted["baked"]
    for polar, speed in cameras:
        polar = torch.tensor(polar)
        speed = None if speed is None else torch.tensor(speed)
        position = m.from_polar(polar, params)
        with LibmMode(host_lib):
            ref = cam.observer_tetrad_reference(m, position, params, speed)
            got = host_tetrad(host_lib, header, m, position, params, speed)
        assert torch.isfinite(ref).all(), (case, polar)
        assert same_bits(got, ref), (case, polar, got - ref)


def test_the_cameras_reach_the_second_pass_and_the_far_side():
    """Inside Kerr's ergosphere the first pass's timelike leg is not at 0
    (so the frame basis takes the second pass, with leg 0 swapped into its
    slot); the wormhole's far-side camera has r < 0 in its polar chart."""
    m = metrics.get_metric("kerr_boyer")
    params = m.params()
    gab = m.fn(m.from_polar(torch.tensor([0.0, 0.8, math.pi / 2, 0.3]),
                            params), params)
    _, tl1 = tetrad._frame_basis_swap_batched(
        gab[..., None], torch.zeros((1,), dtype=torch.int32))
    assert int(tl1) != 0
    w = metrics.get_metric("wormhole (morris-thorne)")
    polar = w.to_polar(w.from_polar(torch.tensor([0.0, -5.0, 1.2, 0.5]),
                                    w.params()), w.params())
    assert float(polar[1]) < 0


def test_host_frame_basis_matches_eager_on_every_swap(host_lib):
    """The frame basis of seeded symmetric metrics, one, two or no negative
    diagonal entries, some with a zero on the diagonal: where the second
    pass finds its timelike leg at a slot other than 0 too (a metric with
    two timelike directions), its es_sw puts leg 0 in that slot, and every
    leg reaches the tetrad."""
    g = torch.Generator().manual_seed(5)
    n = 64
    off = 0.3 * torch.randn((n, 4, 4), generator=g)
    diag = torch.rand((n, 4), generator=g) + 0.5
    sign = torch.ones((n, 4))
    sign[torch.arange(n), torch.randint(0, 4, (n,), generator=g)] = -1.0
    sign[n // 2:, 0] = -1.0  # half with a second negative entry (or two)
    diag = diag * sign
    diag[::9, 1] = 0.0
    gab = off + off.transpose(1, 2) + torch.diag_embed(diag)
    batched = gab.permute(1, 2, 0).contiguous()
    with LibmMode(host_lib):
        ref, _ = tetrad.frame_basis_batched(batched)
        _, tl1 = tetrad._frame_basis_swap_batched(
            batched, torch.zeros((n,), dtype=torch.int32))
        _, tl2 = tetrad._frame_basis_swap_batched(batched, tl1)
    ref = ref.permute(2, 0, 1)
    got = np.empty((n, 4, 4), np.float32)
    host_lib.grt_host_frame_basis(n, _ptr(gab.contiguous().numpy()),
                                  _ptr(got))
    assert same_bits(torch.from_numpy(got), ref)
    assert ((tl1 != 0) & (tl2 != 0)).any() and ((tl1 != 0) & (tl2 == 0)).any()
    assert (tl1 == 0).any()
