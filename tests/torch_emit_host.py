"""Emitted metric structs (``ops/emit.py``) built by g++ as host code and
marched: the only check of an emitted struct's arithmetic without a GPU.

Each header is compiled with ``csrc/march.cuh`` through the march loop of
``tests/test_torch_raymarch_host.py``'s shim, in a translation unit of its
own (the units build in parallel), into one library whose entry point
``grt_emit_march_<struct>`` marches an (N,)-ray state in place with the
default step options, 4-D or planar.
"""

import concurrent.futures
import ctypes
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

import test_torch_raymarch_host as host
from geodesic_raytracing_tpu_torch import metrics
from geodesic_raytracing_tpu_torch.ops import emit, integrate, raymarch

# The shim's march_all, without its dispatch over the hand instances.
SHIM_HEAD = host.SHIM.split("// Every instance:")[0]

ENTRY = r"""
extern "C" int grt_emit_march_STRUCT(const float* mparams, const float* feats,
                                     int planar, int n, int max_steps,
                                     float* pos, float* vel, float* acc,
                                     float* next_ds, float* rdl, int* status,
                                     int* steps, const float* f_in_x) {
  const Arrays a{pos, vel, acc, next_ds, rdl, status, steps, f_in_x};
  const grt::Features f = grt::features_from(feats);
  const auto m = grt::STRUCT::from_params(mparams);
#if PLANAR
  if (planar) {
    march_all<grt::StepOptions<true, false, false>>(m, f, n, max_steps, a);
    return 0;
  }
#endif
  if (planar) return 1;
  march_all<grt::DefaultOptions>(m, f, n, max_steps, a);
  return 0;
}
"""

FLAGS = ["-O2", "-std=c++17", "-ffp-contract=off", "-Wall", "-Werror",
         "-Wno-unused-function", "-fPIC"]


def build(headers, directory, planar=(), hand=(), jobs=2) -> dict:
    """Compile each emitted ``Header`` of ``headers`` (with a planar entry
    where its struct is in ``planar``), and the hand structs named in
    ``hand`` (4-D), and link them into one library in ``directory``.
    Returns ``{struct: entry point}``; skips the test where g++ is not
    installed."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of march.cuh "
                    "needs it")
    units = []
    for h in headers:
        hp = directory / f"{h.struct}.cuh"
        hp.write_text(h.text)
        cpp = directory / f"{h.struct}.cpp"
        entry = ENTRY.replace("STRUCT", h.struct).replace(
            "PLANAR", str(int(h.struct in planar)))
        cpp.write_text(f'#include "{hp}"\n' + SHIM_HEAD + entry)
        units.append(cpp)
    for struct in hand:
        cpp = directory / f"hand_{struct}.cpp"
        cpp.write_text(SHIM_HEAD + ENTRY.replace("STRUCT", struct).replace(
            "PLANAR", "0"))
        units.append(cpp)

    def compile_unit(cpp):
        obj = cpp.with_suffix(".o")
        proc = subprocess.run([gxx, *FLAGS, "-c", "-I", str(host.CSRC),
                               str(cpp), "-o", str(obj)],
                              capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return obj

    workers = max(1, min(jobs, len(units), os.cpu_count() or 1))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        objs = list(pool.map(compile_unit, units))
    lib = directory / "libemit_host.so"
    subprocess.run([gxx, "-shared", *map(str, objs), "-o", str(lib)],
                   check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    out = {}
    for struct in [h.struct for h in headers] + list(hand):
        fn = getattr(dll, f"grt_emit_march_{struct}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p] * 8
        out[struct] = fn
    return out


def host_march(fn, header, state, params, features, opts):
    """The host march of a struct (``fn`` its entry point) with ``params``
    in the order of ``header.params`` (an emitted ``Header``, or a hand
    struct's ``raymarch.hand_instance``), from ``state``."""
    arrs = [t.numpy().copy() for t in state]
    fx = np.abs(arrs[1][:, 0]).copy()
    feats = np.array([*features, *integrate.schedule_constants(features)],
                     np.float32)
    mp = np.array([params[k] for k in header.params] + [0.0], np.float32)
    rc = fn(mp.ctypes.data, feats.ctypes.data, int(opts.planar), len(fx),
            opts.max_steps, *[a.ctypes.data for a in arrs], fx.ctypes.data)
    assert rc == 0, header.struct
    return integrate.RayState(*(torch.from_numpy(a) for a in arrs))


def launch_state(m, params, rays_of=None):
    """The host test's 64 rays in the chart of ``m`` (of the metric
    ``rays_of`` where given), every 7th born DEAD."""
    feats = integrate.Features.for_metric(m)
    pos, vel = host.generic_rays(rays_of or m, params)
    st = integrate.init_ray_state(m, pos, vel, params, feats)
    st.status[::7] = integrate.DEAD
    return st, feats


def assert_kerr_family(got, ref):
    """The host test's rule for the Kerr family
    (``test_host_kerr_family_matches_plain_torch``): fates equal, step
    counts on at least 62, escaped positions within 1e-4 where the counts
    agree but on rays of more than 1.5 times the median step count."""
    np.testing.assert_array_equal(got.status.numpy(), ref.status.numpy())
    steps_eq = got.steps.numpy() == ref.steps.numpy()
    assert steps_eq.sum() >= 62, steps_eq.sum()
    escaped = ref.status.numpy() == integrate.ESCAPED
    steps = ref.steps.numpy()
    long_ = escaped & (steps > 1.5 * np.median(steps[escaped]))
    ok = escaped & steps_eq & ~long_
    assert ok.sum() >= 16 and long_.sum() <= 8, (ok.sum(), long_.sum())
    np.testing.assert_allclose(got.position.numpy()[ok],
                               ref.position.numpy()[ok], rtol=1e-4,
                               atol=1e-4)


# The tolerance of each registered metric, as test_torch_raymarch_host.py
# holds its hand instance.
KERR_FAMILY = host.KERR_FAMILY
TANH_WALL = host.TANH_WALL


def assert_as_host_test(name, m, got, ref, st, params, feats, opts):
    """``got`` against the plain march ``ref`` by the rule the host test
    applies to metric ``name``'s hand instance (``params``: the float
    parameters, of the float64 march of the tanh walls)."""
    if name in KERR_FAMILY:
        assert_kerr_family(got, ref)
    elif name in TANH_WALL:
        host._assert_same_march_tanh_wall(got, ref, m, st, params, feats,
                                          opts)
    else:
        host._assert_same_march(got, ref, 16,
                                host.BLOW_UP_DEAD_VELOCITY_RTOL.get(name,
                                                                    1e-4))
    for a, b in zip(got, st):  # rays born DEAD are untouched
        np.testing.assert_array_equal(a.numpy()[::7], b.numpy()[::7])


def builtin_cases(names):
    """``[(name, mode)]`` of the registered metrics ``names``, dynamic and
    baked."""
    return [(n, mode) for n in names for mode in ("dynamic", "baked")]


def build_builtins(names, directory):
    """The emitted structs of the registered metrics ``names``, dynamic
    and baked with the defaults, and their hand structs, built:
    ``(lib, {(name, mode): Header})``."""
    headers = {}
    for n in names:
        m = metrics.get_metric(n)
        headers[(n, "dynamic")] = emit.emit_metric(m)
        headers[(n, "baked")] = emit.emit_metric(m, m.params())
    hand = [raymarch.INSTANCES[n][0] for n in names]
    return build(list(headers.values()), directory, hand=hand), headers


def same_bits(a, b) -> int:
    """The number of rays on which two RayStates differ in any bit."""
    diff = np.zeros(a.status.shape[0], bool)
    for x, y in zip(a, b):
        x, y = x.numpy(), y.numpy()
        diff |= (x.view(np.int32) != y.view(np.int32)).reshape(
            x.shape[0], -1).any(1)
    return int(diff.sum())


def check_builtin(lib, headers, name, mode):
    """The emitted struct of the registered metric ``name`` in ``mode``
    marched on the host (4096 trial iterations): against the plain march
    of its twin parameters (``emit.tensor_params`` for the dynamic struct,
    the float parameters for the baked one) by the host test's rule, and
    against the hand struct's host march bit for bit (the two run the
    same operations: where they part, the emitter is at fault)."""
    m = metrics.get_metric(name)
    h = headers[(name, mode)]
    params = m.params()
    twin = emit.tensor_params(params, "cpu") if mode == "dynamic" else params
    st, feats = launch_state(m, params)
    opts = integrate.TraceOptions(max_steps=4096)
    got = host_march(lib[h.struct], h, st, params, feats, opts)
    inst = raymarch.hand_instance(name)
    hand = host_march(lib[inst.struct], inst, st, params, feats, opts)
    assert same_bits(got, hand) == 0, (name, mode)
    ref = integrate.trace_rays_reference(m, st, twin, feats, opts)
    assert_as_host_test(name, m, got, ref, st, params, feats, opts)
