"""Emitted metric structs (``ops/emit.py``) built by g++ as host code and
marched: every struct the kernel is built with is emitted, so this is the
only check of the kernel's metric arithmetic without a GPU.

Each header is compiled with ``csrc/march.cuh`` through the march loop of
``tests/test_torch_raymarch_host.py``'s shim, in a translation unit of its
own (the units build in parallel), into one library whose entry point
``grt_emit_march_<struct>`` marches an (N,)-ray state in place: with the
default step options, 4-D or planar, or with any of them.  ``includes``
and ``dispatch`` give the other host shims (render data, the observer, the
duals, the recorded slots) the same headers.
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
from chip_smoke import ray_set
from geodesic_raytracing_tpu_torch import metrics
from geodesic_raytracing_tpu_torch.ops import emit, integrate

# OPTIONS: 0 the default step options alone, 1 and planar mode, 2 every
# option (march_options).
ENTRY = r"""
extern "C" int grt_emit_march_STRUCT(const float* mparams, const float* feats,
                                     int planar, int euler, int reparam,
                                     int n, int max_steps, float* pos,
                                     float* vel, float* acc, float* next_ds,
                                     float* rdl, int* status, int* steps,
                                     const float* f_in_x) {
  const Arrays a{pos, vel, acc, next_ds, rdl, status, steps, f_in_x};
  const grt::Features f = grt::features_from(feats);
#if OPTIONS == 2
  march_options<grt::STRUCT>(mparams, f, planar, euler, reparam, n,
                             max_steps, a);
  return 0;
#else
  if (euler || reparam || (planar && OPTIONS == 0)) return 1;
  const auto m = grt::STRUCT::from_params(mparams);
  if (planar) {
    march_all<grt::StepOptions<true, false, false>>(m, f, n, max_steps, a);
    return 0;
  }
  march_all<grt::DefaultOptions>(m, f, n, max_steps, a);
  return 0;
#endif
}
"""

FLAGS = ["-O2", "-std=c++17", "-ffp-contract=off", "-Wall", "-Werror",
         "-Wno-unused-function", "-fPIC"]


def gxx() -> str:
    """g++, or skip the test: the host build of the kernel's headers needs
    it."""
    found = shutil.which("g++")
    if found is None:
        pytest.skip("g++ is not installed: the host build of the kernel's "
                    "headers needs it")
    return found


def includes(headers, directory) -> str:
    """Write each emitted ``Header`` of ``headers`` to ``directory`` and
    return the ``#include`` lines of them, for a shim."""
    lines = []
    for h in headers:
        path = directory / f"{h.struct}.cuh"
        path.write_text(h.text)
        lines.append(f'#include "{path}"')
    return "\n".join(lines) + "\n"


def dispatch(headers) -> str:
    """A shim's ``TRY(<struct>)`` line of each emitted ``Header``."""
    return "\n".join(f"  TRY({h.struct})" for h in headers) + "\n"


def build(headers, directory, planar=(), every_option=(), flags=(),
          jobs=2) -> dict:
    """Compile each emitted ``Header`` of ``headers`` (with a planar entry
    where its struct is in ``planar``, with every step option where it is in
    ``every_option``; ``flags`` added to g++'s), and link them into one
    library in ``directory``.  Returns ``{struct: entry point}``; skips the
    test where g++ is not installed."""
    compiler = gxx()
    units = []
    for h in headers:
        options = 2 if h.struct in every_option else int(h.struct in planar)
        cpp = directory / f"{h.struct}.cpp"
        cpp.write_text(includes([h], directory) + host.SHIM + ENTRY.replace(
            "STRUCT", h.struct).replace("OPTIONS", str(options)))
        units.append(cpp)

    def compile_unit(cpp):
        obj = cpp.with_suffix(".o")
        proc = subprocess.run([compiler, *FLAGS, *flags, "-c", "-I",
                               str(host.CSRC), str(cpp), "-o", str(obj)],
                              capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-4000:]
        return obj

    workers = max(1, min(jobs, len(units), os.cpu_count() or 1))
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        objs = list(pool.map(compile_unit, units))
    lib = directory / "libemit_host.so"
    subprocess.run([compiler, "-shared", *map(str, objs), "-o", str(lib)],
                   check=True, capture_output=True, timeout=300)
    dll = ctypes.CDLL(str(lib))
    out = {}
    for h in headers:
        fn = getattr(dll, f"grt_emit_march_{h.struct}")
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p] * 8
        out[h.struct] = fn
    return out


def host_march(fn, header, state, params, features, opts, f_in_x=None):
    """The host march of an emitted struct (``fn`` its entry point) with
    ``params`` in the order of ``header.params``, from ``state``, with the
    step options of ``opts`` and the launch-time |v^t| ``f_in_x`` (default:
    taken from ``state``), as a kernel launch."""
    arrs = [t.numpy().copy() for t in state]
    fx = np.abs(arrs[1][:, 0]).copy() if f_in_x is None else f_in_x
    feats = np.array([*features, *integrate.schedule_constants(features)],
                     np.float32)
    mp = np.array([params[k] for k in header.params] + [0.0], np.float32)
    rc = fn(mp.ctypes.data, feats.ctypes.data, int(opts.planar),
            int(opts.integrator == "euler"), int(opts.reparameterisation),
            len(fx), opts.max_steps, *[a.ctypes.data for a in arrs],
            fx.ctypes.data)
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
    """The Kerr family's rule, as ``kerr_boyer``'s: fates equal on all
    rays, step counts on at least 62, escaped positions within 1e-4 where
    the counts agree (libm's sin/cos and torch's may differ in the last
    ulp, and torch's CPU sqrt is not correctly rounded: it differs from
    IEEE sqrt on about 0.7% of float32 inputs), except on a ray that takes
    more than 1.5 times the median step count of the escaped rays: it
    lingered near the photon sphere, where the last ulp grows by about a bit
    a step (kerr_newman_boyer's boundary ray, 884 steps against a median of
    480, ends 7.2e-3 apart; kerr_newman_schild's ray of 1,726 steps against
    a median of 840, 0.025).  The Kerr-Schild instances (the rank-1
    acceleration) are held so too: their chain takes two square roots.  On
    the card every instance equals the plain march bit for bit
    (chip_smoke.py phase 14)."""
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
# holds kerr_boyer and schwarzschild.
KERR_FAMILY = host.KERR_FAMILY
TANH_WALL = host.TANH_WALL


def assert_as_host_test(name, m, got, ref, st, params, feats, opts):
    """``got`` against the plain march ``ref`` by the rule of metric
    ``name`` (``params``: the float parameters, of the float64 march of the
    tanh walls)."""
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


# The cases of a registered metric's structs: "dynamic", its dynamic struct
# against the plain march of its twin parameters (0-d float32 tensors,
# ``emit.tensor_params``); "baked", its baked struct against the plain march
# of the float parameters; "launched", the dynamic struct with the float
# parameters, as ``trace_rays_cuda`` launches it, against the plain march of
# the same; "planar", the same in planar mode, where the metric is
# spherically symmetric.
MODES = ("dynamic", "baked", "launched")


def builtin_cases(names):
    """``[(name, mode)]`` of the registered metrics ``names``."""
    cases = [(n, mode) for n in names for mode in MODES]
    return cases + [(n, "planar") for n in names
                    if metrics.get_metric(n).spherically_symmetric]


def build_builtins(names, directory):
    """The emitted structs of the registered metrics ``names``, dynamic
    (with a planar entry where the metric is spherically symmetric) and
    baked with the defaults, built: ``(lib, {(name, "dynamic" or "baked"):
    Header}, {}: the plain marches, kept for the cases that share one)``."""
    headers, planar = {}, []
    for n in names:
        m = metrics.get_metric(n)
        headers[(n, "dynamic")] = emit.emit_metric(m)
        headers[(n, "baked")] = emit.emit_metric(m, m.params())
        if m.spherically_symmetric:
            planar.append(headers[(n, "dynamic")].struct)
    lib = build(list(headers.values()), directory, planar=planar)
    return lib, headers, {}


def check_builtin(lib, headers, plain, name, mode):
    """A ``builtin_cases`` case of the registered metric ``name``: its
    struct marched on the host (4096 trial iterations) against the plain
    march by the rule of ``assert_as_host_test``.  ``plain`` keeps each
    plain march for the other cases of this metric that take it."""
    m = metrics.get_metric(name)
    h = headers[(name, "baked" if mode == "baked" else "dynamic")]
    params = m.params()
    st, feats = launch_state(m, params)
    opts = integrate.TraceOptions(max_steps=4096, planar=mode == "planar")
    got = host_march(lib[h.struct], h, st, params, feats, opts)
    key = (name, mode == "dynamic", opts.planar)
    if key not in plain:
        twin = emit.tensor_params(params, "cpu") if mode == "dynamic" \
            else params
        plain[key] = integrate.trace_rays_reference(m, st, twin, feats, opts)
    assert_as_host_test(name, m, got, plain[key], st, params, feats, opts)
    if name == "godel_cylindrical":
        # The rays launched next to the axis and aimed at it die at the
        # cylindrical terminator.
        axis = ray_set(name, 64)[0][:, 1] < 0.1
        dead = got.status.numpy() == integrate.DEAD
        assert (dead[axis][1:]).all()
        assert (got.position.numpy()[axis][1:, 1] < 0.005).all()
