"""The emitter's op set and its refusals (``ops/emit.py``, ``csrc/dual.cuh``,
``csrc/complex.cuh``).

* The dual functions of the aten ops a torch function may call beside the
  first ones (``torch.atan``, ``asin``, ``acos``, ``sinh``, ``cosh``, ``pow``
  of two tensors, ``clamp`` with tensor bounds, ``add`` / ``sub`` with
  ``alpha``) and of ``ops/complexify``'s ``cabs`` and ``csqrt``, built by g++
  as host code, against ``torch.func.jvp`` of the torch op on 1024 seeded
  float32 inputs, each side's tangent live alone and both: bit for bit
  where the rule's operations are torch's own, else within the ulps that
  the host's libm and torch's CPU kernels part by (``OPS``).
* A custom ``torch.autograd.Function`` whose ``jvp`` is not its forward's
  derivative: ``emit_metric`` refuses it, naming the metric and the entry;
  without that check the struct is emitted silently and its host march
  leaves the plain march, which follows the JAX pack of the same rule
  (``jax.custom_jvp``) as ``tests/test_torch_content.py`` holds packs.
* The port's own recorded rules pass the check; a rank-1 decomposition that
  does not depend on x, y and z alone, or whose l_0 is not 1, is refused.
"""

import ctypes
import dataclasses
import shutil
import subprocess
import textwrap
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_raymarch_host as host
import torch_emit_host as eh
from geodesic_raytracing_tpu import content as jcontent
from geodesic_raytracing_tpu.ops import integrate as jint
from geodesic_raytracing_tpu_torch import content, metrics
from geodesic_raytracing_tpu_torch.metrics.base import diag_metric
from geodesic_raytracing_tpu_torch.ops import complexify as cx
from geodesic_raytracing_tpu_torch.ops import emit, integrate
from geodesic_raytracing_tpu_torch.ops.geometry import arctan, arctan2
from test_integrator import make_rays

torch.set_num_threads(1)

N = 1024

OPS_SHIM = r"""
#include "complex.cuh"

namespace {

// out[4 i ...]: value and tangent of the first output, then of the second.
template <class F>
void run(int n, int which, const float* x, const float* y, const float* z,
         const float* tx, const float* ty, const float* tz, float* out,
         F f) {
  for (int i = 0; i < n; ++i) {
    grt::Dual<1u> dx, dy, dz;
    dx.v = x[i]; dx.d[0] = tx[i];
    dy.v = y[i]; dy.d[0] = ty[i];
    dz.v = z[i]; dz.d[0] = tz[i];
    const auto cx = grt::dual_constant(x[i]);
    const auto cy = grt::dual_constant(y[i]);
    const auto cz = grt::dual_constant(z[i]);
    float r[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (which == 0) f(dx, dy, dz, r);
    else if (which == 1) f(dx, cy, cz, r);
    else f(cx, dy, dz, r);
    for (int k = 0; k < 4; ++k) out[4 * i + k] = r[k];
  }
}

template <class D>
void put(const D& d, float* r) {
  r[0] = d.v;
  r[1] = d.d[0];
}

}  // namespace

extern "C" int grt_op(int op, int n, int which, const float* x,
                      const float* y, const float* z, const float* tx,
                      const float* ty, const float* tz, float* out) {
#define OP(K, EXPR)                                                     \
  if (op == K) {                                                        \
    run(n, which, x, y, z, tx, ty, tz, out,                             \
        [](const auto& a, [[maybe_unused]] const auto& b,               \
           [[maybe_unused]] const auto& c, float* r) { EXPR; });        \
    return 0;                                                           \
  }
  OP(0, put(grt::grt_atan(a), r))
  OP(1, put(grt::grt_asin(a), r))
  OP(2, put(grt::grt_acos(a), r))
  OP(3, put(grt::grt_sinh(a), r))
  OP(4, put(grt::grt_cosh(a), r))
  OP(5, put(grt::grt_pow_tensor(a, b), r))
  OP(6, put(grt::grt_clamp_tensor(a, b, c), r))
  OP(7, put(grt::grt_clamp_tensor_min(a, b), r))
  OP(8, put(grt::grt_clamp_tensor_max(a, b), r))
  OP(9, put(grt::grt_clamp_min_tensor(a, b), r))
  OP(10, put(grt::grt_clamp_max_tensor(a, b), r))
  OP(11, put(grt::grt_add_alpha(a, b, 2.5f), r))
  OP(12, put(grt::grt_sub_alpha(a, b, 2.5f), r))
  OP(13, put(grt::cabs_dual(a, b), r))
  OP(14, const auto w = grt::csqrt_dual(a, b); put(w.re, r);
      put(w.im, r + 2))
#undef OP
  return 1;
}
"""

# name: (op index, arity, torch function, the most ulps by which the value
# and the tangent may part).  0: bit for bit (the rule and its operations
# are torch's).  Otherwise the operations the rule applies are those of
# the host's libm, not of torch's CPU kernels: sinh and cosh (2 ulps),
# torch's CPU pow (SLEEF's, within an ulp, which e * pow(x, e - 1) carries
# into the tangent: 8), its sqrt, which is not correctly rounded (cabs 2;
# csqrt's half-angle form cancels it in 0.5 (m + re): 32), and its rsqrt
# (asin, acos: 2).
OPS = {
    "atan": (0, 1, torch.atan, 1, 0),
    "asin": (1, 1, torch.asin, 1, 2),
    "acos": (2, 1, torch.acos, 1, 2),
    "sinh": (3, 1, torch.sinh, 1, 2),
    "cosh": (4, 1, torch.cosh, 1, 2),
    "pow": (5, 2, lambda a, b: a ** b, 1, 8),
    "clamp": (6, 3, lambda a, b, c: torch.clamp(a, b, c), 0, 0),
    "clamp(min=)": (7, 2, lambda a, b: torch.clamp(a, min=b), 0, 0),
    "clamp(max=)": (8, 2, lambda a, b: torch.clamp(a, max=b), 0, 0),
    "clamp_min": (9, 2, torch.clamp_min, 0, 0),
    "clamp_max": (10, 2, torch.clamp_max, 0, 0),
    "add alpha": (11, 2, lambda a, b: torch.add(a, b, alpha=2.5), 0, 0),
    "sub alpha": (12, 2, lambda a, b: torch.sub(a, b, alpha=2.5), 0, 0),
    "cabs": (13, 2, lambda a, b: cx.cabs((a, b)), 1, 2),
    "csqrt": (14, 2, lambda a, b: cx.csqrt((a, b)), 8, 32),
}


@pytest.fixture(scope="module")
def op_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of dual.cuh "
                    "needs it")
    d = tmp_path_factory.mktemp("emit_ops")
    (d / "ops.cpp").write_text(OPS_SHIM)
    lib = d / "libops.so"
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-Wall",
                    "-Werror", "-shared", "-fPIC", "-I", str(host.CSRC),
                    str(d / "ops.cpp"), "-o", str(lib)], check=True,
                   capture_output=True, timeout=300)
    fn = ctypes.CDLL(str(lib)).grt_op
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 7
    return fn


def _inputs(name):
    """Seeded inputs of the op's domain: bounds that meet x exactly on some
    inputs and cross each other on others (clamp), pairs next to the real
    axis (csqrt)."""
    rng = np.random.default_rng(12)
    x = rng.uniform(-1.5, 1.5, N)
    y = rng.uniform(-1.0, 1.0, N)
    z = y + rng.uniform(-0.2, 1.0, N)
    if name in ("asin", "acos"):
        x = rng.uniform(-0.99, 0.99, N)
    if name == "pow":
        x = rng.uniform(0.05, 3.0, N)
        x[:8] = 0.0
        y[:4] = 0.0
    if name.startswith("clamp"):
        x[:64] = y[:64]
        x[64:128] = z[64:128]
    if name == "csqrt":
        y[::5] = 0.0  # the real axis, where csqrt's own rule would be NaN
    t = [rng.standard_normal(N) for _ in range(3)]
    return [torch.from_numpy(a.astype(np.float32)) for a in (x, y, z, *t)]


def _ulps(a, b):
    ia = a.view(torch.int32).long()
    ib = b.view(torch.int32).long()
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


CASES = [(name, which) for name, (_, arity, *_) in OPS.items()
         for which in ((1,) if arity == 1 else (0, 1, 2))]


@pytest.mark.parametrize("name,which", CASES)
def test_dual_tangent_is_torch_jvp(op_lib, name, which):
    """``which``: 0 every operand carries the tangent, 1 the first alone,
    2 the others alone."""
    k, arity, fn, v_ulps, t_ulps = OPS[name]
    x, y, z, tx, ty, tz = _inputs(name)
    prim, tang = (x, y, z)[:arity], (tx, ty, tz)[:arity]
    live = [True] * arity if which == 0 else (
        [i == 0 for i in range(arity)] if which == 1
        else [i > 0 for i in range(arity)])

    def f(*vs):
        it = iter(vs)
        return fn(*(next(it) if on else p for p, on in zip(prim, live)))

    val, jt = torch.func.jvp(
        f, tuple(p for p, on in zip(prim, live) if on),
        tuple(t for t, on in zip(tang, live) if on))
    vals = val if isinstance(val, tuple) else (val,)
    jts = jt if isinstance(jt, tuple) else (jt,)
    out = np.zeros((N, 4), np.float32)
    arrs = [a.numpy() for a in (x, y, z, tx, ty, tz)]
    assert op_lib(k, N, which, *[a.ctypes.data for a in arrs],
                  out.ctypes.data) == 0
    got = torch.from_numpy(out)
    for j, (v, t) in enumerate(zip(vals, jts)):
        for a, b, tol in ((got[:, 2 * j], v, v_ulps),
                          (got[:, 2 * j + 1], t, t_ulps)):
            b = b.float()
            nan = torch.isnan(a) & torch.isnan(b)
            d = torch.where(nan, 0, _ulps(a, b))
            assert int(d.max()) <= tol, (name, j, int(d.max()))


# -- custom autograd rules ----------------------------------------------------

SOFT_TORCH = """
import torch
from geodesic_raytracing_tpu_torch.metrics.base import diag_metric

DEFAULTS = {"rs": 1.0}
DIAGONAL = True
SPHERICALLY_SYMMETRIC = True
DEPENDS_ON = (1, 2)


class SoftSqrt(torch.autograd.Function):
    # sqrt with a softened tangent: dx / (2 max(y, 0.9)).

    @staticmethod
    def forward(x):
        return torch.sqrt(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(output)

    @staticmethod
    def jvp(ctx, dx):
        y, = ctx.saved_tensors
        return dx / (2.0 * torch.clamp(y, min=0.9))


def metric(x, params):
    r, theta = x[1], x[2]
    st = torch.sin(theta)
    u = SoftSqrt.apply(1.0 - params["rs"] / r)
    return diag_metric(-(u * u), 1.0 / (u * u), r * r, r * r * st * st)
"""

SOFT_JAX = """
import jax
import jax.numpy as jnp
from geodesic_raytracing_tpu.metrics.base import diag_metric

DEFAULTS = {"rs": 1.0}
DIAGONAL = True
SPHERICALLY_SYMMETRIC = True
DEPENDS_ON = (1, 2)


@jax.custom_jvp
def soft_sqrt(x):
    return jnp.sqrt(x)


@soft_sqrt.defjvp
def _soft_sqrt_jvp(primals, tangents):
    x, = primals
    dx, = tangents
    y = jnp.sqrt(x)
    return y, dx / (2.0 * jnp.maximum(y, 0.9))


def metric(x, params):
    r, theta = x[1], x[2]
    st = jnp.sin(theta)
    u = soft_sqrt(1.0 - params["rs"] / r)
    return diag_metric(-(u * u), 1.0 / (u * u), r * r, r * r * st * st)
"""


def _soft_packs(tmp_path):
    for sub, text in (("torch", SOFT_TORCH), ("jax", SOFT_JAX)):
        d = tmp_path / sub
        d.mkdir()
        (d / "soft_hole.py").write_text(textwrap.dedent(text))
        (d / "soft_hole.json").write_text(
            '{"name": "soft_hole", "inherit_settings": "polar_base"}')
    tm = content.load_pack(tmp_path / "torch", register=False).metrics[
        "soft_hole"]
    jm = jcontent.load_pack(tmp_path / "jax", register=False).metrics[
        "soft_hole"]
    return tm, jm


def test_custom_function_is_refused(tmp_path):
    tm, _ = _soft_packs(tmp_path)
    for params in (None, tm.params()):
        with pytest.raises(NotImplementedError,
                           match=r"soft_hole: the tangent of its entry "
                                 r"g\(0, 0\) by x1 .*autograd\.Function"):
            emit.emit_metric(tm, params)


def test_custom_function_emitted_unchecked_leaves_the_plain_march(
        tmp_path, monkeypatch):
    """What the emitter did before the check: it traced through the
    Function's forward and emitted the struct silently; that struct's host
    march leaves the plain march, and the plain march follows the JAX pack
    with the same custom rule."""
    tm, jm = _soft_packs(tmp_path)
    monkeypatch.setattr(emit, "check_tangents", lambda *a: None)
    h = emit.emit_metric(tm, tm.params())
    lib = eh.build([h], tmp_path)
    params = tm.params()
    pos, vel = (np.array(a) for a in make_rays(64))
    feats = integrate.Features.for_metric(tm)
    st = integrate.init_ray_state(tm, torch.from_numpy(pos),
                                  torch.from_numpy(vel), params, feats)
    opts = integrate.TraceOptions(max_steps=4096)
    ref = integrate.trace_rays_reference(tm, st, params, feats, opts)
    got = eh.host_march(lib[h.struct], h, st, params, feats, opts)
    off = ((got.steps != ref.steps) | (got.status != ref.status)
           | ((got.position - ref.position).abs().amax(1) > 1e-2))
    assert int(off.sum()) >= 16, int(off.sum())
    # The plain march against JAX's, as tests/test_torch_content.py holds a
    # pack's.
    jf = jint.Features.for_metric(jm)
    jst = jint.init_ray_state(jm, jnp.asarray(pos), jnp.asarray(vel),
                              params=jm.params(), features=jf)
    jfin = jint.trace_rays(jm, jst, jm.params(), features=jf,
                           opts=jint.TraceOptions(max_steps=4096))
    np.testing.assert_array_equal(ref.status.numpy(),
                                  np.asarray(jfin.status))
    same = ref.steps.numpy() == np.asarray(jfin.steps)
    assert same.sum() >= 62, same.sum()
    np.testing.assert_allclose(ref.position.numpy()[same],
                               np.asarray(jfin.position)[same], rtol=1e-3,
                               atol=1e-3)


def _with_fn(fn, **kw):
    return dataclasses.replace(metrics.get_metric("schwarzschild"), fn=fn,
                               **kw)


def test_recorded_rules_pass_the_check():
    """geometry.arctan / arctan2 and complexify's cabs / csqrt of a pair of
    coordinates are recorded ops with their own rules: the check passes,
    and each is one node of the struct."""
    def fn(x, params):
        r, th = x[1], x[2]
        w = cx.csqrt((r * r - 4.0, th))
        h = arctan(r) + arctan2(th, r) + cx.cabs(w) + cx.real(w)
        return diag_metric(-1.0, 1.0, r * r * (1.0 + 0.01 * h), r * r)

    text = emit.emit_metric(_with_fn(fn)).text
    for needle in ("grt_arctan(c1)", "grt_arctan2(c2, c1)", "csqrt_dual(",
                   "cabs_dual("):
        assert needle in text, needle


@pytest.mark.parametrize("body,needle", [
    (lambda x: (x[0] * 0 + 1.0, torch.stack([x[0] * 0 + 1.0, x[1], x[2],
                                              x[3]])), r"\[0, 1, 2, 3\]"),
    (lambda x: (x[1] * 0 + 1.0, torch.stack([x[1] * 0 + 1.0] * 4)),
     r"\[1\], not on exactly x, y and z"),
    (lambda x: (x[1] + x[2] + x[3], torch.stack([x[1], x[1], x[2], x[3]])),
     "l_0 is not the constant 1"),
])
def test_rank1_decomposition_refusals(body, needle):
    ks = metrics.get_metric("kerr_schild")
    m = dataclasses.replace(ks, name="rank1_probe",
                            rank1=lambda x, p: body(x))
    with pytest.raises(NotImplementedError, match=needle):
        emit.emit_metric(m)


# -- parameter exponents: the dynamic program of hot-swap ---------------------

EXPONENT_PACK = """
import torch
from geodesic_raytracing_tpu_torch.metrics.base import diag_metric
from geodesic_raytracing_tpu_torch.ops.geometry import param64, param_pow

DEFAULTS = {"rs": 1.0, "mu": 4.0}
DIAGONAL = True
SPHERICALLY_SYMMETRIC = True
DEPENDS_ON = (1, 2)


def metric(x, params):
    r, theta = x[1], x[2]
    st = torch.sin(theta)
    A = param_pow(1.0 - params["rs"] / r, 1.0 / param64(params["mu"]))
    return diag_metric(-A, 1.0 / A, r * r, r * r * st * st)
"""


@pytest.fixture
def registries():
    saved = dict(metrics.REGISTRY)
    yield
    metrics.REGISTRY.clear()
    metrics.REGISTRY.update(saved)


def test_parameter_exponent_pack_serves_dynamic_while_baked_builds(
        tmp_path, monkeypatch, registries):
    """A pack whose exponent is a parameter (``geometry.param_pow``) has a
    dynamic struct (the exponent a ``PowRule`` member set in
    ``from_params``), so ``kernel_program`` serves its frames by the
    dynamic program while the baked library builds (here ``nvcc`` waits,
    then is missing) and after the build failed."""
    from geodesic_raytracing_tpu_torch.ops import raymarch
    from geodesic_raytracing_tpu_torch.runtime.hotswap import kernel_program

    (tmp_path / "exp_hole.py").write_text(textwrap.dedent(EXPONENT_PACK))
    (tmp_path / "exp_hole.json").write_text(
        '{"name": "exp_hole", "inherit_settings": "polar_base"}')
    m = content.load_pack(tmp_path).metrics["exp_hole"]
    release = threading.Event()

    def no_nvcc():
        release.wait(60.0)
        raise RuntimeError("nvcc not found (a stand-in)")

    monkeypatch.setattr(raymarch, "nvcc_path", no_nvcc)
    monkeypatch.setattr(raymarch, "BUILD_DIR", tmp_path / "build")
    served = []

    def run(metric, params, x):
        # On the card the dynamic program's launch emits and builds this.
        served.append(raymarch.instance_of(metric))
        return metric.fn(x, params)

    prog = kernel_program(m, run)
    params = m.params()
    x = torch.tensor([0.0, 6.0, 1.2, 0.4])
    prog.request_static(params)
    frames = [prog(params, x) for _ in range(3)]
    assert not prog.static_ready and prog.served == {"dynamic": 3,
                                                     "static": 0}
    inst = served[0]
    assert inst.baked is None and inst.label == "exp_hole"
    assert "PowRule n" in inst.header and "= pow_rule(" in inst.header
    release.set()
    prog.wait(60.0)
    assert "nvcc not found" in prog.static_error
    torch.testing.assert_close(prog(params, x), frames[0], rtol=0, atol=0)
    assert prog.served["dynamic"] == 4
