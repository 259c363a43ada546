"""Metric structs emitted from torch metric functions (``ops/emit.py``).

Each emitted header is compiled by g++ with ``csrc/march.cuh`` as host code,
through the shim of ``tests/test_torch_raymarch_host.py``, and marched
against the plain torch march on the host test's 64 rays (every 7th born
DEAD, 4096 trial iterations), 4-D and, for a spherically symmetric metric,
planar: the only check of an emitted struct's arithmetic without a GPU.

Twins.  The dynamic header (parameters at launch) is held to the plain march
with the parameters as 0-d float32 tensors (``emit.tensor_params``), the
baked header (parameters traced as Python floats) to the plain march with
float parameters.  Tolerances are the host test's: fates and step counts
equal on every ray and positions within 1e-4 (``_assert_same_march``; also
for the op zoo, a Schwarzschild metric perturbed through every op the
emitter writes), and for ``kerr_boyer`` its rule (fates equal, step counts
on 62 of 64, escaped positions within 1e-4 where the counts agree: glibc's
sin and cos and torch's CPU ones may differ in the last ulp).  The
plain march is held to JAX by the other ``test_torch_*`` files, and the pack
metric's by ``test_torch_content.py``.
"""

import ctypes
import dataclasses
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_raymarch_host as host
from geodesic_raytracing_tpu_torch import content, metrics
from geodesic_raytracing_tpu_torch.metrics.base import diag_metric
from geodesic_raytracing_tpu_torch.ops import emit, integrate
from geodesic_raytracing_tpu_torch.ops.geometry import (arctan, arctan2,
                                                        pow_pos, recip)

torch.set_num_threads(1)

PACK = Path(__file__).resolve().parents[1] / "examples" / "pack_torch"

# The shim's march_all and march_options, and an entry point over the
# emitted structs: the default options, 4-D or planar.
_SHIM_HEAD = host.SHIM.split("// Every instance:")[0]


def rn_metric():
    return content.load_pack(PACK, register=False).metrics[
        "reissner_nordstrom"]


def zoo_fn(x, params):
    """Schwarzschild perturbed by 1% through every op the emitter writes
    (but a division by a Python number, which the card and the CPU
    evaluate differently): each entry's tangent goes through their rules."""
    rs, a = params["rs"], params["a"]
    r, th = x[1], x[2]
    s, c = torch.sin(th), torch.cos(th)
    f = 1.0 - rs * recip(r)
    h1 = torch.tanh(r - 3.0) * torch.exp(-r) + torch.log1p(r) * 0.1
    h2 = torch.clamp(c, max=0.9) + torch.clamp(s, -0.5, 0.5) + torch.abs(c)
    h3 = r ** -1.5 + torch.sqrt(r) * 0.1 + pow_pos(r - 2.0, 0.7) * 0.01
    h4 = torch.where(r > 5.0, arctan(r), arctan2(s, c + 2.0)) \
        + torch.log(r) * a + torch.cos(th * 0.5) + s / r
    eps = 0.01
    return diag_metric(-f * (1.0 + eps * h1), recip(f) * (1.0 + eps * h2),
                       r * r * (1.0 + eps * h3),
                       r * r * s * s * (1.0 + eps * h4))


def zoo_metric():
    base = metrics.get_metric("schwarzschild")
    return dataclasses.replace(
        base, name="op_zoo", fn=zoo_fn, defaults={"rs": 1.0, "a": 0.5},
        spherically_symmetric=False,
        config=dataclasses.replace(base.config, name="op_zoo"))


def _cases():
    out = {}
    for name in ("schwarzschild", "kerr_boyer", "de_sitter"):
        out[name] = metrics.get_metric(name)
    out["reissner_nordstrom"] = rn_metric()
    out["op_zoo"] = zoo_metric()
    return out


@pytest.fixture(scope="module")
def emitted():
    """``{(metric name, mode): (metric, Header)}`` of every case, dynamic
    and baked with the defaults."""
    out = {}
    for name, m in _cases().items():
        out[(name, "dynamic")] = (m, emit.emit_metric(m))
        out[(name, "baked")] = (m, emit.emit_metric(m, m.params()))
    return out


@pytest.fixture(scope="module")
def emit_lib(emitted, tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed: the host build of march.cuh "
                    "needs it")
    d = tmp_path_factory.mktemp("emit_host")
    includes, tries = [], []
    for (name, mode), (_, h) in emitted.items():
        p = d / f"{h.struct}.cuh"
        p.write_text(h.text)
        includes.append(f'#include "{p}"')
        tries.append(f'  TRY(grt::{h.struct}, "{h.struct}")')
    shim = "\n".join(includes) + "\n" + _SHIM_HEAD + r"""
extern "C" int grt_emit_march(const char* metric, const float* mparams,
                              const float* feats, int planar, int n,
                              int max_steps, float* pos, float* vel,
                              float* acc, float* next_ds, float* rdl,
                              int* status, int* steps, const float* f_in_x) {
  const Arrays a{pos, vel, acc, next_ds, rdl, status, steps, f_in_x};
  const grt::Features f = grt::features_from(feats);
#define TRY(M, NAME)                                                       \
  if (strcmp(metric, NAME) == 0) {                                         \
    const M m = M::from_params(mparams);                                   \
    if (planar)                                                            \
      march_all<grt::StepOptions<true, false, false>>(m, f, n, max_steps,  \
                                                      a);                  \
    else                                                                   \
      march_all<grt::DefaultOptions>(m, f, n, max_steps, a);               \
    return 0;                                                              \
  }
""" + "\n".join(tries) + """
#undef TRY
  return 1;
}
"""
    (d / "shim.cpp").write_text(shim)
    lib = d / "libemit_host.so"
    proc = subprocess.run(
        [gxx, "-O2", "-std=c++17", "-ffp-contract=off", "-Wall", "-Werror",
         "-Wno-unused-function", "-shared", "-fPIC", "-I", str(host.CSRC),
         str(d / "shim.cpp"), "-o", str(lib)], capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    fn = ctypes.CDLL(str(lib)).grt_emit_march
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 8)
    return fn


def host_march(fn, header, state, params, features, opts):
    arrs = [t.numpy().copy() for t in state]
    fx = np.abs(arrs[1][:, 0]).copy()
    feats = np.array([*features, *integrate.schedule_constants(features)],
                     np.float32)
    mp = np.array([params[k] for k in header.params] + [0.0], np.float32)
    rc = fn(header.struct.encode(), mp.ctypes.data, feats.ctypes.data,
            int(opts.planar), len(fx), opts.max_steps,
            *[a.ctypes.data for a in arrs], fx.ctypes.data)
    assert rc == 0, header.struct
    return integrate.RayState(*(torch.from_numpy(a) for a in arrs))


def _launch_state(m, params):
    feats = integrate.Features.for_metric(m)
    pos, vel = host.generic_rays(
        metrics.get_metric("schwarzschild")
        if m.name in ("reissner_nordstrom", "op_zoo") else m, params)
    st = integrate.init_ray_state(m, pos, vel, params, feats)
    st.status[::7] = integrate.DEAD
    return st, feats


def _assert_kerr_rule(h, ref):
    np.testing.assert_array_equal(h.status.numpy(), ref.status.numpy())
    steps_eq = h.steps.numpy() == ref.steps.numpy()
    assert steps_eq.sum() >= 62, steps_eq.sum()
    ok = (ref.status.numpy() == integrate.ESCAPED) & steps_eq
    assert ok.sum() >= 16
    np.testing.assert_allclose(h.position.numpy()[ok],
                               ref.position.numpy()[ok], rtol=1e-4,
                               atol=1e-4)


# Held by kerr_boyer's rule (see the module docstring).
KERR_RULE = ("kerr_boyer",)
# Not spherically symmetric: 4-D only.
FOUR_D = ("kerr_boyer", "op_zoo")
CASES = [(n, mode, planar)
         for n in ("schwarzschild", "kerr_boyer", "de_sitter",
                   "reissner_nordstrom", "op_zoo")
         for mode in ("dynamic", "baked")
         for planar in ((False,) if n in FOUR_D else (False, True))]


@pytest.mark.parametrize("name,mode,planar", CASES)
def test_emitted_march_matches_plain(emitted, emit_lib, name, mode, planar):
    """An emitted header's host march against the plain march of its twin
    parameters (see the module docstring)."""
    m, h = emitted[(name, mode)]
    params = m.params()
    twin = emit.tensor_params(params, "cpu") if mode == "dynamic" else params
    st, feats = _launch_state(m, params)
    opts = integrate.TraceOptions(max_steps=4096, planar=planar)
    got = host_march(emit_lib, h, st, params, feats, opts)
    ref = integrate.trace_rays_reference(m, st, twin, feats, opts)
    if name in KERR_RULE:
        _assert_kerr_rule(got, ref)
    else:
        host._assert_same_march(got, ref, 16)
    for a, b in zip(got, st):  # rays born DEAD are untouched
        np.testing.assert_array_equal(a.numpy()[::7], b.numpy()[::7])


def test_baked_and_dynamic_headers_agree(emitted, emit_lib):
    """The baked and the dynamic header of the pack metric march the same
    rays to the same fates (their parameter arithmetic differs: ``rs / r``
    is a division by a tensor in one and a product with ``1 / r`` in the
    other), held as kerr_boyer's host march is held."""
    m, hd = emitted[("reissner_nordstrom", "dynamic")]
    _, hb = emitted[("reissner_nordstrom", "baked")]
    params = m.params()
    st, feats = _launch_state(m, params)
    opts = integrate.TraceOptions(max_steps=4096)
    _assert_kerr_rule(host_march(emit_lib, hb, st, params, feats, opts),
                      host_march(emit_lib, hd, st, params, feats, opts))


def test_emitted_entries_follow_the_entry_dict(emitted):
    """Absent entries are structural zeros, the declared structure's other
    entries constant zeros, parameter-only products members evaluated in
    ``from_params`` (dynamic) or hex-float literals (baked)."""
    _, kd = emitted[("kerr_boyer", "dynamic")]
    ret = kd.text.split("return sym(")[1]
    for e in ("entry<0, 0>", "entry<1, 1>", "entry<2, 2>", "entry<3, 3>",
              "entry<0, 3>"):
        assert e in ret
    assert "entry<0, 1>" not in ret and "entry<1, 2>" not in ret
    assert "= p1 * p1;" in kd.text  # a * a, once per node, in from_params
    assert "grt_sincos(c2" in kd.text  # sin and cos of theta share one call
    _, kb = emitted[("kerr_boyer", "baked")]
    assert "p1" not in kb.text and "0x1.0000000000000p-2f" in kb.text
    _, rd = emitted[("reissner_nordstrom", "dynamic")]
    assert "grt_div(p0, c1)" in rd.text  # rs / r with rs a tensor
    _, rb = emitted[("reissner_nordstrom", "baked")]
    assert "grt_div" not in rb.text and "grt_recip(c1)" in rb.text
    dense = dataclasses.replace(metrics.get_metric("schwarzschild"),
                                diagonal=False)
    ret = emit.emit_metric(dense).text.split("return sym(")[1]
    assert "entry<0, 1>(0x0.0p+0f)" in ret and ret.count("entry<") == 10


def _with_fn(fn, **kw):
    return dataclasses.replace(metrics.get_metric("schwarzschild"), fn=fn,
                               **kw)


@pytest.mark.parametrize("body,needle", [
    (lambda r, th: torch.atan(r), "aten.atan"),
    (lambda r, th: torch.sinh(r), "aten.sinh"),
    (lambda r, th: r ** r, "pow"),
    (lambda r, th: r if float(r.sum()) > 0 else -r, "cannot be traced"),
])
def test_unsupported_op_raises(body, needle):
    def fn(x, params):
        r, th = x[1], x[2]
        return diag_metric(-1.0, 1.0, body(r, th), r * r)

    with pytest.raises(NotImplementedError, match=needle):
        emit.emit_metric(_with_fn(fn))


def test_rank1_and_complex_pairs_raise():
    with pytest.raises(NotImplementedError, match="rank-1"):
        emit.emit_metric(metrics.get_metric("kerr_schild"))
    with pytest.raises(NotImplementedError, match="complex pairs"):
        emit.emit_metric(metrics.get_metric("double_kerr"))
    stack = _with_fn(lambda x, p: torch.stack([x[1]]))
    with pytest.raises(NotImplementedError, match="sym_metric"):
        emit.emit_metric(stack)


def test_arctan_is_one_node_with_its_custom_tangent():
    """``geometry.arctan2`` is emitted as ``grt_arctan2`` (its custom
    derivative), not as the ops of its polynomial."""
    from geodesic_raytracing_tpu_torch.ops.geometry import arctan2

    def fn(x, params):
        r, th = x[1], x[2]
        return diag_metric(-1.0, 1.0, r * r + arctan2(th, r), r * r)

    text = emit.emit_metric(_with_fn(fn)).text
    assert "grt_arctan2(c2, c1)" in text and "grt_where" not in text


def test_struct_name_follows_the_function():
    m = metrics.get_metric("schwarzschild")
    a, b = emit.emit_metric(m), emit.emit_metric(m)
    assert a == b
    other = _with_fn(lambda x, p: diag_metric(-1.0, 1.0, x[1] * x[1],
                                              x[1] * x[1]))
    assert emit.emit_metric(other).struct != a.struct
    assert emit.emit_metric(m, m.params(rs=1.5)).struct != \
        emit.emit_metric(m, m.params()).struct
