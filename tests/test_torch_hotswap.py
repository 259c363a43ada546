"""Hot-swap program pair and static parameter baking (port of
``geodesic_raytracing_tpu.runtime.hotswap``), held to the JAX package's
``tests/test_hotswap.py`` on the same events.

Tolerances: the baked metric against the dynamic one and against JAX's
baked metric at rtol 1e-6 (the reference's bar; the port's float32 metric
and JAX's agree to an ulp or two).  The baked metric's plain march equals
the plain march with float parameters bit for bit (the same function with
the same values).
"""

import dataclasses
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.runtime.hotswap import bake as jbake
from geodesic_raytracing_tpu_torch import metrics
from geodesic_raytracing_tpu_torch.metrics.base import BakedFn
from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
from geodesic_raytracing_tpu_torch.runtime.hotswap import (
    HotSwapProgram, bake, kernel_program)
from test_integrator import make_rays

torch.set_num_threads(1)


def test_bake_matches_dynamic():
    m = metrics.get_metric("kerr_boyer")
    x = np.array([0.1, 5.0, 1.1, 0.3], np.float32)
    params = m.params(a=-0.7)
    baked = bake(m, params)
    assert isinstance(baked.fn, BakedFn)
    got = baked.fn(torch.from_numpy(x), {}).numpy()
    np.testing.assert_allclose(m.fn(torch.from_numpy(x), params).numpy(), got,
                               rtol=1e-6)
    jm = jmetrics.get_metric("kerr_boyer")
    want = np.asarray(jbake(jm, jm.params(a=-0.7)).g(jnp.asarray(x), {}))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_hotswap_dispatch():
    """The twin of the JAX test: dynamic until the static build for the
    same parameters is ready, static then, dynamic again on new ones."""
    m = metrics.get_metric("schwarzschild")
    x = torch.tensor([0.0, 6.0, 1.2, 0.4])
    calls = {"dynamic": 0, "static": 0}

    def dynamic(params, xx):
        calls["dynamic"] += 1
        return m.fn(xx, params)

    def build_static(params):
        baked = bake(m, params)
        baked.fn(x, {})  # warm-up: ready before the swap

        def wrapped(xx):
            calls["static"] += 1
            return baked.fn(xx, {})

        return wrapped

    prog = HotSwapProgram(dynamic, build_static)
    params = m.params(rs=1.3)
    r1 = prog(params, x)
    assert calls["dynamic"] == 1
    prog.request_static(params)
    prog.wait(30.0)
    assert prog.static_ready and prog.static_error is None
    assert prog.build_seconds is not None
    r2 = prog(params, x)
    assert calls["static"] == 1
    np.testing.assert_allclose(r1.numpy(), r2.numpy(), rtol=1e-6)
    prog(m.params(rs=2.0), x)
    assert calls["dynamic"] == 2
    assert prog.served == {"dynamic": 2, "static": 1}
    # The JAX program's result on the same event.
    jm = jmetrics.get_metric("schwarzschild")
    np.testing.assert_allclose(
        r2.numpy(), np.asarray(jbake(jm, jm.params(rs=1.3)).g(
            jnp.asarray(x.numpy()), {})), rtol=1e-6, atol=1e-6)


def test_failed_static_build_keeps_the_dynamic_program():
    """A build that fails is reported (``static_error``, and a line on
    stderr) and the dynamic program keeps serving; a call never waits."""
    def build_static(params):
        raise RuntimeError("nvcc failed (1): a stand-in error")

    prog = HotSwapProgram(lambda p, v: ("dynamic", v), build_static)
    prog.request_static({"rs": 1.0})
    prog.wait(30.0)
    assert not prog.static_ready
    assert "stand-in error" in prog.static_error
    assert prog({"rs": 1.0}, 3) == ("dynamic", 3)
    assert prog.served == {"dynamic": 1, "static": 0}


def test_kernel_program_without_nvcc_serves_dynamic(monkeypatch, capsys,
                                                   tmp_path):
    """The kernel program of a pack's metric: the baked header is
    emitted on the requesting thread, the library's build fails
    on the worker (no nvcc), the failure is kept and the dynamic program
    serves."""
    import test_torch_emit

    rn = test_torch_emit.rn_metric()

    def no_nvcc():
        raise RuntimeError("nvcc not found (a stand-in)")

    monkeypatch.setattr(raymarch, "nvcc_path", no_nvcc)
    monkeypatch.setattr(raymarch, "BUILD_DIR", tmp_path)
    seen = []

    def run(metric, params, x):
        seen.append(metric.fn)
        return metric.fn(x, params)

    prog = kernel_program(rn, run)
    params = rn.params()
    prog.request_static(params)
    prog.wait(60.0)
    assert "nvcc not found" in prog.static_error
    assert "dynamic program keeps serving" in capsys.readouterr().err
    x = torch.tensor([0.0, 6.0, 1.2, 0.4])
    prog(params, x)
    assert seen == [rn.fn] and prog.served["dynamic"] == 1


# A stand-in for a kernel library: the C entry points that
# ``raymarch.get_lib`` reads when it loads one, built for ``kerr_boyer`` with
# the values of BAKED compiled in.
STAND_IN = r"""
static const float baked[] = {BAKED};
int grt_raymarch(void) { return 0; }
const char* grt_metric_name(int* n) { *n = 2; return "kerr_boyer"; }
int grt_raymarch_config(int* t, int* b) { *t = 128; *b = 1; return 0; }
const float* grt_baked_params(int* n) { *n = 2; return baked; }
const char* grt_error_string(int code) { return "stand-in"; }
"""


def test_baked_instance_refuses_other_parameters(monkeypatch, tmp_path):
    """A baked library has its values compiled in: a library whose values
    are not its instance's is refused when it is loaded, and a baked
    metric launches its own values (a CPU state is then refused)."""
    m = metrics.get_metric("kerr_boyer")
    p = m.params(a=-0.7)
    inst = raymarch.emitted_instance(m, p)
    assert inst.struct.startswith("Emitted_kerr_boyer_")
    assert inst.baked == (1.0, p["a"])
    assert raymarch.instance_of(bake(m, p)) == inst
    st = integrate.RayState(*(torch.zeros(1) for _ in range(7)))
    feats = integrate.Features.for_metric(m)
    opts = integrate.TraceOptions(max_steps=8)
    gcc = shutil.which("gcc")
    if gcc is None:
        pytest.skip("gcc is not installed: the stand-in library needs it")
    monkeypatch.setattr(raymarch, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(raymarch, "_libs", {})
    monkeypatch.setattr(raymarch, "BUILD_INFO", {})
    src = tmp_path / "stand_in.c"
    src.write_text(STAND_IN.replace("BAKED", "1.0f, -0.5f"))
    so = raymarch.library_path(inst)
    so.with_suffix(".ptxas.txt").write_text("")
    subprocess.run([gcc, "-shared", "-fPIC", "-o", str(so), str(src)],
                   check=True)
    with pytest.raises(RuntimeError, match=r"\(1\.0, -0\.5\) compiled in"):
        raymarch.get_lib(inst)
    assert not raymarch._libs
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        raymarch.trace_rays_cuda(bake(m, p), st, m.params(), feats, opts)
    # A baked function that is not the registered one is refused.
    other = dataclasses.replace(m, fn=lambda x, q: m.fn(x, q))
    with pytest.raises(NotImplementedError, match="differs in fn"):
        raymarch.instance_of(bake(other, p))
    assert raymarch.baked_define(inst.baked) == (
        "#define GRT_BAKED_PARAMS 0x1.0000000000000p+0f,"
        "-0x1.6666660000000p-1f,")


def test_baked_plain_march_equals_the_float_parameter_march():
    m = metrics.get_metric("kerr_boyer")
    p = m.params(a=-0.6)
    feats = integrate.Features.for_metric(m)
    pos, vel = (torch.from_numpy(np.array(a)) for a in make_rays(16))
    st = integrate.init_ray_state(m, pos, vel, p, feats)
    opts = integrate.TraceOptions(max_steps=512)
    a = integrate.trace_rays_reference(bake(m, p), st, {}, feats, opts)
    b = integrate.trace_rays_reference(m, st, p, feats, opts)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
