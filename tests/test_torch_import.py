"""The PyTorch port imports without JAX, and asks for the card explicitly:
without a GPU, device="cuda" raises instead of rendering on the CPU, and
the kernel wrapper refuses CPU tensors and what it does not implement."""

import dataclasses
import math
import pkgutil
import subprocess
import sys

import pytest
import torch

import geodesic_raytracing_tpu_torch as pkg
from geodesic_raytracing_tpu_torch import metrics
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.ops import integrate, raymarch
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render import pipeline as pl

torch.set_num_threads(1)


def test_port_imports_without_jax():
    mods = sorted(m.name for m in pkgutil.walk_packages(
        pkg.__path__, pkg.__name__ + "."))
    assert "geodesic_raytracing_tpu_torch.cli" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                              'geodesic_raytracing_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def _small_state():
    m = metrics.get_metric("kerr_boyer")
    pos = torch.tensor([[0.0, 7.0, math.pi / 2, 0.0]] * 4)
    vel = torch.tensor([[1.0, -1.0, 0.0, 0.05]] * 4)
    st = integrate.init_ray_state(m, pos, vel, m.params(),
                                  integrate.Features.for_metric(m))
    return m, st


def test_render_frame_cuda_without_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: device='cuda' renders there")
    m = metrics.get_metric("kerr_boyer")
    settings = pl.RenderSettings(width=8, height=8)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        pl.render_frame(m, Camera.default(device="cpu"), m.params(),
                        bg.checker_background(64, 128, device="cpu"), settings,
                        device="cuda")


def test_trace_rays_cuda_refuses_cpu_tensors():
    m, st = _small_state()
    before = raymarch.LAUNCHES
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        raymarch.trace_rays_cuda(m, st, m.params(),
                                 integrate.Features.for_metric(m),
                                 integrate.TraceOptions(max_steps=8))
    assert raymarch.LAUNCHES == before


@pytest.mark.parametrize("opts", [
    integrate.TraceOptions(integrator="euler"),
    integrate.TraceOptions(reparameterisation=True),
    integrate.TraceOptions(planar=True),
])
def test_trace_rays_cuda_refuses_unported_options(opts):
    m, st = _small_state()
    with pytest.raises(NotImplementedError):
        raymarch.trace_rays_cuda(m, st, m.params(),
                                 integrate.Features.for_metric(m), opts)


@pytest.mark.parametrize("override", [
    dict(adaptive_precision=False),
    dict(singular=True),
    dict(has_cylindrical_singularity=True),
    dict(unconditionally_nonsingular=True),
])
@pytest.mark.parametrize("march", ["plain", "kernel"])
def test_march_refuses_unported_metric_configs(override, march):
    m, st = _small_state()
    m = dataclasses.replace(m, config=dataclasses.replace(m.config,
                                                          **override))
    fn = (integrate.trace_rays_reference if march == "plain"
          else raymarch.trace_rays_cuda)
    with pytest.raises(NotImplementedError, match="is ported"):
        fn(m, st, m.params(), integrate.Features.for_metric(m),
           integrate.TraceOptions(max_steps=8))


def test_render_frame_refuses_adaptive_sampling():
    """Of an image with an odd side: the quarter grid takes every second
    pixel, so the adaptive frame refuses it with a clear error."""
    m = metrics.get_metric("kerr_boyer")
    for width, height in ((9, 8), (8, 9)):
        settings = dataclasses.replace(
            pl.RenderSettings(width=width, height=height),
            adaptive_sampling=True)
        with pytest.raises(ValueError, match="even image dimensions"):
            pl.render_frame(m, Camera.default(device="cpu"), m.params(),
                            bg.checker_background(64, 128, device="cpu"),
                            settings, device="cpu")


def test_select_refine_blocks_refuses_seam_rows():
    """Seam rows belong to banded multi-device frames, which are not
    ported: a non-empty value raises instead of being ignored."""
    z = torch.zeros((4, 6))
    qg = pl.RenderData(tex_coord=torch.zeros((4, 6, 2)), z_shift=z,
                       side=z.int(), terminated=z.int(),
                       angles=torch.zeros((4, 6, 2)), steps=z.int())
    settings = pl.RenderSettings(width=12, height=8)
    with pytest.raises(NotImplementedError, match="seam_rows"):
        pl._select_refine_blocks(qg, settings, 8, seam_rows=(2,))
    should, sel, dest = pl._select_refine_blocks(qg, settings, 8)
    assert sel.shape == (8,) and dest.shape == (24,)
