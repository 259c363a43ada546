"""The PyTorch port imports without JAX, and asks for the card explicitly:
without a GPU, device="cuda" raises instead of rendering on the CPU, and
the kernel wrapper refuses CPU tensors and what it does not implement."""

import ast
import dataclasses
import importlib
import math
import pkgutil
import subprocess
import sys
from pathlib import Path

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
    for new in ("cli", "ops.planar", "metrics.catalogue_simple",
                "metrics.catalogue_exotic",
                "render.colour", "render.cie1931_data", "carry", "fit",
                "parallel", "parallel.mesh", "physics", "physics.geodesics",
                "utils", "utils.checkpoint", "triangles", "triangles.scene",
                "triangles.physics", "triangles.render", "ops.emit",
                "content", "runtime", "runtime.hotswap", "utils.profiling",
                "settings", "viewer"):
        assert f"geodesic_raytracing_tpu_torch.{new}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('jax', 'jaxlib',\n"
        "                              'geodesic_raytracing_tpu')]\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300)


def _reference_all(subpackage: str):
    """The JAX package's ``__all__`` of a subpackage, read from its source
    (importing it would import JAX), or None where it has none."""
    src = (Path(__file__).resolve().parents[1] / "geodesic_raytracing_tpu"
           / subpackage / "__init__.py")
    for node in ast.parse(src.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    return None


@pytest.mark.parametrize("subpackage", [
    "coordinates", "metrics", "ops", "parallel", "physics", "render",
    "triangles", "utils"])
def test_subpackages_export_the_reference_names(subpackage):
    """Every name of a reference subpackage's ``__all__`` is exported by the
    port's subpackage of the same name (which may export more), and
    resolves there."""
    want = _reference_all(subpackage)
    assert want, subpackage
    mod = importlib.import_module(f"geodesic_raytracing_tpu_torch."
                                  f"{subpackage}")
    assert set(want) <= set(mod.__all__), sorted(set(want) - set(mod.__all__))
    for name in mod.__all__:
        assert getattr(mod, name) is not None, name
    if subpackage == "parallel":
        assert {"sharded_adaptive_frame", "banded_adaptive_frame",
                "train_step_schedule"} <= set(mod.__all__)


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
    before = raymarch.launches()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        raymarch.trace_rays_cuda(m, st, m.params(),
                                 integrate.Features.for_metric(m),
                                 integrate.TraceOptions(max_steps=8))
    assert raymarch.launches() == before


@pytest.mark.parametrize("opts", [
    integrate.TraceOptions(integrator="euler"),
    integrate.TraceOptions(reparameterisation=True),
    integrate.TraceOptions(planar=True),
])
def test_trace_rays_cuda_refuses_unported_options(opts):
    """Every trace option is ported now, so what the wrapper still refuses
    under each is a state that is not on the card: it raises, launches
    nothing, and never marches the rays with the plain twin instead."""
    m, st = _small_state()
    before = raymarch.launches()
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        raymarch.trace_rays_cuda(m, st, m.params(),
                                 integrate.Features.for_metric(m), opts)
    assert raymarch.launches() == before
    # The plain twin takes the same options.
    fin = integrate.trace_rays_reference(
        m, st, m.params(), integrate.Features.for_metric(m),
        dataclasses.replace(opts, max_steps=8))
    assert int(fin.steps.max()) <= 8


@pytest.mark.parametrize("override", [
    dict(adaptive_precision=False),
    dict(singular=True),
    dict(has_cylindrical_singularity=True),
    dict(unconditionally_nonsingular=True),
])
@pytest.mark.parametrize("march", ["plain", "kernel"])
def test_march_refuses_unported_metric_configs(override, march):
    """The plain march refuses no metric config any more (the step has all
    the reference's branches).  A kernel instance has its registered
    metric's config compiled in, so the wrapper refuses a metric whose
    config was replaced, on any device, before it looks at the tensors: it
    never marches such rays with the catalogue struct's branches."""
    m, st = _small_state()
    m = dataclasses.replace(m, config=dataclasses.replace(m.config,
                                                          **override))
    feats = integrate.Features.for_metric(m)
    opts = integrate.TraceOptions(max_steps=8)
    if march == "plain":
        fin = integrate.trace_rays_reference(m, st, m.params(), feats, opts)
        assert int(fin.steps.max()) <= 8
        assert bool(torch.isfinite(fin.position).all())
    else:
        before = raymarch.launches()
        with pytest.raises(NotImplementedError,
                           match=f"differs in config.{next(iter(override))}"):
            raymarch.trace_rays_cuda(m, st, m.params(), feats, opts)
        assert raymarch.launches() == before


@pytest.mark.parametrize("field,value", [
    ("fn", lambda x, p: metrics.get_metric("kerr_boyer").fn(x, p)),
    ("depends_on", (0, 1, 2, 3)),
    ("spherically_symmetric", True),
])
def test_kernel_refuses_a_metric_that_is_not_the_registered_one(field, value):
    """Function, ``depends_on`` and the symmetry flag are compiled into the
    instance as the config is; ``max_acceleration_change`` is not (it
    travels in Features), so replacing it gets as far as the tensors."""
    m, st = _small_state()
    feats = integrate.Features.for_metric(m)
    opts = integrate.TraceOptions(max_steps=8)
    other = dataclasses.replace(m, **{field: value})
    with pytest.raises(NotImplementedError, match=f"differs in {field}"):
        raymarch.trace_rays_cuda(other, st, m.params(), feats, opts)
    raymarch.check_compiled_metric(m)
    loose = dataclasses.replace(m, config=dataclasses.replace(
        m.config, max_acceleration_change=1e-4))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        raymarch.trace_rays_cuda(loose, st, m.params(), feats, opts)


def test_metric_without_kernel_instance_raises():
    """A metric the kernel has no instance for raises NotImplementedError
    from the wrapper, before anything is built or launched: it is never
    marched by the plain twin in the kernel's place."""
    m, st = _small_state()
    other = dataclasses.replace(m, name="kerr_boyer_variant")
    before = raymarch.launches()
    with pytest.raises(NotImplementedError, match="no ray-march kernel"):
        raymarch.trace_rays_cuda(other, st, m.params(),
                                 integrate.Features.for_metric(m),
                                 integrate.TraceOptions(max_steps=8))
    with pytest.raises(NotImplementedError, match="no ray-march kernel"):
        raymarch.instance_of(other)
    assert raymarch.launches() == before
    for name in metrics.CATALOGUE:
        raymarch.check_compiled_metric(metrics.get_metric(name))


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
    """Seam rows (the band seams of a multi-device frame) are must-refine
    like the borders, so a budget that cannot cover the seam and border
    rows and columns (its ``must_floor``) is refused with a clear error
    instead of leaving seam blocks to interpolation; a budget that covers
    them selects every seam block."""
    z = torch.zeros((4, 6))
    qg = pl.RenderData(tex_coord=torch.zeros((4, 6, 2)), z_shift=z,
                       side=z.int(), terminated=z.int(),
                       angles=torch.zeros((4, 6, 2)), steps=z.int())
    settings = pl.RenderSettings(width=12, height=8)
    floor = (1 + 2) * 6 + 2 * (4 - 2)  # one seam row, the borders: 22
    with pytest.raises(ValueError, match=f"cannot cover the {floor}"):
        pl._select_refine_blocks(qg, settings, floor - 1, seam_rows=(2,))
    should, sel, dest = pl._select_refine_blocks(qg, settings, floor,
                                                 seam_rows=(2,))
    assert sel.shape == (floor,) and dest.shape == (24,)
    assert bool(should[2].all()) and bool((dest.reshape(4, 6)[2] < floor)
                                          .all())
    should, sel, dest = pl._select_refine_blocks(qg, settings, 8)
    assert sel.shape == (8,) and dest.shape == (24,)
    assert not bool(should[1:3, 1:5].any())


def test_while_driver_refuses_tensors_that_require_grad():
    """The ``while`` driver is not differentiable (on the card it is the
    forward-only kernel): a parameter or state that requires grad raises
    with grad enabled instead of cutting the graph, and the kernel wrapper
    refuses such a parameter before it looks at the tensors."""
    m, st = _small_state()
    feats = integrate.Features.for_metric(m)
    opts = integrate.TraceOptions(max_steps=8)
    p = {k: torch.tensor(v, requires_grad=True) for k, v in m.params().items()}
    with pytest.raises(ValueError, match="not differentiable"):
        integrate.trace_rays(m, st, p, feats, opts)
    with pytest.raises(ValueError, match="not differentiable"):
        integrate.trace_rays(m, st._replace(
            position=st.position.clone().requires_grad_()), m.params(),
            feats, opts)
    with torch.no_grad():
        fin = integrate.trace_rays(m, st, p, feats, opts)
    assert int(fin.steps.max()) <= 8
    with pytest.raises(ValueError, match="requires grad"):
        raymarch.trace_rays_cuda(m, st, p, feats, opts)
    with pytest.raises(ValueError, match="unknown trace method"):
        integrate.TraceOptions(method="pallas")
