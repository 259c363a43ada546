"""Port parity: GR triangle rendering end to end (``render_triangles``: the
recorded march, then an intersector), one case per metric of the reference
tests, each from JAX's launch state and with JAX's worldlines: the
``minkowski`` two-cube scene (dense) and the ``schwarzschild`` near-field
cube (binned, 64 slots of 8).  The march runs in each package, so its
last-ulp differences enter; hit masks equal and colours within 1e-6 all the
same.  Also the port's twin of
tests/test_triangles.py::test_schwarzschild_nearfield_cube_hits."""

import math

import numpy as np
import pytest
import torch

import jax

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.ops import integrate as jintegrate
from geodesic_raytracing_tpu.render import pipeline as jpl
from geodesic_raytracing_tpu.triangles import physics as jphysics
from geodesic_raytracing_tpu.triangles import render as jrender
from geodesic_raytracing_tpu_torch import carry
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.ops.integrate import Features, TraceOptions
from geodesic_raytracing_tpu_torch.render.pipeline import (RenderSettings,
                                                           init_camera_rays)
from geodesic_raytracing_tpu_torch.triangles import (
    TriangleScene,
    make_cube,
    precompute_object,
    render_triangles,
)
from test_torch_triangles_intersect_dense import (
    assert_same_image,
    geos_from_jax,
    two_cubes,
)

torch.set_num_threads(1)


def near_field(size):
    """tests/test_triangles.py::test_schwarzschild_nearfield_cube_hits's
    scene: a cube between the camera and the hole, 4-D camera rays."""
    jm = jmetrics.get_metric("schwarzschild")
    jp, jf = jm.params(), jintegrate.Features.for_metric(jm)
    cube = make_cube([-6.0, 0.0, -3.0, 0.0])
    jgeos = [jphysics.precompute_object(jm, cube, jp, jf, n_steps=512,
                                        segments=48)]
    cam = JCamera.default().rotate(pitch=-np.pi / 2)
    settings = jpl.RenderSettings(width=size, height=size, planar=False)
    jst, _, _ = jpl.init_camera_rays(jm, cam, jp, settings, jf)
    return dict(jm=jm, m=tmetrics.get_metric("schwarzschild"),
                scene=TriangleScene.build([cube]), jgeos=jgeos,
                geos=geos_from_jax(jgeos), jst=jst,
                st=carry.ray_state_from_jax(jst, device="cpu")[0])


# name: (scene, render_triangles keyword arguments)
CASES = {"minkowski": (two_cubes, dict(n_slots=8, steps_per_slot=32)),
         "schwarzschild": (lambda: near_field(24),
                           dict(binned=True, budget=64))}


@pytest.fixture(scope="module", params=sorted(CASES))
def rendered(request):
    make, kw = CASES[request.param]
    sc = make()
    jm, jp = sc["jm"], sc["jm"].params()
    jf = jintegrate.Features.for_metric(jm)
    opts = jintegrate.TraceOptions(max_steps=512)
    want = jax.jit(lambda s, g: jrender.render_triangles(
        jm, s, jp, sc["scene"], g, features=jf, opts=opts, **kw))(
        sc["jst"], sc["jgeos"])
    m = sc["m"]
    got = render_triangles(m, sc["st"], m.params(), sc["scene"], sc["geos"],
                           features=Features.for_metric(m),
                           opts=TraceOptions(max_steps=512), **kw)
    return request.param, got, want, sc


def test_render_triangles_equals_reference(rendered):
    name, got, want, _ = rendered
    np.testing.assert_array_equal(got[0].status.numpy(),
                                  np.asarray(want[0].status))
    np.testing.assert_array_equal(got[0].steps.numpy(),
                                  np.asarray(want[0].steps))
    assert_same_image(got[1:], want[1:])
    if name == "schwarzschild":  # the cube subtends ~2% of the frame
        assert float(got[1].float().mean()) > 0.005


def test_render_triangles_passes_budgets_and_returns_stats(rendered):
    """Compact with its budgets sized to the survivors (as the CLI runs it)
    and the counters after the image: the reference's image, nothing
    dropped; the dense intersector has no counters."""
    name, _, want, sc = rendered
    m = sc["m"]
    args = (m, sc["st"], m.params(), sc["scene"], sc["geos"],
            Features.for_metric(m), TraceOptions(max_steps=512))
    slots = CASES[name][1].get("n_slots", 64), CASES[name][1].get(
        "steps_per_slot", 8)
    *got, stats = render_triangles(
        *args, *slots, compact=True, with_stats=True, pair_budget=None,
        tri_budget=None)
    assert_same_image(got[1:], want[1:])
    assert float(stats["dropped"]) == 0.0 and float(stats["sphere_pass"]) > 0
    assert render_triangles(*args, *slots, with_stats=True)[3] == {}


def test_schwarzschild_nearfield_cube_hits():
    """A cube between camera and hole in strong field must be hit (the
    recording's 64 slots of 8 keep its segments short there)."""
    m = tmetrics.get_metric("schwarzschild")
    params, feats = m.params(), Features.for_metric(m)
    cube = make_cube([-6.0, 0.0, -3.0, 0.0])
    geo = precompute_object(m, cube, params, feats, n_steps=512, segments=48,
                            device="cpu")
    scene = TriangleScene.build([cube])
    cam = Camera.default(device="cpu").rotate(pitch=-math.pi / 2)
    settings = RenderSettings(width=48, height=48, planar=False,
                              trace=TraceOptions(max_steps=512))
    st, _, _ = init_camera_rays(m, cam, params, settings, feats,
                                device="cpu")
    _, hit, _ = render_triangles(m, st, params, scene, [geo], feats,
                                 settings.trace, binned=True, budget=64)
    frac = float(hit.float().mean())
    assert frac > 0.005, frac
