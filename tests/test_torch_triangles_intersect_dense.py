"""Port parity: the dense and binned triangle intersectors against the JAX
package, each fed THE SAME recorded path and object worldlines (JAX's, as
numpy), so that no march difference enters: hit masks equal, colours within
1e-6, the binned counters equal.  Also the port's twins of
tests/test_triangles.py's minkowski_cube_hits, binned_matches_dense,
binned_budget_prunes and binned_overflow_counter.

The scenes are the reference tests': two cubes at t = -40 seen by 16 rays
(8 slots of 32 iterations), and one cube at t = -8 seen by 32x32 camera rays
(16 slots of 8), whose chunks overflow a budget of 2.  JAX's intersectors
run once each, jitted, in module fixtures."""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.ops import integrate as jintegrate
from geodesic_raytracing_tpu.render import pipeline as jpl
from geodesic_raytracing_tpu.triangles import physics as jphysics
from geodesic_raytracing_tpu.triangles import render as jrender
from geodesic_raytracing_tpu_torch import carry
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.ops import integrate
from geodesic_raytracing_tpu_torch.ops.integrate import Features, TraceOptions
from geodesic_raytracing_tpu_torch.triangles import (
    ObjectGeodesic,
    TriangleScene,
    make_cube,
    precompute_object,
    render_triangles,
)
from geodesic_raytracing_tpu_torch.triangles import render

torch.set_num_threads(1)

COLOUR_TOL = 1e-6


def geos_from_jax(jgeos):
    return [ObjectGeodesic(*(torch.from_numpy(np.array(x)) for x in g))
            for g in jgeos]


def two_cubes():
    """tests/test_triangles.py's two-cube scene in both packages: JAX's
    worldlines, 16 rays and their recorded path (8 slots x 32)."""
    jm = jmetrics.get_metric("minkowski")
    jp, jf = jm.params(), jintegrate.Features.for_metric(jm)
    objs = [make_cube([-40.0, 0.0, 0.0, 0.0], scale=1.0),
            make_cube([-40.0, 0.0, 2.0, 0.0], scale=0.8)]
    jgeos = [jphysics.precompute_object(jm, o, jp, jf, n_steps=256,
                                        segments=16) for o in objs]
    n = 16
    offsets = np.linspace(-1.0, 3.0, n)
    pos = np.tile([0.0, -7.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    dirs = np.stack([np.full(n, 7.0), offsets, np.zeros(n)], -1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    vel = np.concatenate([-np.ones((n, 1)), dirs], axis=1).astype(np.float32)
    jst = jintegrate.init_ray_state(jm, jnp.asarray(pos), jnp.asarray(vel),
                                    jp, jf)
    _, jpath = jax.jit(lambda s: jintegrate.trace_rays_recorded(
        jm, s, jp, features=jf, opts=jintegrate.TraceOptions(max_steps=512),
        n_slots=8, steps_per_slot=32))(jst)
    return dict(jm=jm, m=tmetrics.get_metric("minkowski"), objs=objs,
                scene=TriangleScene.build(objs), jgeos=jgeos,
                geos=geos_from_jax(jgeos), jpath=jpath,
                path=torch.from_numpy(np.array(jpath)), jst=jst,
                st=carry.ray_state_from_jax(jst, device="cpu")[0],
                pos=pos, vel=vel)


def overflow_scene():
    """tests/test_triangles.py::test_binned_overflow_counter's scene: one
    cube at t = -8, 32x32 camera rays, 16 slots x 8."""
    jm = jmetrics.get_metric("minkowski")
    jp, jf = jm.params(), jintegrate.Features.for_metric(jm)
    objs = [make_cube([-8.0, 0.0, -3.0, 0.0])]
    jgeos = [jphysics.precompute_object(jm, objs[0], jp, jf, n_steps=128,
                                        segments=8)]
    cam = JCamera.default().rotate(pitch=-np.pi / 2)
    settings = jpl.RenderSettings(width=32, height=32, planar=False)
    jst, _, _ = jpl.init_camera_rays(jm, cam, jp, settings, jf)
    _, jpath = jax.jit(lambda s: jintegrate.trace_rays_recorded(
        jm, s, jp, features=jf, opts=jintegrate.TraceOptions(max_steps=128),
        n_slots=16, steps_per_slot=8))(jst)
    return dict(jm=jm, m=tmetrics.get_metric("minkowski"), objs=objs,
                scene=TriangleScene.build(objs), jgeos=jgeos,
                geos=geos_from_jax(jgeos), jpath=jpath,
                path=torch.from_numpy(np.array(jpath)))


def jax_intersect(fn, sc, **kw):
    """A JAX intersector on the scene's own path and worldlines, jitted."""
    jm, jp, scene = sc["jm"], sc["jm"].params(), sc["scene"]
    return jax.jit(lambda p, g: fn(jm, p, scene, g, jp, **kw))(
        sc["jpath"], sc["jgeos"])


def assert_same_image(got, want, colour_tol=COLOUR_TOL, some_hit=True):
    hit, col = got[0].numpy(), got[1].numpy()
    jhit, jcol = np.asarray(want[0]), np.asarray(want[1])
    np.testing.assert_array_equal(hit, jhit)
    np.testing.assert_allclose(col[hit], jcol[jhit], rtol=0, atol=colour_tol)
    assert hit.any() or not some_hit  # not vacuous


def assert_same_stats(got, want):
    assert set(got) == set(want), (sorted(got), sorted(want))
    for k in want:
        assert float(got[k]) == float(np.asarray(want[k])), (k, got, want)


@pytest.fixture(scope="module")
def cubes():
    sc = two_cubes()
    sc["dense"] = jax_intersect(jrender.intersect_scene, sc)
    sc["binned"] = jax_intersect(jrender.intersect_scene_binned, sc,
                                 block=8, budget=96, with_stats=True)
    return sc


@pytest.fixture(scope="module")
def overflow():
    sc = overflow_scene()
    for b in (2, 96):
        sc[b] = jax_intersect(jrender.intersect_scene_binned, sc, budget=b,
                              with_stats=True)
    return sc


def test_dense_equals_reference(cubes):
    got = render.intersect_scene(cubes["m"], cubes["path"], cubes["scene"],
                                 cubes["geos"], cubes["m"].params())
    assert_same_image(got, cubes["dense"])


@pytest.mark.parametrize("chunk", [1, 7, 200])
def test_dense_does_not_depend_on_the_chunk(cubes, chunk, monkeypatch):
    args = (cubes["m"], cubes["path"], cubes["scene"], cubes["geos"],
            cubes["m"].params())
    ref = render.intersect_scene(*args)
    monkeypatch.setattr(render, "CHUNK", chunk)
    got = render.intersect_scene(*args)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_binned_equals_reference(cubes):
    hit, col, stats = render.intersect_scene_binned(
        cubes["m"], cubes["path"], cubes["scene"], cubes["geos"],
        cubes["m"].params(), block=8, budget=96, with_stats=True)
    assert_same_image((hit, col), cubes["binned"])
    assert_same_stats(stats, cubes["binned"][2])
    assert_same_image((hit, col), cubes["dense"])


@pytest.mark.parametrize("budget", [2, 96])
def test_binned_counters_equal_reference(overflow, budget):
    """With a budget of 2 most chunks overflow: the candidate set is the
    lowest overlapping entries (``lax.top_k``'s ties, a stable sort here),
    so the hits and both counters equal the reference's."""
    hit, col, stats = render.intersect_scene_binned(
        overflow["m"], overflow["path"], overflow["scene"], overflow["geos"],
        overflow["m"].params(), budget=budget, with_stats=True)
    # (At a budget of 2 the earliest segments fill the bins and no ray
    # hits, in both packages.)
    assert_same_image((hit, col), overflow[budget], some_hit=budget == 96)
    assert_same_stats(stats, overflow[budget][2])
    if budget == 2:
        assert int(stats["dropped"]) > 0


@pytest.mark.parametrize("chunk", [1, 3000])
def test_binned_does_not_depend_on_the_chunk(overflow, chunk, monkeypatch):
    args = (overflow["m"], overflow["path"], overflow["scene"],
            overflow["geos"], overflow["m"].params())
    ref = render.intersect_scene_binned(*args, budget=2, with_stats=True)
    monkeypatch.setattr(render, "CHUNK", chunk)
    got = render.intersect_scene_binned(*args, budget=2, with_stats=True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert_same_stats(got[2], ref[2])


def test_build_swept_triangles_equals_reference(cubes):
    got = render.build_swept_triangles(cubes["scene"], cubes["geos"],
                                       pad=0.01)
    want = jrender.build_swept_triangles(cubes["scene"], cubes["jgeos"],
                                         pad=0.01)
    for f in render.SweptTriangles._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


def test_periodic_primitives_equal_reference():
    rng = np.random.default_rng(7)
    periods = np.array([0.0, 0.0, np.pi, 2 * np.pi], np.float32)
    a = rng.uniform(-10, 10, (64, 4)).astype(np.float32)
    b = rng.uniform(-10, 10, (64, 4)).astype(np.float32)
    a[:8, 3] = b[:8, 3] + np.float32(np.pi)  # halves: round half to even
    np.testing.assert_array_equal(
        render.periodic_diff(torch.from_numpy(a), torch.from_numpy(b),
                             torch.from_numpy(periods)).numpy(),
        np.asarray(jrender.periodic_diff(a, b, periods)))
    lo1, lo2 = a, b
    hi1 = a + rng.uniform(0, 4, a.shape).astype(np.float32)
    hi2 = b + rng.uniform(0, 4, b.shape).astype(np.float32)
    np.testing.assert_array_equal(
        render._periodic_aabb_overlap(*(torch.from_numpy(x) for x in (
            lo1, hi1, lo2, hi2, periods))).numpy(),
        np.asarray(jrender._periodic_aabb_overlap(lo1, hi1, lo2, hi2,
                                                  periods)))


# -- the port's twins of tests/test_triangles.py ---------------------------

def _port_two_cubes(n, offsets):
    m = tmetrics.get_metric("minkowski")
    params, feats = m.params(), Features.for_metric(m)
    pos = np.tile([0.0, -7.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    dirs = np.stack([np.full(n, 7.0), offsets, np.zeros(n)], -1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    vel = np.concatenate([-np.ones((n, 1)), dirs], axis=1).astype(np.float32)
    st = integrate.init_ray_state(m, torch.from_numpy(pos),
                                  torch.from_numpy(vel), params, feats)
    return m, params, feats, st


def test_minkowski_cube_hits():
    """Rays aimed at a static cube hit it; rays aimed away miss."""
    n = 9
    offsets = np.linspace(-3.0, 3.0, n)
    m, params, feats, st = _port_two_cubes(n, offsets)
    cube = make_cube([-40.0, 0.0, 0.0, 0.0], scale=1.0)
    geo = precompute_object(m, cube, params, feats, n_steps=256,
                            segments=32, device="cpu")
    assert torch.isfinite(geo.positions).all()
    np.testing.assert_allclose(geo.positions[:, 1:].numpy(), 0.0, atol=1e-4)
    scene = TriangleScene.build([cube])
    _, hit, colour = render_triangles(
        m, st, params, scene, [geo], features=feats,
        opts=TraceOptions(max_steps=512), n_slots=8, steps_per_slot=32)
    hit = hit.numpy()
    assert hit[np.abs(offsets) < 0.45].all(), (offsets, hit)
    assert not hit[np.abs(offsets) > 0.8].any(), (offsets, hit)
    cols = colour.numpy()[hit]
    assert (cols.max(axis=1) > 0.9).all()


def _two_cube_geos(m, params, feats):
    cube = make_cube([-40.0, 0.0, 0.0, 0.0], scale=1.0)
    cube2 = make_cube([-40.0, 0.0, 2.0, 0.0], scale=0.8)
    geos = [precompute_object(m, c, params, feats, n_steps=256, segments=16,
                              device="cpu") for c in (cube, cube2)]
    return TriangleScene.build([cube, cube2]), geos


def test_binned_matches_dense():
    """The AABB-binned intersector agrees with the dense one whenever the
    per-chunk overlap count fits the budget."""
    n = 16
    m, params, feats, st = _port_two_cubes(n, np.linspace(-1.0, 3.0, n))
    scene, geos = _two_cube_geos(m, params, feats)
    common = dict(features=feats, opts=TraceOptions(max_steps=512),
                  n_slots=8, steps_per_slot=32)
    _, hit_d, col_d = render_triangles(m, st, params, scene, geos, **common)
    _, hit_b, col_b = render_triangles(m, st, params, scene, geos,
                                       binned=True, block=8, budget=96,
                                       **common)
    np.testing.assert_array_equal(hit_d.numpy(), hit_b.numpy())
    assert hit_b.any()
    np.testing.assert_allclose(col_d.numpy(), col_b.numpy(), atol=1e-5)


def test_binned_budget_prunes():
    """A tiny budget still finds hits for simple scenes (earliest segments
    win, like the reference's overflowing bins)."""
    m = tmetrics.get_metric("minkowski")
    params, feats = m.params(), Features.for_metric(m)
    cube = make_cube([-40.0, 0.0, 0.0, 0.0], scale=1.0)
    geo = precompute_object(m, cube, params, feats, n_steps=256, segments=16,
                            device="cpu")
    st = integrate.init_ray_state(
        m, torch.tensor([[0.0, -7.0, 0.0, 0.0]]),
        torch.tensor([[-1.0, 1.0, 0.0, 0.0]]), params, feats)
    _, hit, _ = render_triangles(
        m, st, params, TriangleScene.build([cube]), [geo], features=feats,
        opts=TraceOptions(max_steps=512), n_slots=8, steps_per_slot=32,
        binned=True, block=8, budget=16)
    assert bool(hit[0])


def test_binned_overflow_counter():
    """with_stats reports dropped candidates when the budget is too small,
    zero when it fits."""
    from geodesic_raytracing_tpu_torch.camera import Camera
    from geodesic_raytracing_tpu_torch.render.pipeline import (
        RenderSettings, init_camera_rays)

    m = tmetrics.get_metric("minkowski")
    params, feats = m.params(), Features.for_metric(m)
    cube = make_cube([-8.0, 0.0, -3.0, 0.0])
    geo = precompute_object(m, cube, params, feats, n_steps=128, segments=8,
                            device="cpu")
    scene = TriangleScene.build([cube])
    cam = Camera.default(device="cpu").rotate(pitch=-math.pi / 2)
    settings = RenderSettings(width=32, height=32, planar=False,
                              trace=TraceOptions(max_steps=128))
    st, _, _ = init_camera_rays(m, cam, params, settings, feats,
                                device="cpu")
    _, path = integrate.trace_rays_recorded(
        m, st, params, features=feats, opts=settings.trace, n_slots=16,
        steps_per_slot=8)
    _, _, small = render.intersect_scene_binned(
        m, path, scene, [geo], params, budget=2, with_stats=True)
    hit_big, _, big = render.intersect_scene_binned(
        m, path, scene, [geo], params, budget=96, with_stats=True)
    assert int(small["dropped"]) > 0
    assert int(big["dropped"]) == 0
    assert int(big["max_overlap"]) <= 96
    assert int(hit_big.sum()) > 0
