"""Port parity: the compact (worklist) triangle intersector against the JAX
package on THE SAME recorded path and worldlines (JAX's): hit masks equal,
colours within 1e-6, every counter equal, with budgets that cover the scene,
with the flat (pair x patch) compaction (``patch_slots=0``), with starved
patch slots and with pair and item budgets that overflow.  The selection
and compaction primitives against ``lax.top_k`` and ``jnp.nonzero(size=)``
on inputs that overflow.  Compact = grouped = binned = dense on the
reference tests' scene, and the port's twin of
tests/test_triangles.py::test_compact_matches_dense_and_grouped.

Where compact and dense part.  The compact (and grouped) intersector solves
ONE fixed point per (ray segment x object segment), at the ray's closest
approach to the object's origin, where dense solves one per triangle.  On
scripts/triangle_bench.py's moving cubes, 8 segments a worldline, the two
part, both ways: seen by 48x27 rays, dense hits 12 pixels of the sixth cube
that compact does not, and compact 2 pixels of the tenth that dense does
not.  Both packages part there alike (the port's compact equals JAX's
compact and its dense JAX's dense), so it is the reference's design, not
the port's."""

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
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.ops.integrate import Features, TraceOptions
from geodesic_raytracing_tpu_torch.triangles import (
    TriangleScene,
    make_cube,
    precompute_object,
    render_triangles,
)
from geodesic_raytracing_tpu_torch.triangles import render
from test_torch_triangles_intersect_dense import (
    assert_same_image,
    assert_same_stats,
    geos_from_jax,
    jax_intersect,
    two_cubes,
)

torch.set_num_threads(1)

# name: compact keyword arguments (block 8, obj_budget 16 throughout)
CASES = {"covered": dict(),
         "flat": dict(patch_slots=0),
         "starved_slots": dict(patch_size=4, patch_slots=1),
         "pair_overflow": dict(pair_budget=8),
         "item_overflow": dict(tri_budget=4)}


@pytest.fixture(scope="module")
def cubes():
    sc = two_cubes()
    for name, kw in CASES.items():
        sc[name] = jax_intersect(jrender.intersect_scene_compact, sc,
                                 block=8, obj_budget=16, with_stats=True,
                                 **kw)
    return sc


def _compact(sc, **kw):
    kw = {"block": 8, "obj_budget": 16, "with_stats": True, **kw}
    return render.intersect_scene_compact(
        sc["m"], sc["path"], sc["scene"], sc["geos"], sc["m"].params(), **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_compact_equals_reference(cubes, case):
    hit, col, stats = _compact(cubes, **CASES[case])
    assert_same_image((hit, col), cubes[case], some_hit=case == "covered")
    assert_same_stats(stats, cubes[case][2])
    dropped = float(stats["dropped"])
    assert dropped == 0.0 if case in ("covered", "flat") else dropped > 0.0


def test_flat_compaction_equals_slots(cubes):
    """No pair overflows its 8 slots here: the slot extraction is bit for
    bit the flat (pair x patch) compaction."""
    a, b = _compact(cubes), _compact(cubes, patch_slots=0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_survivor_sized_budgets(cubes):
    """Budgets of None are sized to the survivors: nothing dropped, and the
    result of budgets that cover them."""
    hit, col, stats = _compact(cubes, pair_budget=None, tri_budget=None)
    assert float(stats["dropped"]) == 0.0
    ref = _compact(cubes)
    assert torch.equal(hit, ref[0]) and torch.equal(col, ref[1])
    assert_same_stats(stats, ref[2])


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_compact_stages(cubes, stage):
    """Each cost-decomposition stage returns no hits and the survivor
    counters of the phases it ran."""
    hit, _, stats = _compact(cubes, stage=stage)
    full = cubes["covered"][2]
    assert not hit.any()
    assert float(stats["sphere_pass"]) == float(full["sphere_pass"])
    assert float(stats["patch_pass"]) == (
        float(full["patch_pass"]) if stage >= 2 else 0.0)


@pytest.mark.parametrize("chunk", [1, 50])
def test_compact_does_not_depend_on_the_chunk(cubes, chunk, monkeypatch):
    ref = _compact(cubes)
    monkeypatch.setattr(render, "CHUNK", chunk)
    got = _compact(cubes)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert_same_stats(got[2], ref[2])


def test_all_four_intersectors_agree(cubes):
    args = (cubes["m"], cubes["path"], cubes["scene"], cubes["geos"],
            cubes["m"].params())
    dense = render.intersect_scene(*args)
    binned = render.intersect_scene_binned(*args, block=8, budget=96)
    grouped = render.intersect_scene_grouped(*args, block=8, obj_budget=16)
    compact = _compact(cubes)[:2]
    assert dense[0].any()
    for other in (binned, grouped, compact):
        assert torch.equal(other[0], dense[0])
        np.testing.assert_allclose(other[1].numpy()[dense[0]],
                                   dense[1].numpy()[dense[0]], atol=1e-6)


def test_topk_stable_is_lax_top_k():
    """0/1 overlap rows (almost every value ties) and integer counts: the
    same indices as ``lax.top_k``, also where the ones overflow k."""
    rng = np.random.default_rng(3)
    for p in (0.02, 0.3, 0.9):
        x = (rng.random((64, 300)) < p).astype(np.float32)
        for k in (1, 8, 64):
            jv, ji = jax.lax.top_k(x, k)
            v, i = render._topk_stable(torch.from_numpy(x), k)
            np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
            np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    c = rng.integers(0, 4, 500).astype(np.int32)
    _, ji = jax.lax.top_k(c, 37)
    _, i = render._topk_stable(torch.from_numpy(c), 37)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_nonzero_static_is_jnp_nonzero():
    """Row-major indices of the set elements, padded with 0, truncated at
    the size: as ``jnp.nonzero(size=, fill_value=0)``."""
    rng = np.random.default_rng(4)
    for p in (0.0, 0.01, 0.5, 1.0):
        m = rng.random((37, 19)) < p
        for size in (1, 5, 100, 37 * 19, 1000):
            (want,) = jnp.nonzero(m.reshape(-1), size=size, fill_value=0)
            got = render._nonzero_static(torch.from_numpy(m), size)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- where compact and dense part, in both packages ------------------------

@pytest.fixture(scope="module")
def bench_path():
    """48x27 planar-rotated camera rays of scripts/triangle_bench.py's scene
    recorded by JAX in 32 slots of 8, as the script records them."""
    jm = jmetrics.get_metric("schwarzschild")
    jp, jf = jm.params(), jintegrate.Features.for_metric(jm)
    cam = JCamera.default().rotate(pitch=-np.pi / 2)
    jst, _, _ = jpl.init_camera_rays(
        jm, cam, jp, jpl.RenderSettings(width=48, height=27), jf)
    _, jpath = jax.jit(lambda s: jintegrate.trace_rays_recorded(
        jm, s, jp, features=jf, n_slots=32, steps_per_slot=8))(jst)
    return jpath


def _bench_cube(k, jpath):
    """Cube ``k`` of the 12-cube scene (12 triangles) on the recorded path
    ``jpath``: JAX's worldline, dense and compact intersections."""
    jm = jmetrics.get_metric("schwarzschild")
    jp, jf = jm.params(), jintegrate.Features.for_metric(jm)
    ang = 2 * np.pi * k / 12
    cube = make_cube([-6.0, 4 * np.cos(ang), 4 * np.sin(ang), 0.0],
                     scale=0.6, velocity=(0.408 * -np.sin(ang),
                                          0.408 * np.cos(ang), 0))
    jgeos = [jphysics.precompute_object(jm, cube, jp, jf, n_steps=512,
                                        segments=8)]
    sc = dict(jm=jm, m=tmetrics.get_metric("schwarzschild"),
              scene=TriangleScene.build([cube]), jgeos=jgeos,
              geos=geos_from_jax(jgeos), jpath=jpath,
              path=torch.from_numpy(np.array(jpath)))
    sc["dense"] = jax_intersect(jrender.intersect_scene, sc)
    sc["compact"] = jax_intersect(jrender.intersect_scene_compact, sc,
                                  block=8, obj_budget=8, with_stats=True)
    return sc


@pytest.fixture(scope="module")
def bench_cube(bench_path):
    return _bench_cube(5, bench_path)  # the sixth cube


@pytest.fixture(scope="module")
def bench_cube_9(bench_path):
    return _bench_cube(9, bench_path)


def _part(sc):
    """The port's dense and compact on the scene's path, each held to JAX's;
    returns (dense-only, compact-only) hit counts."""
    args = (sc["m"], sc["path"], sc["scene"], sc["geos"], sc["m"].params())
    dense = render.intersect_scene(*args)
    hit, col, stats = render.intersect_scene_compact(
        *args, block=8, obj_budget=8, with_stats=True)
    assert_same_image(dense, sc["dense"])
    assert_same_image((hit, col), sc["compact"], some_hit=False)
    assert_same_stats(stats, sc["compact"][2])
    assert float(stats["dropped"]) == 0.0
    return int((dense[0] & ~hit).sum()), int((hit & ~dense[0]).sum())


def test_compact_and_dense_part_as_in_the_reference(bench_cube):
    assert _part(bench_cube) == (12, 0)


def test_compact_may_hit_where_dense_does_not(bench_cube_9):
    """The parting goes the other way too: on the tenth cube compact hits
    2 pixels that dense misses and misses none that dense hits."""
    assert _part(bench_cube_9) == (0, 2)


# -- the port's twin of tests/test_triangles.py ----------------------------

def test_compact_matches_dense_and_grouped():
    """The compact intersector reproduces the dense intersector's hit/miss
    pattern on this scene and reports zero drops when its budgets cover the
    survivors; the slot extraction equals the flat compaction; starved slots
    surface in the drop counter."""
    m = tmetrics.get_metric("minkowski")
    params, feats = m.params(), Features.for_metric(m)
    cube = make_cube([-40.0, 0.0, 0.0, 0.0], scale=1.0)
    cube2 = make_cube([-40.0, 0.0, 2.0, 0.0], scale=0.8)
    geos = [precompute_object(m, c, params, feats, n_steps=256, segments=16,
                              device="cpu") for c in (cube, cube2)]
    scene = TriangleScene.build([cube, cube2])
    n = 16
    offsets = np.linspace(-1.0, 3.0, n)
    pos = np.tile([0.0, -7.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    dirs = np.stack([np.full(n, 7.0), offsets, np.zeros(n)], -1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    vel = np.concatenate([-np.ones((n, 1)), dirs], axis=1).astype(np.float32)
    from geodesic_raytracing_tpu_torch.ops import integrate

    st = integrate.init_ray_state(m, torch.from_numpy(pos),
                                  torch.from_numpy(vel), params, feats)
    common = dict(features=feats, opts=TraceOptions(max_steps=512),
                  n_slots=8, steps_per_slot=32)
    _, hit_d, col_d = render_triangles(m, st, params, scene, geos, **common)
    _, hit_c, col_c = render_triangles(m, st, params, scene, geos,
                                       compact=True, block=8, budget=16,
                                       **common)
    _, hit_g, col_g = render_triangles(m, st, params, scene, geos,
                                       grouped=True, block=8, budget=16,
                                       **common)
    assert hit_d.any()
    assert torch.equal(hit_d, hit_c) and torch.equal(hit_g, hit_c)
    both = (hit_d & hit_c).numpy()
    np.testing.assert_allclose(col_d.numpy()[both], col_c.numpy()[both],
                               atol=1e-3)
    np.testing.assert_allclose(col_g.numpy()[both], col_c.numpy()[both],
                               atol=1e-5)
    _, path = integrate.trace_rays_recorded(m, st, params, **common)
    hit_s, col_s, stats = render.intersect_scene_compact(
        m, path, scene, geos, params, block=8, obj_budget=16,
        with_stats=True)
    assert float(stats["dropped"]) == 0.0
    assert float(stats["sphere_pass"]) > 0
    hit_f, col_f, stats_f = render.intersect_scene_compact(
        m, path, scene, geos, params, block=8, obj_budget=16,
        patch_slots=0, with_stats=True)
    assert torch.equal(hit_s, hit_f) and torch.equal(col_s, col_f)
    assert float(stats_f["dropped"]) == 0.0
    _, _, stats_1 = render.intersect_scene_compact(
        m, path, scene, geos, params, block=8, obj_budget=16,
        patch_size=4, patch_slots=1, with_stats=True)
    assert float(stats_1["dropped"]) > 0.0
