"""Port parity: the grouped (two-level object / patch) triangle intersector
against the JAX package on THE SAME recorded path and worldlines (JAX's):
hit masks equal, colours within 1e-6, every counter equal, at a budget that
covers the scene (4 object segments a chunk: the worst chunk overlaps 3), at
a budget that overflows (1: the stable selection keeps the same candidate
as ``lax.top_k``) and with a chunk budget that drops chunks.  Also the
port's twins of tests/test_triangles.py's grouped_matches_dense and
grouped_overflow_counters."""

import numpy as np
import pytest
import torch

from geodesic_raytracing_tpu.triangles import render as jrender
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.ops import integrate
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
    jax_intersect,
    two_cubes,
)

torch.set_num_threads(1)

# name: grouped keyword arguments (block 8 throughout)
CASES = {"covered": dict(obj_budget=4),
         "overflow": dict(obj_budget=1),
         "chunk_budget": dict(obj_budget=4, chunk_budget=1)}


@pytest.fixture(scope="module")
def cubes():
    sc = two_cubes()
    for name, kw in CASES.items():
        sc[name] = jax_intersect(jrender.intersect_scene_grouped, sc,
                                 block=8, with_stats=True, **kw)
    sc["dense"] = jax_intersect(jrender.intersect_scene, sc)
    return sc


def _grouped(sc, **kw):
    return render.intersect_scene_grouped(
        sc["m"], sc["path"], sc["scene"], sc["geos"], sc["m"].params(),
        block=8, with_stats=True, **kw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_grouped_equals_reference(cubes, case):
    hit, col, stats = _grouped(cubes, **CASES[case])
    want = cubes[case]
    # (Budget 1 keeps each chunk's earliest object segment and a chunk
    # budget of 1 one block a segment: no ray hits, in both packages.)
    assert_same_image((hit, col), want, some_hit=case == "covered")
    assert_same_stats(stats, want[2])
    if case == "covered":
        assert int(stats["max_overlap"]) == 3 and int(stats["dropped"]) == 0
        assert_same_image((hit, col), cubes["dense"])
    elif case == "overflow":
        assert int(stats["dropped"]) > 0
    else:
        assert int(stats["dropped_chunks"]) > 0


@pytest.mark.parametrize("chunk", [1, 100])
def test_grouped_does_not_depend_on_the_chunk(cubes, chunk, monkeypatch):
    ref = _grouped(cubes, obj_budget=4)
    monkeypatch.setattr(render, "CHUNK", chunk)
    got = _grouped(cubes, obj_budget=4)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert_same_stats(got[2], ref[2])


@pytest.mark.parametrize("stage", [0, 1, 2])
def test_grouped_stages_count_as_the_reference(cubes, stage):
    """The cost-decomposition stages return no hits and the counters of the
    work they ran (sphere and patch survivors from stage 1 and 2 on)."""
    hit, _, stats = _grouped(cubes, obj_budget=4, stage=stage)
    assert not hit.any()
    full = cubes["covered"][2]
    assert float(stats["sphere_pass"]) == (
        float(full["sphere_pass"]) if stage >= 1 else 0.0)
    assert float(stats["patch_pass"]) == (
        float(full["patch_pass"]) if stage >= 2 else 0.0)


def test_build_patches_and_swept_objects_equal_reference(cubes):
    got = render.build_patches(cubes["scene"], 2, patch_size=4,
                               device="cpu")
    want = jrender.build_patches(cubes["scene"], 2, patch_size=4)
    for f in render.Patches._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))
    got = render.build_swept_objects(cubes["scene"], cubes["geos"], pad=0.1)
    want = jrender.build_swept_objects(cubes["scene"], cubes["jgeos"],
                                       pad=0.1)
    for f in render.SweptObjects._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(want, f)), rtol=1e-6,
                                   atol=1e-6, err_msg=f)


def test_object_local_ray_and_slab_test_equal_reference(cubes):
    """The object-level fixed point and the slab test on every (ray segment
    x object segment) pair of the scene."""
    path = cubes["path"]
    sw = render.build_swept_objects(cubes["scene"], cubes["geos"])
    jsw = jrender.build_swept_objects(cubes["scene"], cubes["jgeos"])
    periods = cubes["m"].periods({}, device="cpu")
    ga, gb = path[:-1, :, None], path[1:, :, None]  # (S, N, 1, 4)
    got = render._object_local_ray(ga, gb, sw.p1, sw.p2, sw.ier, sw.ien,
                                   periods)
    import jax

    jp = np.asarray(cubes["jpath"])
    f = jax.vmap(jax.vmap(jax.vmap(
        lambda a, b, p1, p2, r, n: jrender._object_local_ray(
            a, b, p1, p2, r, n, np.asarray(periods)),
        in_axes=(None, None, 0, 0, 0, 0)), in_axes=(0, 0, None, None, None,
                                                    None)),
        in_axes=(0, 0, None, None, None, None))
    want = f(jp[:-1], jp[1:], jsw.p1, jsw.p2, jsw.ier, jsw.ien)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    o3, d3 = got[0][..., 1:], got[1][..., 1:]
    lo = torch.tensor([-0.3, -0.2, -0.1]).expand_as(o3)
    hit, tmin = render._ray_aabb(o3, d3, lo, lo + 0.5)
    jhit, jtmin = jrender._ray_aabb(o3.numpy(), d3.numpy(), lo.numpy(),
                                    lo.numpy() + 0.5)
    np.testing.assert_array_equal(hit.numpy(), np.asarray(jhit))
    np.testing.assert_array_equal(tmin.numpy(), np.asarray(jtmin))


# -- the port's twins of tests/test_triangles.py ---------------------------

def _rays(n, offsets, m, params, feats):
    pos = np.tile([0.0, -7.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    dirs = np.stack([np.full(n, 7.0), offsets, np.zeros(n)], -1)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    vel = np.concatenate([-np.ones((n, 1)), dirs], axis=1).astype(np.float32)
    return integrate.init_ray_state(m, torch.from_numpy(pos),
                                    torch.from_numpy(vel), params, feats)


def test_grouped_matches_dense():
    """The two-level object/patch intersector agrees with the dense one on
    hit/miss away from edge rays."""
    m = tmetrics.get_metric("minkowski")
    params, feats = m.params(), Features.for_metric(m)
    cube = make_cube([-40.0, 0.0, 0.0, 0.0], scale=1.0)
    cube2 = make_cube([-40.0, 0.0, 2.0, 0.0], scale=0.8)
    geos = [precompute_object(m, c, params, feats, n_steps=256, segments=16,
                              device="cpu") for c in (cube, cube2)]
    scene = TriangleScene.build([cube, cube2])
    n = 16
    st = _rays(n, np.linspace(-1.0, 3.0, n), m, params, feats)
    common = dict(features=feats, opts=TraceOptions(max_steps=512),
                  n_slots=8, steps_per_slot=32)
    _, hit_d, col_d = render_triangles(m, st, params, scene, geos, **common)
    _, hit_g, col_g = render_triangles(m, st, params, scene, geos,
                                       grouped=True, block=8, budget=16,
                                       **common)
    hit_d, hit_g = hit_d.numpy(), hit_g.numpy()
    assert hit_d.any()
    np.testing.assert_array_equal(hit_d, hit_g)
    both = hit_d & hit_g
    np.testing.assert_allclose(col_d.numpy()[both], col_g.numpy()[both],
                               atol=1e-3)


def test_grouped_overflow_counters():
    """with_stats reports candidate drops at a budget of 1, none at 16."""
    m = tmetrics.get_metric("minkowski")
    params, feats = m.params(), Features.for_metric(m)
    cube = make_cube([-40.0, 0.0, 0.0, 0.0], scale=1.0)
    geo = precompute_object(m, cube, params, feats, n_steps=256, segments=16,
                            device="cpu")
    scene = TriangleScene.build([cube])
    n = 8
    pos = np.tile([0.0, -7.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    vel = np.tile([-1.0, 1.0, 0.0, 0.0], (n, 1)).astype(np.float32)
    st = integrate.init_ray_state(m, torch.from_numpy(pos),
                                  torch.from_numpy(vel), params, feats)
    _, path = integrate.trace_rays_recorded(
        m, st, params, features=feats, opts=TraceOptions(max_steps=512),
        n_slots=8, steps_per_slot=32)
    _, _, stats = render.intersect_scene_grouped(
        m, path, scene, [geo], params, block=8, obj_budget=1,
        with_stats=True)
    assert int(stats["max_overlap"]) > 1
    assert int(stats["dropped"]) > 0
    hit2, _, stats2 = render.intersect_scene_grouped(
        m, path, scene, [geo], params, block=8, obj_budget=16,
        with_stats=True)
    assert int(stats2["dropped"]) == 0
    assert hit2.any()
