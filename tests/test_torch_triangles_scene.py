"""Port parity: the triangle scene on the host (OBJ parsing, the cube, the
subtriangulation, the flattened scene) and the periodicity of the charts,
against the JAX package (its Python OBJ parser): arrays equal, exactly.
Also the port's twins of
tests/test_triangles.py::test_subtriangulate_splits_edges and
::test_scene_build."""

import numpy as np
import pytest
import torch

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu import runtime as jruntime
from geodesic_raytracing_tpu.triangles import scene as jscene
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch import runtime
from geodesic_raytracing_tpu_torch.coordinates import transforms
from geodesic_raytracing_tpu_torch.triangles import (
    TriangleScene,
    make_cube,
    object_from_obj,
    subtriangulate,
)

torch.set_num_threads(1)

OBJ_FILES = {
    "triangles": "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 0 0 1\nf 1 2 3\nf 1 3 4\n",
    # A quad fanned into two triangles; v/vt/vn tokens; a comment.
    "quad_slashes": ("# quad\nv -1 -1 0\nv 1 -1 0\nv 1 1 0\nv -1 1 0\n"
                     "vt 0 0\nvn 0 0 1\nf 1/1/1 2/1/1 3/1/1 4/1/1\n"),
    # Negative (relative) indices and a pentagon.
    "negative": ("v 0 0 0\nv 2 0 0\nv 3 1 0\nv 1 2 0\nv -1 1 0\n"
                 "f -5 -4 -3 -2 -1\nv 0 0 5\nf 1 2 -1\n"),
}


@pytest.fixture(autouse=True)
def python_obj_parser(monkeypatch):
    """The reference's ``load_obj`` through its Python parser (the one the
    port restates): with no native library loaded, and none rebuilt by
    test workers at once (ROADMAP Queue 3)."""
    monkeypatch.setattr(jruntime, "get_lib", lambda: None)


def _write(tmp_path, name):
    p = tmp_path / f"{name}.obj"
    p.write_text(OBJ_FILES[name])
    return p


@pytest.mark.parametrize("name", sorted(OBJ_FILES))
def test_load_obj_equals_reference(tmp_path, name):
    p = _write(tmp_path, name)
    v, t = runtime.load_obj(str(p))
    jv, jt = jruntime.load_obj(str(p))
    assert v.dtype == np.float32 and t.dtype == np.int32
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)


@pytest.mark.parametrize("normalise", [True, False])
def test_object_from_obj_equals_reference(tmp_path, normalise):
    p = _write(tmp_path, "negative")
    o = object_from_obj(str(p), [-6, 1, 2, 3], velocity=(0.1, 0, 0),
                        scale=0.5, normalise=normalise)
    j = jscene.object_from_obj(str(p), [-6, 1, 2, 3], velocity=(0.1, 0, 0),
                               scale=0.5, normalise=normalise)
    for f in ("position", "velocity", "vertices", "triangles"):
        np.testing.assert_array_equal(getattr(o, f), getattr(j, f))
        assert getattr(o, f).dtype == getattr(j, f).dtype
    assert o.scale == j.scale


def test_make_cube_equals_reference():
    o = make_cube([-6, 0, -3, 0], velocity=(0.2, 0, 0.1), scale=0.6)
    j = jscene.make_cube([-6, 0, -3, 0], velocity=(0.2, 0, 0.1), scale=0.6)
    for f in ("position", "velocity", "vertices", "triangles"):
        np.testing.assert_array_equal(getattr(o, f), getattr(j, f))
        assert getattr(o, f).dtype == getattr(j, f).dtype
    assert o.scale == j.scale


@pytest.mark.parametrize("max_edge", [1.5, 0.6, 0.2, 1.5 / 32 + 1e-6])
def test_subtriangulate_equals_reference(max_edge):
    c = make_cube([0, 0, 0, 0], scale=0.6)
    v, t = subtriangulate(c.vertices, c.triangles, max_edge=max_edge)
    jv, jt = jscene.subtriangulate(c.vertices, c.triangles, max_edge=max_edge)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(t, jt)


def test_scene_build_equals_reference(tmp_path):
    objs = [make_cube([-6, 0, -3, 0], scale=2.0),
            object_from_obj(str(_write(tmp_path, "quad_slashes")),
                            [-6, 1, 1, 1], scale=0.5),
            make_cube([-6, 0, 3, 0], scale=0.8)]
    jobjs = [jscene.Object3(o.position, o.velocity, o.scale, o.vertices,
                            o.triangles) for o in objs]
    s, j = TriangleScene.build(objs), jscene.TriangleScene.build(jobjs)
    for f in ("v0", "v1", "v2", "parent"):
        np.testing.assert_array_equal(getattr(s, f), getattr(j, f))
        assert getattr(s, f).dtype == getattr(j, f).dtype
    empty = TriangleScene.build([jscene.Object3(np.zeros(4, np.float32))])
    assert empty.v0.shape == (0, 3) and empty.parent.shape == (0,)


@pytest.mark.parametrize("name", ["schwarzschild", "minkowski",
                                  "godel_cylindrical", "misner_4d",
                                  "kerr_boyer", "alcubierre"])
def test_periods_equal_reference(name):
    m, jm = tmetrics.get_metric(name), jmetrics.get_metric(name)
    got = m.periods(m.params(), device="cpu")
    want = np.asarray(jm.periods(jm.params()))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4,)
    np.testing.assert_array_equal(got.numpy(), want)


def test_periodicity_functions_equal_reference():
    from geodesic_raytracing_tpu.coordinates import transforms as jtr

    p = {"phi0": 1.3}
    for fn in ("polar_periodicity", "cylindrical_periodicity",
               "misner_periodicity"):
        np.testing.assert_array_equal(
            getattr(transforms, fn)(p, device="cpu").numpy(),
            np.asarray(getattr(jtr, fn)(p)))
    assert transforms.polar_periodicity(p, device="cpu")[2] == np.float32(
        np.pi)  # theta's period is pi, as the reference's
    np.testing.assert_array_equal(
        transforms.get_periodicity("")(p, device="cpu").numpy(),
        np.zeros(4, np.float32))


def test_subtriangulate_splits_edges():
    """Twin of tests/test_triangles.py::test_subtriangulate_splits_edges."""
    cube = make_cube([0, 0, 0, 0])
    v, t = subtriangulate(cube.vertices, cube.triangles, max_edge=0.6)
    assert len(t) > len(cube.triangles)
    edges = v[t[:, 1]] - v[t[:, 0]]
    assert np.linalg.norm(edges, axis=1).max() <= 0.6 + 1e-5


def test_scene_build():
    """Twin of tests/test_triangles.py::test_scene_build."""
    cube = make_cube([0, 0, 0, 0], scale=2.0)
    scene = TriangleScene.build([cube])
    assert scene.v0.shape == (12, 3)
    assert np.all(scene.parent == 0)
    assert np.abs(scene.v0).max() == 1.0  # scaled by 2
