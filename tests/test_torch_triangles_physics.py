"""Port parity: the object worldlines of triangle rendering
(``triangles.precompute_object``) against the JAX package, a static cube in
``minkowski`` (the scene of tests/test_triangles.py) and one of
scripts/triangle_bench.py's 12 cubes in ``schwarzschild``.  The script
gives each cube the velocity of a circular orbit in cartesian x, y, but an
object's velocity is read in its tetrad frame, whose legs are the polar
coordinates' (r, theta, phi): the cube starts with radial and polar
velocity, and falls in, in both packages.

Tolerance: positions, tetrads and inverse tetrads within 1e-4 (rtol and
atol): the same recorder and transport as tests/test_torch_physics.py, whose
float32 differences between the frameworks stay far below it over these
short, weak-field worldlines."""

import numpy as np
import pytest
import torch

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.ops.integrate import Features as JFeatures
from geodesic_raytracing_tpu.triangles import physics as jphysics
from geodesic_raytracing_tpu.triangles import scene as jscene
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.ops.integrate import Features
from geodesic_raytracing_tpu_torch.triangles import make_cube, physics

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)

ORBIT_ANGLE = 2 * np.pi * 5 / 12  # the sixth cube of the 12-cube scene
CASES = {
    # metric, (position, velocity), n_steps, segments
    "static_minkowski": ("minkowski", ([-40.0, 0.0, 0.0, 0.0], (0, 0, 0)),
                         256, 32),
    "bench_cube_schwarzschild": (
        "schwarzschild",
        ([-6.0, 4 * np.cos(ORBIT_ANGLE), 4 * np.sin(ORBIT_ANGLE), 0.0],
         (0.408 * -np.sin(ORBIT_ANGLE), 0.408 * np.cos(ORBIT_ANGLE), 0.0)),
        512, 48),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def worldlines(request):
    name, (pos, vel), n_steps, segments = CASES[request.param]
    jm, m = jmetrics.get_metric(name), tmetrics.get_metric(name)
    j = jphysics.precompute_object(
        jm, jscene.make_cube(pos, velocity=vel, scale=0.6), jm.params(),
        JFeatures.for_metric(jm), n_steps=n_steps, segments=segments)
    t = physics.precompute_object(
        m, make_cube(pos, velocity=vel, scale=0.6), m.params(),
        Features.for_metric(m), n_steps=n_steps, segments=segments,
        device="cpu")
    return request.param, j, t, segments


def test_precompute_object_equals_reference(worldlines):
    case, j, t, segments = worldlines
    assert int(t.count) == int(j.count) == segments
    for f in ("positions", "tetrads", "inv_tetrads"):
        got, want = getattr(t, f), np.asarray(getattr(j, f))
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, err_msg=f, **TOL)


def test_worldline_physics(worldlines):
    """Static cube: spatial position fixed, time advancing (the property of
    tests/test_triangles.py::test_minkowski_cube_hits).  Bench cube:
    radius falling from 4 to the horizon.  Both: the inverse tetrads invert
    the tetrads."""
    case, _, t, _ = worldlines
    pos = t.positions.numpy()
    assert np.isfinite(pos).all()
    assert (np.diff(pos[:, 0]) > 0).all()
    if case == "static_minkowski":
        np.testing.assert_allclose(pos[:, 1:], 0.0, atol=1e-4)
    else:
        assert pos[0, 1] == 4.0 and (np.diff(pos[:, 1]) < 0).all()
        assert 1.0 < pos[-1, 1] < 1.01, pos[-1, 1]
    # The inverse tetrad is the inverse of the transposed tetrad.
    eye = torch.einsum("kab,kcb->kac", t.inv_tetrads, t.tetrads)
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(
        np.eye(4, dtype=np.float32), eye.shape), atol=1e-4)


def test_linspace_is_the_reference_subsampling():
    """The proper-time targets follow jnp.linspace(0, 1, n) bit for bit."""
    import jax.numpy as jnp

    for n in (2, 8, 16, 32, 47, 48, 64, 100):
        np.testing.assert_array_equal(physics._linspace01(n, "cpu").numpy(),
                                      np.asarray(jnp.linspace(0.0, 1.0, n)))


def test_worldlines_recorded_together_equal_one_by_one():
    """``precompute_objects`` records every worldline in one batch: each
    object's nodes, tetrads and inverses equal its own recording's, bit for
    bit (a static cube, two of the bench's falling cubes, a cube that starts
    inside the precision radius)."""
    m = tmetrics.get_metric("schwarzschild")
    params, feats = m.params(), Features.for_metric(m)
    objs = [make_cube([-40.0, 0.0, 30.0, 0.0])]
    for i in (0, 5):
        a = 2 * np.pi * i / 12
        objs.append(make_cube([-6.0, 4 * np.cos(a), 4 * np.sin(a), 0.0],
                              scale=0.6, velocity=(0.408 * -np.sin(a),
                                                   0.408 * np.cos(a), 0.0)))
    objs.append(make_cube([-6.0, 0.0, -3.0, 0.0]))
    together = physics.precompute_objects(m, objs, params, feats,
                                          n_steps=256, segments=16,
                                          device="cpu")
    for o, t in zip(objs, together):
        one = physics.precompute_object(m, o, params, feats, n_steps=256,
                                        segments=16, device="cpu")
        for a, b in zip(one, t):
            assert torch.equal(a, b)
