"""Port parity: the metric layer, geometry and tetrads of the PyTorch port
against the JAX reference on the same seeded numpy inputs (CPU).

Tolerances: g and its partials are a few float32 ops deep, so rtol 1e-5 /
atol 1e-6.  The acceleration, null fix, frame basis and observer tetrad
divide by metric combinations (1/D, 1/det) whose sin/cos ulps grow near the
horizon, so rtol 1e-4 / atol 1e-5.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geodesic_raytracing_tpu import camera as jcam
from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.ops import geometry as jgeo
from geodesic_raytracing_tpu.ops import tetrad as jtet
from geodesic_raytracing_tpu_torch import camera as tcam
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.ops import geometry as tgeo
from geodesic_raytracing_tpu_torch.ops import tetrad as ttet

torch.set_num_threads(1)

TIGHT = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=1e-4, atol=1e-5)
N = 256


@pytest.fixture(scope="module")
def kerr():
    jm = jmetrics.get_metric("kerr_boyer")
    tm = tmetrics.get_metric("kerr_boyer")
    return jm, jm.params(), tm, tm.params()


@pytest.fixture(scope="module")
def events():
    """(x, v) component-first (4, N) float32: r in [1.6, 20], theta in
    [0.05, pi - 0.05], random t, phi and velocity."""
    rng = np.random.default_rng(0)
    x = np.stack([
        rng.uniform(-5.0, 5.0, N),
        rng.uniform(1.6, 20.0, N),
        rng.uniform(0.05, np.pi - 0.05, N),
        rng.uniform(-np.pi, np.pi, N),
    ]).astype(np.float32)
    v = rng.normal(size=(4, N)).astype(np.float32)
    return x, v


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_metric_and_partials(kerr, events):
    jm, jp, tm, tp = kerr
    x, _ = events
    jg, jdg = jgeo.metric_and_partials_batched(jm.fn, jnp.asarray(x), jp,
                                               deps=jm.depends_on)
    tg, tdg = tgeo.metric_and_partials_batched(tm.fn, torch.from_numpy(x), tp,
                                               deps=tm.depends_on)
    np.testing.assert_allclose(_np(tg), _np(jg), **TIGHT)
    for c in range(4):
        assert (tdg[c] is None) == (jdg[c] is None), c
        if tdg[c] is not None:
            np.testing.assert_allclose(_np(tdg[c]), _np(jdg[c]), **TIGHT)


def test_acceleration_batched(kerr, events):
    jm, jp, tm, tp = kerr
    x, v = events
    ja = jgeo.acceleration_batched(jm.fn, jnp.asarray(x), jnp.asarray(v), jp,
                                   deps=jm.depends_on, nz=jm.nonzeros())
    ta = tgeo.acceleration_batched(tm.fn, torch.from_numpy(x),
                                   torch.from_numpy(v), tp,
                                   deps=tm.depends_on, nz=tm.nonzeros())
    np.testing.assert_allclose(_np(ta), _np(ja), **LOOSE)


def test_fix_null_batched(kerr, events):
    jm, jp, tm, tp = kerr
    x, v = events
    jv = jgeo.fix_null_batched(jm.fn(jnp.asarray(x), jp), jnp.asarray(v))
    tv = tgeo.fix_null_batched(tm.fn(torch.from_numpy(x), tp),
                               torch.from_numpy(v))
    np.testing.assert_allclose(_np(tv), _np(jv), **LOOSE)


def test_frame_basis_batched(kerr, events):
    jm, jp, tm, tp = kerr
    x, _ = events
    jes, jtl = jtet.frame_basis_batched(jm.fn(jnp.asarray(x), jp))
    tes, ttl = ttet.frame_basis_batched(tm.fn(torch.from_numpy(x), tp))
    np.testing.assert_array_equal(_np(ttl), _np(jtl))
    np.testing.assert_allclose(_np(tes), _np(jes), **LOOSE)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_observer_tetrad(kerr, seed):
    """Default flagship camera position (seed 0) and seeded positions with a
    seeded observer 3-velocity."""
    jm, jp, tm, tp = kerr
    rng = np.random.default_rng(seed)
    if seed == 0:
        pos = np.array([0.0, 7.0, np.pi / 2, -np.pi / 2], np.float32)
        speed = np.zeros(3, np.float32)
    else:
        pos = np.array([0.0, rng.uniform(3.0, 15.0),
                        rng.uniform(0.3, np.pi - 0.3),
                        rng.uniform(-np.pi, np.pi)], np.float32)
        speed = rng.uniform(-0.3, 0.3, 3).astype(np.float32)
    jes = jcam.observer_tetrad(jm, jnp.asarray(pos), jp,
                               basis_speed3=jnp.asarray(speed))
    tes = tcam.observer_tetrad(tm, torch.from_numpy(pos), tp,
                               basis_speed3=torch.from_numpy(speed))
    np.testing.assert_allclose(_np(tes), _np(jes), **LOOSE)


def test_camera_rotate_and_arctan2():
    """Camera.rotate quaternions, and the reference's polynomial arctan2
    over all quadrants and the axes."""
    jq = jcam.Camera.default().rotate(yaw=0.3, pitch=-np.pi / 2, roll=0.1)
    tq = tcam.Camera.default().rotate(yaw=0.3, pitch=-np.pi / 2, roll=0.1)
    np.testing.assert_allclose(_np(tq.quat), _np(jq.quat), rtol=1e-6,
                               atol=1e-7)
    rng = np.random.default_rng(3)
    y = np.concatenate([rng.normal(size=64), [0.0, 1.0, -1.0, 0.0]])
    x = np.concatenate([rng.normal(size=64), [0.0, 0.0, 0.0, -2.0]])
    y, x = y.astype(np.float32), x.astype(np.float32)
    np.testing.assert_allclose(
        _np(tgeo.arctan2(torch.from_numpy(y), torch.from_numpy(x))),
        _np(jgeo.arctan2(jnp.asarray(y), jnp.asarray(x))), **TIGHT)
