"""The port's ``double_kerr`` against the benchmark's plain reference of it
(``benchmark/reference/metrics/double_kerr.py`` with its complex pairs,
``benchmark/reference/complexify.py``), on three seeded parameter sets near
the defaults (R in 2.5-3.5, M in 0.25-0.35, a in 0.20-0.30): the metric and
its partials at seeded events, the cylindrical chart both ways, the launch
state of a 16x9 camera grid, trial iterations of the plain march of those
rays (64 for the first set, 16 for the others: the eager march of this
metric costs ~36 ms a trial iteration a side on one core, and the file
keeps within 15 s) and the render data of where they stop.

Every comparison is exact (NaN equal to NaN): the reference is the port's
plain path copied term for term, so both sides run the same float32 torch
operations in the same order on the CPU.  The chart's round trip alone is
held to a tolerance, that of the polynomial atan2 (2e-7 radians) and the
float32 sine and cosine."""

import functools
import math
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.reference import camera as rcam  # noqa: E402
from benchmark.reference import frame as rframe  # noqa: E402
from benchmark.reference import geometry as rgeo  # noqa: E402
from benchmark.reference import march as rmarch  # noqa: E402
from benchmark.reference import spacetime  # noqa: E402
from geodesic_raytracing_tpu_torch import metrics  # noqa: E402
from geodesic_raytracing_tpu_torch.camera import Camera  # noqa: E402
from geodesic_raytracing_tpu_torch.ops import geometry, integrate  # noqa: E402
from geodesic_raytracing_tpu_torch.render import pipeline as pl  # noqa: E402

torch.set_num_threads(1)

SETS = [0, 1, 2]
W, H = 16, 9
STEPS = {0: 64, 1: 16, 2: 16}  # trial iterations of each set's march


def same(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit, or NaN on both sides."""
    if a.dtype != torch.float32:
        return torch.equal(a, b)
    nan = torch.isnan(a) & torch.isnan(b)
    return bool(((a.view(torch.int32) == b.view(torch.int32)) | nan).all())


@functools.lru_cache(maxsize=None)
def sides(k: int):
    """``(port metric, reference metric, params)`` of parameter set ``k``,
    as float32 values held in Python floats on both sides."""
    g = torch.Generator().manual_seed(1700 + k)
    u = torch.rand(3, generator=g, dtype=torch.float64).tolist()
    raw = {"R": 2.5 + u[0], "M": 0.25 + 0.1 * u[1], "a": 0.20 + 0.1 * u[2]}
    port = metrics.get_metric("double_kerr")
    ref = spacetime.load("double_kerr")
    params = port.params(**raw)
    assert params == ref.params(raw)
    return port, ref, params


def events(k: int, n: int = 96) -> torch.Tensor:
    """Seeded cylindrical events (t, p, phi, z) off the axis, (4, n)."""
    g = torch.Generator().manual_seed(2600 + k)
    t = -5.0 + 10.0 * torch.rand(n, generator=g)
    p = 0.05 + 8.0 * torch.rand(n, generator=g)
    phi = -3.1 + 6.2 * torch.rand(n, generator=g)
    z = -6.0 + 12.0 * torch.rand(n, generator=g)
    return torch.stack([t, p, phi, z])


@functools.lru_cache(maxsize=None)
def frames(k: int):
    """The launch state, the march and the render data of the 16x9 grid of
    the benchmark's camera (r = 7 on the plane between the holes, pitched at
    the centre), each side by its own code."""
    port, ref, params = sides(k)
    feats = integrate.Features.for_metric(port)
    rfeats = rmarch.features_for(ref)
    assert tuple(feats) == tuple(rfeats)

    cam = Camera.default(device="cpu").rotate(pitch=-math.pi / 2)
    settings = pl.RenderSettings(width=W, height=H, fov_degrees=90.0)
    state, ku, iquat = pl.init_camera_rays(port, cam, params, settings,
                                           feats, device="cpu")
    opts = integrate.TraceOptions(max_steps=STEPS[k])
    final = integrate.trace_rays_reference(port, state, params, feats, opts)
    rd = pl.compute_render_data(port, final, ku, params, feats, iquat)

    polar, quat, speed = rcam.scene_camera(7.0, math.pi / 2, -math.pi / 2,
                                           -math.pi / 2, 0.0, "cpu")
    assert same(quat, cam.quat) and same(polar, cam.polar_position)
    rsettings = rframe.Settings(width=W, height=H, max_steps=STEPS[k])
    position, es = rframe.camera_frame(ref, params, polar, speed)
    rstate, rku, riquat = rframe.rays_for_pixels(
        ref, quat, position, es, params, rsettings, rfeats,
        *rframe._grid_coords(W, H, 1.0, "cpu"))
    rfinal = rmarch.march(ref, rstate, params, rfeats, False, STEPS[k])
    rrd = rframe.compute_render_data(ref, rfinal, rku, params, rfeats,
                                     riquat)
    return (state, ku, iquat, final, rd), (rstate, rku, riquat, rfinal, rrd)


@pytest.mark.parametrize("k", SETS)
def test_the_metric_and_its_partials_match(k):
    port, ref, params = sides(k)
    x = events(k)
    g, dg = geometry.metric_and_partials_batched(port.fn, x, params,
                                                 deps=port.depends_on)
    rg, rdg = rgeo.metric_and_partials_batched(ref.fn, x, params,
                                               ref.depends_on)
    assert same(g, rg)
    assert torch.isfinite(g).all()
    assert [d is None for d in dg] == [d is None for d in rdg] == [
        True, False, True, False]
    for d, rd in zip(dg, rdg):
        if d is not None:
            assert same(d, rd)
            assert torch.isfinite(d).all()
    assert ref.structure == port.nonzeros()
    assert ref.depends_on == port.depends_on


@pytest.mark.parametrize("k", SETS)
def test_the_chart_matches_both_ways(k):
    port, ref, params = sides(k)
    x = events(k)
    polar = port.to_polar(x, params)
    assert same(polar, ref.to_polar(x, params))
    back = port.from_polar(polar, params)
    assert same(back, ref.from_polar(polar, params))
    assert float((back - x).abs().max()) <= 1e-5
    v = torch.randn(x.shape, generator=torch.Generator().manual_seed(k))
    assert same(port.to_polar_velocity(x, v, params),
                ref.to_polar_velocity(x, v, params))
    assert ref.precision_weights() == port.precision_weights()
    assert ref.max_acceleration_change == port.config.max_acceleration_change


@pytest.mark.parametrize("k", SETS)
def test_the_launch_state_matches(k):
    (state, ku, iquat, _, _), (rstate, rku, riquat, _, _) = frames(k)
    assert iquat is None and riquat is None
    for field in integrate.RayState._fields:
        assert same(getattr(state, field), getattr(rstate, field)), field
    assert same(ku, rku)
    assert torch.isfinite(state.acceleration).all()


@pytest.mark.parametrize("k", SETS)
def test_the_march_matches(k):
    (_, _, _, final, _), (_, _, _, rfinal, _) = frames(k)
    for field in integrate.RayState._fields:
        assert same(getattr(final, field), getattr(rfinal, field)), field
    assert int(final.steps.sum()) > W * H * STEPS[k] // 2


@pytest.mark.parametrize("k", SETS)
def test_the_render_data_matches(k):
    (*_, rd), (*_, rrd) = frames(k)
    for field in pl.RenderData._fields:
        assert same(getattr(rd, field), getattr(rrd, field)), field
