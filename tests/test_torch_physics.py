"""Port parity: observer physics (geodesic recording, parallel transport,
the camera riding a geodesic) of the PyTorch port against the JAX package,
and the six property checks of tests/test_physics.py on the port (CPU).

Tolerances: the recorder runs the same integrator step on one ray, so the
valid-node count is equal and positions agree within 1e-5 relative; the
transports integrate 1/D-sized Christoffel symbols along the infall, where
float32 differences between the frameworks grow to 3e-4 relative of the
tetrad near the horizon, so rtol 1e-3 (atol 1e-4).  Frames: the golden gate
of tests/test_parity_images.py on sRGB uint8.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu import physics as jphys
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.ops import tetrad as jtet
from geodesic_raytracing_tpu.ops.integrate import Features as JFeatures
from geodesic_raytracing_tpu.ops.integrate import TraceOptions as JTrace
from geodesic_raytracing_tpu.render import background as jbg
from geodesic_raytracing_tpu.render import colour as jcolour
from geodesic_raytracing_tpu.render import pipeline as jpl
from geodesic_raytracing_tpu_torch import cli
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch import physics as tphys
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.ops.integrate import Features, TraceOptions
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render import colour
from geodesic_raytracing_tpu_torch.render import pipeline as pl

torch.set_num_threads(1)

POS = dict(rtol=1e-5, atol=1e-5)
TRANSPORT = dict(rtol=1e-3, atol=1e-4)


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _infall(n_steps):
    """Both packages' records of tests/test_physics.py's infall: a static
    observer released from rest at r = 8 in Schwarzschild (u = e0), and the
    frame basis there as the tetrad."""
    jm = jmetrics.get_metric("schwarzschild")
    x0 = np.array([0.0, 8.0, np.pi / 2, 0.0], np.float32)
    jes, _ = jtet.frame_basis(jm.fn(jnp.asarray(x0), jm.params()))
    jpath = jphys.record_geodesic(jm, jnp.asarray(x0), jes[0], jm.params(),
                                  JFeatures.for_metric(jm), n_steps=n_steps)
    tm = tmetrics.get_metric("schwarzschild")
    es = torch.from_numpy(np.asarray(jes))
    path = tphys.record_geodesic(tm, torch.from_numpy(x0), es[0], tm.params(),
                                 Features.for_metric(tm), n_steps=n_steps)
    return (jm, jpath, jes), (tm, path, es)


@pytest.fixture(scope="module")
def infall512():
    return _infall(512)


@pytest.fixture(scope="module")
def infall256():
    return _infall(256)


def _metric_of_path(m, path, count):
    xs = path.positions[:count]
    return torch.stack([m.fn(x, m.params()) for x in xs]), xs


def test_record_geodesic_matches_jax_and_falls_inward(infall512):
    (jm, jpath, _), (tm, path, _) = infall512
    count = int(path.count)
    assert count == int(jpath.count) and count > 10
    np.testing.assert_allclose(_np(path.positions), _np(jpath.positions),
                               **POS)
    np.testing.assert_allclose(_np(path.velocities), _np(jpath.velocities),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_np(path.ds), _np(jpath.ds), **POS)
    np.testing.assert_allclose(_np(path.proper_time), _np(jpath.proper_time),
                               **POS)
    r = _np(path.positions)[:count, 1]
    # Free fall from rest: r strictly decreases.
    assert r[5] < 8.0
    assert np.all(np.diff(r[r > 1.05]) < 1e-5)


def test_timelike_norm_preserved_along_path(infall512):
    _, (tm, path, _) = infall512
    count = int(path.count)
    gab, xs = _metric_of_path(tm, path, count)
    vs = path.velocities[:count]
    norm = _np(torch.einsum("tab,ta,tb->t", gab, vs, vs))
    ok = _np(xs)[:, 1] > 1.5
    assert ok.sum() > 20
    np.testing.assert_allclose(norm[ok], -1.0, atol=5e-2)


def test_parallel_transport_matches_jax_and_preserves_inner_products(
        infall256):
    (jm, jpath, jes), (tm, path, es) = infall256
    jqs = jphys.parallel_transport_quantity(jm, jpath, jes[1], jm.params())
    qs = tphys.parallel_transport_quantity(tm, path, es[1], tm.params())
    assert qs.shape == jqs.shape
    np.testing.assert_allclose(_np(qs), _np(jqs), **TRANSPORT)
    count = int(path.count)
    gab, xs = _metric_of_path(tm, path, count)
    ok = _np(xs)[:, 1] > 2.0
    assert ok.sum() > 20
    q = qs[:count]
    norms = _np(torch.einsum("tab,ta,tb->t", gab, q, q))
    np.testing.assert_allclose(norms[ok], 1.0, atol=5e-2)
    dots = _np(torch.einsum("tab,ta,tb->t", gab, q, path.velocities[:count]))
    np.testing.assert_allclose(dots[ok], 0.0, atol=5e-2)


def test_transported_tetrads_match_jax_and_stay_orthonormal(infall256):
    (jm, jpath, jes), (tm, path, es) = infall256
    jtets = jphys.parallel_transport_tetrads(jm, jpath, jes, jm.params())
    tets = tphys.parallel_transport_tetrads(tm, path, es, tm.params())
    assert tets.shape == jtets.shape
    np.testing.assert_allclose(_np(tets), _np(jtets), **TRANSPORT)
    count = int(path.count)
    gab, _ = _metric_of_path(tm, path, count)
    eta = torch.einsum("tab,tia,tjb->tij", gab, tets[:count], tets[:count])
    np.testing.assert_allclose(
        _np(eta), np.broadcast_to(np.diag([-1.0, 1.0, 1.0, 1.0]),
                                  (count, 4, 4)), atol=5e-2)


def test_tetrad_inverses_along_path():
    (jm, jpath, jes), (tm, path, es) = _infall(64)
    jtets = jphys.parallel_transport_tetrads(jm, jpath, jes, jm.params())
    tets = tphys.parallel_transport_tetrads(tm, path, es, tm.params())
    invs = tphys.tetrad_inverses_along_path(tets)
    np.testing.assert_allclose(
        _np(invs), _np(jphys.tetrad_inverses_along_path(jtets)),
        **TRANSPORT)
    prod = torch.einsum("tij,tjk->tik", invs[:32],
                        tets.transpose(1, 2)[:32])
    np.testing.assert_allclose(_np(prod),
                               np.broadcast_to(np.eye(4), (32, 4, 4)),
                               atol=1e-2)


def test_interpolate_camera_brackets(infall512):
    (jm, jpath, jes), (tm, path, es) = infall512
    jtets = jphys.parallel_transport_tetrads(jm, jpath, jes, jm.params())
    tets = tphys.parallel_transport_tetrads(tm, path, es, tm.params())
    count = int(path.count)
    for tau in (float(path.proper_time[count // 2]), 2.0, -1.0, 1e6):
        pos, vel, tet = tphys.interpolate_camera(path, tets, tau)
        want = jphys.interpolate_camera(jpath, jtets, tau)
        for got, ref in zip((pos, vel, tet), want):
            np.testing.assert_allclose(_np(got), _np(ref), **TRANSPORT)
        rs = _np(path.positions)[:count, 1]
        assert rs.min() - 1e-3 <= float(pos[1]) <= rs.max() + 1e-3
        assert np.isfinite(_np(tet)).all()


def test_geodesic_camera_frame_matches_jax():
    """The CLI's --geodesic-camera flow on the Kerr flagship camera falling
    in at 0.3 c (a 1024-step recording, proper time 2), then a 32x32 frame
    from the camera on that geodesic through both pipelines."""
    W = H = 32
    tau, n_steps, speed = 2.0, 1024, np.array([-0.3, 0.0, 0.0], np.float32)
    jm = jmetrics.get_metric("kerr_boyer")
    jcam = JCamera.default()._replace(basis_speed=jnp.asarray(speed)).rotate(
        pitch=-np.pi / 2)
    x0 = jpl.camera_to_generic(jm, jcam, jm.params())
    gab = jm.fn(x0, jm.params())
    es0 = jtet.boost_tetrad(jtet.frame_basis(gab)[0], jcam.basis_speed, gab)
    jpath = jphys.record_geodesic(jm, x0, es0[0], jm.params(),
                                  JFeatures.for_metric(jm), n_steps=n_steps)
    jtets = jphys.parallel_transport_tetrads(jm, jpath, es0, jm.params())
    jpos, _, jframe = jphys.interpolate_camera(jpath, jtets, tau)
    jcam = jcam.on_geodesic(jpos, jframe)
    jimg = jpl.render_frame(
        jm, jcam, jm.params(), jbg.checker_background(),
        jpl.RenderSettings(width=W, height=H, adaptive_sampling=False,
                           trace=JTrace(max_steps=2048)),
        JFeatures.for_metric(jm))

    tm = tmetrics.get_metric("kerr_boyer")
    cam = Camera.default(device="cpu")._replace(
        basis_speed=torch.from_numpy(speed)).rotate(pitch=-math.pi / 2)
    cam = cli.geodesic_camera(tm, cam, tm.params(), tau, n_steps=n_steps)
    pos, frame = cam.frame_override
    np.testing.assert_allclose(_np(pos), _np(jpos), **TRANSPORT)
    np.testing.assert_allclose(_np(frame), _np(jframe), **TRANSPORT)
    assert pl.camera_frame(tm, cam, tm.params()) is cam.frame_override
    img = pl.render_frame(tm, cam, tm.params(),
                          bg.checker_background(device="cpu"),
                          pl.RenderSettings(width=W, height=H,
                                            trace=TraceOptions(
                                                max_steps=2048)),
                          Features.for_metric(tm), device="cpu")
    ours = (np.clip(_np(colour.lin_to_srgb(img)), 0, 1) * 255).astype(np.uint8)
    theirs = (np.clip(np.asarray(jcolour.lin_to_srgb(jimg)), 0, 1)
              * 255).astype(np.uint8)
    assert len(np.unique(ours.reshape(-1, 3), axis=0)) > 16  # lensed sky
    d = np.abs(ours.astype(int) - theirs.astype(int))
    assert float(np.sqrt((d.astype(float) ** 2).mean())) < 4.0
    assert float((d > 32).mean()) < 0.01


def test_stream_key_tells_geodesic_cameras_apart():
    """The adaptive frame's prepass reuse keys on the camera: two cameras
    that differ only in their geodesic frame have different keys, the same
    camera object the same key."""
    cam = Camera.default(device="cpu")
    a = cam.on_geodesic(torch.zeros(4), torch.eye(4))
    b = cam.on_geodesic(torch.zeros(4), torch.eye(4))
    params = {"rs": 1.0}
    assert pl._stream_key(a, params, Features()) != pl._stream_key(
        b, params, Features())
    assert pl._stream_key(a, params, Features()) == pl._stream_key(
        a, params, Features())
    assert pl._stream_key(cam, params, Features()) != pl._stream_key(
        a, params, Features())
    moved = a.to("cpu")
    assert moved.frame_override[1] is not None


def test_cli_geodesic_camera_renders(tmp_path, capsys):
    """``cli --geodesic-camera TAU`` on the CPU: the observer falls from the
    camera position and the frame is written from proper time TAU."""
    out = tmp_path / "infall.png"
    rc = cli.main(["--metric", "schwarzschild", "--speed", "-0.3", "0", "0",
                   "--geodesic-camera", "2", "--width", "8", "--height", "8",
                   "--pitch", "-90", "--max-steps", "512", "--device", "cpu",
                   "--out", str(out)])
    assert rc == 0 and out.exists()
    said = capsys.readouterr().out
    assert "geodesic camera: tau=2 pos=" in said
    r = float(said.split("pos=[")[1].split(",")[1])
    assert 1.0 < r < 7.0  # fallen in from r = 7
    assert cli.read_png(out).shape == (8, 8, 3)
