"""Port parity: gradients through the differentiable scan of the PyTorch
port against ``jax.grad`` of the JAX package on the same numpy inputs, and
against finite differences at tests/test_gradients.py's own tolerances
(CPU).

Tolerances: where the ray fates agree the two frameworks run the same
float32 step, so the gradients agree within rtol 1e-3 (transcendental ulps
differ between the frameworks and the backward sweep amplifies them on the
rays that pass closest to the photon sphere).  The finite differences carry
the adaptive integrator's discontinuous step sequence: rtol 0.15 (mass,
camera pose) and 0.2 (spin), as the reference's tests state them.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.ops import integrate as jint
from geodesic_raytracing_tpu.render import pipeline as jpl
from geodesic_raytracing_tpu_torch import camera as tcam
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.ops import integrate as tint
from geodesic_raytracing_tpu_torch.render import background as tbg
from geodesic_raytracing_tpu_torch.render import pipeline as tpl
from test_integrator import make_rays

torch.set_num_threads(1)

JAX_RTOL = 1e-3


def _rays(n, r0, lo, hi):
    ang = np.linspace(lo, hi, n)
    pos = np.tile([0.0, r0, np.pi / 2, 0.0], (n, 1)).astype(np.float32)
    vel = np.stack([np.ones(n), -np.cos(ang), np.zeros(n),
                    np.sin(ang) / r0], -1).astype(np.float32)
    return pos, vel


def _endpoint_loss_jax(name, pos, vel, opts, params_of):
    m = jmetrics.get_metric(name)
    feats = jint.Features.for_metric(m)

    def loss(x):
        p = params_of(m, x)
        st = jint.init_ray_state(m, jnp.asarray(pos), jnp.asarray(vel), p,
                                 feats)
        fin = jint.trace_rays(m, st, p, features=feats, opts=opts)
        esc = (fin.status == jint.ESCAPED).astype(jnp.float32)
        return jnp.sum(fin.position[:, 3] * esc) / jnp.maximum(
            jnp.sum(esc), 1.0)

    return loss


def _endpoint_loss_torch(name, pos, vel, opts, params_of):
    m = tmetrics.get_metric(name)
    feats = tint.Features.for_metric(m)

    def loss(x):
        p = params_of(m, x)
        st = tint.init_ray_state(m, torch.from_numpy(pos),
                                 torch.from_numpy(vel), p, feats)
        fin = tint.trace_rays(m, st, p, feats, opts)
        esc = (fin.status == tint.ESCAPED).to(torch.float32)
        return torch.sum(fin.position[:, 3] * esc) / torch.clamp(
            torch.sum(esc), min=1.0)

    return loss


def _grad_and_fd(loss, x0, eps):
    """The port's autograd gradient at ``x0`` and the central difference."""
    x = torch.tensor(x0, dtype=torch.float32, requires_grad=True)
    g, = torch.autograd.grad(loss(x), x)
    with torch.no_grad():
        fd = (loss(torch.tensor(x0 + eps)) - loss(torch.tensor(x0 - eps))) / (
            2 * eps)
    return float(g), float(fd)


def _check(name, pos, vel, remat, params_of, x0, eps, fd_tol):
    jopts = jint.TraceOptions(max_steps=256, method="scan",
                              remat_every=remat)
    topts = tint.TraceOptions(max_steps=256, method="scan",
                              remat_every=remat)
    jg = jax.grad(_endpoint_loss_jax(name, pos, vel, jopts, params_of))(
        jnp.float32(x0))
    g, fd = _grad_and_fd(_endpoint_loss_torch(name, pos, vel, topts,
                                              params_of), x0, eps)
    assert np.isfinite(g)
    np.testing.assert_allclose(g, float(jg), rtol=JAX_RTOL)
    np.testing.assert_allclose(g, fd, **fd_tol)
    return g


def test_grad_wrt_mass_matches_jax_and_fd():
    pos, vel = _rays(8, 7.0, 0.5, 0.9)
    g = _check("schwarzschild", pos, vel, 32,
               lambda m, rs: {"rs": rs}, 1.0, 1e-3, dict(rtol=0.15))
    # Deflection grows with mass: the gradient is significant.
    assert abs(g) > 1e-3


def test_grad_wrt_kerr_spin_matches_jax_and_fd():
    pos, vel = _rays(4, 7.0, 0.55, 0.8)
    _check("kerr_boyer", pos, vel, 32,
           lambda m, a: {"rs": 1.0, "a": a}, -0.5, 2e-3,
           dict(rtol=0.2, atol=5e-3))


def test_remat_gradient_equals_unwindowed_gradient():
    """Recomputed windows of 32 iterations give the gradient of one window
    of all 256 bit for bit: ``torch.func.jvp`` inside non-reentrant
    ``torch.utils.checkpoint`` replays exactly the forward's ops."""
    pos, vel = _rays(8, 7.0, 0.5, 0.9)
    gs = []
    for remat in (32, 256):
        opts = tint.TraceOptions(max_steps=256, method="scan",
                                 remat_every=remat)
        loss = _endpoint_loss_torch("schwarzschild", pos, vel, opts,
                                    lambda m, rs: {"rs": rs})
        rs = torch.tensor(1.0, requires_grad=True)
        gs.append(torch.autograd.grad(loss(rs), rs)[0])
    assert gs[0].item() == gs[1].item() and math.isfinite(gs[0].item())


def test_grad_wrt_camera_pose_matches_jax_and_fd():
    """Pixel observables differentiate with respect to the camera pose: the
    mean escape angle of an 8x8 frame against the camera radius."""
    W = H = 8
    jm = jmetrics.get_metric("schwarzschild")
    jset = jpl.RenderSettings(width=W, height=H, planar=False,
                              trace=jint.TraceOptions(max_steps=192,
                                                      method="scan",
                                                      remat_every=32))
    jfeats = jint.Features.for_metric(jm)

    def jloss(cam_r):
        cam = JCamera.default().rotate(pitch=-np.pi / 2)
        cam = cam._replace(polar_position=cam.polar_position.at[1].set(cam_r))
        st, _, _ = jpl.init_camera_rays(jm, cam, jm.params(), jset, jfeats)
        fin = jint.trace_rays(jm, st, jm.params(), features=jfeats,
                              opts=jset.trace)
        esc = (fin.status == jint.ESCAPED).astype(jnp.float32)
        return jnp.sum(fin.position[:, 3] * esc) / jnp.maximum(jnp.sum(esc),
                                                               1.0)

    tm = tmetrics.get_metric("schwarzschild")
    tset = tpl.RenderSettings(width=W, height=H, planar=False,
                              trace=tint.TraceOptions(max_steps=192,
                                                      method="scan",
                                                      remat_every=32))
    tfeats = tint.Features.for_metric(tm)

    def tloss(cam_r):
        cam = tcam.Camera.default(device="cpu").rotate(pitch=-np.pi / 2)
        pp = cam.polar_position
        cam = cam._replace(polar_position=torch.cat([pp[:1], cam_r[None],
                                                     pp[2:]]))
        st, _, _ = tpl.init_camera_rays(tm, cam, tm.params(), tset, tfeats,
                                        device="cpu")
        fin = tint.trace_rays(tm, st, tm.params(), tfeats, tset.trace)
        esc = (fin.status == tint.ESCAPED).to(torch.float32)
        return torch.sum(fin.position[:, 3] * esc) / torch.clamp(
            torch.sum(esc), min=1.0)

    jg = jax.grad(jloss)(jnp.float32(7.0))
    g, fd = _grad_and_fd(tloss, 7.0, 1e-2)
    assert np.isfinite(g)
    np.testing.assert_allclose(g, float(jg), rtol=JAX_RTOL)
    np.testing.assert_allclose(g, fd, rtol=0.15, atol=1e-4)


def test_grad_finite_with_dead_rays():
    """Rays that die mid-trace (horizon capture, blow-up kill) do not poison
    the backward sweep: the step freezes a dying ray at its last finite
    state, so the gradient of a 32x32 Kerr frame with more than 50 DEAD
    rays is finite, and equals JAX's."""
    W = H = 32
    opts = dict(max_steps=2048, method="scan", remat_every=128)
    jm = jmetrics.get_metric("kerr_boyer")
    jset = jpl.RenderSettings(width=W, height=H, planar=False,
                              trace=jint.TraceOptions(**opts))
    jfeats = jint.Features.for_metric(jm)
    jcam = JCamera.default().rotate(pitch=-np.pi / 2)

    def jloss(params):
        st, _, _ = jpl.init_camera_rays(jm, jcam, params, jset, jfeats)
        fin = jint.trace_rays(jm, st, params, features=jfeats,
                              opts=jset.trace)
        ok = (fin.status == jint.ESCAPED)[:, None]
        return jnp.sum(jnp.where(ok, fin.velocity[:, 1:3], 0.0) ** 2)

    jg = jax.grad(jloss)(jm.params())

    tm = tmetrics.get_metric("kerr_boyer")
    tset = tpl.RenderSettings(width=W, height=H, planar=False,
                              trace=tint.TraceOptions(**opts))
    tfeats = tint.Features.for_metric(tm)
    cam = tcam.Camera.default(device="cpu").rotate(pitch=-np.pi / 2)
    params = {k: torch.tensor(v, requires_grad=True)
              for k, v in tm.params().items()}
    st, _, _ = tpl.init_camera_rays(tm, cam, params, tset, tfeats,
                                    device="cpu")
    fin = tint.trace_rays(tm, st, params, tfeats, tset.trace)
    assert int((fin.status == tint.DEAD).sum()) > 50
    assert bool(torch.isfinite(fin.position).all())
    assert bool(torch.isfinite(fin.velocity).all())
    ok = (fin.status == tint.ESCAPED)[:, None]
    loss = torch.sum(torch.where(ok, fin.velocity[:, 1:3], 0.0) ** 2)
    g = torch.autograd.grad(loss, list(params.values()))
    for k, v in zip(params, g):
        assert math.isfinite(float(v)), (k, v)
        np.testing.assert_allclose(float(v), float(jg[k]), rtol=JAX_RTOL)


@pytest.mark.parametrize("max_steps,remat,iterations", [
    (512, 128, 512),
    (200, 64, 256),   # ceil(200 / 64) windows of 64: 256 iterations
])
def test_scan_equals_while_reference(max_steps, remat, iterations):
    """``method="scan"`` runs ceil(max_steps / remat) windows of remat
    iterations over every ray; finished rays idle through the step's own
    masks, so its final state equals the ``while`` driver's at that many
    iterations bit for bit (Kerr ``make_rays(64)``, every 7th ray DEAD)."""
    m = tmetrics.get_metric("kerr_boyer")
    feats = tint.Features.for_metric(m)
    pos, vel = make_rays(64)
    st = tint.init_ray_state(m, torch.from_numpy(np.asarray(pos)),
                             torch.from_numpy(np.asarray(vel)), m.params(),
                             feats)
    st.status[::7] = tint.DEAD
    scan = tint.trace_rays(m, st, m.params(), feats, tint.TraceOptions(
        max_steps=max_steps, method="scan", remat_every=remat))
    ref = tint.trace_rays_reference(m, st, m.params(), feats,
                                    tint.TraceOptions(max_steps=iterations))
    assert int((ref.status == tint.ACTIVE).sum()) > 0  # some hit the budget
    for a, b in zip(scan, ref):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", tmetrics.list_metrics())
def test_tensor_params_equal_float_params(name):
    """Every function of both paths takes a params dict of 0-d float32
    tensors that require grad and gives the numbers it gives with floats:
    the metric and its charts, the launch state, the camera frame, the
    camera rays and the render data."""
    m = tmetrics.get_metric(name)
    feats = tint.Features.for_metric(m)
    fl = m.params()
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in fl.items()}
    rng = np.random.default_rng(7)
    x = torch.from_numpy(np.stack([
        rng.uniform(-1, 1, 16), rng.uniform(3.0, 12.0, 16),
        rng.uniform(0.3, 2.8, 16), rng.uniform(-3, 3, 16)]).astype(np.float32))
    for fn in (m.fn, m.to_polar, m.from_polar):
        assert torch.equal(fn(x, tp).detach(), fn(x, fl))
    polar = m.to_polar(x, fl)
    assert torch.equal(m.origin_distance(polar, tp).detach(),
                       m.origin_distance(polar, fl))
    settings = tpl.RenderSettings(width=4, height=4, planar=False)
    cam = tcam.Camera.default(device="cpu").rotate(pitch=-np.pi / 2)
    pos_f = tpl.camera_to_generic(m, cam, fl)
    assert torch.equal(tpl.camera_to_generic(m, cam, tp).detach(), pos_f)
    assert torch.equal(tcam.observer_tetrad(m, pos_f, tp).detach(),
                       tcam.observer_tetrad(m, pos_f, fl))
    outs = []
    for p in (tp, fl):
        st, ku, _ = tpl.init_camera_rays(m, cam, p, settings, feats,
                                         device="cpu")
        rd = tpl.compute_render_data(m, st, ku, p, feats)
        outs.append([t.detach() for t in (*st, ku, *rd)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_read_mipmap_gradient_through_bilinear_weights():
    """``read_mipmap`` differentiates with respect to the texture
    coordinates through its bilinear weights (the fit's only path from the
    image to the rays): the gradient matches the central difference."""
    sky = tbg.checker_background(64, 128, device="cpu")
    uv = torch.tensor([[0.3013, 0.4121], [0.7777, 0.2531]],
                      requires_grad=True)
    side = torch.ones(2, dtype=torch.int32)
    lod = torch.full((2,), 3.0)
    g, = torch.autograd.grad(tbg.read_mipmap(sky, side, uv, lod).sum(), uv)
    eps = 1e-3
    for i in range(2):
        for j in range(2):
            d = torch.zeros_like(uv)
            d[i, j] = eps
            with torch.no_grad():
                fd = (tbg.read_mipmap(sky, side, uv + d, lod).sum()
                      - tbg.read_mipmap(sky, side, uv - d, lod).sum()) / (
                          2 * eps)
            np.testing.assert_allclose(float(g[i, j]), float(fd), rtol=0.05,
                                       atol=1e-3)
    assert float(g.abs().sum()) > 0


def test_trace_frame_and_grad_safe_final_match_jax():
    """``trace_frame`` (trace only, planar off, ``settings.trace`` as it
    is) and ``grad_safe_final`` (launch states on every lane that is not
    consumed: escaped to the far half of the universe sphere within the step
    cap) on an 8x8 Kerr frame, against the JAX package's."""
    W = H = 8
    jm = jmetrics.get_metric("kerr_boyer")
    jset = jpl.RenderSettings(width=W, height=H,
                              trace=jint.TraceOptions(max_steps=1024))
    jcam = JCamera.default().rotate(pitch=-np.pi / 2)
    jfeats = jint.Features.for_metric(jm)
    jfin, jku = jpl.trace_frame(jm, jcam, jm.params(), jset, jfeats)
    jst, _, _ = jpl.init_camera_rays(jm, jcam, jm.params(), jset, jfeats)
    jsane, jcons = jpl.grad_safe_final(jm, jst, jfin, jm.params(), jfeats,
                                       step_cap=256)

    tm = tmetrics.get_metric("kerr_boyer")
    tset = tpl.RenderSettings(width=W, height=H,
                              trace=tint.TraceOptions(max_steps=1024))
    cam = tcam.Camera.default(device="cpu").rotate(pitch=-np.pi / 2)
    tfeats = tint.Features.for_metric(tm)
    fin, ku = tpl.trace_frame(tm, cam, tm.params(), tset, device="cpu")
    st, _, _ = tpl.init_camera_rays(tm, cam, tm.params(), tset, tfeats,
                                    device="cpu")
    sane, cons = tpl.grad_safe_final(tm, st, fin, tm.params(), tfeats,
                                     step_cap=256)
    np.testing.assert_array_equal(fin.status.numpy(), np.asarray(jfin.status))
    np.testing.assert_allclose(ku.numpy(), np.asarray(jku), rtol=1e-5)
    np.testing.assert_array_equal(cons.numpy(), np.asarray(jcons))
    assert 0 < int(cons.sum()) < W * H
    np.testing.assert_allclose(sane.position.numpy(),
                               np.asarray(jsane.position), rtol=1e-4,
                               atol=1e-4)
    keep = cons.numpy()
    np.testing.assert_array_equal(sane.position.numpy()[~keep],
                                  st.position.numpy()[~keep])
