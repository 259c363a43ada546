"""Port parity: the differentiable train step (``parallel.make_train_step``)
and the ``fit`` CLI of the PyTorch port against the JAX package's
``make_train_step`` on a one-device mesh (CPU), at 16x16 Kerr with a
512-step budget and a soft step cap of 256 (hard cap 405, a 512-iteration
scan in windows of 128).

Tolerances: the target images agree within 1e-5; loss, gradients and the
updated parameters within rtol 1e-3 (the same float32 step in both, ulps of
the transcendentals apart).  The gradient against the finite difference of
the same weighted loss with the probe frozen: rtol 0.2, as
tests/test_gradients.py states it.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.fit import _render_target as jtarget
from geodesic_raytracing_tpu.ops.integrate import Features as JFeatures
from geodesic_raytracing_tpu.ops.integrate import TraceOptions as JTrace
from geodesic_raytracing_tpu.parallel.mesh import make_train_step as jmake
from geodesic_raytracing_tpu.parallel.mesh import ray_mesh
from geodesic_raytracing_tpu.render import background as jbg
from geodesic_raytracing_tpu.render.pipeline import RenderSettings as JSettings
from geodesic_raytracing_tpu_torch import fit
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.ops.integrate import Features, TraceOptions
from geodesic_raytracing_tpu_torch.parallel import (make_train_step,
                                                    train_step_schedule)
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render.pipeline import RenderSettings

torch.set_num_threads(1)

SIZE, MAX_STEPS, REMAT, CAP = 16, 512, 128, 256
TIGHT = dict(rtol=1e-3, atol=1e-9)


@pytest.fixture(scope="module")
def kerr_fit():
    """Both packages' train steps, cameras, skies and targets (rs 1.1)."""
    jm = jmetrics.get_metric("kerr_boyer")
    jset = JSettings(width=SIZE, height=SIZE, trace=JTrace(
        max_steps=MAX_STEPS, method="scan", remat_every=REMAT))
    jcam = JCamera.default().rotate(pitch=-np.pi / 2)
    jsky = jbg.checker_background(64, 128)
    jstep = jmake(jm, ray_mesh(jax.devices()[:1]), jset,
                  JFeatures.for_metric(jm), grad_step_cap=CAP)
    jt = jtarget(jm, jcam, jm.params(rs=1.1), jsky, jset,
                 JFeatures.for_metric(jm), grad_step_cap=CAP)

    tm = tmetrics.get_metric("kerr_boyer")
    tset = RenderSettings(width=SIZE, height=SIZE, trace=TraceOptions(
        max_steps=MAX_STEPS, method="scan", remat_every=REMAT))
    cam = Camera.default(device="cpu").rotate(pitch=-np.pi / 2)
    sky = bg.checker_background(64, 128, device="cpu")
    step = make_train_step(tm, tset, Features.for_metric(tm),
                           grad_step_cap=CAP, device="cpu")
    target = fit._render_target(tm, cam, tm.params(rs=1.1), sky, tset,
                                Features.for_metric(tm), grad_step_cap=CAP,
                                device="cpu")
    return (jm, jstep, jcam, jsky, jt), (tm, step, cam, sky, target, tset)


def test_schedule_matches_the_reference():
    """The hard cap min(2 cap, cap + ceil(149 / decay), budget) and the
    scan length: 1.25x the hard cap in whole windows, at most the budget
    (896 at the production 256^2 / 2048 / remat 128 / cap 512)."""
    prod = RenderSettings(width=256, height=256, trace=TraceOptions(
        max_steps=2048, method="scan", remat_every=128))
    hard, opts, probe = train_step_schedule(prod, 512)
    assert (hard, opts.max_steps, opts.method) == (661, 896, "scan")
    assert (probe.max_steps, probe.method) == (2048, "while")
    small = RenderSettings(trace=TraceOptions(max_steps=512, remat_every=64))
    hard, opts, _ = train_step_schedule(small, 128)
    assert (hard, opts.max_steps) == (256, 320)
    hard, opts, _ = train_step_schedule(small, 128, soft_decay_bits=4.0)
    assert (hard, opts.max_steps) == (166, 256)
    hard, opts, _ = train_step_schedule(small, 300)
    assert (hard, opts.max_steps) == (449, 512)


def test_target_matches_jax(kerr_fit):
    (_, _, _, _, jt), (_, _, _, _, target, _) = kerr_fit
    assert target.shape == (SIZE, SIZE, 3)
    assert float(target.max()) > 0 and bool((target.sum(-1) == 0).any())
    np.testing.assert_allclose(target.numpy(), np.asarray(jt), atol=1e-5)


def test_train_step_matches_jax(kerr_fit):
    """One step from rs 0.95: loss, gradients and the clipped SGD update."""
    (jm, jstep, jcam, jsky, jt), (tm, step, cam, sky, target, _) = kerr_fit
    jloss, jgrads = jstep.loss_and_grad(jm.params(rs=0.95), jcam, jt, jsky)
    jnew, jloss2 = jstep(jm.params(rs=0.95), jcam, jt, jsky,
                         jnp.float32(0.05))
    loss, grads = step.loss_and_grad(tm.params(rs=0.95), cam, target, sky)
    new, loss2 = step(tm.params(rs=0.95), cam, target, sky, 0.05)
    assert float(loss) > 0 and float(loss2) == float(loss)
    np.testing.assert_allclose(float(loss), float(jloss), **TIGHT)
    assert sorted(grads) == sorted(jgrads)
    for k in grads:
        assert math.isfinite(float(grads[k]))
        np.testing.assert_allclose(float(grads[k]), float(jgrads[k]),
                                   **TIGHT)
        np.testing.assert_allclose(float(new[k]), float(jnew[k]), **TIGHT)
    assert float(new["rs"]) > 0.95  # toward the target's 1.1


def test_soft_lyapunov_window_grad_matches_fd(kerr_fit):
    """The weighted loss's autodiff gradient at rs 1.0 equals the central
    difference of the same loss with the probe frozen at rs 1.0 (its masks
    and weights are constants of the loss), and JAX's gradient."""
    (jm, jstep, jcam, jsky, jt), (tm, step, cam, sky, target, _) = kerr_fit
    frozen = tm.params(rs=1.0)
    _, g = step.loss_and_grad(frozen, cam, target, sky)
    g = float(g["rs"])
    assert math.isfinite(g) and abs(g) > 1e-6
    _, jg = jstep.loss_and_grad(jm.params(rs=1.0), jcam, jt, jsky)
    np.testing.assert_allclose(g, float(jg["rs"]), **TIGHT)
    eps = 2e-3

    def loss_at(rs):
        return float(step.loss(tm.params(rs=rs), cam, target, sky,
                               probe_params=frozen))

    fd = (loss_at(1.0 + eps) - loss_at(1.0 - eps)) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=0.2)


def test_fit_cli_resumes_from_its_checkpoint(tmp_path, capsys):
    """``fit`` on the CPU: two steps with a checkpoint after each, then a
    second run that resumes from step 2 and takes the third."""
    ck = tmp_path / "ck"
    argv = ["--metric", "schwarzschild", "--size", "8", "--max-steps", "96",
            "--remat-every", "32", "--device", "cpu", "--checkpoint",
            str(ck), "--checkpoint-every", "1", "--true", "rs=1.1",
            "--start", "rs=0.9"]
    assert fit.main([*argv, "--steps", "2"]) == 0
    first = capsys.readouterr().out
    assert "resumed" not in first and "step   1 loss" in first
    assert fit.main([*argv, "--steps", "3"]) == 0
    second = capsys.readouterr().out
    assert "resumed from step 2" in second
    assert "step   0 loss" not in second and "step   2 loss" in second
    assert "rs: fitted" in second


def test_fit_cli_refuses_cuda_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: --device cuda fits there")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        fit.main(["--device", "cuda", "--steps", "1"])
