"""Port parity, stage by stage: the adaptive pipeline's plain-torch stages
against the JAX functions on the same inputs (CPU).

Inputs are made with numpy from a seed, or are the JAX package's own
intermediate results of a real 64x64 ``kerr_boyer`` adaptive frame (prepass,
quarter march, selection, refine march, all by the JAX package), carried over
as numpy.  No test here marches a ray with the port.

Tolerances: integer and bool results are exact; float fields agree to 1e-5
(uv and angles on the circle: a float32 ulp can flip an angle between -pi and
pi; z_shift of rays that died at the horizon to rtol 1e-3); ``err_ratio`` to rtol 1e-4 where it is above 1e-6; RGB to 2e-3.  Error
buckets are ``floor(log2(err) * 2)``: ``log2`` of XLA and of torch may differ
in the last ulp, so buckets are compared except where ``log2(err) * 2`` lies
within 1e-4 of an integer, and ``should`` except where the error ratio lies
within 1e-5 of its threshold 1.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geodesic_raytracing_tpu import bench_config as jbench
from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.ops.integrate import Features as JFeatures
from geodesic_raytracing_tpu.ops.integrate import RayState as JRayState
from geodesic_raytracing_tpu.ops.integrate import TraceOptions as JTrace
from geodesic_raytracing_tpu.render import background as jbg
from geodesic_raytracing_tpu.render import pipeline as jpl
from geodesic_raytracing_tpu_torch import bench_config, carry
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from geodesic_raytracing_tpu_torch.ops import packing
from geodesic_raytracing_tpu_torch.ops.integrate import (Features, RayState,
                                                         TraceOptions)
from geodesic_raytracing_tpu_torch.render import pipeline as pl

torch.set_num_threads(1)

W = H = 64
STEPS = 2048
KS = (128, 1024)  # fewer blocks than want refinement, and every block


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _tuple_t(cls, jtuple):
    return cls(*(_t(f) for f in jtuple))


def _close_circle(a, b, period, tol=1e-5):
    d = np.abs(np.asarray(a, dtype=np.float64) - np.asarray(b))
    d = np.minimum(d, np.abs(period - d))
    assert d.max() <= tol, d.max()


def _assert_rdata(ours: pl.RenderData, theirs, tol=1e-5):
    """Float fields to ``tol`` (uv mod 1, phi mod 2 pi), integer fields
    exact."""
    _close_circle(ours.tex_coord.numpy(), theirs.tex_coord, 1.0, tol)
    # z_shift of a ray that died at the horizon is ill-conditioned (the
    # metric is singular there; values of 10 and more): rtol 1e-3 there.
    esc = np.asarray(theirs.terminated) == 1
    z, jz = ours.z_shift.numpy(), np.asarray(theirs.z_shift)
    np.testing.assert_allclose(z[esc], jz[esc], rtol=tol, atol=tol)
    np.testing.assert_allclose(z[~esc], jz[~esc], rtol=1e-3, atol=tol)
    _close_circle(ours.angles.numpy(), theirs.angles, 2 * math.pi, tol)
    for name in ("side", "terminated", "steps"):
        got = getattr(ours, name)
        assert got.dtype == torch.int32, name
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(theirs, name)), name)


# ---------------------------------------------------------------------------
# Grid helpers and the prepass kill mask
# ---------------------------------------------------------------------------

# (W, H): a ragged small image, the test frame, and the 1080p frame, whose
# 120x67 prepass map upsamples to the 960x540 quarter grid.
SIZES = [(64, 48), (64, 64), (96, 40), (1920, 1080)]


def _prepass_shape(w, h):
    return max(h // 16, 4), max(w // 16, 4)


@pytest.mark.parametrize("size", SIZES)
def test_prepass_kill_equals_jax(size):
    w, h = size
    dead = np.random.default_rng(w + h).random(_prepass_shape(w, h)) < 0.6
    want = jpl._prepass_kill(jnp.asarray(dead), w, h, w // 2, h // 2)
    got = pl._prepass_kill(torch.from_numpy(dead), w, h, w // 2, h // 2)
    assert got.dtype == torch.bool and got.shape == ((w // 2) * (h // 2),)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size", SIZES)
def test_upsample_round_equals_jax(size):
    w, h = size
    small = np.random.default_rng(w).integers(
        0, 1 << 20, _prepass_shape(w, h)).astype(np.int32)
    want = jpl._upsample_round(jnp.asarray(small), w // 2, h // 2, 2.0, w, h)
    got = pl._upsample_round(torch.from_numpy(small), w // 2, h // 2, 2.0,
                             w, h)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_prepass_kill_upsample_semantics():
    """The shift + index upsample must match the per-ray probe definition
    (round-indexed 5-neighbour AND) of the reference renderer."""
    rng = np.random.default_rng(0)
    w, h = 64, 48
    pw, ph = w // 16, h // 16
    dead = rng.random((ph, pw)) < 0.5
    got = pl._prepass_kill(torch.from_numpy(dead), w, h, w // 2,
                           h // 2).numpy().reshape(h // 2, w // 2)

    qx = 2.0 * np.arange(w // 2)
    qy = 2.0 * np.arange(h // 2)
    lx = np.clip(np.round(qx / w * pw).astype(int), 0, pw - 1)
    ly = np.clip(np.round(qy / h * ph).astype(int), 0, ph - 1)

    def probe(dx, dy):
        xx = np.clip(lx[None, :] + dx, 0, pw - 1)
        yy = np.clip(ly[:, None] + dy, 0, ph - 1)
        inb = ((lx[None, :] + dx >= 0) & (lx[None, :] + dx <= pw - 1)
               & (ly[:, None] + dy >= 0) & (ly[:, None] + dy <= ph - 1))
        return np.where(inb, dead[yy, xx], False)

    want = (probe(-1, 0) & probe(0, 0) & probe(1, 0) & probe(0, -1)
            & probe(0, 1))
    # Interior must match exactly; the border row/column may differ (the
    # upsample clamps instead of declaring out-of-bounds un-killable).
    assert (got[1:-1, 1:-1] == want[1:-1, 1:-1]).all()


@pytest.mark.parametrize("shift", [(0, -1), (0, 1), (-1, 0), (1, 0)])
def test_shift2d_equals_jax(shift):
    x = np.random.default_rng(3).random((5, 7)) < 0.5
    want = jpl._shift2d(jnp.asarray(x), *shift, False)
    got = pl._shift2d(torch.from_numpy(x), *shift, False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# Selection on a synthetic grid and on a real frame
# ---------------------------------------------------------------------------

def _synthetic_grid(hh=40, wh=56, seed=5):
    """A seeded (hh, wh) RenderData grid as numpy: a smooth angle field with
    a steep patch and noise (error ratios on both sides of the threshold,
    over several octaves) and a disc of DEAD rays."""
    rng = np.random.default_rng(seed)
    y, x = np.meshgrid(np.linspace(-1, 1, hh), np.linspace(-1, 1, wh),
                       indexing="ij")
    r2 = x * x + y * y
    theta = 1.2 + 0.5 * y + 0.6 * np.exp(-6 * r2) * np.sin(9 * x)
    phi = 0.8 * x + 0.5 * np.exp(-4 * r2) * np.cos(7 * y)
    ang = np.stack([theta, phi], -1) + rng.normal(0, 2e-3, (hh, wh, 2))
    term = np.where(r2 < 0.08, 2, 1).astype(np.int32)
    return dict(
        tex_coord=rng.random((hh, wh, 2)).astype(np.float32),
        z_shift=rng.normal(0, 0.1, (hh, wh)).astype(np.float32),
        side=np.ones((hh, wh), np.int32),
        terminated=term,
        angles=ang.astype(np.float32),
        steps=rng.integers(1, 900, (hh, wh)).astype(np.int32),
    )


def _jax_buckets(qg, settings):
    """The bucket array of the JAX package's ``_select_refine_blocks``
    (its lines between the error terms and the sort)."""
    err_ratio, must = jpl._refine_error_terms(qg, settings)
    should = (err_ratio >= 1.0) | must
    logr = jnp.log2(jnp.maximum(err_ratio, 1e-20))
    by_err = jnp.clip(14.0 - jnp.floor(logr * 2.0), 1.0, 14.0).astype(
        jnp.int32)
    bucket = jnp.where(should, by_err, 15)
    return np.asarray(err_ratio), np.asarray(jnp.where(must, 0, bucket))


def _check_selection(qg_np: dict, width: int, k: int):
    hh, wh = qg_np["terminated"].shape
    jset = jpl.RenderSettings(width=width, height=2 * hh)
    tset = pl.RenderSettings(width=width, height=2 * hh)
    jqg = jpl.RenderData(**{n: jnp.asarray(v) for n, v in qg_np.items()})
    tqg = pl.RenderData(**{n: _t(v) for n, v in qg_np.items()})

    jerr, jmust = jpl._refine_error_terms(jqg, jset)
    err, must = pl._refine_error_terms(tqg, tset)
    jerr = np.asarray(jerr)
    np.testing.assert_array_equal(must.numpy(), np.asarray(jmust))
    big = jerr > 1e-6
    np.testing.assert_allclose(err.numpy()[big], jerr[big], rtol=1e-4)

    jshould, jsel, jdest = jpl._select_refine_blocks(jqg, jset, k)
    should, sel, dest = pl._select_refine_blocks(tqg, tset, k)
    off_threshold = np.abs(jerr - 1.0) > 1e-5
    np.testing.assert_array_equal(should.numpy()[off_threshold],
                                  np.asarray(jshould)[off_threshold])
    np.testing.assert_array_equal(
        pl._adaptive_should_sample(tqg, tset).numpy(), should.numpy())
    assert sel.shape == (k,) and dest.shape == (hh * wh,)

    _, jbucket = _jax_buckets(jqg, jset)
    _, bucket = pl._refine_buckets(tqg, tset)
    twice_log = np.log2(np.maximum(jerr.astype(np.float64), 1e-20)) * 2.0
    off_edge = (np.abs(twice_log - np.round(twice_log)) > 1e-4) & off_threshold
    assert off_edge.mean() > 0.99
    np.testing.assert_array_equal(bucket.numpy()[off_edge],
                                  jbucket[off_edge])
    print(f"{hh}x{wh} k={k}: should {should.float().mean():.4f}, buckets "
          f"compared {off_edge.mean():.5f}, equal everywhere "
          f"{(bucket.numpy() == jbucket).all()}")

    # sel and dest from ONE bucket array (JAX's) are exact.
    perm, tdest = packing.bucket_sort_perm(
        torch.from_numpy(jbucket.reshape(-1).copy()))
    np.testing.assert_array_equal(perm[:k].numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(tdest.numpy(), np.asarray(jdest))
    if (bucket.numpy() == jbucket).all():
        np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
        np.testing.assert_array_equal(dest.numpy(), np.asarray(jdest))


# Fewer blocks than want refinement (273), the 0.375 budget, every block.
@pytest.mark.parametrize("k", [128, (int(40 * 56 * 0.375) // 8) * 8, 40 * 56])
def test_select_refine_blocks_synthetic_grid(k):
    _check_selection(_synthetic_grid(), 112, k)


def test_refine_k_is_the_reference_formula():
    """``k`` for the budget fractions the controller can ask for; the 1080p
    cap of 0.375 is 194,400 blocks."""
    assert pl._refine_k(960 * 540, 0.375) == 194400
    for nq in (16, 1024, 1536, 960 * 540):
        for frac in (*pl.RefineBudgetController.BUCKETS, 0.375, 0.01):
            want = nq if frac >= 1.0 else max(min(nq, 1024),
                                              (int(nq * frac) // 8) * 8)
            assert pl._refine_k(nq, frac) == want


# ---------------------------------------------------------------------------
# A real 64x64 frame, every intermediate by the JAX package
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_frame():
    """The JAX package's adaptive 64x64 ``kerr_boyer`` frame, stage by stage
    (``method="while"``), with the refine half at each k of ``KS``."""
    m = jmetrics.get_metric("kerr_boyer")
    cam = JCamera.default().rotate(pitch=-np.pi / 2)
    params = m.params()
    feats = JFeatures.for_metric(m)
    sky = jbg.checker_background(128, 256)
    settings = jpl.RenderSettings(
        width=W, height=H, anisotropy=8, adaptive_sampling=True,
        probe_segments=jbench.PRODUCTION_PROBE_SEGMENTS,
        refine_probe_segments=jbench.PRODUCTION_REFINE_SEGMENTS,
        trilinear=False, trace=JTrace(max_steps=STEPS, method="while"))
    psettings = dataclasses.replace(settings, width=4, height=4,
                                    adaptive_sampling=False)
    dead, psteps = jpl._prepass_dead_map(m, cam, params, psettings, feats)
    q0, ku, iquat, f_in_x, qcost = jpl._quarter_setup_jit(
        m, cam, params, settings, feats, dead, psteps, None, None)
    assert iquat is None
    qstate = jpl._trace_phases(m, q0, params, settings, feats, qcost, f_in_x)
    out = dict(m=m, cam=cam, params=params, feats=feats, sky=sky,
               settings=settings, dead=dead, q0=q0, ku=ku, qstate=qstate,
               refine={})
    for k in KS:
        (qr, should, demand, sel, dest, r0, rku, _, rf_in_x,
         rcost) = jpl._refine_setup_jit(m, cam, params, settings, feats,
                                        qstate, ku, None, k, None)
        rstate = jpl._trace_phases(m, r0, params, settings, feats, rcost,
                                   rf_in_x)
        out["refine"][k] = dict(qr=qr, should=should, demand=demand, sel=sel,
                                dest=dest, r0=r0, rku=rku, rstate=rstate)
    return out


@pytest.fixture(scope="module")
def port_scene(jax_frame):
    """The same scene's objects in the port, carried from the JAX ones."""
    m = tmetrics.get_metric("kerr_boyer")
    js = jax_frame["settings"]
    settings = pl.RenderSettings(
        width=W, height=H, anisotropy=js.anisotropy, adaptive_sampling=True,
        probe_segments=js.probe_segments,
        refine_probe_segments=js.refine_probe_segments, trilinear=False,
        trace=TraceOptions(max_steps=STEPS))
    camera = carry.camera_from_jax(jax_frame["cam"], device="cpu")
    params = carry.params_from_jax(jax_frame["params"])
    return dict(m=m, camera=camera, params=params,
                feats=Features.for_metric(m), settings=settings,
                sky=carry.background_from_jax(jax_frame["sky"], device="cpu"),
                frame=pl.camera_frame(m, camera, params))


def _assert_launch_state(ours: RayState, theirs: JRayState):
    for name in ("position", "velocity", "acceleration", "next_ds"):
        np.testing.assert_allclose(getattr(ours, name).numpy(),
                                   np.asarray(getattr(theirs, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(ours.status.numpy(),
                                  np.asarray(theirs.status))
    np.testing.assert_array_equal(ours.steps.numpy(),
                                  np.asarray(theirs.steps))


@pytest.mark.parametrize("dead_map", ["prepass", "seeded"])
def test_quarter_setup_matches_jax(jax_frame, port_scene, dead_map):
    """From JAX's prepass dead map (4x4 here: it kills nothing) and from a
    seeded one that does: the same born-DEAD quarter rays and the same
    launch state (rtol 1e-4: a tetrad, a null fix and a jvp apart)."""
    p, j = port_scene, jax_frame
    dead, want, want_ku = j["dead"], j["q0"], j["ku"]
    if dead_map == "seeded":
        dead = jnp.asarray(np.random.default_rng(2).random((4, 4)) < 0.85)
        want, want_ku, *_ = jpl._quarter_setup_jit(
            j["m"], j["cam"], j["params"], j["settings"], j["feats"], dead,
            jnp.zeros((4, 4), jnp.int32), None, None)
    state, ku = pl._quarter_setup(p["m"], p["camera"], p["frame"],
                                  p["params"], p["settings"], p["feats"],
                                  _t(dead))
    _assert_launch_state(state, want)
    np.testing.assert_allclose(ku.numpy(), np.asarray(want_ku), rtol=1e-4)
    born_dead = state.status.numpy() == 2
    if dead_map == "seeded":
        assert 0 < born_dead.sum() < born_dead.size
    # A ray born DEAD keeps the camera's position and its launch velocity.
    assert bool(torch.isfinite(state.velocity).all())
    assert bool((state.position == state.position[0]).all())


def test_quarter_setup_reuse_erodes_the_last_dead_map(jax_frame, port_scene):
    """With last frame's quarter statuses the kill mask is their DEAD map
    eroded by the 5-neighbour test, as in the JAX package."""
    p = port_scene
    qterm = jax_frame["refine"][KS[0]]["qr"].terminated
    want, *_ = jpl._quarter_setup_jit(
        jax_frame["m"], jax_frame["cam"], jax_frame["params"],
        jax_frame["settings"], jax_frame["feats"], None, None, None, qterm)
    state, _ = pl._quarter_setup(p["m"], p["camera"], p["frame"], p["params"],
                                 p["settings"], p["feats"], None, _t(qterm))
    np.testing.assert_array_equal(state.status.numpy(),
                                  np.asarray(want.status))
    dead = np.asarray(qterm) == 2
    killed = state.status.numpy() == 2
    assert killed.sum() > 0 and not (killed & ~dead).any()
    assert killed.sum() < dead.sum()  # eroded at the shadow's edge


@pytest.mark.parametrize("k", KS)
def test_select_refine_blocks_real_frame(jax_frame, k):
    qr = jax_frame["refine"][k]["qr"]
    qg = {n: np.asarray(f).reshape((H // 2, W // 2) + f.shape[1:])
          for n, f in zip(jpl.RenderData._fields, qr)}
    _check_selection(qg, W, k)


@pytest.mark.parametrize("k", KS)
def test_refine_setup_matches_jax(jax_frame, port_scene, k):
    """Fed JAX's marched quarter state: the quarter render data, the
    selection, the demand and the refine rays (those of blocks that do not
    want refinement born DEAD)."""
    p, ref = port_scene, jax_frame["refine"][k]
    qr, should, demand, sel, dest, rstate, rku = pl._refine_setup(
        p["m"], p["camera"], p["frame"], p["params"], p["settings"],
        p["feats"], _tuple_t(RayState, jax_frame["qstate"]),
        _t(jax_frame["ku"]), k)
    _assert_rdata(qr, ref["qr"])
    np.testing.assert_array_equal(should.numpy(), np.asarray(ref["should"]))
    np.testing.assert_array_equal(sel.numpy(), np.asarray(ref["sel"]))
    np.testing.assert_array_equal(dest.numpy(), np.asarray(ref["dest"]))
    assert demand.shape == () and float(demand) == pytest.approx(
        float(ref["demand"]), abs=1e-6)
    assert rstate.position.shape == (3 * k, 4)
    _assert_launch_state(rstate, ref["r0"])
    np.testing.assert_allclose(rku.numpy(), np.asarray(ref["rku"]), rtol=1e-4)


def _finish_operands(jax_frame, k):
    ref = jax_frame["refine"][k]
    return (_tuple_t(RayState, ref["rstate"]), _t(ref["rku"]),
            _tuple_t(pl.RenderData, ref["qr"]), _t(ref["should"]),
            _t(ref["sel"]).long(), _t(ref["dest"]).long())


@pytest.mark.parametrize("k", KS)
def test_finish_matches_jax(jax_frame, port_scene, k):
    """``_finish`` (refine render data, scatter, ``_adaptive_assemble``) fed
    JAX's ``qr``, ``should``, ``sel``, ``dest`` and marched refine state."""
    p, ref = port_scene, jax_frame["refine"][k]
    want, want_rsteps = jpl._finish_jit(
        jax_frame["m"], ref["rstate"], ref["rku"], None, jax_frame["params"],
        jax_frame["feats"], ref["qr"], ref["should"], ref["sel"], ref["dest"],
        jax_frame["settings"], k)
    rstate, rku, qr, should, sel, dest = _finish_operands(jax_frame, k)
    got, rsteps = pl._finish(p["m"], rstate, rku, p["params"], p["feats"], qr,
                             should, sel, dest, p["settings"], k)
    assert got.tex_coord.shape == (W * H, 2)
    _assert_rdata(got, want)
    np.testing.assert_array_equal(rsteps.numpy(), np.asarray(want_rsteps))
    assert (rsteps.numpy() > 0).sum() <= k


@pytest.mark.parametrize("k", KS)
def test_finish_shade_matches_jax(jax_frame, port_scene, k):
    """``_finish_shade`` on the same operands: RGB to 2e-3 (membership of
    the probe-demand prefix may fall differently on ties, which the probe
    budget turns into a small blur difference), step feedback exact."""
    p, ref = port_scene, jax_frame["refine"][k]
    want, want_rsteps = jpl._finish_shade_jit(
        jax_frame["m"], ref["rstate"], ref["rku"], None, jax_frame["params"],
        jax_frame["feats"], ref["qr"], ref["should"], ref["sel"], ref["dest"],
        jax_frame["sky"], jax_frame["settings"], k)
    rstate, rku, qr, should, sel, dest = _finish_operands(jax_frame, k)
    got, rsteps = pl._finish_shade(p["m"], rstate, rku, p["params"],
                                   p["feats"], qr, should, sel, dest,
                                   p["sky"], p["settings"], k)
    assert got.shape == (H, W, 3) and bool(torch.isfinite(got).all())
    d = np.abs(got.numpy() - np.asarray(want))
    print(f"k={k}: max |dRGB| {d.max():.3g}, mean {d.mean():.3g}")
    assert d.max() < 2e-3, d.max()
    np.testing.assert_array_equal(rsteps.numpy(), np.asarray(want_rsteps))


def test_adaptive_assemble_synthetic_grid():
    """``_adaptive_assemble`` alone, on seeded grids: interpolated cells
    where ``should`` is false, the traced parts elsewhere."""
    grids = [_synthetic_grid(seed=s) for s in range(4)]
    should = np.random.default_rng(9).random((40, 56)) < 0.4
    jset = jpl.RenderSettings(width=112, height=80)
    tset = pl.RenderSettings(width=112, height=80)
    want = jpl._adaptive_assemble(
        *(jpl.RenderData(**{n: jnp.asarray(v) for n, v in g.items()})
          for g in grids), jnp.asarray(should), jset)
    got = pl._adaptive_assemble(
        *(pl.RenderData(**{n: torch.from_numpy(v) for n, v in g.items()})
          for g in grids), torch.from_numpy(should), tset)
    _assert_rdata(got, want)


# ---------------------------------------------------------------------------
# Settings, schedules and the controller
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(probe_segments=bench_config.PRODUCTION_PROBE_SEGMENTS,
         refine_probe_segments=bench_config.PRODUCTION_REFINE_SEGMENTS),
    dict(probe_segments=bench_config.PRODUCTION_PROBE_SEGMENTS),
    dict(probe_segments=((0.072, 8), (0.11, 4), (0.17, 2))),
    dict(probe_segments=((0.2, 7), (0.1, 5), (0.3, 3))),  # 4x overflows 1
    dict(),
])
def test_refine_segments_equal_jax(kw):
    assert (pl._refine_segments(pl.RenderSettings(**kw))
            == jpl._refine_segments(jpl.RenderSettings(**kw)))


def test_flagship_config_equals_the_reference():
    """Every settings field the port has equals the reference's flagship
    value (the trace options but for ``max_steps`` are TPU tuning)."""
    assert (bench_config.PRODUCTION_REFINE_SEGMENTS
            == jbench.PRODUCTION_REFINE_SEGMENTS)
    *_, jset, jfeat = jbench.flagship_config()
    metric, params, camera, settings, feats = bench_config.flagship_config(
        device="cpu")
    assert settings.adaptive_sampling and settings.shade_traced_only
    for f in dataclasses.fields(settings):
        if f.name != "trace":
            assert getattr(settings, f.name) == getattr(jset, f.name), f.name
    assert settings.trace.max_steps == jset.trace.max_steps
    assert tuple(feats) == pytest.approx(tuple(jfeat))
    defaults, jdefaults = pl.RenderSettings(), jpl.RenderSettings()
    for f in dataclasses.fields(defaults):
        if f.name != "trace":
            assert getattr(defaults, f.name) == getattr(jdefaults, f.name)


def test_refine_budget_controller_logic():
    """Bucket selection: grow immediately, shrink only with patience."""
    c = pl.RefineBudgetController(margin=1.3, latency=0, down_patience=3)
    assert c.fraction(0.375) == 0.375  # no data yet -> the cap
    c.observe(np.float32(0.10))  # want 0.13 -> bucket 3/16
    assert c.fraction(0.375) == 3 / 16
    c.observe(np.float32(0.40))  # want 0.52 -> bucket 3/4, grows at once
    assert c.fraction(0.375) == 0.375  # capped
    assert c.fraction(1.0) == 3 / 4
    # shrink needs down_patience consecutive low frames
    c.observe(np.float32(0.05))
    c.observe(np.float32(0.05))
    assert c.fraction(1.0) == 3 / 4
    c.observe(np.float32(0.05))
    assert c.fraction(1.0) == 1 / 8
    # demand above every bucket clamps to 1.0
    c2 = pl.RefineBudgetController(latency=0)
    c2.observe(np.float32(0.9))
    assert c2.fraction(1.0) == 1.0


def test_refine_budget_controller_latency_and_tensors():
    """A 0-d tensor demand is read ``latency`` observations later."""
    c = pl.RefineBudgetController(latency=2)
    assert pl.RefineBudgetController.BUCKETS == jpl.RefineBudgetController.BUCKETS
    c.observe(torch.tensor(0.10))
    c.observe(torch.tensor(0.10))
    assert c.fraction(1.0) == 1.0  # nothing matured yet
    c.observe(torch.tensor(0.9))
    assert c.fraction(1.0) == 3 / 16  # the first frame's demand


def test_stream_key_follows_object_identity(port_scene):
    p = port_scene
    key = pl._stream_key(p["camera"], p["params"], p["feats"])
    assert key == pl._stream_key(p["camera"], dict(p["params"]),
                                 Features(*p["feats"]))
    rebuilt = p["camera"]._replace(quat=p["camera"].quat.clone())
    assert key != pl._stream_key(rebuilt, p["params"], p["feats"])
    assert key != pl._stream_key(p["camera"], {**p["params"], "a": 0.25},
                                 p["feats"])
