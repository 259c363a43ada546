"""A content pack of the new emitted forms against its JAX pack: a rank-1
(``RANK1``) Kerr-Schild pack, written into ``tmp_path`` for each package.

As ``tests/test_torch_content.py`` holds a pack (the 64-ray march of
``make_rays(64)`` from each package's launch state, 4096 trial iterations:
fates equal on every ray, step counts on at least 62 of 64, positions within
1e-3 where the counts agree, the rays killed at the ring held as
``kerr_schild``'s are, see ``assert_march_matches_jax``; the 64x64 frame:
sRGB RMSE < 4 and under 1% of pixels off by more than 32), and its emitted
structs, dynamic and baked, built by g++ and marched on the host against the
plain march of their twin parameters by the Kerr family's rule of
``tests/test_torch_raymarch_host.py`` (the pack's decomposition is
``kerr_schild``'s formula as a pack author writes it, with divisions
instead of reciprocals).  The JAX pack's
decomposition is the same formula on ``jnp``.
"""

import math
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_emit_host as eh
from geodesic_raytracing_tpu import content as jcontent
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.ops import integrate as jint
from geodesic_raytracing_tpu.render import background as jbg
from geodesic_raytracing_tpu.render import colour as jcolour
from geodesic_raytracing_tpu.render import pipeline as jpl
from geodesic_raytracing_tpu_torch import content
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.metrics.catalogue_kerr import (
    _kerr_schild_r)
from geodesic_raytracing_tpu_torch.ops import emit, integrate
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render import colour
from geodesic_raytracing_tpu_torch.render import pipeline as pl
from test_integrator import make_rays
from test_torch_metrics_catalogue_c import RING_R

torch.set_num_threads(1)

RANK1_PACK = """
import {np} as np_
from {pkg}.metrics.base import minkowski_plus

DEFAULTS = {{"a": -0.5, "rs": 1.0}}
DEPENDS_ON = (1, 2, 3)


def RANK1(x, params):
    a, rs = params["a"], params["rs"]
    xx, y, z = x[1], x[2], x[3]
    R2 = xx * xx + y * y + z * z
    Rm2 = xx * xx + y * y - z * z
    r2 = (-a * a + np_.sqrt(a ** 4 - 2.0 * a * a * Rm2 + R2 * R2) + R2) / 2.0
    r = np_.sqrt(r2)
    lv = np_.stack([np_.ones_like(r), (r * xx + a * y) / (r2 + a * a),
                    (r * y - a * xx) / (r2 + a * a), z / r])
    f = rs * r2 * r / (r2 * r2 + a * a * z * z)
    return f, lv


def metric(x, params):
    return minkowski_plus(*RANK1(x, params))
"""
RANK1_CONFIG = ('{"name": "ks_pack", "inherit_settings": "cartesian_base", '
                '"use_prepass": true, "max_acceleration_change": 1e-6}')


def pack_pair(tmp_path, stem, torch_text, jax_text, config):
    """The torch pack ``torch_text`` and the JAX pack ``jax_text`` with
    the config ``config``, loaded without registering: ``(torch metric,
    JAX metric)``."""
    out = []
    for sub, text, load in (("torch", torch_text, content.load_pack),
                            ("jax", jax_text, jcontent.load_pack)):
        d = tmp_path / sub
        d.mkdir()
        (d / f"{stem}.py").write_text(textwrap.dedent(text))
        (d / f"{stem}.json").write_text(config)
        pack = load(d, register=False)
        assert not pack.broken, pack.broken
        out.append(next(iter(pack.metrics.values())))
    return tuple(out)


def in_both(text, **torch_kw):
    """``text`` formatted for the torch pack and for the JAX pack: ``np``
    the array module, ``pkg`` the package (and ``torch_kw`` / their JAX
    values, as pairs)."""
    return tuple(text.format(
        np=np_, pkg=pkg, **{k: v[i] for k, v in torch_kw.items()})
        for i, (np_, pkg) in enumerate((
            ("torch", "geodesic_raytracing_tpu_torch"),
            ("jax.numpy", "geodesic_raytracing_tpu"))))


def launch(tm):
    """``make_rays(64)`` in the pack's chart (polar position and velocity
    through its ``from_polar``), as numpy arrays."""
    pos, vel = (torch.from_numpy(np.array(a)).T for a in make_rays(64))
    params = tm.params()
    return (tm.from_polar(pos, params).T.contiguous().numpy(),
            tm.from_polar_velocity(pos, vel, params).T.contiguous().numpy())


def assert_march_matches_jax(tm, jm, ring=False):
    """``ring``: a Kerr-Schild pack, whose rays killed at the ring keep the
    rule of ``test_torch_metrics_catalogue_c.assert_march_parity_c``: there
    the step counts within 2% (JAX's rank-1 acceleration takes its gradient
    term by a transposed linearisation, the port's by a forward pass: the
    ring's kills come a step apart, ROADMAP Queue 3, PR 8), and they do not
    count against the 62 of 64."""
    pos, vel = launch(tm)
    jf = jint.Features.for_metric(jm)
    jst = jint.init_ray_state(jm, jnp.asarray(pos), jnp.asarray(vel),
                              params=jm.params(), features=jf)
    jfin = jint.trace_rays(jm, jst, jm.params(), features=jf,
                           opts=jint.TraceOptions(max_steps=4096))
    tf = integrate.Features.for_metric(tm)
    tst = integrate.init_ray_state(tm, torch.from_numpy(pos),
                                   torch.from_numpy(vel), tm.params(), tf)
    tfin = integrate.trace_rays_reference(
        tm, tst, tm.params(), tf, integrate.TraceOptions(max_steps=4096))
    status = np.asarray(jfin.status)
    np.testing.assert_array_equal(tfin.status.numpy(), status)
    assert (status == integrate.ESCAPED).sum() >= 16
    js, ts = np.asarray(jfin.steps), tfin.steps.numpy()
    same = ts == js
    at_ring = np.zeros_like(same)
    if ring:
        x = torch.from_numpy(np.asarray(jfin.position)).T
        r = _kerr_schild_r(x, tm.params()["a"])[1].numpy()
        at_ring = (status == integrate.DEAD) & (r < RING_R)
        assert (np.abs(ts - js)[at_ring] <= 0.02 * js[at_ring]).all()
    assert (same | at_ring).sum() >= 62, (same.sum(), at_ring.sum())
    np.testing.assert_allclose(tfin.position.numpy()[same],
                               np.asarray(jfin.position)[same], rtol=1e-3,
                               atol=1e-3)


def assert_frame_matches_jax(tm, jm):
    """The 64x64 frame (2048 steps) through each package's pipeline, from
    the default camera pitched to the hole."""
    img = pl.render_frame(
        tm, Camera.default(device="cpu").rotate(pitch=-math.pi / 2),
        tm.params(), bg.checker_background(128, 256, device="cpu"),
        pl.RenderSettings(width=64, height=64, anisotropy=2,
                          trace=integrate.TraceOptions(max_steps=2048)),
        device="cpu")
    jimg = jpl.render_frame(
        jm, JCamera.default().rotate(pitch=-np.pi / 2), jm.params(),
        jbg.checker_background(128, 256),
        jpl.RenderSettings(width=64, height=64, anisotropy=2,
                           trace=jint.TraceOptions(max_steps=2048,
                                                   method="while")))
    ours = (np.clip(colour.lin_to_srgb(img).numpy(), 0, 1) * 255
            ).astype(np.uint8)
    theirs = (np.clip(np.asarray(jcolour.lin_to_srgb(jimg)), 0, 1) * 255
              ).astype(np.uint8)
    assert (ours.sum(-1) == 0).any()  # the shadow
    d = np.abs(ours.astype(int) - theirs.astype(int))
    rmse = float(np.sqrt((d.astype(float) ** 2).mean()))
    assert rmse < 4.0, rmse
    assert (d > 32).mean() < 0.01


def emitted_vs_plain(tm, tmp_path, mode, assert_same):
    """The pack's emitted struct (``mode``: dynamic or baked) marched on
    the host against the plain march of its twin parameters, held by
    ``assert_same(got, ref)``."""
    params = tm.params()
    h = emit.emit_metric(tm, None if mode == "dynamic" else params)
    lib = eh.build([h], tmp_path)
    st, feats = eh.launch_state(tm, params)
    opts = integrate.TraceOptions(max_steps=4096)
    twin = emit.tensor_params(params, "cpu") if mode == "dynamic" else params
    got = eh.host_march(lib[h.struct], h, st, params, feats, opts)
    ref = integrate.trace_rays_reference(tm, st, twin, feats, opts)
    assert_same(got, ref)
    for a, b in zip(got, st):  # rays born DEAD are untouched
        np.testing.assert_array_equal(a.numpy()[::7], b.numpy()[::7])
    return h


@pytest.fixture
def ks(tmp_path):
    return pack_pair(tmp_path, "ks_pack", *in_both(RANK1_PACK), RANK1_CONFIG)


def test_rank1_pack_march_matches_jax(ks):
    tm, jm = ks
    assert tm.rank1 is not None and jm.rank1 is not None
    assert_march_matches_jax(tm, jm, ring=True)


def test_rank1_pack_frame_matches_jax(ks):
    assert_frame_matches_jax(*ks)


@pytest.mark.parametrize("mode", ["dynamic", "baked"])
def test_rank1_pack_emitted_march_matches_plain(ks, tmp_path, mode):
    h = emitted_vs_plain(ks[0], tmp_path, mode, eh.assert_kerr_family)
    assert "auto fl(" in h.text and " g(" not in h.text
