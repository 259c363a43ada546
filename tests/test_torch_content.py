"""Content packs of torch metrics (port of ``geodesic_raytracing_tpu.content``)
held to the JAX package's loader and to its pack metric.

The loader twin of ``tests/test_content.py`` (inheritance, a broken entry,
``sorting.json``), pack-local charts and origins, and the example pack
``examples/pack_torch`` (Reissner-Nordstrom, the torch twin of
``examples/pack``) against JAX's on the same seeded inputs:

* ``g`` on 256 seeded events: rtol 1e-5, atol 1e-6 of the largest entry;
* the 64-ray march (``make_rays(64)``, 4096 trial iterations): fates equal
  on every ray and step counts on at least 62 of 64 (JAX divides ``rs / r``
  where torch multiplies by ``1 / r``: an ulp that a photon-ring ray can
  carry into a step), positions within 1e-3 where the counts agree;
* the 64x64 frame through each package's pipeline: the golden gate (sRGB
  RMSE < 4, under 1% of pixels off by more than 32).

Loading with ``register=True`` adds to the port's registries; the
``registries`` fixture puts them back as they were.
"""

import json
import math
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geodesic_raytracing_tpu import content as jcontent
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.ops import integrate as jint
from geodesic_raytracing_tpu.render import background as jbg
from geodesic_raytracing_tpu.render import colour as jcolour
from geodesic_raytracing_tpu.render import pipeline as jpl
from geodesic_raytracing_tpu_torch import cli, content
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.coordinates import transforms as ttr
from geodesic_raytracing_tpu_torch.metrics import base as tbase
from geodesic_raytracing_tpu_torch.ops import integrate as tint
from geodesic_raytracing_tpu_torch.ops import raymarch
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render import colour
from geodesic_raytracing_tpu_torch.render import pipeline as pl
from test_integrator import make_rays

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PACK_TORCH = REPO / "examples" / "pack_torch"
PACK_JAX = REPO / "examples" / "pack"


@pytest.fixture
def registries():
    saved = (dict(tbase.REGISTRY), dict(tbase.ORIGINS),
             dict(ttr.TRANSFORMS), dict(ttr.PERIODICITY))
    yield
    for live, old in zip((tbase.REGISTRY, tbase.ORIGINS, ttr.TRANSFORMS,
                          ttr.PERIODICITY), saved):
        live.clear()
        live.update(old)


def make_pack(tmp_path):
    """The torch twin of tests/test_content.py::make_pack, with a chart and
    an origin of its own."""
    (tmp_path / "my_hole.py").write_text(textwrap.dedent("""
        import torch
        from geodesic_raytracing_tpu_torch.metrics.base import diag_metric

        DEFAULTS = {"rs": 2.0}
        DIAGONAL = True
        SPHERICALLY_SYMMETRIC = True
        DEPENDS_ON = (1, 2)

        def metric(x, params):
            rs = params["rs"]
            r, theta = x[1], x[2]
            st = torch.sin(theta)
            f = 1.0 - rs / r
            return diag_metric(-f, 1.0 / f, r * r, r * r * st * st)
    """))
    (tmp_path / "my_hole.json").write_text(json.dumps({
        "name": "my_hole",
        "inherit_settings": "local_base",
        "max_acceleration_change": 1e-5,
    }))
    (tmp_path / "local_base.json").write_text(json.dumps({
        "inherit_settings": "polar_base",
        "singular": True,
        "singular_terminator": 2.1,
    }))
    (tmp_path / "broken.py").write_text("def metric(x, params): raise 1\n"
                                        "syntax error here")
    (tmp_path / "sorting.json").write_text(json.dumps(
        ["my_hole.py", "broken.py"]))
    (tmp_path / "coordinates").mkdir()
    (tmp_path / "coordinates" / "my_pack_to_polar.py").write_text(
        "def transform(x, params):\n    return x\n")
    (tmp_path / "origins").mkdir()
    (tmp_path / "origins" / "my_pack_origin.py").write_text(
        "def origin(polar, params):\n    return polar[1] * 2.0\n")
    return tmp_path


def test_load_pack(tmp_path, registries):
    pack = content.load_pack(make_pack(tmp_path), register=False)
    assert "my_hole" in pack.metrics
    assert "broken" in pack.broken and "SyntaxError" in pack.broken["broken"]
    m = pack.metrics["my_hole"]
    assert m.config.singular is True
    assert m.config.singular_terminator == 2.1
    assert m.config.max_acceleration_change == 1e-5
    assert m.config.to_polar == "polar_to_polar"
    assert m.defaults == {"rs": 2.0}
    assert m.depends_on == (1, 2)
    assert pack.order == ["my_hole"]
    assert "my_hole" not in tbase.REGISTRY
    # Pack-local chart and origin are registered under their stems.
    assert "my_pack_to_polar" in ttr.TRANSFORMS
    assert float(tbase.ORIGINS["my_pack_origin"](
        torch.tensor([0.0, 3.0, 1.0, 0.0]), {})) == 6.0
    g = m.fn(torch.tensor([0.0, 8.0, 1.2, 0.3]), m.params())
    np.testing.assert_allclose(float(g[0, 0]), -(1 - 2.0 / 8.0), rtol=1e-6)
    # The JAX loader reads the same configs the same way.
    jdir = tmp_path / "jax"
    jdir.mkdir()
    for f in ("my_hole.json", "local_base.json", "sorting.json"):
        (jdir / f).write_text((tmp_path / f).read_text())
    (jdir / "my_hole.py").write_text(
        (tmp_path / "my_hole.py").read_text()
        .replace("import torch", "import jax.numpy as jnp")
        .replace("torch.sin", "jnp.sin")
        .replace("geodesic_raytracing_tpu_torch", "geodesic_raytracing_tpu"))
    jm = jcontent.load_pack(jdir, register=False).metrics["my_hole"]
    for f in ("singular", "singular_terminator", "max_acceleration_change",
              "to_polar", "from_polar", "origin_distance",
              "coordinate_system", "adaptive_precision",
              "detect_singularities"):
        assert getattr(jm.config, f) == getattr(m.config, f), f


def test_loaded_pack_registers_and_emits(tmp_path, registries):
    """Loading registers the pack's metrics; the kernel wrapper's instance
    of such a metric is emitted from its function (no nvcc is needed for
    that), and a rank-1 pack metric raises naming the cause."""
    content.load_pack(make_pack(tmp_path))
    m = tbase.get_metric("my_hole")
    inst = raymarch.instance_of(m)
    assert inst.label == "my_hole" and inst.struct.startswith(
        "Emitted_my_hole_")
    assert "singular_terminator = 0x1.0ccccc0000000p+1f" in inst.header
    (tmp_path / "rank1_hole.py").write_text(textwrap.dedent("""
        import torch
        from geodesic_raytracing_tpu_torch.metrics.base import minkowski_plus

        def RANK1(x, params):
            return x[1] * 0 + 1.0, torch.stack([x[1] * 0 + 1.0] * 4)

        def metric(x, params):
            return minkowski_plus(*RANK1(x, params))
    """))
    content.load_pack(tmp_path)
    with pytest.raises(NotImplementedError, match="rank-1"):
        raymarch.instance_of(tbase.get_metric("rank1_hole"))


def _rn_pair():
    tm = content.load_pack(PACK_TORCH, register=False).metrics[
        "reissner_nordstrom"]
    jm = jcontent.load_pack(PACK_JAX, register=False).metrics[
        "reissner_nordstrom"]
    return tm, jm


def test_pack_metric_matches_jax():
    tm, jm = _rn_pair()
    assert tm.defaults == jm.defaults and tm.depends_on == jm.depends_on
    rng = np.random.default_rng(10)
    x = np.stack([rng.uniform(-5, 5, 256), rng.uniform(1.2, 30, 256),
                  rng.uniform(0.1, 3.0, 256), rng.uniform(-3, 3, 256)]
                 ).astype(np.float32)
    got = tm.fn(torch.from_numpy(x), tm.params()).numpy()
    want = np.asarray(jm.g(jnp.asarray(x), jm.params()))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


def test_pack_march_matches_jax():
    tm, jm = _rn_pair()
    pos, vel = (np.array(a) for a in make_rays(64))
    jf = jint.Features.for_metric(jm)
    jst = jint.init_ray_state(jm, jnp.asarray(pos), jnp.asarray(vel),
                              params=jm.params(), features=jf)
    jfin = jint.trace_rays(jm, jst, jm.params(), features=jf,
                           opts=jint.TraceOptions(max_steps=4096))
    tf = tint.Features.for_metric(tm)
    tst = tint.init_ray_state(tm, torch.from_numpy(pos),
                              torch.from_numpy(vel), tm.params(), tf)
    tfin = tint.trace_rays_reference(tm, tst, tm.params(), tf,
                                     tint.TraceOptions(max_steps=4096))
    np.testing.assert_array_equal(tfin.status.numpy(),
                                  np.asarray(jfin.status))
    assert set(np.asarray(jfin.status)) <= {1, 2}
    same = tfin.steps.numpy() == np.asarray(jfin.steps)
    assert same.sum() >= 62, same.sum()
    np.testing.assert_allclose(tfin.position.numpy()[same],
                               np.asarray(jfin.position)[same], rtol=1e-3,
                               atol=1e-3)


def test_pack_frame_matches_jax():
    """The Reissner-Nordstrom 64x64 frame (2048 steps) of examples/pack_torch
    through the port's pipeline against JAX's from examples/pack."""
    tm, jm = _rn_pair()
    img = pl.render_frame(
        tm, Camera.default(device="cpu").rotate(pitch=-math.pi / 2),
        tm.params(), bg.checker_background(128, 256, device="cpu"),
        pl.RenderSettings(width=64, height=64, anisotropy=2,
                          trace=tint.TraceOptions(max_steps=2048)),
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


def test_cli_content_lists_and_reports(tmp_path, registries, capsys):
    """``--content`` loads a pack (its metrics join ``--list``) and reports
    a broken entry."""
    assert cli.main(["--content", str(make_pack(tmp_path)), "--content",
                     str(PACK_TORCH), "--list"]) == 0
    out = capsys.readouterr().out
    assert "loaded pack" in out and "(broken) broken: SyntaxError" in out
    names = out.splitlines()
    assert "my_hole" in names and "reissner_nordstrom" in names
    assert "kerr_boyer" in names
