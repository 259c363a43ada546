"""Image skies: ``render.background.load_background`` of the port (its own
PNG decoder, ``cli.read_png``) against the JAX package's (imageio) on PNGs
the test writes itself: RGB, grey, grey + alpha and RGBA, with every row
filter type (row y takes filter y % 5).

Tolerances: the linear images (sRGB -> linear, float32) within atol 1e-6;
the packed rgb10 atlases (every mip level of both sides) within one 10-bit
step of each other everywhere and equal on at least 99.9% of texels (a
linear value on a rounding edge of the 10-bit quantisation can fall either
way by an ulp of the sRGB power).  The 64x64 frame with the image sky
against JAX's: the golden gate (sRGB RMSE < 4, under 1% of pixels off by
more than 32).
"""

import math
import struct
import zlib

import imageio.v3 as iio
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu.camera import Camera as JCamera
from geodesic_raytracing_tpu.ops import integrate as jint
from geodesic_raytracing_tpu.render import background as jbg
from geodesic_raytracing_tpu.render import colour as jcolour
from geodesic_raytracing_tpu.render import pipeline as jpl
from geodesic_raytracing_tpu_torch import cli, metrics
from geodesic_raytracing_tpu_torch.camera import Camera
from geodesic_raytracing_tpu_torch.ops import integrate as tint
from geodesic_raytracing_tpu_torch.render import background as bg
from geodesic_raytracing_tpu_torch.render import colour
from geodesic_raytracing_tpu_torch.render import pipeline as pl

torch.set_num_threads(1)

CTYPES = {"grey": (0, 1), "rgb": (2, 3), "grey_alpha": (4, 2), "rgba": (6, 4)}


def _paeth(a, b, c):
    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
    return a if pa <= pb and pa <= pc else b if pb <= pc else c


def encode_png(path, px: np.ndarray, ctype: int) -> None:
    """An 8-bit PNG of ``px`` (H, W, C) with row y filtered by type y % 5."""
    h, w, c = px.shape
    rows, prev = [], np.zeros(w * c, np.int64)
    for y in range(h):
        cur = px[y].reshape(-1).astype(np.int64)
        f = y % 5
        out = np.zeros_like(cur)
        for i in range(len(cur)):
            a = cur[i - c] if i >= c else 0
            b = prev[i]
            cc = prev[i - c] if i >= c else 0
            pred = (0, a, b, (a + b) // 2, _paeth(a, b, cc))[f]
            out[i] = (cur[i] - pred) & 0xFF
        rows.append(bytes([f]) + out.astype(np.uint8).tobytes())
        prev = cur

    def chunk(tag, data):
        body = tag + data
        return (struct.pack(">I", len(data)) + body
                + struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF))

    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n"
                 + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0,
                                              0, 0))
                 + chunk(b"IDAT", zlib.compress(b"".join(rows), 6))
                 + chunk(b"IEND", b""))


def sky(seed, h=32, w=64, c=3):
    """A seeded sky: smooth bands plus noise, every byte value in use."""
    rng = np.random.default_rng(seed)
    v, u = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                       indexing="ij")
    base = np.stack([np.sin(7 * u + k) * np.cos(5 * v - k)
                     for k in range(c)], -1)
    px = (base * 90 + 128 + rng.integers(-40, 40, (h, w, c))).clip(0, 255)
    return px.astype(np.uint8)


def _atlas(b):
    p = np.asarray(b.packed.cpu() if isinstance(b.packed, torch.Tensor)
                   else b.packed).view(np.uint32)
    return np.stack([(p >> s) & 1023 for s in (20, 10, 0)], -1)


@pytest.mark.parametrize("kind", list(CTYPES))
def test_load_background_matches_jax(tmp_path, kind):
    ctype, c = CTYPES[kind]
    px, px2 = sky(1, c=c), sky(2, c=c)
    p, p2 = tmp_path / "a.png", tmp_path / "b.png"
    encode_png(p, px, ctype)
    encode_png(p2, px2, ctype)
    # The decoder: bytes equal to imageio's, grey widened, alpha dropped.
    want = iio.imread(p)
    want = np.stack([want] * 3, -1) if want.ndim == 2 else want
    if kind == "grey_alpha":
        want = np.repeat(want[..., :1], 3, -1)
    np.testing.assert_array_equal(cli.read_png(p), want[..., :3])
    lin = colour.srgb_to_lin(torch.from_numpy(
        cli.read_png(p).astype(np.float32) / 255.0)).numpy()
    jlin = np.asarray(jcolour.srgb_to_lin(jnp.asarray(
        want[..., :3].astype(np.float32) / 255.0)))
    np.testing.assert_allclose(lin, jlin, rtol=0, atol=1e-6)
    ours = bg.load_background(str(p), str(p2), device="cpu")
    if kind == "grey_alpha":
        # JAX's loader keeps a grey + alpha image's two channels and fails
        # in build_background (ROADMAP Queue 3): hold the port to JAX's
        # load of the same grey pixels without alpha.
        with pytest.raises(IndexError):
            jbg.load_background(str(p), str(p2))
        p, p2 = tmp_path / "ga.png", tmp_path / "gb.png"
        encode_png(p, px[..., :1], 0)
        encode_png(p2, px2[..., :1], 0)
    theirs = jbg.load_background(str(p), str(p2))
    assert ours.level_w == tuple(theirs.level_w)
    a, b = _atlas(ours), _atlas(theirs)
    assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
    assert (a == b).all(-1).mean() >= 0.999


def test_load_background_refuses_jpeg(tmp_path):
    p = tmp_path / "sky.jpg"
    p.write_bytes(b"\xff\xd8\xff\xe0" + bytes(64))
    with pytest.raises(ValueError, match="JPEG"):
        bg.load_background(str(p), device="cpu")


def test_image_sky_frame_matches_jax(tmp_path):
    p = tmp_path / "sky.png"
    encode_png(p, sky(3, 64, 128), 2)
    tm, jm = metrics.get_metric("schwarzschild"), jmetrics.get_metric(
        "schwarzschild")
    img = pl.render_frame(
        tm, Camera.default(device="cpu").rotate(pitch=-math.pi / 2),
        tm.params(), bg.load_background(str(p), device="cpu"),
        pl.RenderSettings(width=64, height=64, anisotropy=2,
                          trace=tint.TraceOptions(max_steps=2048)),
        device="cpu")
    jimg = jpl.render_frame(
        jm, JCamera.default().rotate(pitch=-np.pi / 2), jm.params(),
        jbg.load_background(str(p)),
        jpl.RenderSettings(width=64, height=64, anisotropy=2,
                           trace=jint.TraceOptions(max_steps=2048,
                                                   method="while")))
    ours = (np.clip(colour.lin_to_srgb(img).numpy(), 0, 1) * 255
            ).astype(np.uint8)
    theirs = (np.clip(np.asarray(jcolour.lin_to_srgb(jimg)), 0, 1) * 255
              ).astype(np.uint8)
    assert ours.std() > 10  # the sky's pattern, not a flat fill
    d = np.abs(ours.astype(int) - theirs.astype(int))
    assert float(np.sqrt((d.astype(float) ** 2).mean())) < 4.0
    assert (d > 32).mean() < 0.01
