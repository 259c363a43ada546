"""Skysphere backgrounds: mip atlas + anisotropic (EWA) equirect sampling
(port of ``geodesic_raytracing_tpu.render.background``).

All mip levels sit side by side in one atlas so a per-pixel mip level is an
index, not a shape.  Two atlases are carried for two-sided universes
(``side`` picks one).  Texels are rgb10 words: torch has only partial
``uint32`` support, so the words are kept as ``int32`` with the same bits
(only bits 0-29 are used, so ``>>`` and ``& 0x3FF`` decode them unchanged).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import runtime
from ..ops import packing

Tensor = torch.Tensor

MIP_LEVELS = 10  # reference uses 10 (graphics_settings.cpp:165)


@dataclasses.dataclass(frozen=True)
class Background:
    """Mip atlas for both universe sides, one rgb10 texel per int32 word.

    ``packed``: (2 * H * 2W,) flat row-major (2, H, 2W) atlas; level l of
    side s occupies columns ``level_x[l]:level_x[l]+level_w[l]`` of rows
    ``:level_h[l]``.  ``quad``: (2 * H * 2W, 4) — every texel's wrap-correct
    2x2 neighbourhood [c00, c01, c10, c11], for one-row bilinear taps.
    ``level_w, level_h, level_x``: per-level sizes and x offsets (ints).
    """

    packed: Tensor
    quad: Tensor
    level_w: tuple
    level_h: tuple
    level_x: tuple

    @property
    def atlas_h(self) -> int:
        return self.level_h[0]

    @property
    def atlas_w(self) -> int:
        return 2 * self.level_w[0]

    @property
    def levels(self) -> int:
        return len(self.level_w)

    @property
    def pow2(self) -> bool:
        """True when every level size is a power of two and levels halve
        exactly — wrap becomes AND, level tables become shifts."""
        w0, h0 = self.level_w[0], self.level_h[0]
        if w0 & (w0 - 1) or h0 & (h0 - 1):
            return False
        return all(
            self.level_w[l] == max(w0 >> l, 1)
            and self.level_h[l] == max(h0 >> l, 1)
            and self.level_x[l] == 2 * w0 - max((2 * w0) >> l, 2)
            for l in range(self.levels)
        )

    def to(self, device) -> "Background":
        return dataclasses.replace(self, packed=self.packed.to(device),
                                   quad=self.quad.to(device))


def build_background(image: np.ndarray, image2: np.ndarray | None = None,
                     levels: int = MIP_LEVELS, device="cpu") -> Background:
    """Mip atlas from (H, W, 3) float32 linear images."""
    image = np.asarray(image, dtype=np.float32)
    if image2 is None:
        image2 = image
    image2 = np.asarray(image2, dtype=np.float32)
    if image.shape != image2.shape:
        raise ValueError("both sides must share dimensions")

    H, W, _ = image.shape
    levels = min(levels, int(np.log2(min(H, W))) + 1)

    a1, lw, lh, lx = runtime.build_mips(image, max_levels=levels)
    a2, _, _, _ = runtime.build_mips(image2, max_levels=levels)
    atlas = np.stack([a1, a2])

    q = (np.clip(atlas, 0.0, 1.0) * 1023.0 + 0.5).astype(np.uint32)
    packed = (q[..., 0] << 20) | (q[..., 1] << 10) | q[..., 2]

    quad = np.zeros(packed.shape + (4,), dtype=np.uint32)
    for l in range(len(lw)):
        w, h, xo = int(lw[l]), int(lh[l]), int(lx[l])
        blk = packed[:, :h, xo:xo + w]
        right = np.roll(blk, -1, axis=2)
        down = np.roll(blk, -1, axis=1)
        quad[:, :h, xo:xo + w, 0] = blk
        quad[:, :h, xo:xo + w, 1] = right
        quad[:, :h, xo:xo + w, 2] = down
        quad[:, :h, xo:xo + w, 3] = np.roll(right, -1, axis=1)

    return Background(
        packed=torch.from_numpy(packed.reshape(-1).view(np.int32)).to(device),
        quad=torch.from_numpy(quad.reshape(-1, 4).view(np.int32)).to(device),
        level_w=tuple(int(v) for v in lw),
        level_h=tuple(int(v) for v in lh),
        level_x=tuple(int(v) for v in lx),
    )


def checker_background(height: int = 1024, width: int = 2048,
                       squares: int = 24, device="cpu") -> Background:
    """Procedural latitude/longitude checker — the test/bench skysphere."""
    v, u = np.meshgrid(
        np.arange(height) / height, np.arange(width) / width, indexing="ij"
    )
    cu = np.floor(u * squares).astype(int)
    cv = np.floor(v * squares / 2).astype(int)
    check = ((cu + cv) % 2).astype(np.float32)
    img = np.stack(
        [0.15 + 0.7 * check, 0.25 + 0.5 * check, 0.6 - 0.3 * check], axis=-1
    )
    # Tint the second side so wormhole far sides are identifiable.
    img2 = img[..., ::-1].copy()
    return build_background(img, img2, device=device)


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _level_tables(bgr: Background, level: Tensor):
    """Per-pixel (w, h, xoff) int32 for a per-pixel mip level."""
    if bgr.pow2:
        w0, h0 = bgr.level_w[0], bgr.level_h[0]
        wi = torch.full_like(level, w0) >> level
        hi = torch.full_like(level, h0) >> level
        xo = 2 * w0 - (torch.full_like(level, 2 * w0) >> level)
        return wi, hi, xo
    wi = torch.zeros_like(level)
    hi = torch.zeros_like(level)
    xo = torch.zeros_like(level)
    for l in range(bgr.levels):
        sel = level == l
        wi = torch.where(sel, bgr.level_w[l], wi)
        hi = torch.where(sel, bgr.level_h[l], hi)
        xo = torch.where(sel, bgr.level_x[l], xo)
    return wi, hi, xo


def _decode_rgb10(w: Tensor) -> Tensor:
    """rgb10 texel word -> (..., 3) float32 linear."""
    return torch.stack(
        [((w >> 20) & 0x3FF).to(torch.float32),
         ((w >> 10) & 0x3FF).to(torch.float32),
         (w & 0x3FF).to(torch.float32)],
        dim=-1,
    ) * (1.0 / 1023.0)


def _texel_index(bgr: Background, side: Tensor, yy: Tensor,
                 xx: Tensor) -> Tensor:
    """Flat atlas index; side >= 1 samples the primary background."""
    atlas_idx = torch.where(side >= 1, 0, 1)
    return ((atlas_idx * bgr.atlas_h + yy) * bgr.atlas_w + xx).long()


def _wrap(i: Tensor, n: Tensor, pow2: bool) -> Tensor:
    return i & (n - 1) if pow2 else torch.remainder(i, n)


def _bilinear_level(bgr: Background, side: Tensor, uv: Tensor,
                    level: Tensor) -> Tensor:
    """Bilinear wrap-sample one mip level; uv (..., 2)."""
    level = torch.clamp(level, 0, bgr.levels - 1)
    wi, hi, xoff = _level_tables(bgr, level)
    x0f = uv[..., 0] * wi.to(torch.float32) - 0.5
    y0f = uv[..., 1] * hi.to(torch.float32) - 0.5
    xi = torch.floor(x0f)
    yi = torch.floor(y0f)
    fx = (x0f - xi)[..., None]
    fy = (y0f - yi)[..., None]
    x0 = _wrap(xi.to(torch.int32), wi, bgr.pow2)
    y0 = _wrap(yi.to(torch.int32), hi, bgr.pow2)

    q = bgr.quad[_texel_index(bgr, side, y0, xoff + x0)]
    c00 = _decode_rgb10(q[..., 0])
    c01 = _decode_rgb10(q[..., 1])
    c10 = _decode_rgb10(q[..., 2])
    c11 = _decode_rgb10(q[..., 3])
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    return top * (1 - fy) + bot * fy


def _point_level(bgr: Background, side: Tensor, uv: Tensor,
                 level: Tensor) -> Tensor:
    """Nearest-texel wrap-sample of one mip level."""
    level = torch.clamp(level, 0, bgr.levels - 1)
    wi, hi, xoff = _level_tables(bgr, level)
    xi = torch.floor(uv[..., 0] * wi.to(torch.float32)).to(torch.int32)
    yi = torch.floor(uv[..., 1] * hi.to(torch.float32)).to(torch.int32)
    x0 = _wrap(xi, wi, bgr.pow2)
    y0 = _wrap(yi, hi, bgr.pow2)
    return _decode_rgb10(bgr.packed[_texel_index(bgr, side, y0, xoff + x0)])


def read_mipmap(bgr: Background, side: Tensor, uv: Tensor, lod: Tensor,
                trilinear: bool = True, point: bool = False) -> Tensor:
    """Trilinear: blend the two straddling levels; ``trilinear=False``
    samples the nearest level; ``point`` drops the bilinear filter."""
    lod = torch.clamp(lod, 0.0, bgr.levels - 1.0)
    if point:
        return _point_level(bgr, side, uv, torch.round(lod).to(torch.int32))
    if not trilinear:
        return _bilinear_level(bgr, side, uv,
                               torch.round(lod).to(torch.int32))
    lo = torch.floor(lod).to(torch.int32)
    hi = torch.ceil(lod).to(torch.int32)
    frac = (lod - torch.floor(lod))[..., None]
    v_lo = _bilinear_level(bgr, side, uv, lo)
    v_hi = _bilinear_level(bgr, side, uv, hi)
    return v_lo * (1 - frac) + v_hi * frac


def _circular_diff(a: Tensor, b: Tensor) -> Tensor:
    """Shortest wrap-around uv difference."""
    d = b - a
    return d - torch.round(d)


def sample_anisotropic(bgr: Background, tex: Tensor, side: Tensor,
                       max_probes: int = 16, bias_frac: float = 1.3,
                       trilinear: bool = True,
                       live: Tensor | None = None,
                       probe_segments: tuple = ()) -> Tensor:
    """EWA anisotropic filtering over the equirect map (cl.cl:5524-5687).

    ``tex``: (H, W, 2); ``side``: (H, W) int32; ``live``: optional bool
    (H, W) of displayed pixels (others drop out of the probe budget).
    ``probe_segments``: ``((frac, iters), ...)`` schedule over the pixels
    sorted by descending probe demand.  Returns (H, W, 3)."""
    tl = tex
    tr = torch.cat([tex[:, 1:], tex[:, -2:-1]], dim=1)
    bl = torch.cat([tex[1:], tex[-2:-1]], dim=0)
    dx_vtc = _circular_diff(tl, tr) / bias_frac
    dy_vtc = _circular_diff(tl, bl) / bias_frac

    n_pix = int(np.prod(tex.shape[:-1]))
    out = sample_anisotropic_flat(
        bgr, tex.reshape(n_pix, 2), side.reshape(n_pix),
        dx_vtc.reshape(n_pix, 2), dy_vtc.reshape(n_pix, 2),
        max_probes=max_probes, trilinear=trilinear,
        live=None if live is None else live.reshape(n_pix),
        probe_segments=probe_segments,
    )
    return out.reshape(tex.shape[:-1] + (3,))


def sample_anisotropic_flat(bgr: Background, tex: Tensor, side: Tensor,
                            dx_vtc: Tensor, dy_vtc: Tensor,
                            max_probes: int = 16,
                            trilinear: bool = True,
                            live: Tensor | None = None,
                            probe_segments: tuple = ()) -> Tensor:
    """EWA filtering over a flat pixel set with caller-supplied (already
    bias-scaled) screen-space uv derivatives.  ``tex``/``dx_vtc``/``dy_vtc``
    (N, 2); ``side`` (N,).  Returns (N, 3)."""
    w0 = float(bgr.level_w[0])
    h0 = float(bgr.level_h[0])
    du_dx = dx_vtc[..., 0] * w0
    du_dy = dy_vtc[..., 0] * w0
    dv_dx = dx_vtc[..., 1] * h0
    dv_dy = dy_vtc[..., 1] * h0

    # Heckbert ellipse (cl.cl:5577-5601).
    Ann = dv_dx * dv_dx + dv_dy * dv_dy + 1.0
    Bnn = -2.0 * (du_dx * dv_dx + du_dy * dv_dy)
    Cnn = du_dx * du_dx + du_dy * du_dy + 1.0
    F = torch.clamp(Ann * Cnn - Bnn * Bnn / 4.0, min=1e-10)
    A = Ann / F
    B = Bnn / F
    C = Cnn / F
    root = torch.sqrt((A - C) * (A - C) + B * B)
    a_prime = (A + C - root) / 2.0
    c_prime = (A + C + root) / 2.0
    major = torch.rsqrt(torch.clamp(a_prime, min=1e-20))
    minor = torch.rsqrt(torch.clamp(c_prime, min=1e-20))
    theta = torch.atan2(B, (A - C) / 2.0)

    major = torch.maximum(torch.clamp(major, min=1.0), minor)
    minor0 = torch.clamp(minor, min=1.0)

    f_probes = 2.0 * (major / minor0) - 1.0
    i_probes0 = torch.floor(f_probes + 0.5).to(torch.int32)
    i_probes0 = torch.clamp(i_probes0, max=max_probes)
    if live is not None:
        i_probes0 = torch.where(live, i_probes0, 1)

    max_lod = bgr.levels - 1.0

    def probe_geom(ip):
        """The EWA probe-budget rule (cl.cl:5608-5634): clamping below the
        wanted count grows the minor axis; a minor above the top level
        collapses to one probe."""
        ipf32 = ip.to(torch.float32)
        mnr = torch.where(ipf32 < f_probes, 2.0 * major / (ipf32 + 1.0),
                          minor0)
        lod = torch.log2(torch.clamp(mnr, min=1e-20))
        over = lod > max_lod
        lod = torch.where(over, max_lod, lod)
        ip = torch.where(over, 1, ip)
        ip = torch.clamp(ip, min=1)
        return ip, mnr, lod

    i_probes, minor, lod = probe_geom(i_probes0)
    alpha = 2.0

    lod_major = torch.clamp(torch.log2(torch.clamp(major, min=1e-20)), 0.0,
                            bgr.levels - 1.0)
    base_lod = torch.where(i_probes > 1, lod_major, lod)
    base = read_mipmap(bgr, side, tex, base_lod, trilinear=trilinear)
    if max_probes <= 1:
        return base

    n_pix = int(np.prod(tex.shape[:-1]))

    # Static segment bounds over the sorted prefix: (start, end, iters).
    segs = tuple(probe_segments) or ((1.0 / 3.0, max_probes),)
    bounds = []
    prev = 0
    acc = 0.0
    for frac, iters in segs:
        acc += float(frac)
        end = min(n_pix, max(int(n_pix * acc), prev))
        if end > prev:
            bounds.append((prev, end, max(int(iters), 2)))
        prev = end
    k_min = min(n_pix, 1024)  # small-image floor
    if prev < k_min:
        start = bounds[-1][0] if bounds and bounds[-1][1] == prev else prev
        iters = bounds[-1][2] if bounds else max_probes
        if bounds and bounds[-1][1] == prev:
            bounds[-1] = (start, k_min, iters)
        else:
            bounds.append((prev, k_min, iters))
    k = bounds[-1][1]

    # Pixels grouped by descending probe count (stable).
    order, dest = packing.bucket_sort_perm(max_probes - i_probes)
    order = order[:k]

    if any(iters < max_probes for _, _, iters in bounds) or len(bounds) > 1:
        # Per-pixel probe budget from the rank in the sorted order; pixels
        # wanting more than their segment grants re-clamp (overblur).
        budget = torch.ones_like(i_probes)
        for start, end, iters in reversed(bounds):
            budget = torch.where(dest < end, iters, budget)
        i_probes, minor, lod = probe_geom(torch.minimum(i_probes, budget))

    # Probe walk along the major axis (cl.cl:5636-5687); each probe is one
    # nearest-texel sample, the gaussian average supplies the smoothing.
    line_length = 2.0 * (major - minor)
    np_f = torch.clamp(i_probes.to(torch.float32) - 1.0, min=1.0)
    du = torch.cos(theta) * line_length / np_f
    dv = torch.sin(theta) * line_length / np_f
    q_ell = (du * du + dv * dv) / (major * major)

    texf = tex[order]
    sidef = side[order]
    lodf = lod[order]
    sUf, sVf = du[order] * (1.0 / w0), dv[order] * (1.0 / h0)
    qf = q_ell[order]
    ipf = i_probes[order]
    oddf = (ipf % 2) == 1
    startf = torch.where(oddf, -(ipf - 1), -ipf - 1)

    parts = []
    for start, end, iters in bounds:
        sl = slice(start, end)
        total = torch.zeros((end - start, 3), dtype=torch.float32,
                            device=tex.device)
        weight = torch.zeros((end - start,), dtype=torch.float32,
                             device=tex.device)
        for cnt in range(iters):
            nn = (startf[sl] + 2 * cnt).to(torch.float32)
            active = cnt < ipf[sl]
            d2 = (nn * nn / 4.0) * qf[sl]
            rel_w = torch.where(active, torch.exp(-alpha * d2), 0.0)
            cu = texf[sl, 0] + (nn / 2.0) * sUf[sl]
            cv = texf[sl, 1] + (nn / 2.0) * sVf[sl]
            uv = torch.stack([torch.remainder(cu, 1.0),
                              torch.remainder(cv, 1.0)], dim=-1)
            val = read_mipmap(bgr, sidef[sl], uv, lodf[sl],
                              trilinear=trilinear, point=True)
            total = total + rel_w[:, None] * val
            weight = weight + rel_w
        parts.append(total / torch.clamp(weight, min=1e-20)[:, None])

    multi = torch.cat(parts, dim=0)
    out = base.clone()
    sel = ipf > 1  # rows with one probe keep their base value
    out[order[sel]] = multi[sel]
    return torch.where(torch.isfinite(out), out, 0.0)
