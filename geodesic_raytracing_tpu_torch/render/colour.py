"""Colour handling: sRGB transfer and the relativistic redshift model (port
of ``geodesic_raytracing_tpu.render.colour``).

Behavioural twin of the reference's ``redshift()`` (cl.cl:5371-5413) and the
Lorentz-invariant ``I / nu^3`` intensity scaling (cl.cl:5794-5831).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

Tensor = torch.Tensor


def srgb_to_lin(c: Tensor) -> Tensor:
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))


def lin_to_srgb(c: Tensor) -> Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)


def energy_of(v: Tensor) -> Tensor:
    """Relative luminance (cl.cl:5366-5369)."""
    return v[..., 0] * 0.2125 + v[..., 1] * 0.7154 + v[..., 2] * 0.0721


@functools.lru_cache(maxsize=None)
def _rgb_on(values: tuple, device) -> Tensor:
    """A 3-vector constant on ``device``, uploaded once and kept."""
    return torch.tensor(values, dtype=torch.float32, device=device)


def _rgb(values, like: Tensor) -> Tensor:
    return _rgb_on(tuple(values), like.device)


def redshift_colour(v: Tensor, z: Tensor, old: bool = False) -> Tensor:
    """Map the shift z in [-1, +inf] onto a red/blue hue mix while conserving
    estimated radiant energy (``redshift()`` cl.cl:5371-5413).  ``old``
    selects the reference's ``use_old_redshift`` feature (main.cpp:1139):
    skip the blueshift energy-overflow redistribution (cl.cl:5397-5406)."""
    radiant_energy = energy_of(v)[..., None]
    red = _rgb([1.0 / 0.2125, 0.0, 0.0], v)
    blue = _rgb([0.0, 0.0, 1.0 / 0.0721], v)

    z_pos = torch.clamp(z, min=0.0)[..., None]
    result_red = v + (radiant_energy * red - v) * torch.tanh(z_pos)

    iv1pz = 1.0 / (1.0 + torch.clamp(z, max=0.0)) - 1.0
    frac = torch.tanh(iv1pz)[..., None]
    col = v + (radiant_energy * blue - v) * frac
    if not old:
        # Energy overflow from clamping is shared back into red and green
        # (cl.cl:5398-5406).
        final_energy = energy_of(torch.clamp(col, 0.0, 1.0))
        real_energy = energy_of(col)
        remaining = (real_energy - final_energy)[..., None]
        share = _rgb([1.0 / 0.2125, 1.0 / 0.7154, 0.0], v)
        col = col + remaining * share

    result = torch.where(z[..., None] > 0, result_red, col)
    return torch.clamp(result, 0.0, 1.0)


def linear_rgb_to_xyz(c: Tensor) -> Tensor:
    """cl.cl:5770-5778."""
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack(
        [
            0.4124564 * r + 0.3575761 * g + 0.1804375 * b,
            0.2126729 * r + 0.7151522 * g + 0.0721750 * b,
            0.0193339 * r + 0.1191920 * g + 0.9503041 * b,
        ],
        dim=-1,
    )


# DOMINANT_COLOUR anchors (cl.cl:5736-5744): wavelengths and chromaticity
# angles of the sRGB primaries around the white point, in the physically
# consistent pairing the reference package uses.
_R_WL, _G_WL, _B_WL = 612.0, 549.0, 464.0
_R_ANG, _G_ANG, _B_ANG = -0.010759, 1.695013, -2.161580


def _xy_of(lin_rgb: Tensor, floor: float):
    xyz = linear_rgb_to_xyz(lin_rgb)
    s = torch.clamp(xyz.sum(-1), min=floor)
    return xyz, xyz[..., :2] / s[..., None]


def dominant_wavelength(lin_rgb: Tensor) -> Tensor:
    """Estimate each pixel's dominant wavelength from its chromaticity angle
    around the white point, interpolating between the sRGB primary anchors:
    the reference's ``DOMINANT_COLOUR`` redshift variant (cl.cl:5724-5792).
    The purple line (blue..red) lerps through the anchors."""
    _, xy = _xy_of(lin_rgb, 1e-5)
    v = xy - (1.0 / 3.0)
    a = torch.atan2(v[..., 1], v[..., 0])

    two_pi = 2.0 * math.pi
    # Normalise so red sits at 0; green and blue follow counterclockwise.
    # The anchors' own offsets are float32 values, as the angle is.
    an = torch.remainder(a - _R_ANG, two_pi)
    f32 = np.float32
    g_at = float(np.mod(f32(_G_ANG) - f32(_R_ANG), f32(two_pi)))
    b_at = float(np.mod(f32(_B_ANG) - f32(_R_ANG), f32(two_pi)))

    wl_rg = _R_WL + (_G_WL - _R_WL) * an / g_at
    wl_gb = _G_WL + (_B_WL - _G_WL) * (an - g_at) / (b_at - g_at)
    wl_br = _B_WL + (_R_WL - _B_WL) * (an - b_at) / (two_pi - b_at)
    return torch.where(an < g_at, wl_rg,
                       torch.where(an < b_at, wl_gb, wl_br))


def xyz_to_linear_rgb(c: Tensor) -> Tensor:
    """Inverse of linear_rgb_to_xyz (sRGB D65)."""
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    return torch.stack(
        [
            3.2404542 * x - 1.5371385 * y - 0.4985314 * z,
            -0.9692660 * x + 1.8760108 * y + 0.0415560 * z,
            0.0556434 * x - 0.2040259 * y + 1.0572252 * z,
        ],
        dim=-1,
    )


_WHITE = 1.0 / 3.0  # equal-energy white point, chromaticity.hpp:500-501


@functools.lru_cache(maxsize=None)
def _tables(device):
    """(negated unwrapped locus angles about the white point, wavelengths,
    xy) of the CIE 1931 table as float32 tensors on ``device``, made once
    per device.  The locus angle decreases monotonically with wavelength
    once unwrapped; it is stored negated so that the interpolation sees an
    increasing x-axis."""
    from . import cie1931_data as cie

    xy = np.asarray(cie.XY_1NM, dtype=np.float64)
    ang = np.unwrap(np.arctan2(xy[:, 1] - _WHITE, xy[:, 0] - _WHITE))
    assert (np.diff(ang) <= 1e-12).all(), "locus angle not monotone"
    wl = np.arange(cie.WL_START, cie.WL_END + 0.5)

    def f32(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(device)

    return f32(-ang), f32(wl), f32(xy)


def _interp(x: Tensor, xp: Tensor, fp: Tensor) -> Tensor:
    """``numpy.interp`` for increasing ``xp`` (1-D), clamping outside."""
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    xp.numel() - 1)
    x0, f0 = xp[i - 1], fp[i - 1]
    df = fp[i] - f0
    dx = xp[i] - x0
    flat = torch.abs(dx) <= float(np.spacing(np.finfo(np.float32).eps))
    f = torch.where(flat, f0,
                    f0 + ((x - x0) / torch.where(flat, 1.0, dx)) * df)
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f)


def dominant_wavelength_cie(lin_rgb: Tensor) -> Tensor:
    """Dominant wavelength from the full CIE 1931 horseshoe
    (``srgb_to_wavelength``, chromaticity.hpp:536-572): chromaticity angle
    about the equal-energy white point, matched against the spectral-locus
    angles, interpolated between 1 nm entries.  Non-spectral (purple-line)
    chromaticities clamp to the nearer locus end."""
    neg_ang, wl, _ = _tables(lin_rgb.device)
    _, xy = _xy_of(lin_rgb, 1e-6)
    a = torch.atan2(xy[..., 1] - _WHITE, xy[..., 0] - _WHITE)
    # Shift the query onto the unwrapped locus branch [a_min, a_max]
    # (a_max at 360 nm, a_min = angle at 830 nm, one winding below).
    a_max = -neg_ang[0]
    a_min = -neg_ang[-1]
    q = torch.where(a <= a_max, a, a - 2.0 * math.pi)
    # Purple gap (a_max .. a_min + 2pi): circular-nearest locus end.
    in_gap = (a > a_max) & (a < a_min + 2.0 * math.pi)
    gap_mid = 0.5 * (a_max + a_min + 2.0 * math.pi)
    q = torch.where(in_gap, torch.where(a < gap_mid, a_max, a_min), q)
    return _interp(-q, neg_ang, wl)


def srgb_to_wavelength(srgb: Tensor) -> Tensor:
    """chromaticity.hpp:536 behavioural twin (vectorised)."""
    return dominant_wavelength_cie(srgb_to_lin(srgb))


def wavelength_to_xy(wavelength: Tensor) -> Tensor:
    """Spectral-locus chromaticity at ``wavelength`` nm (interpolated)."""
    _, wl, xy = _tables(wavelength.device)
    w = torch.minimum(torch.maximum(wavelength, wl[0]), wl[-1])
    return torch.stack([_interp(w, wl, xy[:, 0].contiguous()),
                        _interp(w, wl, xy[:, 1].contiguous())], dim=-1)


def _dist_white(xy: Tensor) -> Tensor:
    d = xy - _WHITE
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def spectral_redshift(lin_rgb: Tensor, z_shift: Tensor) -> Tensor:
    """Spectral-shift experiment: estimate each pixel's dominant wavelength
    and excitation purity from the CIE horseshoe, shift the wavelength by
    1 + z, and rebuild the colour at the shifted locus point with the same
    purity and the I/nu^3 luminance scale.  Unphysical for broadband
    sources, as the reference's own comment warns (cl.cl:5713)."""
    _, wl_tab, _ = _tables(lin_rgb.device)
    xyz, xy = _xy_of(lin_rgb, 1e-6)
    wl = dominant_wavelength_cie(lin_rgb)
    locus = wavelength_to_xy(wl)
    d_pix = _dist_white(xy)
    d_loc = torch.clamp(_dist_white(locus), min=1e-6)
    purity = torch.clamp(d_pix / d_loc, 0.0, 1.0)

    wl_obs = torch.minimum(torch.maximum(wl * (1.0 + z_shift), wl_tab[0]),
                           wl_tab[-1])
    xy_new = _WHITE + purity[..., None] * (wavelength_to_xy(wl_obs) - _WHITE)

    rel_lum = xyz[..., 1]
    # A numerically overshooting blueshift can dip 1 + z to or past zero,
    # where the power is inf or NaN: floor the base.
    new_lum = torch.clamp(
        rel_lum * torch.pow(torch.clamp(1.0 + z_shift, min=1e-3), -3.0),
        0.0, 1.0)
    y = torch.clamp(xy_new[..., 1], min=1e-6)
    xyz_new = torch.stack(
        [xy_new[..., 0] / y * new_lum,
         new_lum,
         (1.0 - xy_new[..., 0] - xy_new[..., 1]) / y * new_lum],
        dim=-1,
    )
    out = torch.clamp(xyz_to_linear_rgb(xyz_new), min=0.0)
    # Out-of-gamut spectral colours: scale into [0, 1] preserving hue.
    peak = torch.clamp(out.max(-1).values, min=1.0)
    out = out / peak[..., None]
    # Near-black or achromatic pixels keep their colour (the wavelength is
    # undefined there).
    keep = (rel_lum < 1e-4) | (purity < 0.1)
    return torch.where(keep[..., None], torch.clamp(lin_rgb, 0.0, 1.0), out)


def apply_redshift(lin_rgb: Tensor, z_shift: Tensor,
                   dominant_colour: bool = False,
                   old: bool = False, spectral: bool = False) -> Tensor:
    """Full redshift pipeline on linear RGB (cl.cl:5689-5846): I/nu^3
    Lorentz-invariant luminance rescale at the test wavelength, then the
    hue-shift model.  ``dominant_colour`` estimates a per-pixel test
    wavelength from chromaticity instead of the 555 nm human-vision peak."""
    if spectral:
        return spectral_redshift(lin_rgb, z_shift)
    rel_lum = (
        0.2126 * lin_rgb[..., 0]
        + 0.7152 * lin_rgb[..., 1]
        + 0.0722 * lin_rgb[..., 2]
    )
    test_wl = dominant_wavelength(lin_rgb) if dominant_colour else 555.0
    # local_wavelength = test / (z+1): I scales by (z+1)^-3 whatever the
    # absolute wavelength (cl.cl:5794-5812).
    local_wl = test_wl / (z_shift + 1.0)
    new_rel = torch.clamp(rel_lum * torch.pow(local_wl / test_wl, 3.0),
                          0.0, 1.0)
    scale = torch.where(rel_lum > 1e-5,
                        new_rel / torch.clamp(rel_lum, min=1e-20), 1.0)
    out = torch.clamp(lin_rgb * scale[..., None], 0.0, 1.0)
    return redshift_colour(out, z_shift, old=old)
