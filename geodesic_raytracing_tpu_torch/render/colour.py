"""sRGB transfer functions (port of the part of
``geodesic_raytracing_tpu.render.colour`` the slice uses; redshift colour
comes with a later slice)."""

from __future__ import annotations

import torch

Tensor = torch.Tensor


def srgb_to_lin(c: Tensor) -> Tensor:
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))


def lin_to_srgb(c: Tensor) -> Tensor:
    c = torch.clamp(c, 0.0, 1.0)
    return torch.where(c <= 0.0031308, c * 12.92,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)
