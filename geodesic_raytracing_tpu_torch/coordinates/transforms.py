"""Coordinate transforms with autodiff Jacobians (port of
``geodesic_raytracing_tpu.coordinates.transforms``; the charts the ported
slice uses).

A transform is ``f(x: (4, ...), params) -> (4, ...)``; velocity transforms
are one ``torch.func.jvp``.  Canonical polar coordinates are
``(t, r, theta, phi)``.
"""

from __future__ import annotations

import torch

from ..ops.geometry import arctan2

Tensor = torch.Tensor


def cartesian_to_polar3(c: Tensor) -> Tensor:
    """(x, y, z) -> (r, theta, phi), component-last."""
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    theta = arctan2(torch.sqrt(x * x + y * y), z)
    phi = arctan2(y, x)
    return torch.stack([r, theta, phi], dim=-1)


def polar_to_cartesian3(p: Tensor) -> Tensor:
    """(r, theta, phi) -> (x, y, z), component-last."""
    r, theta, phi = p[..., 0], p[..., 1], p[..., 2]
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([r * st * torch.cos(phi), r * st * torch.sin(phi),
                        r * ct], dim=-1)


def cartesian_velocity_to_polar_velocity(pos_cart: Tensor,
                                         vel_cart: Tensor) -> Tensor:
    """Push a cartesian 3-velocity through d(cart->polar) at ``pos_cart``."""
    return torch.func.jvp(cartesian_to_polar3, (pos_cart,), (vel_cart,))[1]


def polar_to_polar(x, params):
    """scripts/coordinates/polar_to_polar.js — identity."""
    return x


TRANSFORMS = {
    "polar_to_polar": polar_to_polar,
}


def get_transform(name: str):
    if not name:
        return polar_to_polar
    return TRANSFORMS[name]


def velocity_transform(fn, x: Tensor, v: Tensor, params) -> Tensor:
    """Push a 4-velocity through the Jacobian of ``fn`` at ``x``."""
    return torch.func.jvp(lambda y: fn(y, params), (x,), (v,))[1]
