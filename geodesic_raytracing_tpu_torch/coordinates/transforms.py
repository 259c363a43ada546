"""Coordinate transforms with autodiff Jacobians (port of
``geodesic_raytracing_tpu.coordinates.transforms``; the charts of the
ported metrics: polar, cartesian, skewed cartesian, cylindrical, ingoing
Eddington-Finkelstein and its identity variant, rational (X = cos theta),
skewed polar and Misner).

A transform is ``f(x: (4, ...), params) -> (4, ...)``; velocity transforms
are one ``torch.func.jvp``.  Canonical polar coordinates are
``(t, r, theta, phi)``.
"""

from __future__ import annotations

import torch

from ..ops.geometry import arccos, arctan2

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


def _cartesian_polar(t, xx, y, z):
    r = torch.sqrt(xx * xx + y * y + z * z)
    theta = arctan2(torch.sqrt(xx * xx + y * y), z)
    phi = arctan2(y, xx)
    return torch.stack([t, r, theta, phi])


def cartesian_to_polar(x, params):
    """scripts/coordinates/cartesian_to_polar.js.  Componentwise."""
    return _cartesian_polar(x[0], x[1], x[2], x[3])


def polar_to_cartesian(x, params):
    """scripts/coordinates/polar_to_cartesian.js.  Componentwise."""
    t, r, theta, phi = x[0], x[1], x[2], x[3]
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack(
        [t, r * st * torch.cos(phi), r * st * torch.sin(phi), r * ct])


def cartesian_skew_to_polar(x, params):
    """scripts/coordinates/cartesian_skew_to_polar.js — args are
    (x, t, y, z)."""
    return _cartesian_polar(x[1], x[0], x[2], x[3])


def polar_to_cartesian_skew(x, params):
    """scripts/coordinates/polar_to_cartesian_skew.js — returns
    (x, t, y, z)."""
    t, r, theta, phi = x[0], x[1], x[2], x[3]
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack(
        [r * st * torch.cos(phi), t, r * st * torch.sin(phi), r * ct])


def cylindrical_to_polar(x, params):
    """scripts/coordinates/cylindrical_to_polar.js — (t, p, phi, z)."""
    t, p, phi, z = x[0], x[1], x[2], x[3]
    rr = torch.sqrt(p * p + z * z)
    rtheta = arctan2(p, z)
    return torch.stack([t, rr, rtheta, phi])


def polar_to_cylindrical(x, params):
    """scripts/coordinates/polar_to_cylindrical.js."""
    t, r, theta, phi = x[0], x[1], x[2], x[3]
    return torch.stack([t, r * torch.sin(theta), phi, r * torch.cos(theta)])


def ingoing_ef_to_polar(x, params):
    """scripts/coordinates/ingoing_ef_to_polar.js —
    v = t + r + rs log|r - rs|."""
    rs = params["rs"]
    v, r, theta, phi = x[0], x[1], x[2], x[3]
    t = v - (r + rs * torch.log(torch.abs(r - rs)))
    return torch.stack([t, r, theta, phi])


def polar_to_ingoing_ef(x, params):
    """scripts/coordinates/polar_to_ingoing_ef.js."""
    rs = params["rs"]
    t, r, theta, phi = x[0], x[1], x[2], x[3]
    v = t + r + rs * torch.log(torch.abs(r - rs))
    return torch.stack([v, r, theta, phi])


def ingoing_ef_variable_to_polar(x, params):
    """scripts/coordinates/ingoing_ef_variable_to_polar.js — identity (the
    polar time coordinate is never round-tripped)."""
    return x


def polar_to_ingoing_ef_variable(x, params):
    """scripts/coordinates/polar_to_ingoing_ef_variable.js — identity."""
    return x


def polar_to_rational(x, params):
    """scripts/coordinates/polar_to_rational.js — X = cos(theta)."""
    t, r, theta, phi = x[0], x[1], x[2], x[3]
    return torch.stack([t, r, torch.cos(theta), phi])


def rational_to_polar(x, params):
    """scripts/coordinates/rational_to_polar.js."""
    t, r, X, phi = x[0], x[1], x[2], x[3]
    return torch.stack([t, r, arccos(torch.clamp(X, -1.0, 1.0)), phi])


def skewed_polar_to_polar(x, params):
    """scripts/coordinates/skewed_polar_to_polar.js — args are (r, t, ...)."""
    return torch.stack([x[1], x[0], x[2], x[3]])


def polar_to_skewed_polar(x, params):
    """scripts/coordinates/polar_to_skewed_polar.js."""
    return torch.stack([x[1], x[0], x[2], x[3]])


def misner_4d_to_polar(x, params):
    """scripts/coordinates/misner_4d_to_polar.js (arXiv:1102.0907 eq. 8-9)
    — (T, phi, y, z)."""
    T, mphi, y, z = x[0], x[1], x[2], x[3]
    t = T * torch.exp(mphi * 0.5) - torch.exp(-mphi * 0.5)
    xx = T * torch.exp(mphi * 0.5) + torch.exp(-mphi * 0.5)
    r = torch.sqrt(xx * xx + y * y + z * z)
    theta = arctan2(torch.sqrt(xx * xx + y * y), z)
    phi = arctan2(y, xx)
    return torch.stack([t, r, theta, phi])


def polar_to_misner_4d(x, params):
    """scripts/coordinates/polar_to_misner_4d.js."""
    t, r, theta, phi = x[0], x[1], x[2], x[3]
    st = torch.sin(theta)
    xx = r * st * torch.cos(phi)
    y = r * st * torch.sin(phi)
    z = r * torch.cos(theta)
    mphi = -2.0 * torch.log((xx - t) * 0.5)
    T = (xx * xx - t * t) * 0.25
    return torch.stack([T, mphi, y, z])


TRANSFORMS = {
    "polar_to_polar": polar_to_polar,
    "cartesian_to_polar": cartesian_to_polar,
    "polar_to_cartesian": polar_to_cartesian,
    "cartesian_skew_to_polar": cartesian_skew_to_polar,
    "polar_to_cartesian_skew": polar_to_cartesian_skew,
    "cylindrical_to_polar": cylindrical_to_polar,
    "polar_to_cylindrical": polar_to_cylindrical,
    "ingoing_ef_to_polar": ingoing_ef_to_polar,
    "polar_to_ingoing_ef": polar_to_ingoing_ef,
    "ingoing_ef_variable_to_polar": ingoing_ef_variable_to_polar,
    "polar_to_ingoing_ef_variable": polar_to_ingoing_ef_variable,
    "skewed_polar_to_polar": skewed_polar_to_polar,
    "polar_to_skewed_polar": polar_to_skewed_polar,
    "polar_to_rational": polar_to_rational,
    "rational_to_polar": rational_to_polar,
    "misner_4d_to_polar": misner_4d_to_polar,
    "polar_to_misner_4d": polar_to_misner_4d,
}


def get_transform(name: str):
    if not name:
        return polar_to_polar
    return TRANSFORMS[name]


def velocity_transform(fn, x: Tensor, v: Tensor, params) -> Tensor:
    """Push a 4-velocity through the Jacobian of ``fn`` at ``x``."""
    return torch.func.jvp(lambda y: fn(y, params), (x,), (v,))[1]
