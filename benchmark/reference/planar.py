"""Constant-theta planar tracing of the plain reference: frozen copy of
``geodesic_raytracing_tpu_torch/ops/planar.py`` (commit e647ccc).  Each
ray's motion plane is rotated into the equator at launch (``to_planar``) and
the final angles rotated back (``unrotate_angles``)."""

from __future__ import annotations

import math

import torch

Tensor = torch.Tensor

HALF_PI = math.pi / 2


def _norm3(v):
    return torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])


def _normalize3(v):
    n = _norm3(v)
    n = torch.where(n < 1e-12, 1.0, n)
    return torch.stack([v[0] / n, v[1] / n, v[2] / n])


def _cross3(a, b):
    return torch.stack([
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    ])


def _dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _axis3(like: Tensor, k: int) -> Tensor:
    """The k-th Cartesian unit vector for every item of ``like`` (N,)."""
    return torch.stack([torch.ones_like(like) if i == k
                        else torch.zeros_like(like) for i in range(3)])


def rot_quat_batched(v, q):
    """Rotate 3-vectors (3, N) by quaternions (4, N) (x, y, z, w)."""
    u = q[:3]
    w = q[3]
    uv = _cross3(u, v)
    uv = torch.stack([uv[0] + w * v[0], uv[1] + w * v[1], uv[2] + w * v[2]])
    uuv = _cross3(u, uv)
    return torch.stack([
        v[0] + 2.0 * uuv[0],
        v[1] + 2.0 * uuv[1],
        v[2] + 2.0 * uuv[2],
    ])


def theta_adjustment_quat(vel_cart, cart_pos, angle_sign):
    """Batched ``get_theta_adjustment_quat`` (cl.cl:2015-2043): quaternion
    rotating each ray's motion plane into the equatorial plane."""
    small = _dot3(vel_cart, vel_cart) < 1e-10
    pd = torch.where(small[None, :], _axis3(vel_cart[0], 1), vel_cart)

    bx = _normalize3(pd)
    by = _normalize3(-cart_pos)
    # rejection of bx from by
    bx = _normalize3(bx - _dot3(bx, by)[None, :] * by)
    plane_n = -_normalize3(_cross3(bx, by))

    z = _axis3(plane_n[0], 2)
    cosang = torch.clamp(_dot3(plane_n, z), -1.0, 1.0)
    angle = torch.acos(cosang) * angle_sign

    axis = _cross3(plane_n, z)
    an = _norm3(axis)
    degenerate = an < 1e-9  # plane already equatorial
    axis = torch.where(degenerate[None, :], _axis3(an, 0),
                       axis / torch.where(degenerate, 1.0, an)[None, :])
    s = torch.sin(angle / 2)
    q = torch.stack([axis[0] * s, axis[1] * s, axis[2] * s,
                     torch.cos(angle / 2)])
    qn = torch.sqrt(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3])
    return q / torch.where(qn < 1e-12, 1.0, qn)[None, :]


def _polar3_to_cart(p):
    r, th, ph = p[0], p[1], p[2]
    st, ct = torch.sin(th), torch.cos(th)
    return torch.stack([r * st * torch.cos(ph), r * st * torch.sin(ph),
                        r * ct])


def _cart_to_polar3(c):
    x, y, z = c[0], c[1], c[2]
    r = torch.sqrt(x * x + y * y + z * z)
    th = torch.atan2(torch.sqrt(x * x + y * y), z)
    ph = torch.atan2(y, x)
    return torch.stack([r, th, ph])


def _polar_vel_to_cart(p, v):
    """d(polar->cart) pushforward, componentwise (batched)."""
    r, th, ph = p[0], p[1], p[2]
    vr, vth, vph = v[0], v[1], v[2]
    st, ct = torch.sin(th), torch.cos(th)
    sp, cp = torch.sin(ph), torch.cos(ph)
    return torch.stack([
        vr * st * cp + r * ct * cp * vth - r * st * sp * vph,
        vr * st * sp + r * ct * sp * vth + r * st * cp * vph,
        vr * ct - r * st * vth,
    ])


def _cart_vel_to_polar(c, v):
    """d(cart->polar) pushforward, componentwise."""
    x, y, z = c[0], c[1], c[2]
    vx, vy, vz = v[0], v[1], v[2]
    rho2 = x * x + y * y
    rho = torch.sqrt(torch.clamp(rho2, min=1e-20))
    r2 = rho2 + z * z
    r = torch.sqrt(torch.clamp(r2, min=1e-20))
    vr = (x * vx + y * vy + z * vz) / r
    vth = (z * (x * vx + y * vy) - rho2 * vz) / (r2 * rho)
    vph = (x * vy - y * vx) / rho2
    return torch.stack([vr, vth, vph])


def _signed(r: Tensor) -> Tensor:
    """sign(r) with +1 at 0."""
    fsign = torch.sign(r)
    return torch.where(fsign == 0, 1.0, fsign)


def to_planar(metric, pos: Tensor, vel: Tensor, params):
    """Rotate rays into the equatorial plane (``correct_lightray``).

    ``pos``/``vel`` are (4, N) generic coordinates.  Returns
    ``(pos', vel', inverse_quat (4, N))`` with theta = pi/2 and
    v_theta = 0."""
    polar, polar_vel = torch.func.jvp(
        lambda x: metric.to_polar(x, params), (pos,), (vel,))

    fsign = _signed(polar[1])
    p3 = torch.stack([torch.abs(polar[1]), polar[2], polar[3]])
    v3 = torch.stack([polar_vel[1] * fsign, polar_vel[2], polar_vel[3]])

    cart = _polar3_to_cart(p3)
    cart_v = _polar_vel_to_cart(p3, v3)

    quat = theta_adjustment_quat(cart_v, cart, 1.0)
    inv_quat = theta_adjustment_quat(cart_v, cart, -1.0)

    cart_r = rot_quat_batched(cart, quat)
    cart_vr = rot_quat_batched(cart_v, quat)

    np3 = _cart_to_polar3(cart_r)
    nv3 = _cart_vel_to_polar(cart_r, cart_vr)

    # Exact equatorial pin (the rotation lands there up to fp noise).
    new_polar = torch.stack([polar[0], np3[0] * fsign,
                             torch.full_like(np3[1], HALF_PI), np3[2]])
    new_pvel = torch.stack([polar_vel[0], nv3[0] * fsign,
                            torch.zeros_like(nv3[1]), nv3[2]])

    new_pos, new_vel = torch.func.jvp(
        lambda x: metric.from_polar(x, params), (new_polar,), (new_pvel,))
    return new_pos, new_vel, inv_quat


def unrotate_angles(snapped_polar3: Tensor, inv_quat: Tensor) -> Tensor:
    """Rotate a final (r, theta, phi) back out of the equatorial plane with
    the stored inverse quaternion (readout path of
    ``get_intersection_position`` cl.cl:5056-5064).  Returns (r, theta,
    phi) (3, N); the sign of r is preserved."""
    fsign = _signed(snapped_polar3[0])
    p3 = torch.stack([torch.abs(snapped_polar3[0]), snapped_polar3[1],
                      snapped_polar3[2]])
    cart = rot_quat_batched(_polar3_to_cart(p3), inv_quat)
    out = _cart_to_polar3(cart)
    return torch.stack([out[0] * fsign, out[1], out[2]])
