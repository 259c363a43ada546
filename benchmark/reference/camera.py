"""Camera of the plain reference: quaternions, pixel directions and the
observer tetrad.  Frozen copy of ``geodesic_raytracing_tpu_torch/camera.py``
and of the chart helpers of ``coordinates/transforms.py`` it calls (commit
e647ccc).  Quaternions are (x, y, z, w)."""

from __future__ import annotations

import math

import torch

from . import tetrad
from .geometry import arctan2, dot

Tensor = torch.Tensor


def _vec(values, device) -> Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def axis_angle_quat(axis: Tensor, angle: Tensor) -> Tensor:
    axis = axis / torch.sqrt(dot(axis, axis))
    s = torch.sin(angle / 2)
    return torch.cat([axis * s, torch.cos(angle / 2)[None]])


def quat_multiply(q1: Tensor, q2: Tensor) -> Tensor:
    x1, y1, z1, w1 = q1
    x2, y2, z2, w2 = q2
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ]
    )


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def rot_quat(v: Tensor, q: Tensor) -> Tensor:
    u = q[:3]
    w = q[3]
    return v + 2.0 * _cross(u, _cross(u, v) + w * v)


def rot_quat_batched(v3: Tensor, q: Tensor) -> Tensor:
    ux, uy, uz, w = q[0], q[1], q[2], q[3]
    vx, vy, vz = v3[0], v3[1], v3[2]
    c1x = uy * vz - uz * vy + w * vx
    c1y = uz * vx - ux * vz + w * vy
    c1z = ux * vy - uy * vx + w * vz
    return torch.stack([
        vx + 2.0 * (uy * c1z - uz * c1y),
        vy + 2.0 * (uz * c1x - ux * c1z),
        vz + 2.0 * (ux * c1y - uy * c1x),
    ])


def rotate(quat: Tensor, pitch: float) -> Tensor:
    """``Camera.rotate(pitch=...)``: the roll, pitch and yaw steps with roll
    and yaw 0, about the camera's local axes."""
    q = quat
    dev = q.device
    for axis, angle in (((0.0, 0.0, 1.0), 0.0), ((1.0, 0.0, 0.0), pitch),
                        ((0.0, 1.0, 0.0), 0.0)):
        local_axis = rot_quat(_vec(list(axis), dev), q)
        q = quat_multiply(axis_angle_quat(local_axis, _vec(float(angle), dev)),
                          q)
    return q


def focal_length(width: int, fov_degrees: float, device) -> Tensor:
    fov_rad = fov_degrees * math.pi / 180.0
    return (width / 2) / torch.tan(
        torch.tensor(fov_rad / 2, dtype=torch.float32, device=device))


def directions_for_pixels(cx: Tensor, cy: Tensor, width: int, height: int,
                          quat: Tensor, fov_degrees: float) -> Tensor:
    """Camera-space ray directions (3, N) of flat pixel coordinates."""
    f_stop = focal_length(width, fov_degrees, cx.device)
    dx = cx - width / 2.0
    dy = cy - height / 2.0
    dz = f_stop.expand(cx.shape)
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
    return rot_quat_batched(torch.stack([dx * inv, dy * inv, dz * inv]),
                            quat)


def cartesian_to_polar3(c: Tensor) -> Tensor:
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    r = torch.sqrt(x * x + y * y + z * z)
    theta = arctan2(torch.sqrt(x * x + y * y), z)
    phi = arctan2(y, x)
    return torch.stack([r, theta, phi], dim=-1)


def polar_to_cartesian3(p: Tensor) -> Tensor:
    r, theta, phi = p[..., 0], p[..., 1], p[..., 2]
    st, ct = torch.sin(theta), torch.cos(theta)
    return torch.stack([r * st * torch.cos(phi), r * st * torch.sin(phi),
                        r * ct], dim=-1)


def cartesian_velocity_to_polar_velocity(pos_cart: Tensor,
                                         vel_cart: Tensor) -> Tensor:
    return torch.func.jvp(cartesian_to_polar3, (pos_cart,), (vel_cart,))[1]


def _orthonormalise3(v1: Tensor, v2: Tensor, v3: Tensor):
    u1 = v1 / torch.sqrt(dot(v1, v1))
    u2 = v2 - dot(v2, u1) * u1
    u2 = u2 / torch.sqrt(dot(u2, u2))
    u3 = v3 - dot(v3, u1) * u1 - dot(v3, u2) * u2
    u3 = u3 / torch.sqrt(dot(u3, u3))
    return u1, u2, u3


def observer_tetrad(metric, position: Tensor, params,
                    basis_speed3: Tensor) -> Tensor:
    """Observer tetrad at a generic position (4,): frame basis, orientation
    to the global polar axes, then the Lorentz boost.  Returns ``es``
    (4, 4) with ``es[a][mu] = e_a^mu``."""
    dev = position.device
    gab = metric.fn(position, params)
    es, _ = tetrad.frame_basis(gab)

    polar_camera = metric.to_polar(position, params)
    apolar = polar_camera[1:4].clone()
    apolar[0] = torch.abs(polar_camera[1])
    cart_camera = polar_to_cartesian3(apolar)

    inv_es = tetrad.tetrad_inverse(es)
    sign_r = torch.where(polar_camera[1] < 0, -1.0, 1.0)

    def to_generic(c3):
        s3 = cartesian_velocity_to_polar_velocity(cart_camera, c3)
        s3 = torch.cat([(s3[0] * sign_r)[None], s3[1:]])
        v4 = torch.cat([torch.zeros((1,), device=dev), s3])
        return torch.func.jvp(lambda y: metric.from_polar(y, params),
                              (polar_camera,), (v4,))[1]

    gx, gy, gz = (to_generic(axis) for axis in torch.eye(3, device=dev))

    tE1 = tetrad.coordinate_to_tetrad(gy, inv_es)
    tE2 = tetrad.coordinate_to_tetrad(gx, inv_es)
    tE3 = tetrad.coordinate_to_tetrad(gz, inv_es)

    b1, b2, b3 = _orthonormalise3(tE1[1:], tE2[1:], tE3[1:])

    def back(b3v):
        return tetrad.tetrad_to_coordinate(
            torch.cat([torch.zeros((1,), device=dev), b3v]), es)

    es = torch.stack([es[0], back(b2), back(b1), back(b3)])
    return tetrad.boost_tetrad(es, basis_speed3, gab)


def scene_camera(r: float, theta: float, phi: float, pitch: float,
                 azimuth: float, device):
    """``(polar position (4,), quaternion (4,), basis speed (3,))`` of a
    static camera at (r, theta, phi + azimuth), pitched by ``pitch`` about
    its local x axis and then turned by ``azimuth`` about the global z
    axis, as the benchmark's scene makes it."""
    quat = rotate(_vec([0.0, 0.0, 0.0, 1.0], device), pitch)
    quat = quat_multiply(
        axis_angle_quat(_vec([0.0, 0.0, 1.0], device),
                        _vec(float(azimuth), device)), quat)
    polar = _vec([0.0, r, theta, phi + azimuth], device)
    return polar, quat, torch.zeros(3, device=device)
