"""Camera state, quaternions and the observer tetrad (port of
``geodesic_raytracing_tpu.camera``).  Quaternions are (x, y, z, w)."""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from .coordinates import transforms as tr
from .metrics.base import Metric
from .ops import raymarch, tetrad
from .ops.geometry import dot
from .utils import profiling

Tensor = torch.Tensor


def _vec(values, device) -> Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def quat_identity(*, device) -> Tensor:
    return _vec([0.0, 0.0, 0.0, 1.0], device)


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
    """Rotate a 3-vector by a quaternion."""
    u = q[:3]
    w = q[3]
    return v + 2.0 * _cross(u, _cross(u, v) + w * v)


def rot_quat_batched(v3: Tensor, q: Tensor) -> Tensor:
    """Rotate a component-first (3, N) batch by one quaternion."""
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


@functools.lru_cache(maxsize=None)
def focal_length(width: int, fov_degrees: float, device) -> Tensor:
    """Focal length in pixels, a 0-d tensor on ``device`` (kept, so that a
    frame uploads nothing)."""
    fov_rad = fov_degrees * math.pi / 180.0
    return (width / 2) / torch.tan(
        torch.tensor(fov_rad / 2, dtype=torch.float32, device=device))


def directions_for_pixels(cx: Tensor, cy: Tensor, width: int, height: int,
                          quat: Tensor, fov_degrees: float) -> Tensor:
    """Camera-space ray directions of flat pixel coordinates ``cx``/``cy``
    of the width x height image, rotated by the camera quaternion
    (``calculate_pixel_direction`` cl.cl:2044-2061).  Returns (3, N)."""
    f_stop = focal_length(width, fov_degrees, cx.device)
    dx = cx - width / 2.0
    dy = cy - height / 2.0
    dz = f_stop.expand(cx.shape)
    inv = torch.rsqrt(dx * dx + dy * dy + dz * dz)
    return rot_quat_batched(torch.stack([dx * inv, dy * inv, dz * inv]),
                            quat)


def pixel_directions(width: int, height: int, quat: Tensor,
                     fov_degrees: float) -> Tensor:
    """Per-pixel ray directions of the row-major width x height image
    (:func:`directions_for_pixels` of every pixel).  Returns (H, W, 3)."""
    dev = quat.device
    yy, xx = torch.meshgrid(
        torch.arange(height, dtype=torch.float32, device=dev),
        torch.arange(width, dtype=torch.float32, device=dev), indexing="ij")
    d = directions_for_pixels(xx.reshape(-1), yy.reshape(-1), width, height,
                              quat, fov_degrees)
    return d.T.reshape(height, width, 3)


def _orthonormalise3(v1: Tensor, v2: Tensor, v3: Tensor):
    """Euclidean Gram-Schmidt of 3 3-vectors."""
    u1 = v1 / torch.sqrt(dot(v1, v1))
    u2 = v2 - dot(v2, u1) * u1
    u2 = u2 / torch.sqrt(dot(u2, u2))
    u3 = v3 - dot(v3, u1) * u1 - dot(v3, u2) * u2
    u3 = u3 / torch.sqrt(dot(u3, u3))
    return u1, u2, u3


def generic_axes(metric: Metric, position: Tensor, params) -> tuple:
    """The chart part of the observer tetrad: the global Cartesian axes at
    the generic ``position``, as generic velocities ``(gx, gy, gz)`` (4,)
    in ``position``'s dtype (``calculate_tetrads`` cl.cl:2350-2380; the side
    of a wormhole from the sign of r).

    At one point a chart's ``torch.func.jvp`` may come out in float64: the
    tangent it gives a Python-float parameter is a float64 zero, and at one
    point every operand is a 0-d tensor, so it promotes (the ingoing
    Eddington-Finkelstein and Misner charts).  The axes are cast back, as
    the JAX package's are float32 throughout."""
    dev = position.device
    polar_camera = metric.to_polar(position, params)
    apolar = polar_camera[1:4].clone()
    apolar[0] = torch.abs(polar_camera[1])
    cart_camera = tr.polar_to_cartesian3(apolar)
    sign_r = torch.where(polar_camera[1] < 0, -1.0, 1.0)

    def to_generic(c3):
        s3 = tr.cartesian_velocity_to_polar_velocity(cart_camera, c3)
        s3 = torch.cat([(s3[0] * sign_r)[None], s3[1:]])
        v4 = torch.cat([torch.zeros((1,), device=dev), s3])
        return metric.from_polar_velocity(polar_camera, v4,
                                          params).to(position.dtype)

    # The Cartesian axes, made on the device (a frame uploads nothing).
    return tuple(to_generic(axis) for axis in torch.eye(3, device=dev))


def observer_tetrad(metric: Metric, position: Tensor, params,
                    basis_speed3: Tensor | None = None) -> Tensor:
    """Observer tetrad at a generic position (4,): frame basis, orientation
    to the global polar axes, then the Lorentz boost (``calculate_tetrads``
    cl.cl:2288-2439).  Returns ``es`` (4, 4) with ``es[a][mu] = e_a^mu``.

    On a CUDA device and asking for no gradient, it is the chart part
    (:func:`generic_axes`, eager) and one launch of the observer kernel
    (``ops.raymarch.observer_tetrad_cuda``), bit for bit its eager twin
    :func:`observer_tetrad_reference`; a metric without a kernel instance
    raises ``NotImplementedError``, as the march does.  The twin serves the
    CPU and a call in grad mode where the position, the speed or a parameter
    requires grad.  Each call adds to the open frame's ``camera_kernel`` or
    ``camera_eager`` counter."""
    if position.is_cuda and not raymarch.asks_for_grad(
            position, basis_speed3, params=params):
        return raymarch.observer_tetrad_cuda(
            metric, position, generic_axes(metric, position, params), params,
            basis_speed3)
    profiling.count("camera_eager")
    return observer_tetrad_reference(metric, position, params, basis_speed3)


def observer_tetrad_reference(metric: Metric, position: Tensor, params,
                              basis_speed3: Tensor | None = None) -> Tensor:
    """:func:`observer_tetrad` in eager torch ops on any device (the
    observer kernel's twin; differentiable)."""
    dev = position.device
    gab = metric.fn(position, params)
    es, _ = tetrad.frame_basis(gab)
    inv_es = tetrad.tetrad_inverse(es)
    gx, gy, gz = generic_axes(metric, position, params)

    # Normalise with y first so camera controls work intuitively.
    tE1 = tetrad.coordinate_to_tetrad(gy, inv_es)
    tE2 = tetrad.coordinate_to_tetrad(gx, inv_es)
    tE3 = tetrad.coordinate_to_tetrad(gz, inv_es)

    b1, b2, b3 = _orthonormalise3(tE1[1:], tE2[1:], tE3[1:])

    def back(b3v):
        return tetrad.tetrad_to_coordinate(
            torch.cat([torch.zeros((1,), device=dev), b3v]), es)

    # x <- basis2, y <- basis1, z <- basis3 (cl.cl:2389-2398).
    es = torch.stack([es[0], back(b2), back(b1), back(b3)])

    if basis_speed3 is None:
        basis_speed3 = torch.zeros(3, device=dev)
    return tetrad.boost_tetrad(es, basis_speed3, gab)


class Camera(NamedTuple):
    """Camera state: polar position (t, r, theta, phi), orientation
    quaternion and tetrad-frame observer 3-velocity (float32 tensors).

    ``frame_override`` attaches the camera to a recorded geodesic: a
    ``(generic position (4,), tetrad (4, 4))`` pair (from
    ``physics.interpolate_camera``) used as it is instead of the
    static-observer construction."""

    polar_position: Tensor
    quat: Tensor
    basis_speed: Tensor
    frame_override: tuple | None = None

    @classmethod
    def default(cls, *, device) -> "Camera":
        return cls(
            polar_position=_vec([0.0, 7.0, math.pi / 2, -math.pi / 2], device),
            quat=quat_identity(device=device),
            basis_speed=torch.zeros(3, device=device),
        )

    def to(self, device) -> "Camera":
        override = self.frame_override
        if override is not None:
            override = tuple(t.to(device) for t in override)
        return Camera(self.polar_position.to(device), self.quat.to(device),
                      self.basis_speed.to(device), override)

    def on_geodesic(self, position: Tensor, tetrad: Tensor) -> "Camera":
        """Attach to a geodesic frame (the reference's "Snapshot Camera
        Geodesic" flow, main.cpp:2675-2759)."""
        return self._replace(frame_override=(position, tetrad))

    def translate(self, local_dir3: Tensor, amount) -> "Camera":
        """Move along a camera-local direction in flat cartesian terms
        (main.cpp:701-711); the sign of r (the side of a wormhole) is
        kept."""
        from .coordinates import transforms as tr

        d = rot_quat(local_dir3, self.quat)
        apolar = self.polar_position[1:4]
        cart = tr.polar_to_cartesian3(
            torch.cat([torch.abs(apolar[:1]), apolar[1:]]))
        new_polar = tr.cartesian_to_polar3(cart + d * amount)
        sign = torch.where(self.polar_position[1] < 0, -1.0, 1.0)
        return self._replace(polar_position=torch.cat(
            [self.polar_position[:1], new_polar[:1] * sign, new_polar[1:]]))

    def rotate(self, yaw=0.0, pitch=0.0, roll=0.0) -> "Camera":
        """Local-axis rotation, matching camera::rotate (main.cpp:686-699)."""
        q = self.quat
        dev = q.device
        for axis, angle in (
            (_vec([0.0, 0.0, 1.0], dev), roll),
            (_vec([1.0, 0.0, 0.0], dev), pitch),
            (_vec([0.0, 1.0, 0.0], dev), yaw),
        ):
            local_axis = rot_quat(axis, q)
            q = quat_multiply(
                axis_angle_quat(local_axis, _vec(float(angle), dev)), q)
        return self._replace(quat=q)
