"""Per-object geodesic precompute for triangle rendering (port of
``geodesic_raytracing_tpu.triangles.physics``).

``physics::setup``/``physics::trace`` (physics.hpp:49-278): every object gets
a timelike geodesic traced once, tetrads parallel-transported along it, the
tetrads inverted, and the path subsampled by proper distance
(``subsample_tri_quantity`` cl.cl:3643-3834, ``DISTANCE_SKIPPING``) so the
renderer interpolates over a short, evenly spaced node list.  Eager torch on
``device``, through ``physics.geodesics``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..metrics.base import Metric
from ..ops import tetrad
from ..ops.integrate import Features
from ..physics import geodesics
from .scene import Object3

Tensor = torch.Tensor


class ObjectGeodesic(NamedTuple):
    """Subsampled object worldline and frames (the buffers of
    physics.hpp:99-278 that the renderer reads)."""

    positions: Tensor  # (K, 4)
    tetrads: Tensor  # (K, 4, 4) transported tetrads (rows = legs)
    inv_tetrads: Tensor  # (K, 4, 4) inverse (co-frame) tetrads
    count: Tensor  # () int32 node count


def _linspace01(n: int, device) -> Tensor:
    """``jnp.linspace(0, 1, n)`` in float32 as the reference computes it:
    ``i * (1 / (n - 1))``, the last node exactly 1."""
    out = torch.arange(n, dtype=torch.float32, device=device) * float(
        np.float32(1.0) / np.float32(max(n - 1, 1)))
    out[-1] = 1.0
    return out


def precompute_object(metric: Metric, obj: Object3, params,
                      features: Features | None = None,
                      n_steps: int = 2048, segments: int = 64,
                      forward_and_back: bool = False, *,
                      device) -> ObjectGeodesic:
    """Trace the object's timelike geodesic on ``device`` and build its frame
    data (physics.hpp:99-278: cart_to_generic -> init_basis_vectors ->
    boost_tetrad -> init_inertial_ray -> get_geodesic_path ->
    parallel_transport_tetrads -> calculate_tetrad_inverse ->
    subsample_tri_quantity).  ``forward_and_back`` is accepted as the
    reference accepts it, and not read there either."""
    return precompute_objects(metric, [obj], params, features, n_steps,
                              segments, device=device)[0]


def precompute_objects(metric: Metric, objects: list[Object3], params,
                       features: Features | None = None,
                       n_steps: int = 2048, segments: int = 64, *,
                       device) -> list[ObjectGeodesic]:
    """:func:`precompute_object` of every object, their worldlines recorded
    together (``physics.record_geodesics``: one eager step a node for all,
    which on the card costs what one object's does); the transport and the
    subsampling follow each object's own nodes."""
    if features is None:
        features = Features.for_metric(metric)
    x0s, frames = [], []
    for obj in objects:
        # (t, x, y, z) world cartesian -> generic coordinates.
        cart = torch.as_tensor(np.asarray(obj.position, np.float32),
                               device=device)
        polar = torch.cat([cart[:1], _cart_to_polar3(cart[1:])])
        x0 = metric.from_polar(polar, params)
        gab = metric.fn(x0, params)
        es, _ = tetrad.frame_basis(gab)
        es = tetrad.boost_tetrad(
            es, torch.as_tensor(np.asarray(obj.velocity, np.float32),
                                device=device), gab)
        x0s.append(x0)
        frames.append(es)
    # The boosted timelike leg is each object's 4-velocity.
    paths = geodesics.record_geodesics(
        metric, torch.stack(x0s), torch.stack([es[0] for es in frames]),
        params, features, n_steps=n_steps)
    out = []
    for b, es in enumerate(frames):
        path = geodesics.GeodesicPath(
            positions=paths.positions[:, b], velocities=paths.velocities[:, b],
            ds=paths.ds[:, b], proper_time=paths.proper_time[:, b],
            count=paths.count[b])
        tets = geodesics.parallel_transport_tetrads(metric, path, es, params)
        # Proper-distance subsampling (DISTANCE_SKIPPING cl.cl:3762-3834):
        # nodes at equal proper-time intervals.
        count = torch.clamp(path.count.to(torch.int64), min=2)
        total = path.proper_time[count - 1]
        targets = _linspace01(segments, device) * total
        idx = torch.searchsorted(path.proper_time.contiguous(), targets)
        idx = torch.minimum(torch.clamp(idx, min=0), count - 1)
        sub_tets = tets[idx]
        out.append(ObjectGeodesic(
            positions=path.positions[idx], tetrads=sub_tets,
            inv_tetrads=geodesics.tetrad_inverses_along_path(sub_tets),
            count=torch.tensor(segments, dtype=torch.int32, device=device)))
    return out


def _cart_to_polar3(c: Tensor) -> Tensor:
    x, y, z = c[0], c[1], c[2]
    r = torch.sqrt(x * x + y * y + z * z)
    theta = torch.atan2(torch.sqrt(x * x + y * y), z)
    phi = torch.atan2(y, x)
    return torch.stack([r, theta, phi])
