"""Timelike geodesic recording, parallel transport and the camera that rides
a geodesic (port of ``geodesic_raytracing_tpu.physics.geodesics``):

* ``record_geodesic``: integrate one ray and record its position, velocity
  and step at every iteration (``get_geodesic_path`` cl.cl:4735-4940);
  ``record_geodesics`` does it for a batch of rays at once;
* ``parallel_transport_quantity``: Heun transport of a 4-vector along a
  recorded path (cl.cl:2569-2637);
* ``parallel_transport_tetrads``: all four legs, re-orthonormalised against
  the local metric at every node (cl.cl:2639-2736);
* ``tetrad_inverses_along_path`` (cl.cl:2534-2567) and
  ``interpolate_camera`` (``handle_interpolating_geodesic``
  cl.cl:2738-2872): proper-time bracket and linear interpolation.

Everything is eager torch on the device of its inputs.  A recording is one
ray, so on a GPU its time is launch latency; the loops stop at the end of the
ray's life (the recorder) or of the valid nodes (the transports) and fill the
remaining nodes as the reference's fixed-length scans leave them, so the
results are those of the full-length loops.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..metrics.base import Metric
from ..ops import geometry, integrate, tetrad
from ..ops.integrate import Features, TraceOptions

Tensor = torch.Tensor

CAMERA_PATH_STEPS = 64000  # main.cpp:1230
OBJECT_PATH_STEPS = 16000  # physics.hpp:10

# Iterations of the recorder between two reads of the ray's status.
_STATUS_EVERY = 64


class GeodesicPath(NamedTuple):
    """A recorded geodesic as T+1 nodes (node 0 = launch point).

    ``ds[i]`` is the affine step from node i to node i+1 (0 past the end and
    at a rejected trial); ``proper_time[i]`` is the cumulative parameter at
    node i; ``count`` (0-d int32) the number of valid nodes."""

    positions: Tensor  # (T+1, 4)
    velocities: Tensor  # (T+1, 4)
    ds: Tensor  # (T+1,)
    proper_time: Tensor  # (T+1,)
    count: Tensor  # () int32


def record_geodesic(metric: Metric, x0: Tensor, v0: Tensor, params,
                    features: Features = Features(),
                    n_steps: int = OBJECT_PATH_STEPS) -> GeodesicPath:
    """Integrate one (typically timelike) geodesic from ``x0``/``v0`` (4,)
    for ``n_steps`` iterations of the integrator step on a batch of one
    (no null fix of the velocity), recording every iteration.

    A ray that is no longer ACTIVE takes no-op iterations (ds = 0, no
    commit), so once it ends the loop stops and the remaining nodes repeat
    its last state with ds = 0, as the full loop would record them.
    ``count`` runs to the LAST committed node: rejected adaptive trials
    record duplicate nodes, so the commit count would fall short."""
    p = record_geodesics(metric, x0[None], v0[None], params, features,
                         n_steps)
    return GeodesicPath(positions=p.positions[:, 0],
                        velocities=p.velocities[:, 0], ds=p.ds[:, 0],
                        proper_time=p.proper_time[:, 0], count=p.count[0])


def record_geodesics(metric: Metric, x0: Tensor, v0: Tensor, params,
                     features: Features = Features(),
                     n_steps: int = OBJECT_PATH_STEPS) -> GeodesicPath:
    """:func:`record_geodesic` of B rays at once (``x0``, ``v0``: (B, 4)),
    one eager step for all of them: each ray's nodes are those its own
    recording has (the step is elementwise per ray; a ray that ended takes
    no-op iterations until the last one ends, and the loop stops once none
    is ACTIVE).  Every field gains a ray axis after the node axis: positions
    (T+1, B, 4), ds and proper_time (T+1, B), count (B,)."""
    state = integrate.init_ray_state(metric, x0, v0, params, features,
                                     fix_null_velocity=False)
    s = integrate._StateT(state.position.T, state.velocity.T,
                          state.acceleration.T, state.next_ds,
                          state.running_dlambda_dnew, state.status,
                          state.steps)
    f_in_x = torch.abs(s.velocity[0])
    step = integrate.make_step_fn(metric, features,
                                  TraceOptions(max_steps=n_steps),
                                  with_ds=True)
    pos, vel, ds, committed = [], [], [], []
    for i in range(n_steps):
        s2, d = step(s, f_in_x, params)
        pos.append(s2.position.T)
        vel.append(s2.velocity.T)
        ds.append(d)
        committed.append(s2.steps > s.steps)
        s = s2
        if (i + 1) % _STATUS_EVERY == 0 and not bool(
                (s.status == integrate.ACTIVE).any()):
            break
    rest = n_steps - len(pos)
    b = x0.shape[0]
    dev = x0.device
    pos = torch.cat([state.position[None], torch.stack(pos),
                     s.position.T.expand(rest, b, 4)])
    vel = torch.cat([state.velocity[None], torch.stack(vel),
                     s.velocity.T.expand(rest, b, 4)])
    committed = torch.cat([torch.stack(committed),
                           torch.zeros((rest, b), dtype=torch.bool,
                                       device=dev)])
    ds = torch.cat([torch.stack(ds), torch.zeros((rest + 1, b), device=dev)])
    idxs = torch.arange(1, n_steps + 1, dtype=torch.int32, device=dev)
    count = torch.amax(torch.where(committed, idxs[:, None], 0), dim=0) + 1
    tau = torch.cat([torch.zeros((1, b), device=dev),
                     torch.cumsum(ds[:-1], 0)])
    return GeodesicPath(positions=pos, velocities=vel, ds=ds,
                        proper_time=tau, count=count)


def _transport_maps(metric: Metric, path: GeodesicPath, params,
                    n: int) -> Tensor:
    """``A[i]`` (n, 4, 4) with dq/dlambda = A[i] q at node i:
    ``A^mu_b = -Gamma^mu_ab v^a`` (cl.cl:2586), the Christoffel symbols from
    the metric partials, ``Gamma^mu_ab = 1/2 g^mu n (d_a g_nb + d_b g_na -
    d_n g_ab)``.  The metric and its partials depend on the path only, so
    all nodes are evaluated in one batch."""
    x = path.positions[:n].T.contiguous()
    v = path.velocities[:n].T
    gab, dg = geometry.metric_and_partials_batched(metric.fn, x, params,
                                                   deps=metric.depends_on)
    if gab.ndim == 2:  # constant metric: add the batch axis
        gab = gab[..., None].expand(4, 4, n)
    zero = torch.zeros_like(gab)
    D = torch.stack([zero if d is None else d for d in dg])  # D[c, i, j, t]
    # G[m, a, b] = d_a g_mb + d_b g_ma - d_m g_ab
    G = D.permute(1, 0, 2, 3) + D.permute(1, 2, 0, 3) - D
    M = 0.5 * (G * v[None, :, None, :]).sum(1)  # M[m, b] = G[m, a, b] v^a / 2
    ginv = geometry.inverse44(gab)
    A = -(ginv[:, :, None, :] * M[None]).sum(1)  # A[mu, b] = -g^mu m M[m, b]
    return A.permute(2, 0, 1)


def _heun(A0: Tensor, A1: Tensor, q: Tensor, h: Tensor) -> Tensor:
    """One Heun step of dq/dlambda = A q over ``h`` (q (4, K))."""
    k1 = (A0[:, :, None] * q[None]).sum(1)
    q1 = q + h * k1
    k2 = (A1[:, :, None] * q1[None]).sum(1)
    return q + 0.5 * h * (k1 + k2)


def _pad_nodes(out: list, total: int) -> Tensor:
    """The transported values of ``total`` nodes: a node past the last valid
    one keeps the last value (its step is 0)."""
    last = out[-1]
    return torch.stack(out + [last] * (total - len(out)))


def parallel_transport_quantity(metric: Metric, path: GeodesicPath,
                                q0: Tensor, params) -> Tensor:
    """Transport ``q0`` (4,) along the recorded path with Heun's method
    (``parallel_transport_quantity`` cl.cl:2569-2637).  Returns (T+1, 4)."""
    n = max(int(path.count), 1)
    A = _transport_maps(metric, path, params, n)
    out, q = [q0], q0[:, None]
    for i in range(n - 1):
        h = path.ds[i]
        q = torch.where(h > 0, _heun(A[i], A[i + 1], q, h), q)
        out.append(q[:, 0])
    return _pad_nodes(out, path.positions.shape[0])


def parallel_transport_tetrads(metric: Metric, path: GeodesicPath,
                               es0: Tensor, params) -> Tensor:
    """Transport a full tetrad ``es0`` (4, 4), rows = legs, with a metric
    Gram-Schmidt at every node (``parallel_transport_tetrads``
    cl.cl:2639-2736, cl.cl:2707).  Returns (T+1, 4, 4)."""
    n = max(int(path.count), 1)
    A = _transport_maps(metric, path, params, n)
    gabs = metric.fn(path.positions[:n].T.contiguous(), params)
    if gabs.ndim == 2:
        gabs = gabs[..., None].expand(4, 4, n)
    out, es = [es0], es0
    for i in range(n - 1):
        h = path.ds[i]
        q = _heun(A[i], A[i + 1], es.T, h)
        es_n = tetrad._gram_schmidt_metric(q.T, gabs[..., i + 1])
        es = torch.where(h > 0, es_n, es)
        out.append(es)
    return _pad_nodes(out, path.positions.shape[0])


def tetrad_inverses_along_path(tetrads: Tensor) -> Tensor:
    """Batch tetrad inversions (``calculate_tetrad_inverse``
    cl.cl:2534-2567): (T, 4, 4) -> (T, 4, 4)."""
    # tetrad.tetrad_inverse(es) = inverse44(es.T), on a component-first batch.
    return geometry.inverse44(tetrads.permute(2, 1, 0)).permute(2, 0, 1)


def interpolate_camera(path: GeodesicPath, tetrads: Tensor, proper_time
                       ) -> tuple[Tensor, Tensor, Tensor]:
    """The camera riding the geodesic: the proper-time bracket, then linear
    interpolation of position, velocity and tetrad
    (``handle_interpolating_geodesic`` cl.cl:2738-2872).  Returns
    ``(position (4,), velocity (4,), tetrad (4, 4))``."""
    pt = path.proper_time
    tau = torch.as_tensor(proper_time, dtype=pt.dtype, device=pt.device)
    count = torch.clamp(path.count.to(torch.int64), min=1)
    tau = torch.minimum(torch.clamp(tau, min=0.0), pt[count - 1])
    idx = torch.searchsorted(pt, tau.reshape(1))[0]
    idx = torch.minimum(torch.clamp(idx, min=1), count - 1)
    t0, t1 = pt[idx - 1], pt[idx]
    frac = torch.where(t1 > t0, (tau - t0) / (t1 - t0), 0.0)

    def lerp(a):
        return a[idx - 1] + frac * (a[idx] - a[idx - 1])

    return lerp(path.positions), lerp(path.velocities), lerp(tetrads)
