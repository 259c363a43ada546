"""GR triangle rendering: swept-volume ("toblerone") intersection (port of
``geodesic_raytracing_tpu.triangles.render``).

Camera ray paths are recorded (cl.cl:4181-4232); each object sweeps its
triangles along its precomputed geodesic; a ray segment hits a triangle when
the fixed-point solve of ``ray_intersects_toblerone2`` (cl.cl:3846-3952)
converges onto a consistent coordinate time, where a Moller-Trumbore test in
the object's local (inverse-tetrad) frame decides the hit, shaded by surface
normal (``render_chunked_tris`` cl.cl:4573-4734).

Four intersectors, as in the reference, in plain torch on the path's device
(the reference's are plain XLA, not kernels):

* :func:`intersect_scene`: every ray segment x object segment x triangle,
  the oracle;
* :func:`intersect_scene_binned`: per (ray block x ray segment) chunk, a
  fixed budget of swept triangles whose 4-D AABBs overlap the chunk's;
* :func:`intersect_scene_grouped`: binning at object-segment granularity,
  one object-level fixed point per (ray x object segment), patch culling
  and Moller-Trumbore in the object's local frame;
* :func:`intersect_scene_compact`: the grouped intersector's work as three
  fixed-budget phases with static-size compaction between them.

Where the reference selects with ``top_k`` on 0/1 overlap values (almost
every value ties; ``lax.top_k`` keeps the lowest indices among ties), this
port sorts with ``stable=True`` and slices.  ``jnp.nonzero(size=W,
fill_value=0)`` becomes :func:`_nonzero_static`, a cumulative count and a
binary search, which never reads the count on the host.  Nearest hits
resolve with ``scatter_reduce_(..., "amin")`` on the key, then on the item
index among equal keys.  :data:`CHUNK` bounds the elements of one batch of
intersection tests (rays x candidates x triangles); no result depends on it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..metrics.base import Metric
from ..ops import integrate
from ..ops.integrate import Features, RayState, TraceOptions
from .physics import ObjectGeodesic
from .scene import TriangleScene

Tensor = torch.Tensor

# Elements of one batch of intersection tests (see the module docstring).
CHUNK = 1 << 22

_INT32_MAX = int(np.iinfo(np.int32).max)


# ---------------------------------------------------------------------------
# Vector helpers: the coordinate axis last, sums in index order (as the
# reference's reductions over 3 or 4 components run)
# ---------------------------------------------------------------------------

def _dot3(a: Tensor, b: Tensor) -> Tensor:
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _cross(a: Tensor, b: Tensor) -> Tensor:
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def _unit(n: Tensor) -> Tensor:
    """``n / max(|n|, 1e-12)`` along the last axis."""
    return n / torch.clamp(torch.sqrt(_dot3(n, n)), min=1e-12)[..., None]


def _matvec4(m: Tensor, x: Tensor) -> Tensor:
    """``m @ x`` for (..., 4, 4) matrices and (..., 4) vectors."""
    return (m[..., 0] * x[..., None, 0] + m[..., 1] * x[..., None, 1]
            + m[..., 2] * x[..., None, 2] + m[..., 3] * x[..., None, 3])


def _row0(m: Tensor, x: Tensor) -> Tensor:
    """``(m @ x)[0]``."""
    return (m[..., 0, 0] * x[..., 0] + m[..., 0, 1] * x[..., 1]
            + m[..., 0, 2] * x[..., 2] + m[..., 0, 3] * x[..., 3])


def _take(nt, idx):
    """Index every field of a NamedTuple of tensors by ``idx``."""
    return type(nt)(*(t[idx] for t in nt))


def _topk_stable(x: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """``lax.top_k`` along the last axis: the k largest, the lowest index
    first among equal values."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _nonzero_static(mask: Tensor, size: int) -> Tensor:
    """``jnp.nonzero(mask.ravel(), size=size, fill_value=0)``: the indices
    of the first ``size`` set elements in row-major order, padded with 0.
    Entry j is found as the first position where the running count of set
    elements reaches j + 1."""
    flat = mask.reshape(-1)
    count = torch.cumsum(flat, 0, dtype=torch.int64)
    want = torch.arange(1, size + 1, dtype=torch.int64, device=flat.device)
    idx = torch.searchsorted(count, want)
    return torch.where(idx < flat.numel(), idx, 0)


def _chunks(n: int, per: int):
    """``(start, stop)`` of consecutive chunks of ``per`` (>= 1) over n."""
    per = max(int(per), 1)
    for a in range(0, n, per):
        yield a, min(a + per, n)


# ---------------------------------------------------------------------------
# Primitives
# ---------------------------------------------------------------------------

def periodic_diff(a: Tensor, b: Tensor, periods: Tensor) -> Tensor:
    """Shortest difference a - b with per-coordinate wrapping
    (cl.cl:3598-3630).  ``torch.round`` rounds half to even, as
    ``jnp.round``."""
    d = a - b
    safe = torch.where(periods > 0, periods, 1.0)
    wrapped = d - torch.round(d / safe) * safe
    return torch.where(periods > 0, wrapped, d)


def _ray_plane(pos3, dir3, p0, n):
    """cl.cl:3436-3456 ray/plane; returns (ok, t)."""
    denom = _dot3(dir3, n)
    ok = torch.abs(denom) >= 1e-6
    t = _dot3(p0 - pos3, n) / torch.where(ok, denom, 1.0)
    return ok, torch.where(ok, t, 0.0)


def _moller_trumbore(o, d, v0, v1, v2):
    """Moller-Trumbore (cl.cl:3473-3520) on (..., 3) vectors; returns (hit,
    t) with t in ray parameter units (inf where no hit)."""
    e1 = v1 - v0
    e2 = v2 - v0
    h = _cross(d, e2)
    a = _dot3(e1, h)
    ok = torch.abs(a) > 1e-9
    f = 1.0 / torch.where(ok, a, 1.0)
    s = o - v0
    u = f * _dot3(s, h)
    q = _cross(s, e1)
    v = f * _dot3(d, q)
    t = f * _dot3(e2, q)
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
    return hit, torch.where(hit, t, torch.inf)


def _moller_trumbore_cf(o, d, v0, v1, v2):
    """Component-first Moller-Trumbore: each argument is a 3-tuple of
    mutually broadcastable tensors (x, y, z).  The same arithmetic as
    :func:`_moller_trumbore`, the triangle axis minor."""
    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    def dot(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    e1 = tuple(v1[i] - v0[i] for i in range(3))
    e2 = tuple(v2[i] - v0[i] for i in range(3))
    h = cross(d, e2)
    a = dot(e1, h)
    ok = torch.abs(a) > 1e-9
    f = 1.0 / torch.where(ok, a, 1.0)
    s = tuple(o[i] - v0[i] for i in range(3))
    u = f * dot(s, h)
    q = cross(s, e1)
    v = f * dot(d, q)
    t = f * dot(e2, q)
    hit = ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1) & (t > 1e-6)
    return hit, torch.where(hit, t, torch.inf)


def _fixed_point(ga, gb, p1, p2, ie_r, ie_n, periods, ray_t):
    """The toblerone fixed point (cl.cl:3846-3952): 8 iterations that move
    the object along its segment (``frac``) to the coordinate time at which
    the ray meets it.  ``ray_t(pos, dirv)`` gives the ray parameter of the
    meeting point in the object's local frame.  Arguments broadcast; vectors
    (..., 4), inverse tetrads (..., 4, 4).  Returns ``(pos, dirv, o_start,
    o_end)`` of the last iteration."""
    ray_vel = gb - ga
    base = periodic_diff(ga, p1, periods) + p1
    d_ie = ie_n - ie_r
    d_p = p2 - p1
    nf = torch.zeros((), dtype=ga.dtype, device=ga.device)
    for _ in range(8):
        frac = torch.clamp(nf, 0.0, 1.0)
        ie = ie_r + frac[..., None, None] * d_ie
        obj_pos = p1 + frac[..., None] * d_p
        pos = _matvec4(ie, base - obj_pos)
        dirv = _matvec4(ie, ray_vel)
        t = ray_t(pos, dirv)
        o_start = _row0(ie, p1 - obj_pos)
        o_end = _row0(ie, p2 - obj_pos)
        ipt0 = pos[..., 0] + dirv[..., 0] * t
        span = o_end - o_start
        nf = (ipt0 - o_start) / torch.where(torch.abs(span) < 1e-12, 1.0,
                                            span)
    return pos, dirv, o_start, o_end


def _toblerone_hit(ga, gb, v0, v1, v2, p1, p2, ie_r, ie_n, periods,
                   plane_n=None):
    """One (ray segment) x (object segment) x (triangle) test
    (``ray_intersects_toblerone2`` cl.cl:3846-3952), broadcast over leading
    axes.  ``ie_r``/``ie_n`` are the inverse tetrads (rows = co-frame legs)
    at the two object nodes; ``plane_n`` the triangle's unit normal (default:
    from the vertices).  Returns (hit, t) with t in [0, 1] along the ray
    segment (inf where no hit)."""
    if plane_n is None:
        plane_n = _unit(_cross(v1 - v0, v2 - v0))

    def plane_t(pos, dirv):
        return _ray_plane(pos[..., 1:], dirv[..., 1:], v0, plane_n)[1]

    pos, dirv, o_start, o_end = _fixed_point(ga, gb, p1, p2, ie_r, ie_n,
                                             periods, plane_t)
    hit, t = _moller_trumbore(pos[..., 1:], dirv[..., 1:], v0, v1, v2)
    end_t = pos[..., 0] + dirv[..., 0] * t
    hit = (hit & (end_t >= torch.minimum(o_start, o_end))
           & (end_t <= torch.maximum(o_start, o_end))
           & (t >= 0) & (t <= 1))
    return hit, torch.where(hit, t, torch.inf)


def _closest_approach_t(pos, dirv):
    """Ray parameter of the local ray's closest approach to the object's
    origin, clipped to the segment."""
    o3, d3 = pos[..., 1:], dirv[..., 1:]
    t = -_dot3(o3, d3) / torch.clamp(_dot3(d3, d3), min=1e-12)
    return torch.clamp(t, 0.0, 1.0)


def _object_local_ray(ga, gb, p1, p2, ie_r, ie_n, periods):
    """Object-LEVEL toblerone fixed point: :func:`_toblerone_hit`'s
    iteration converging on the ray's closest approach to the object's local
    origin instead of one triangle's plane; solved once per (ray segment x
    object segment), after which the ray is straight in the local frame.
    Returns (pos, dirv, o_start, o_end)."""
    return _fixed_point(ga, gb, p1, p2, ie_r, ie_n, periods,
                        _closest_approach_t)


def _sphere_near(pos, dirv, radius):
    """The local ray passes within ``radius`` of the object's origin."""
    o3, d3 = pos[..., 1:], dirv[..., 1:]
    cp = o3 + _closest_approach_t(pos, dirv)[..., None] * d3
    return _dot3(cp, cp) <= radius * radius


def _ray_aabb(o, d, lo, hi):
    """Slab test of the [0, 1] ray segment o + t d against AABBs.
    ``lo/hi``: (..., 3) broadcastable against o/d.  Returns (hit, tmin)."""
    tiny = torch.where(d < 0, -1e-12, 1e-12)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-12, tiny, d)
    t1 = (lo - o) * inv
    t2 = (hi - o) * inv
    tmin = torch.amax(torch.minimum(t1, t2), dim=-1)
    tmax = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tmax >= torch.clamp(tmin, min=0.0)) & (tmin <= 1.0)
    return hit, tmin


def _periodic_aabb_overlap(lo1, hi1, lo2, hi2, periods):
    """Periodic 4-D AABB overlap (``common.cl:58-119``): centre distances
    (shortest wrapped) against summed half-extents.  Shapes broadcast; the
    coordinate axis is last."""
    c1, h1 = (lo1 + hi1) * 0.5, (hi1 - lo1) * 0.5
    c2, h2 = (lo2 + hi2) * 0.5, (hi2 - lo2) * 0.5
    d = torch.abs(periodic_diff(c1, c2, periods))
    return torch.all(d <= h1 + h2, dim=-1)


def _tri_tensors(scene: TriangleScene, mask, device):
    return tuple(torch.as_tensor(np.asarray(v)[mask], device=device)
                 for v in (scene.v0, scene.v1, scene.v2))


# ---------------------------------------------------------------------------
# The dense intersector (the oracle)
# ---------------------------------------------------------------------------

def intersect_scene(metric: Metric, path: Tensor, scene: TriangleScene,
                    geos: list[ObjectGeodesic], params):
    """Test every recorded ray segment against every object's swept
    triangles.

    ``path``: (S+1, N, 4).  Returns ``(hit (N,), colour (N, 3))``: the
    earliest-segment nearest hit, shaded by local-frame normal.  Each
    (segment, object) batch runs in chunks of rays and triangles of at most
    ``CHUNK`` tests; within a chunk the first minimum wins, across chunks
    the lower (object segment, triangle) index, as one argmin over all.  A
    ray whose segment is a point (a terminated ray) cannot hit, and is not
    tested."""
    dev = path.device
    periods = metric.periods(params, device=dev)
    S, n = path.shape[0] - 1, path.shape[1]
    best_key = torch.full((n,), torch.inf, device=dev)
    colour = torch.zeros((n, 3), device=dev)

    parent = np.asarray(scene.parent)
    sets = []
    for oi, geo in enumerate(geos):
        v0s, v1s, v2s = _tri_tensors(scene, parent == oi, dev)
        sets.append((v0s, v1s, v2s, _unit(_cross(v1s - v0s, v2s - v0s)),
                     geo))

    for s in range(S):
        ga_all, gb_all = path[s], path[s + 1]
        live = torch.nonzero((ga_all != gb_all).any(-1)).flatten()
        if live.numel() == 0:
            continue
        for v0s, v1s, v2s, nrm, geo in sets:
            T = v0s.shape[0]
            K = geo.positions.shape[0] - 1
            if T == 0 or K <= 0:
                continue
            p1 = geo.positions[:-1][None, :, None, :]
            p2 = geo.positions[1:][None, :, None, :]
            ier = geo.inv_tetrads[:-1][None, :, None]
            ien = geo.inv_tetrads[1:][None, :, None]
            t_chunk = min(T, max(1, CHUNK // K))
            r_chunk = max(1, CHUNK // (K * t_chunk))
            for r0, r1 in _chunks(live.numel(), r_chunk):
                rays = live[r0:r1]
                ga = ga_all[rays][:, None, None, :]
                gb = gb_all[rays][:, None, None, :]
                t_best = torch.full((rays.numel(),), torch.inf, device=dev)
                i_best = torch.zeros((rays.numel(),), dtype=torch.int64,
                                     device=dev)
                for a, b in _chunks(T, t_chunk):
                    tri = [x[a:b][None, None] for x in (v0s, v1s, v2s, nrm)]
                    hits, ts = _toblerone_hit(ga, gb, tri[0], tri[1], tri[2],
                                              p1, p2, ier, ien, periods,
                                              plane_n=tri[3])
                    ts = torch.where(hits, ts, torch.inf)  # (r, K, b - a)
                    tmin, arg = ts.reshape(rays.numel(), -1).min(dim=1)
                    k_of, t_of = arg // (b - a), arg % (b - a) + a
                    idx = k_of * T + t_of
                    better = (tmin < t_best) | ((tmin == t_best)
                                                & (idx < i_best))
                    t_best = torch.where(better, tmin, t_best)
                    i_best = torch.where(better, idx, i_best)
                any_hit = torch.isfinite(t_best)
                col = torch.abs(nrm)[i_best % T]
                key = s + torch.clamp(t_best, 0.0, 1.0)
                better = any_hit & (key < best_key[rays])
                best_key[rays] = torch.where(better, key, best_key[rays])
                colour[rays] = torch.where(better[:, None], col,
                                           colour[rays])
    return torch.isfinite(best_key), colour


# ---------------------------------------------------------------------------
# The binned intersector
# ---------------------------------------------------------------------------

class SweptTriangles(NamedTuple):
    """The "computed tris" buffer (``generate_computed_tris`` cl.cl:4386):
    one entry per (object geodesic segment x triangle), all objects
    concatenated, with padded 4-D AABBs and what the toblerone solve needs
    gathered per entry."""

    lo: Tensor  # (M, 4) AABB min (generic coordinates)
    hi: Tensor  # (M, 4) AABB max
    v0: Tensor  # (M, 3) local-frame triangle vertices
    v1: Tensor
    v2: Tensor
    p1: Tensor  # (M, 4) object node positions bounding the segment
    p2: Tensor
    ier: Tensor  # (M, 4, 4) inverse tetrads at the nodes
    ien: Tensor
    normal: Tensor  # (M, 3) local-frame unit normal (shading)


def _local_to_world(local3: Tensor, p: Tensor, es: Tensor) -> Tensor:
    """World positions ``p^mu + v^a e_a^mu`` (``tetrad_to_coordinate``
    cl.cl:2150) of local points (..., 3) (a = 1..3; the time component 0)
    at every node: (K, ..., 4) for nodes ``p`` (K, 4), tetrads ``es`` (K, 4,
    4) (rows = legs)."""
    lead = (es.shape[0],) + (1,) * (local3.dim() - 1)
    e = [es[:, a].reshape(lead + (4,)) for a in range(4)]
    loc = local3[None]
    offs = (0.0 * e[0] + loc[..., 0, None] * e[1]
            + loc[..., 1, None] * e[2] + loc[..., 2, None] * e[3])
    return p.reshape(lead + (4,)) + offs


def build_swept_triangles(scene: TriangleScene, geos: list[ObjectGeodesic],
                          pad: float = 0.0) -> SweptTriangles:
    """Sweep every object's triangles along its geodesic segments and bound
    each swept volume with a 4-D AABB (``generate_computed_tris``
    cl.cl:4386-4488): the 6 world vertices at the two bounding nodes."""
    parts = []
    parent = np.asarray(scene.parent)
    for oi, geo in enumerate(geos):
        mask = parent == oi
        if not mask.any():
            continue
        dev = geo.positions.device
        v0, v1, v2 = _tri_tensors(scene, mask, dev)  # (T, 3)
        T = v0.shape[0]
        p, es = geo.positions, geo.tetrads  # (K, 4), (K, 4, 4)
        K = p.shape[0]
        world = _local_to_world(torch.stack([v0, v1, v2], 1), p, es)
        both = torch.cat([world[:-1], world[1:]], dim=2)  # (K-1, T, 6, 4)
        lo = torch.amin(both, dim=2) - pad
        hi = torch.amax(both, dim=2) + pad
        nrm = _unit(_cross(v1 - v0, v2 - v0))

        def per_tri(x):  # (T, ...) -> (M_o, ...) tiled over segments
            return x.repeat((K - 1,) + (1,) * (x.dim() - 1))

        def per_seg(x):  # (K-1, ...) -> (M_o, ...) repeated over triangles
            return torch.repeat_interleave(x, T, dim=0)

        parts.append(SweptTriangles(
            lo=lo.reshape(-1, 4), hi=hi.reshape(-1, 4),
            v0=per_tri(v0), v1=per_tri(v1), v2=per_tri(v2),
            p1=per_seg(p[:-1]), p2=per_seg(p[1:]),
            ier=per_seg(geo.inv_tetrads[:-1]),
            ien=per_seg(geo.inv_tetrads[1:]),
            normal=per_tri(nrm)))
    return SweptTriangles(*(torch.cat(xs) for xs in zip(*parts)))


def _pad_path(path: Tensor, block: int) -> tuple[Tensor, int]:
    """The path with its ray axis padded to whole blocks by copies of the
    last ray.  Returns (padded path, block count)."""
    n = path.shape[1]
    nb = -(-n // block)
    fill = path[:, -1:].expand(path.shape[0], nb * block - n, 4)
    return torch.cat([path, fill], dim=1), nb


def _chunk_aabbs(ga: Tensor, gb: Tensor):
    """Per-block AABBs of the blocks' segment endpoints
    (``generate_clip_regions`` cl.cl:4265)."""
    seg = torch.cat([ga, gb], dim=1)
    return torch.amin(seg, dim=1), torch.amax(seg, dim=1)


def intersect_scene_binned(metric: Metric, path: Tensor,
                           scene: TriangleScene,
                           geos: list[ObjectGeodesic], params,
                           block: int = 256, budget: int = 64,
                           pad: float = 0.0, with_stats: bool = False):
    """Binned twin of :func:`intersect_scene`: per (ray block x ray segment)
    chunk, only the ``budget`` swept triangles whose AABBs overlap the
    chunk's AABB run the toblerone solve (``generate_clip_regions`` ->
    ``generate_tri_lists2`` -> ``render_chunked_tris``, cl.cl:4265-4734).

    A chunk whose overlap set exceeds ``budget`` keeps the lowest entries
    (the earliest object segments); exact whenever the per-chunk overlap
    count fits the budget.  ``with_stats`` also returns ``{"dropped":
    candidates cut by the budget, "max_overlap": the worst chunk's overlap
    count}``."""
    dev = path.device
    periods = metric.periods(params, device=dev)
    swept = build_swept_triangles(scene, geos, pad=pad)
    M = swept.lo.shape[0]
    B = min(budget, M)
    S, n = path.shape[0] - 1, path.shape[1]
    path_p, nb = _pad_path(path, block)
    n_pad = nb * block

    best_key = torch.full((n_pad,), torch.inf, device=dev)
    colour = torch.zeros((n_pad, 3), device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    max_overlap = torch.zeros((), dtype=torch.int64, device=dev)
    per = max(1, CHUNK // max(block * B, M))

    for s in range(S):
        ga_all = path_p[s].reshape(nb, block, 4)
        gb_all = path_p[s + 1].reshape(nb, block, 4)
        t_parts, n_parts = [], []
        for a, b in _chunks(nb, per):
            ga, gb = ga_all[a:b], gb_all[a:b]
            lo_c, hi_c = _chunk_aabbs(ga, gb)
            ov = _periodic_aabb_overlap(lo_c[:, None], hi_c[:, None],
                                        swept.lo[None], swept.hi[None],
                                        periods)  # (G, M)
            n_ov = ov.sum(dim=1)
            if with_stats:
                dropped = dropped + torch.clamp(n_ov - B, min=0).sum()
                max_overlap = torch.maximum(max_overlap, n_ov.max())
            # Candidates past every chunk's overlap count are invalid
            # everywhere: only the first ones are tested (no result
            # changes; one read of the count).
            b_eff = max(1, min(B, int(n_ov.max())))
            vals, idx = _topk_stable(ov.to(torch.float32), b_eff)
            valid = vals > 0.0
            c = _take(swept, idx)  # (G, b_eff, ...)

            def cand(x):  # (G, B, ...) -> (G, 1, B, ...)
                return x[:, None]

            hits, ts = _toblerone_hit(
                ga[:, :, None], gb[:, :, None], cand(c.v0), cand(c.v1),
                cand(c.v2), cand(c.p1), cand(c.p2), cand(c.ier),
                cand(c.ien), periods)  # (G, block, B)
            hits = hits & valid[:, None, :]
            ts = torch.where(hits, ts, torch.inf)
            t_best, arg = ts.min(dim=2)  # (G, block)
            t_parts.append(t_best)
            n_parts.append(torch.gather(
                c.normal, 1, arg[..., None].expand(-1, -1, 3)))
        t_best = torch.cat(t_parts).reshape(n_pad)
        col = torch.abs(torch.cat(n_parts).reshape(n_pad, 3))
        key = s + torch.clamp(t_best, 0.0, 1.0)
        better = torch.isfinite(t_best) & (key < best_key)
        best_key = torch.where(better, key, best_key)
        colour = torch.where(better[:, None], col, colour)

    if with_stats:
        return torch.isfinite(best_key[:n]), colour[:n], {
            "dropped": dropped, "max_overlap": max_overlap}
    return torch.isfinite(best_key[:n]), colour[:n]


# ---------------------------------------------------------------------------
# Object-level structures: patches and swept objects
# ---------------------------------------------------------------------------

class Patches(NamedTuple):
    """Static local-frame triangle patches, one set per object
    (:func:`build_patches`).  Objects are rigid in their own tetrad frame,
    so this structure is built once per scene on the host."""

    v0: Tensor      # (O, P, ps, 3) local-frame vertices, padded
    v1: Tensor
    v2: Tensor
    normal: Tensor  # (O, P, ps, 3) unit normals
    valid: Tensor   # (O, P, ps) real-triangle mask
    lo: Tensor      # (O, P, 3) patch AABB min (local frame)
    hi: Tensor      # (O, P, 3)


def build_patches(scene: TriangleScene, n_objects: int,
                  patch_size: int = 32, *, device) -> Patches:
    """Group each object's triangles into spatially coherent fixed-size
    patches (recursive median split along the widest centroid axis), with
    local-frame AABBs.  Host-side numpy, as the reference's; the tables
    then move to ``device``."""
    v0s, v1s, v2s = (np.asarray(scene.v0), np.asarray(scene.v1),
                     np.asarray(scene.v2))
    parent = np.asarray(scene.parent)

    def kd_order(cent):
        """An ordering that groups nearby centroids into contiguous runs of
        patch_size."""
        def split(ids):
            if ids.size <= patch_size:
                return [ids]
            c = cent[ids]
            axis = int(np.argmax(c.max(0) - c.min(0)))
            order = ids[np.argsort(c[:, axis], kind="stable")]
            half = max((ids.size // 2 // patch_size) * patch_size,
                       patch_size)
            return split(order[:half]) + split(order[half:])

        return np.concatenate(split(np.arange(cent.shape[0])))

    per_obj = []
    for oi in range(n_objects):
        m = parent == oi
        a, b, c = v0s[m], v1s[m], v2s[m]
        T = a.shape[0]
        if T == 0:
            a = b = c = np.zeros((1, 3), np.float32)
            T = 1
        order = kd_order((a + b + c) / 3.0)
        a, b, c = a[order], b[order], c[order]
        pad = -T % patch_size
        va = np.ones(T + pad, bool)
        va[T:] = False
        if pad:
            filler = np.repeat(a[-1:], pad, axis=0)
            a = np.concatenate([a, filler])
            b = np.concatenate([b, filler])
            c = np.concatenate([c, filler])
        P = a.shape[0] // patch_size
        a = a.reshape(P, patch_size, 3)
        b = b.reshape(P, patch_size, 3)
        c = c.reshape(P, patch_size, 3)
        va = va.reshape(P, patch_size)
        nrm = np.cross(b - a, c - a)
        nrm = nrm / np.maximum(np.linalg.norm(nrm, axis=-1, keepdims=True),
                               1e-12)
        allv = np.stack([a, b, c], axis=2)  # (P, ps, 3, 3)
        lo = np.where(va[..., None], allv.min(2), np.inf).min(1)
        hi = np.where(va[..., None], allv.max(2), -np.inf).max(1)
        lo = np.where(np.isfinite(lo), lo, 0.0)
        hi = np.where(np.isfinite(hi), hi, 0.0)
        per_obj.append((a, b, c, nrm, va, lo, hi))

    p_max = max(p[0].shape[0] for p in per_obj)

    def stacked(i, fill=0.0):
        out = []
        for p in per_obj:
            x = p[i]
            extra = p_max - x.shape[0]
            if extra:
                x = np.concatenate(
                    [x, np.full((extra,) + x.shape[1:], fill, x.dtype)])
            out.append(x)
        return torch.as_tensor(np.stack(out), device=device)

    return Patches(v0=stacked(0), v1=stacked(1), v2=stacked(2),
                   normal=stacked(3), valid=stacked(4, False),
                   lo=stacked(5), hi=stacked(6))


class SweptObjects(NamedTuple):
    """One entry per (object x geodesic segment): the object's whole swept
    4-D AABB plus the frame data of its bounding nodes."""

    lo: Tensor   # (Mo, 4)
    hi: Tensor   # (Mo, 4)
    p1: Tensor   # (Mo, 4)
    p2: Tensor   # (Mo, 4)
    ier: Tensor  # (Mo, 4, 4)
    ien: Tensor  # (Mo, 4, 4)
    obj: Tensor  # (Mo,) int64 object index
    radius: Tensor  # (Mo,) local bounding radius


def build_swept_objects(scene: TriangleScene, geos: list[ObjectGeodesic],
                        pad: float = 0.0) -> SweptObjects:
    """Sweep each object's local bounding box (8 corners) along its
    geodesic segments: the object-level analogue of
    :func:`build_swept_triangles`."""
    parts = []
    parent = np.asarray(scene.parent)
    for oi, geo in enumerate(geos):
        m = parent == oi
        if not m.any():
            continue
        dev = geo.positions.device
        verts = np.concatenate([np.asarray(scene.v0)[m],
                                np.asarray(scene.v1)[m],
                                np.asarray(scene.v2)[m]])
        blo, bhi = verts.min(0), verts.max(0)
        radius = float(np.linalg.norm(np.maximum(np.abs(blo), np.abs(bhi))))
        corners = np.array([[blo[0], blo[1], blo[2]],
                            [blo[0], blo[1], bhi[2]],
                            [blo[0], bhi[1], blo[2]],
                            [blo[0], bhi[1], bhi[2]],
                            [bhi[0], blo[1], blo[2]],
                            [bhi[0], blo[1], bhi[2]],
                            [bhi[0], bhi[1], blo[2]],
                            [bhi[0], bhi[1], bhi[2]]], np.float32)
        p = geo.positions
        world = _local_to_world(torch.as_tensor(corners, device=dev), p,
                                geo.tetrads)  # (K, 8, 4)
        both = torch.cat([world[:-1], world[1:]], dim=1)  # (K-1, 16, 4)
        K = p.shape[0]
        parts.append(SweptObjects(
            lo=torch.amin(both, dim=1) - pad,
            hi=torch.amax(both, dim=1) + pad,
            p1=p[:-1], p2=p[1:],
            ier=geo.inv_tetrads[:-1], ien=geo.inv_tetrads[1:],
            obj=torch.full((K - 1,), oi, dtype=torch.int64, device=dev),
            radius=torch.full((K - 1,), radius, dtype=torch.float32,
                              device=dev)))
    return SweptObjects(*(torch.cat(xs) for xs in zip(*parts)))


# ---------------------------------------------------------------------------
# The grouped intersector
# ---------------------------------------------------------------------------

def intersect_scene_grouped(metric: Metric, path: Tensor,
                            scene: TriangleScene,
                            geos: list[ObjectGeodesic], params,
                            block: int = 256, obj_budget: int = 8,
                            chunk_budget: int | None = None,
                            patch_budget: int = 8, patch_size: int = 32,
                            pad: float = 0.0, with_stats: bool = False,
                            stage: int = 3):
    """Two-level intersector for dense scenes: budgeted binning at
    object-segment granularity, then per (ray x object-segment candidate)
    one object-level fixed point, a bounding-sphere test, patch-AABB slab
    tests over :func:`build_patches`'s structure, and Moller-Trumbore on the
    ``patch_budget x patch_size`` triangles of the nearest patches hit.

    ``chunk_budget``: ray blocks processed per segment (the most candidates
    first; None = all).  ``with_stats`` reports dropped object-segment
    candidates and chunks, the worst chunk's overlap and the survivor counts
    ``sphere_pass`` and ``patch_pass``.  ``stage`` (cost decomposition):
    0 = binning only, 1 = + object-local solve and sphere test, 2 = + patch
    culling, 3 = full; stages < 3 return no hits."""
    dev = path.device
    periods = metric.periods(params, device=dev)
    patches = build_patches(scene, len(geos), patch_size=patch_size,
                            device=dev)
    swept = build_swept_objects(scene, geos, pad=pad)
    Mo = swept.lo.shape[0]
    OB = min(obj_budget, Mo)
    P = patches.lo.shape[1]
    PB = min(patch_budget, P)
    S, n = path.shape[0] - 1, path.shape[1]
    path_p, nb = _pad_path(path, block)
    n_pad = nb * block
    CB = nb if chunk_budget is None else min(chunk_budget, nb)

    best_key = torch.full((n_pad,), torch.inf, device=dev)
    colour = torch.zeros((n_pad, 3), device=dev)
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    dropped_cand = dropped_chunks = max_overlap = zero
    sphere_pass = patch_pass = torch.zeros((), device=dev)
    per = max(1, CHUNK // (block * max(P, PB * patch_size)))
    ray_iota = torch.arange(block, device=dev)

    for s in range(S):
        ga = path_p[s].reshape(nb, block, 4)
        gb = path_p[s + 1].reshape(nb, block, 4)
        lo_c, hi_c = _chunk_aabbs(ga, gb)
        ov = _periodic_aabb_overlap(lo_c[:, None], hi_c[:, None],
                                    swept.lo[None], swept.hi[None],
                                    periods)  # (nb, Mo)
        cnt = ov.sum(dim=1)
        if with_stats:
            dropped_cand = dropped_cand + torch.clamp(cnt - OB, min=0).sum()
            max_overlap = torch.maximum(max_overlap, cnt.max())
        _, chunk_sel = _topk_stable(cnt, CB)  # (CB,)
        chunk_live = cnt[chunk_sel] > 0
        if with_stats and CB < nb:
            dropped_chunks = dropped_chunks + torch.clamp(
                (cnt > 0).sum() - CB, min=0)
        vals, cand = _topk_stable(ov[chunk_sel].to(torch.float32), OB)
        cand_valid = (vals > 0.0) & chunk_live[:, None]  # (CB, OB)
        ga_s, gb_s = ga[chunk_sel], gb[chunk_sel]  # (CB, block, 4)
        co = _take(swept, cand)  # (CB, OB, ...)

        # Candidate j >= the largest count is invalid in every chunk: it
        # is not tested (no result changes; one read of the count).
        ob_eff = min(OB, int(cnt.max())) if stage >= 1 else 0
        t_all, n_all = [], []
        for j in range(ob_eff):
            tj, nj = [], []
            for a, b in _chunks(CB, per):
                def ray_axis(x):  # (G, ...) -> (G, 1, ...)
                    return x[a:b, j][:, None]

                ok = cand_valid[a:b, j]  # (G,)
                pos, dirv, o_start, o_end = _object_local_ray(
                    ga_s[a:b], gb_s[a:b], ray_axis(co.p1), ray_axis(co.p2),
                    ray_axis(co.ier), ray_axis(co.ien), periods)
                near = _sphere_near(pos, dirv, ray_axis(co.radius))
                near = near & ok[:, None]  # (G, block)
                if with_stats:
                    sphere_pass = sphere_pass + near.sum()
                if stage < 2:
                    continue
                obj = co.obj[a:b, j]  # (G,)
                o3, d3 = pos[..., None, 1:], dirv[..., None, 1:]
                phit, ptmin = _ray_aabb(o3, d3, patches.lo[obj][:, None],
                                        patches.hi[obj][:, None])  # (G,blk,P)
                if with_stats:
                    patch_pass = patch_pass + (phit & near[..., None]).sum()
                if stage < 3:
                    continue
                score = torch.where(phit, -ptmin, -torch.inf)
                _, pidx = _topk_stable(score, PB)  # (G, block, PB)
                pvalid = torch.gather(phit, 2, pidx)
                oidx = obj[:, None, None]

                def tri(x):  # (O, P, ps, ...) -> (G, block, PB * ps, ...)
                    g = x[oidx, pidx]
                    return g.reshape(g.shape[:2] + (-1,) + g.shape[4:])

                tva = tri(patches.valid) & pvalid[..., None].expand(
                    -1, -1, -1, patch_size).reshape(pvalid.shape[:2] + (-1,))
                tnm = tri(patches.normal)
                hit, t = _moller_trumbore(o3, d3, tri(patches.v0),
                                          tri(patches.v1), tri(patches.v2))
                end_t = pos[..., None, 0] + dirv[..., None, 0] * t
                hit = (hit & tva
                       & (end_t >= torch.minimum(o_start, o_end)[..., None])
                       & (end_t <= torch.maximum(o_start, o_end)[..., None])
                       & (t >= 0) & (t <= 1))
                t = torch.where(hit, t, torch.inf)
                t_min, arg = t.min(dim=2)  # (G, block)
                tj.append(torch.where(ok[:, None], t_min, torch.inf))
                nj.append(torch.gather(
                    tnm, 2, arg[..., None, None].expand(-1, -1, 1, 3))[:, :,
                                                                        0])
            if stage >= 3:
                t_all.append(torch.cat(tj))  # (CB, block)
                n_all.append(torch.cat(nj))  # (CB, block, 3)

        if stage >= 3 and t_all:
            t_stack = torch.stack(t_all)  # (OB, CB, block)
            n_stack = torch.stack(n_all)  # (OB, CB, block, 3)
            t_best, jbest = t_stack.min(dim=0)  # (CB, block)
            nrm = torch.gather(n_stack, 0, jbest[None, ..., None].expand(
                1, -1, -1, 3))[0]
            flat_idx = (chunk_sel[:, None] * block
                        + ray_iota[None, :]).reshape(-1)
            t_flat = t_best.reshape(-1)
            col = torch.abs(nrm.reshape(-1, 3))
            key = s + torch.clamp(t_flat, 0.0, 1.0)
            cur = best_key[flat_idx]
            better = torch.isfinite(t_flat) & (key < cur)
            best_key[flat_idx] = torch.where(better, key, cur)
            colour[flat_idx] = torch.where(better[:, None], col,
                                           colour[flat_idx])

    if with_stats:
        return torch.isfinite(best_key[:n]), colour[:n], {
            "dropped": dropped_cand, "dropped_chunks": dropped_chunks,
            "max_overlap": max_overlap, "sphere_pass": sphere_pass,
            "patch_pass": patch_pass}
    return torch.isfinite(best_key[:n]), colour[:n]


# ---------------------------------------------------------------------------
# The compact intersector
# ---------------------------------------------------------------------------

class _Pairs(NamedTuple):
    """Phase B's worklist: per kept (ray segment x object segment) pair,
    its ray segment, ray, object and the object-local ray of the re-solved
    fixed point."""

    s: Tensor        # (n_p,) ray segment
    ray: Tensor      # (n_p,) ray (of the block-padded rays)
    obj: Tensor      # (n_p,) object
    pos: Tensor      # (n_p, 4) local ray origin
    dirv: Tensor     # (n_p, 4) local ray direction
    o_start: Tensor  # (n_p,) object time window
    o_end: Tensor


def _bin_and_sphere(path_p: Tensor, nb: int, block: int,
                    swept: SweptObjects, OB: int, periods: Tensor):
    """Phase A: dense binning of every (ray block x ray segment) against the
    swept objects, the object-local fixed point and the bounding-sphere
    test of each (ray x object-segment candidate) pair.  Only the valid
    (block, candidate) entries are solved (one read of their count a chunk
    of blocks); the others' bits are False, as the reference masks them.
    Returns ``(near (S, nb, OB, block) bool, cand (S, nb, OB))``."""
    dev = path_p.device
    S = path_p.shape[0] - 1
    near_s, cand_s = [], []
    per_a = max(1, CHUNK // (OB * block))
    for s in range(S):
        ga_all = path_p[s].reshape(nb, block, 4)
        gb_all = path_p[s + 1].reshape(nb, block, 4)
        for a, b in _chunks(nb, per_a):
            ga, gb = ga_all[a:b], gb_all[a:b]
            lo_c, hi_c = _chunk_aabbs(ga, gb)
            ov = _periodic_aabb_overlap(lo_c[:, None], hi_c[:, None],
                                        swept.lo[None], swept.hi[None],
                                        periods)  # (G, Mo)
            vals, cand = _topk_stable(ov.to(torch.float32), OB)  # (G, OB)
            near = torch.zeros(cand.shape + (block,), dtype=torch.bool,
                               device=dev)
            g, j = torch.nonzero(vals > 0.0, as_tuple=True)
            if g.numel():
                co = _take(swept, cand[g, j])  # (L, ...)
                pos, dirv, _, _ = _object_local_ray(
                    ga[g], gb[g], co.p1[:, None], co.p2[:, None],
                    co.ier[:, None], co.ien[:, None], periods)  # (L, block)
                near[g, j] = _sphere_near(pos, dirv, co.radius[:, None])
            near_s.append(near)  # (G, OB, block)
            cand_s.append(cand)
    return (torch.cat(near_s).reshape(S, nb, OB, block),
            torch.cat(cand_s).reshape(S, nb, OB))


def _compact_pairs(near: Tensor, cand: Tensor, path_p: Tensor,
                   swept: SweptObjects, periods: Tensor,
                   pair_budget: int | None):
    """Phase B, first half: the (ray x candidate) pairs that passed the
    sphere test, compacted (the non-empty (segment, block, candidate) rows
    first, then the pairs among them) and re-solved.  Returns ``(pairs,
    kept, Wp)``: the kept pairs (a :class:`_Pairs`), the count of pairs
    that fit the row budget (a tensor) and the pair budget."""
    dev = near.device
    S, nb, OB, block = near.shape
    n_blocks = S * nb * OB
    rows = near.reshape(n_blocks, block)
    blk_any = rows.any(dim=1)
    if pair_budget is None:
        WB = max(int(blk_any.sum()), 1)
    else:
        WB = min(max(pair_budget // 8, 1024), n_blocks)
    bidx = _nonzero_static(blk_any, WB)
    rows_b = rows[bidx] & (torch.arange(WB, device=dev)
                           < blk_any.sum())[:, None]  # (WB, block)
    kept = rows_b.sum().to(torch.float32)
    Wp = max(int(kept), 1) if pair_budget is None else pair_budget
    # The pairs kept are the first min(kept, Wp) of the reference's
    # fixed-size list (the rest is its fill); only they are solved.
    n_p = min(int(kept), Wp)
    p2 = _nonzero_static(rows_b, n_p)
    pidx = bidx[p2 // block] * block + p2 % block
    # Decode (s, block, j, ray in block) from the flat index.
    per_s = nb * OB * block
    s_of = pidx // per_s
    rem = pidx % per_s
    cb_of = rem // (OB * block)
    rem = rem % (OB * block)
    j_of = rem // block
    ray_of = cb_of * block + rem % block  # global ray

    n_pad = nb * block
    path_flat = path_p.reshape((S + 1) * n_pad, 4)
    ep = _take(swept, cand[s_of, cb_of, j_of])  # (n_p, ...)
    pos, dirv, o_start, o_end = _object_local_ray(
        path_flat[s_of * n_pad + ray_of],
        path_flat[(s_of + 1) * n_pad + ray_of],
        ep.p1, ep.p2, ep.ier, ep.ien, periods)  # (n_p, 4) ...
    return _Pairs(s_of, ray_of, ep.obj, pos, dirv, o_start, o_end), kept, Wp


def _patch_tests(pairs: _Pairs, patches: Patches) -> Tensor:
    """Phase B, second half: the slab test of every kept pair's local ray
    against its object's patch AABBs.  Returns the (n_p, P) bitmask."""
    P = patches.lo.shape[1]
    n_p = pairs.obj.shape[0]
    return torch.cat(
        [torch.zeros((0, P), dtype=torch.bool, device=patches.lo.device)] + [
            _ray_aabb(pairs.pos[a:b, None, 1:], pairs.dirv[a:b, None, 1:],
                      patches.lo[pairs.obj[a:b]],
                      patches.hi[pairs.obj[a:b]])[0]
            for a, b in _chunks(n_p, CHUNK // P)])  # (n_p, P)


def _compact_items(phit: Tensor, patch_slots: int, tri_budget: int | None):
    """Phase C, first half: the (pair, patch) items, the first
    ``patch_slots`` patches hit of each pair (0 = every patch hit), in
    pair-major, patch-ascending order.  Returns ``(pair, patch, kept,
    Wt)``: each kept item's pair and patch, the count of items (a tensor)
    and the item budget."""
    dev = phit.device
    n_p, P = phit.shape
    if patch_slots:
        # Slot k is where the pair's running count of hit patches first
        # reaches k + 1.
        K = min(patch_slots, P)
        count = torch.cumsum(phit, dim=1, dtype=torch.int64)  # (n_p, P)
        want = torch.arange(1, K + 1, device=dev).expand(n_p, K).contiguous()
        slot_v = count[:, -1:] >= want  # (n_p, K)
        slot_pa = torch.searchsorted(count, want)
        kept = slot_v.sum().to(torch.float32)
    else:
        K, slot_v, kept = P, phit, phit.sum().to(torch.float32)
    Wt = max(int(kept), 1) if tri_budget is None else tri_budget
    # As the pairs: the first min(kept, Wt) items of the fixed-size list.
    tidx = _nonzero_static(slot_v, min(int(kept), Wt))
    pr_of = tidx // K
    pa_of = slot_pa[pr_of, tidx % K] if patch_slots else tidx % K
    return pr_of, pa_of, kept, Wt


def _patch_tables(patches: Patches):
    """The patch tables (O, P, 3, ps) of v0, v1, v2 and the normals: the
    item axis leads, triangles minor."""
    return tuple(torch.swapaxes(x, -1, -2) for x in (
        patches.v0, patches.v1, patches.v2, patches.normal))


def _nearest_hits(pairs: _Pairs, pr_of: Tensor, pa_of: Tensor,
                  patches: Patches, n_pad: int):
    """Phase C, second half: Moller-Trumbore of each item's local ray
    against its patch's triangles, then the nearest hit per ray by a
    deterministic two-pass scatter-min (the key, then the item index among
    equal keys).  Returns ``(key (n_pad,), colour (n_pad, 3))``, the key
    inf where no hit."""
    dev = pr_of.device
    f32 = torch.float32
    n_t, ps = pr_of.shape[0], patches.v0.shape[2]
    v0t, v1t, v2t, nmt = _patch_tables(patches)
    t_item = torch.full((n_t,), torch.inf, dtype=f32, device=dev)
    nrm_item = torch.zeros((max(n_t, 1), 3), dtype=f32, device=dev)
    for a, b in _chunks(n_t, CHUNK // ps):
        pr, pa = pr_of[a:b], pa_of[a:b]
        objt = pairs.obj[pr]
        o3, d3 = pairs.pos[pr, 1:], pairs.dirv[pr, 1:]
        tv = [x[objt, pa] for x in (v0t, v1t, v2t)]  # (c, 3, ps)
        hit, t = _moller_trumbore_cf(
            tuple(o3[:, i:i + 1] for i in range(3)),
            tuple(d3[:, i:i + 1] for i in range(3)),
            *(tuple(x[:, i] for i in range(3)) for x in tv))  # (c, ps)
        end_t = (pairs.pos[pr, 0][:, None]
                 + pairs.dirv[pr, 0][:, None] * t)
        lo_w = torch.minimum(pairs.o_start[pr], pairs.o_end[pr])[:, None]
        hi_w = torch.maximum(pairs.o_start[pr], pairs.o_end[pr])[:, None]
        hit = (hit & patches.valid[objt, pa]
               & (end_t >= lo_w) & (end_t <= hi_w) & (t >= 0) & (t <= 1))
        t = torch.where(hit, t, torch.inf)
        t_item[a:b], arg = t.min(dim=1)
        nrm_item[a:b] = torch.gather(nmt[objt, pa], 2,
                                     arg[:, None, None].expand(-1, 3, 1))[
                                         ..., 0]

    key_item = torch.where(torch.isfinite(t_item),
                           pairs.s[pr_of].to(f32)
                           + torch.clamp(t_item, 0.0, 1.0), torch.inf)
    ray_item = pairs.ray[pr_of]
    best_key = torch.full((n_pad,), torch.inf, device=dev).scatter_reduce_(
        0, ray_item, key_item, "amin", include_self=True)
    tie = torch.where(torch.isfinite(key_item)
                      & (key_item <= best_key[ray_item]),
                      torch.arange(n_t, device=dev), _INT32_MAX)
    winner = torch.full((n_pad,), _INT32_MAX, dtype=torch.int64,
                        device=dev).scatter_reduce_(
        0, ray_item, tie, "amin", include_self=True)
    has = winner < _INT32_MAX
    colour = torch.where(
        has[:, None],
        torch.abs(nrm_item[torch.clamp(winner, 0, max(n_t - 1, 0))]), 0.0)
    return best_key, colour


def intersect_scene_compact(metric: Metric, path: Tensor,
                            scene: TriangleScene,
                            geos: list[ObjectGeodesic], params,
                            block: int = 256, obj_budget: int = 8,
                            pair_budget: int | None = 1 << 17,
                            tri_budget: int | None = 1 << 18,
                            patch_size: int = 128,
                            patch_slots: int = 8,
                            pad: float = 0.0, with_stats: bool = False,
                            stage: int = 4):
    """Worklist-compacted two-level intersector: the grouped intersector's
    tests as three fixed-budget phases with static-size compaction
    (:func:`_nonzero_static`) between them.

    A. dense binning + object-local fixed point + bounding-sphere test for
       every (ray x object-segment candidate) pair -> bitmask
       (:func:`_bin_and_sphere`);
    B. surviving pairs (<= ``pair_budget``; blocks of ``block`` pairs that
       hold one compacted first, at most max(pair_budget / 8, 1024) of them)
       re-solve and run the patch slab tests -> (pair x patch) bitmask
       (:func:`_compact_pairs`, :func:`_patch_tests`);
    C. the first ``patch_slots`` patches hit of each pair (0 = every patch)
       become items (<= ``tri_budget``), each gathers ONE patch's triangles
       and runs Moller-Trumbore; hits resolve to the nearest per ray by a
       deterministic two-pass scatter-min (key, then item index on equal
       keys) (:func:`_compact_items`, :func:`_nearest_hits`).

    Exact whenever the budgets cover the survivor counts; ``with_stats``
    reports ``sphere_pass``, ``patch_pass`` and the dropped pairs and items.
    A budget of None is sized to its survivors: the blocks and pairs of
    phase B, the items of C, so that nothing is dropped.

    Of the reference's fixed-size lists only the kept entries (a prefix) are
    computed, the fill is not: one read of the kept count on the host for
    the pairs and one for the items, and one for the number of valid
    (block, candidate) entries in each chunk of blocks of phase A.
    ``stage`` (cost decomposition): 0 = phase A, 1 = + pair compaction and
    re-solve, 2 = + patch slab tests, 3 = + item compaction and triangle
    gathers, 4 = full; stages < 4 return no hits.  Each phase runs in
    chunks (of ray blocks, pairs, items) of at most ``CHUNK`` tests."""
    dev = path.device
    f32 = torch.float32
    zero = torch.zeros((), dtype=f32, device=dev)
    periods = metric.periods(params, device=dev)
    patches = build_patches(scene, len(geos), patch_size=patch_size,
                            device=dev)
    swept = build_swept_objects(scene, geos, pad=pad)
    OB = min(obj_budget, swept.lo.shape[0])
    n = path.shape[1]
    path_p, nb = _pad_path(path, block)

    def result(hit, colour, *counters):
        names = ["sphere_pass", "patch_pass", "pairs_dropped",
                 "items_dropped", "dropped"]
        stats = dict(zip(names, counters))
        for k in names:
            stats.setdefault(k, zero)
        stats["max_overlap"] = torch.zeros((), dtype=torch.int64, device=dev)
        return (hit, colour, stats) if with_stats else (hit, colour)

    def no_hits(*counters):  # a stage's early out
        return result(torch.zeros((n,), dtype=torch.bool, device=dev),
                      torch.zeros((n, 3), dtype=f32, device=dev), *counters)

    # --- Phase A: dense bin + solve + sphere test ------------------------
    near, cand = _bin_and_sphere(path_p, nb, block, swept, OB, periods)
    sphere_pass = near.sum().to(f32)
    if stage <= 0:
        return no_hits(sphere_pass)

    # --- Phase B: pair compaction + patch culling ------------------------
    pairs, kept_pairs, Wp = _compact_pairs(near, cand, path_p, swept,
                                           periods, pair_budget)
    del near
    pairs_dropped = sphere_pass - torch.clamp(kept_pairs, max=float(Wp))
    if stage <= 1:
        return no_hits(sphere_pass, zero, pairs_dropped)
    phit = _patch_tests(pairs, patches)
    patch_pass = phit.sum().to(f32)
    if stage <= 2:
        return no_hits(sphere_pass, patch_pass)

    # --- Phase C: (pair, patch) compaction + Moller-Trumbore -------------
    pr_of, pa_of, kept_items, Wt = _compact_items(phit, patch_slots,
                                                  tri_budget)
    del phit
    if stage <= 3:
        objt = pairs.obj[pr_of]
        gathered = sum(x[objt, pa_of].sum() for x in _patch_tables(patches))
        return no_hits(sphere_pass, patch_pass, zero,
                       0.0 * (gathered + patches.valid[objt, pa_of].sum()))
    items_dropped = patch_pass - torch.clamp(kept_items, max=float(Wt))
    best_key, colour = _nearest_hits(pairs, pr_of, pa_of, patches,
                                     nb * block)
    # Overflow counts against the budgets (fill indices may repeat entry
    # 0); the kept pairs account for the block budget too.
    return result(torch.isfinite(best_key[:n]), colour[:n], sphere_pass,
                  patch_pass, pairs_dropped, items_dropped,
                  pairs_dropped + items_dropped)


def render_triangles(metric: Metric, state: RayState, params,
                     scene: TriangleScene, geos: list[ObjectGeodesic],
                     features: Features | None = None,
                     opts: TraceOptions = TraceOptions(),
                     n_slots: int = 64, steps_per_slot: int = 8,
                     binned: bool = False, block: int = 256,
                     budget: int = 64, grouped: bool = False,
                     compact: bool = False, *,
                     image_width: int | None = None,
                     with_stats: bool = False, **intersect_kw):
    """Trace rays with path recording (on a CUDA device: ``n_slots``
    launches of the ray-march kernel, warp tiles of the row-major image of
    ``image_width`` if given), then intersect the scene.

    ``binned`` switches to the AABB-binned intersector, ``grouped`` to the
    two-level object/patch intersector, ``compact`` to its worklist form;
    ``budget`` is the binned budget or the object-segment budget, and
    ``intersect_kw`` further arguments of the chosen intersector (compact's
    ``pair_budget=None, tri_budget=None`` size them to the survivors).
    Returns ``(final RayState, hit (N,), colour (N, 3))``, and with
    ``with_stats`` the intersector's counters after them (empty for the
    dense one).  The recorded segments must be short where the field is
    strong: the toblerone solve interpolates the ray linearly within one,
    and (64, 8) records 512 iterations in segments that still see
    near-field objects."""
    if features is None:
        features = Features.for_metric(metric)
    final, path = integrate.trace_rays_recorded(
        metric, state, params, features=features, opts=opts,
        n_slots=n_slots, steps_per_slot=steps_per_slot,
        image_width=image_width)
    args = (metric, path, scene, geos, params)
    if compact:
        out = intersect_scene_compact(*args, block=block, obj_budget=budget,
                                      with_stats=with_stats, **intersect_kw)
    elif grouped:
        out = intersect_scene_grouped(*args, block=block, obj_budget=budget,
                                      with_stats=with_stats, **intersect_kw)
    elif binned:
        out = intersect_scene_binned(*args, block=block, budget=budget,
                                     with_stats=with_stats, **intersect_kw)
    else:
        out = intersect_scene(*args, **intersect_kw) + (
            ({},) if with_stats else ())
    return (final,) + tuple(out)
