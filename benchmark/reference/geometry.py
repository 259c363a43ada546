"""Differential geometry of the plain reference.

Frozen copy of ``geodesic_raytracing_tpu_torch/ops/geometry.py`` and of
``sym_metric`` / ``diag_metric`` of ``metrics/base.py`` at commit e647ccc,
trimmed to the polar charts and the metrics of the benchmark's
configurations (no content-pack emitter hooks, no rank-1 path).
Component-first batches: events ``x`` (4, N), metrics (4, 4, N); partials
from ``torch.func.jvp``.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_PI = 3.141592653589793
_PI_2 = 1.5707963267948966
_PI_4 = 0.7853981633974483


def recip(x: Tensor) -> Tensor:
    return torch.reciprocal(x)


def _arctan_poly(x: Tensor) -> Tensor:
    ax = torch.abs(x)
    inv = ax > 1.0
    t = torch.where(inv, 1.0 / torch.clamp(ax, min=1e-37), ax)
    red = t > 0.4142135623730951  # tan(pi/8)
    u = torch.where(red, (t - 1.0) / (t + 1.0), t)
    z = u * u
    p = (((8.05374449538e-2 * z - 1.38776856032e-1) * z
          + 1.99777106478e-1) * z - 3.33329491539e-1) * z * u + u
    y = torch.where(red, p + _PI_4, p)
    y = torch.where(inv, _PI_2 - y, y)
    return torch.where(x < 0, -y, y)


def _arctan2_poly(y: Tensor, x: Tensor) -> Tensor:
    y, x = torch.broadcast_tensors(y, x)
    safe_x = torch.where(x == 0.0, torch.ones_like(x), x)
    base = _arctan_poly(y / safe_x)
    zero = torch.zeros_like(y)
    base = torch.where(
        x == 0.0,
        torch.where(y > 0, zero + _PI_2, torch.where(y < 0, zero - _PI_2, zero)),
        base,
    )
    corr = torch.where(y < 0, zero - _PI, zero + _PI)
    return torch.where(x < 0, base + corr, base)


class _Arctan2(torch.autograd.Function):
    @staticmethod
    def forward(y, x):
        return _arctan2_poly(y, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)

    @staticmethod
    def jvp(ctx, dy, dx):
        y, x = ctx.saved_tensors
        d = torch.clamp(x * x + y * y, min=1e-37)
        return (x * dy - y * dx) / d


def arctan2(y: Tensor, x: Tensor) -> Tensor:
    """The reference renderer's polynomial atan2 with the exact tangent."""
    return _Arctan2.apply(y, x)


def matvec(m: Tensor, v: Tensor) -> Tensor:
    out = m[:, 0] * v[0]
    for j in range(1, m.shape[1]):
        out = out + m[:, j] * v[j]
    return out


def dot(u: Tensor, v: Tensor) -> Tensor:
    out = u[0] * v[0]
    for j in range(1, u.shape[0]):
        out = out + u[j] * v[j]
    return out


def inverse44(m: Tensor) -> Tensor:
    """General 4x4 inverse by cofactor expansion."""
    a = m
    s0 = a[0, 0] * a[1, 1] - a[1, 0] * a[0, 1]
    s1 = a[0, 0] * a[1, 2] - a[1, 0] * a[0, 2]
    s2 = a[0, 0] * a[1, 3] - a[1, 0] * a[0, 3]
    s3 = a[0, 1] * a[1, 2] - a[1, 1] * a[0, 2]
    s4 = a[0, 1] * a[1, 3] - a[1, 1] * a[0, 3]
    s5 = a[0, 2] * a[1, 3] - a[1, 2] * a[0, 3]

    c5 = a[2, 2] * a[3, 3] - a[3, 2] * a[2, 3]
    c4 = a[2, 1] * a[3, 3] - a[3, 1] * a[2, 3]
    c3 = a[2, 1] * a[3, 2] - a[3, 1] * a[2, 2]
    c2 = a[2, 0] * a[3, 3] - a[3, 0] * a[2, 3]
    c1 = a[2, 0] * a[3, 2] - a[3, 0] * a[2, 2]
    c0 = a[2, 0] * a[3, 1] - a[3, 0] * a[2, 1]

    det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0
    invdet = 1.0 / det

    b = [
        [
            (a[1, 1] * c5 - a[1, 2] * c4 + a[1, 3] * c3) * invdet,
            (-a[0, 1] * c5 + a[0, 2] * c4 - a[0, 3] * c3) * invdet,
            (a[3, 1] * s5 - a[3, 2] * s4 + a[3, 3] * s3) * invdet,
            (-a[2, 1] * s5 + a[2, 2] * s4 - a[2, 3] * s3) * invdet,
        ],
        [
            (-a[1, 0] * c5 + a[1, 2] * c2 - a[1, 3] * c1) * invdet,
            (a[0, 0] * c5 - a[0, 2] * c2 + a[0, 3] * c1) * invdet,
            (-a[3, 0] * s5 + a[3, 2] * s2 - a[3, 3] * s1) * invdet,
            (a[2, 0] * s5 - a[2, 2] * s2 + a[2, 3] * s1) * invdet,
        ],
        [
            (a[1, 0] * c4 - a[1, 1] * c2 + a[1, 3] * c0) * invdet,
            (-a[0, 0] * c4 + a[0, 1] * c2 - a[0, 3] * c0) * invdet,
            (a[3, 0] * s4 - a[3, 1] * s2 + a[3, 3] * s0) * invdet,
            (-a[2, 0] * s4 + a[2, 1] * s2 - a[2, 3] * s0) * invdet,
        ],
        [
            (-a[1, 0] * c3 + a[1, 1] * c1 - a[1, 2] * c0) * invdet,
            (a[0, 0] * c3 - a[0, 1] * c1 + a[0, 2] * c0) * invdet,
            (-a[3, 0] * s3 + a[3, 1] * s1 - a[3, 2] * s0) * invdet,
            (a[2, 0] * s3 - a[2, 1] * s1 + a[2, 2] * s0) * invdet,
        ],
    ]
    return torch.stack([torch.stack(row) for row in b])


def sym_metric(entries: dict) -> Tensor:
    """A symmetric 4x4 metric from an upper-triangle entry dict; components
    of shape ``B`` give (4, 4, *B)."""
    ref = next(v for v in entries.values() if isinstance(v, torch.Tensor))
    vals = torch.broadcast_tensors(*(
        v if isinstance(v, torch.Tensor)
        else torch.full((), float(v), dtype=ref.dtype, device=ref.device)
        for v in entries.values()))
    z = torch.zeros_like(vals[0])
    grid = [[z] * 4 for _ in range(4)]
    for (i, j), v in zip(entries.keys(), vals):
        grid[i][j] = v
        if i != j:
            grid[j][i] = v
    return torch.stack([torch.stack(row) for row in grid])


def diag_metric(d0, d1, d2, d3) -> Tensor:
    return sym_metric({(0, 0): d0, (1, 1): d1, (2, 2): d2, (3, 3): d3})


def metric_and_partials_batched(g, x: Tensor, params, deps) -> tuple:
    """``(gab (4, 4, N), dgab)`` with ``dgab[c]`` = d g / d x^c or None
    outside ``deps``: one ``torch.func.jvp`` over the batch repeated once
    per dependent coordinate."""
    dgs: list = [None, None, None, None]
    n = x.shape[-1]
    xs = x.repeat(1, len(deps))
    seed = torch.zeros_like(xs)
    for k, c in enumerate(deps):
        seed[c, k * n:(k + 1) * n] = 1.0
    gab, dg = torch.func.jvp(lambda y: g(y, params), (xs,), (seed,))
    for k, c in enumerate(deps):
        dgs[c] = dg[..., k * n:(k + 1) * n]
    return gab[..., :n], dgs


# ``None`` is the structural zero of a sparse metric.

def _pmul(x, y):
    return None if x is None or y is None else x * y


def _padd(x, y):
    if x is None:
        return y
    if y is None:
        return x
    return x + y


def _psub(x, y):
    if y is None:
        return x
    if x is None:
        return -y
    return x - y


def _pneg(x):
    return None if x is None else -x


def _sym_entries(m: Tensor, nz: frozenset):
    def get(i, j):
        key = (i, j) if i <= j else (j, i)
        return m[i, j] if key in nz else None

    return [[get(i, j) for j in range(4)] for i in range(4)]


def _inv44_sym_entries(E):
    """Pruned symmetric-4x4 inverse over an entry grid (Tensor-or-None)."""
    a = E[0][0]; b = E[0][1]; c = E[0][2]; d = E[0][3]  # noqa: E702
    e = E[1][1]; f = E[1][2]; g_ = E[1][3]  # noqa: E702
    h = E[2][2]; i = E[2][3]  # noqa: E702
    j = E[3][3]

    hj_ii = _psub(_pmul(h, j), _pmul(i, i))
    fj_gi = _psub(_pmul(f, j), _pmul(g_, i))
    fi_gh = _psub(_pmul(f, i), _pmul(g_, h))
    ej_gg = _psub(_pmul(e, j), _pmul(g_, g_))
    ei_gf = _psub(_pmul(e, i), _pmul(g_, f))
    eh_ff = _psub(_pmul(e, h), _pmul(f, f))
    cj_di = _psub(_pmul(c, j), _pmul(d, i))
    ci_dh = _psub(_pmul(c, i), _pmul(d, h))
    cg_df = _psub(_pmul(c, g_), _pmul(d, f))
    bj_dg = _psub(_pmul(b, j), _pmul(d, g_))
    bi_df = _psub(_pmul(b, i), _pmul(d, f))
    bg_de = _psub(_pmul(b, g_), _pmul(d, e))
    bh_cf = _psub(_pmul(b, h), _pmul(c, f))
    bf_ce = _psub(_pmul(b, f), _pmul(c, e))

    def tri(x, p, y, q, z, r):
        return _padd(_psub(_pmul(x, p), _pmul(y, q)), _pmul(z, r))

    C00 = tri(e, hj_ii, f, fj_gi, g_, fi_gh)
    C01 = _pneg(tri(b, hj_ii, f, cj_di, g_, ci_dh))
    C02 = tri(b, fj_gi, e, cj_di, g_, cg_df)
    C03 = _pneg(tri(b, fi_gh, e, ci_dh, f, cg_df))
    C11 = tri(a, hj_ii, c, cj_di, d, ci_dh)
    C12 = _pneg(tri(a, fj_gi, b, cj_di, d, cg_df))
    C13 = tri(a, fi_gh, b, ci_dh, c, cg_df)
    C22 = tri(a, ej_gg, b, bj_dg, d, bg_de)
    C23 = _pneg(tri(a, ei_gf, b, bi_df, c, bg_de))
    C33 = tri(a, eh_ff, b, bh_cf, c, bf_ce)

    det = _padd(_padd(_pmul(a, C00), _pmul(b, C01)),
                _padd(_pmul(c, C02), _pmul(d, C03)))
    inv_det = 1.0 / det

    C = [[C00, C01, C02, C03],
         [C01, C11, C12, C13],
         [C02, C12, C22, C23],
         [C03, C13, C23, C33]]
    return [[_pmul(C[r][s], inv_det) for s in range(4)] for r in range(4)]


def acceleration_batched(g, x: Tensor, v: Tensor, params, deps,
                         nz: frozenset | None) -> Tensor:
    """Geodesic acceleration, x and v (4, N) -> (4, N):
    S_n = v^a v^b (d_a g_nb - 1/2 d_n g_ab),  a = -g^{-1} S."""

    def present(i, j):
        return nz is None or ((i, j) if i <= j else (j, i)) in nz

    gab, dg = metric_and_partials_batched(g, x, params, deps)
    vv: dict = {}

    def vvp(a, b):
        key = (a, b) if a <= b else (b, a)
        if key not in vv:
            vv[key] = v[key[0]] * v[key[1]]
        return vv[key]

    S = []
    for n in range(4):
        acc = None
        for a in deps:
            for b in range(4):
                if not present(n, b):
                    continue
                t = vvp(a, b) * dg[a][n, b]
                acc = t if acc is None else acc + t
        if dg[n] is not None:
            for a in range(4):
                for b in range(a, 4):
                    if not present(a, b):
                        continue
                    w = 1.0 if a == b else 2.0
                    t = (0.5 * w) * vvp(a, b) * dg[n][a, b]
                    acc = -t if acc is None else acc - t
        S.append(acc)

    if nz is None:
        nz = frozenset((i, j) for i in range(4) for j in range(i, 4))
    ginv = _inv44_sym_entries(_sym_entries(gab, nz))
    zero = torch.zeros_like(v[0])
    out = []
    for mu in range(4):
        acc = None
        for n in range(4):
            acc = _padd(acc, _pmul(ginv[mu][n], S[n]))
        out.append(-acc if acc is not None else zero)
    return torch.stack(out)


def fix_null_batched(gab: Tensor, v: Tensor) -> Tensor:
    """Rescale v^t so that g(v, v) = 0, keeping the root closest to the
    original v^t."""
    vs = v.clone()
    vs[0] = 0.0
    a = gab[0, 0]
    b = 2.0 * (gab[0, 0] * vs[0] + gab[0, 1] * vs[1] + gab[0, 2] * vs[2]
               + gab[0, 3] * vs[3])
    c = 0.0
    for i in range(4):
        for j in range(4):
            c = c + gab[i, j] * vs[i] * vs[j]
    disc = torch.clamp(b * b - 4.0 * a * c, min=0.0)
    sq = torch.sqrt(disc)
    r0 = (-b - sq) / (2.0 * a)
    r1 = (-b + sq) / (2.0 * a)
    want = v[0]
    vt = torch.where(torch.abs(r0 - want) < torch.abs(r1 - want), r0, r1)
    lin = -c / torch.where(torch.abs(b) < 1e-12, torch.full_like(b, 1e-12), b)
    vt = torch.where(torch.abs(a) < 1e-12, lin, vt)
    out = v.clone()
    out[0] = vt
    return out
