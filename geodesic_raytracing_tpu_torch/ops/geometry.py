"""Core differential geometry (port of ``geodesic_raytracing_tpu.ops.geometry``).

Component-first batches: events ``x`` are (4, N), metrics (4, 4, N).  The
metric partials come from ``torch.func.jvp`` of the torch metric, one
tangent sweep per coordinate the metric depends on — the plain twin of the
kernel's dual numbers (``csrc/dual.cuh``), kept independent of them.
"""

from __future__ import annotations

import math
import threading
from typing import Callable

import torch

Tensor = torch.Tensor

MetricFn = Callable[..., Tensor]


def recip(x: Tensor) -> Tensor:
    """1/x with a division-free tangent, as the reference's custom-JVP
    ``recip``: torch's forward-mode rule for ``reciprocal`` reuses the
    primal, ``-dx * (y*y)`` (the reference groups it ``(-y*y) * dx``; the
    kernel's dual numbers follow the reference)."""
    return torch.reciprocal(x)


# The reference's polynomial inverse trig (written for Mosaic, which has no
# atan): ported as is so that endpoints that go through it track the
# reference.  The exact tangents are kept as custom JVPs.
_PI = 3.141592653589793
_PI_2 = 1.5707963267948966
_PI_4 = 0.7853981633974483


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
        ctx.save_for_backward(*inputs)

    @staticmethod
    def jvp(ctx, dy, dx):
        y, x = ctx.saved_tensors
        d = torch.clamp(x * x + y * y, min=1e-37)
        return (x * dy - y * dx) / d

    @staticmethod
    def backward(ctx, g):
        # The transpose of the tangent rule, as jax.grad forms it: the
        # cotangent divided by d, then times x for y and times -y for x.
        y, x = ctx.saved_tensors
        gd = g / torch.clamp(x * x + y * y, min=1e-37)
        return (x * gd).sum_to_size(y.shape), (y * -gd).sum_to_size(x.shape)


class _Arctan(torch.autograd.Function):
    @staticmethod
    def forward(x):
        return _arctan_poly(x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_forward(*inputs)
        ctx.save_for_backward(*inputs)

    @staticmethod
    def jvp(ctx, dx):
        x, = ctx.saved_tensors
        return dx / (1.0 + x * x)

    @staticmethod
    def backward(ctx, g):
        # The transpose of the tangent rule, as jax.grad forms it.
        x, = ctx.saved_tensors
        return g / (1.0 + x * x)


class _Emitting(threading.local):
    trace = None


# Set on a thread while ``ops.emit`` traces a function, to its trace, and
# read through ``emitting()``: ``metrics.base.sym_metric`` hands the trace
# its entry dict, the functions with a custom derivative record one node
# each (an op of ``ops.emit``) in place of their forward's ops, whose own
# tangent rules are not theirs, and complex pairs raise (not emitted yet).
EMITTING = _Emitting()


def emitting():
    """The ``ops.emit`` trace running on this thread, or None."""
    return EMITTING.trace


def arctan(x: Tensor) -> Tensor:
    """The reference's polynomial atan with the exact derivative
    ``dx / (1 + x^2)`` in forward and reverse mode."""
    trace = emitting()
    if trace is not None:
        return trace.arctan(x)
    return _Arctan.apply(x)


def arctan2(y: Tensor, x: Tensor) -> Tensor:
    """The reference's polynomial atan2 (numpy quadrant conventions) with
    the exact derivative ``(x dy - y dx) / (x^2 + y^2)`` in forward and
    reverse mode."""
    trace = emitting()
    if trace is not None:
        return trace.arctan2(y, x)
    return _Arctan2.apply(y, x)


def arccos(x: Tensor) -> Tensor:
    """The reference's acos through the polynomial atan2:
    ``arctan2(sqrt(max(1 - x^2, 0)), x)``, with its derivatives."""
    return arctan2(torch.sqrt(torch.clamp(1.0 - x * x, min=0.0)), x)


def pow_pos(base, exponent: float):
    """``base ** exponent`` for ``base >= 0`` as the reference's
    ``exp(log(max(base, 1e-37)) * exponent)``, with ``base <= 0`` mapped to
    exactly 0 (value and tangent).  A Python float ``base`` (a parameter
    expression) is evaluated in double, as Python evaluates it."""
    if not isinstance(base, torch.Tensor):
        return math.exp(math.log(max(base, 1e-37)) * exponent) \
            if base > 0 else 0.0
    safe = torch.clamp(base, min=1e-37)
    return torch.where(base > 0, torch.exp(torch.log(safe) * exponent), 0.0)


# Expressions of parameters alone are evaluated in double: by Python where
# the parameters are floats, and in float64 where one is a tensor (a fitted
# parameter), so that both give the same float32 value where the expression
# meets a coordinate (the kernel's structs evaluate them in double too).

def param64(x):
    """A parameter for an expression of parameters alone: a Python float as
    it is, a tensor in float64."""
    return x.double() if isinstance(x, torch.Tensor) else x


def param32(x):
    """The value of such an expression where it meets a coordinate: a
    tensor rounded to float32 (a Python float is rounded by the op)."""
    return x.float() if isinstance(x, torch.Tensor) else x


def param_sqrt(x):
    """sqrt of a parameter expression (see :func:`param64`)."""
    return torch.sqrt(x) if isinstance(x, torch.Tensor) else math.sqrt(x)


def param_tanh(x):
    """tanh of a parameter expression (see :func:`param64`)."""
    return torch.tanh(x) if isinstance(x, torch.Tensor) else math.tanh(x)


def param_pow(x: Tensor, e) -> Tensor:
    """``x ** e`` for an exponent of parameters alone: torch's pow with a
    Python-number exponent (the kernel's rule), also where ``e`` is a
    tensor (a fitted parameter: its value is read on the host), whose
    gradient then flows through a term of value 0."""
    if not isinstance(e, torch.Tensor):
        return x ** e
    y = x ** float(e.detach())
    z = x.detach() ** e.float()
    return y + (z - z.detach())


# ---------------------------------------------------------------------------
# Single-event 4x4 algebra (camera frame)
# ---------------------------------------------------------------------------

def matvec(m: Tensor, v: Tensor) -> Tensor:
    """``m @ v`` for a (4, 4) by (4,) product as an elementwise sum in
    column order, so no TF32 matmul path can touch it on the card."""
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
    """General 4x4 inverse by cofactor expansion (reference ``_inverse44``)."""
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


# ---------------------------------------------------------------------------
# Batched (component-first) formulation
# ---------------------------------------------------------------------------

def metric_and_partials_batched(g, x: Tensor, params,
                                deps=(0, 1, 2, 3)) -> tuple[Tensor, list]:
    """``(gab, dgab)`` for ``x`` of shape (4, N): ``gab`` is (4, 4, N) and
    ``dgab[c]`` = d g / d x^c as (4, 4, N), or None when the metric does not
    depend on coordinate ``c``.  One tangent sweep per dependent
    coordinate, seeded with the coordinate basis vector; the sweeps run as
    ONE ``torch.func.jvp`` over the batch repeated once per sweep (the
    metric is elementwise per event, so this changes no number and pays the
    eager dispatch once)."""
    dgs: list = [None, None, None, None]
    if not deps:
        return g(x, params), dgs
    n = x.shape[-1]
    xs = x.repeat(1, len(deps))
    seed = torch.zeros_like(xs)
    for k, c in enumerate(deps):
        seed[c, k * n:(k + 1) * n] = 1.0
    gab, dg = torch.func.jvp(lambda y: g(y, params), (xs,), (seed,))
    for k, c in enumerate(deps):
        dgs[c] = dg[..., k * n:(k + 1) * n]
    return gab[..., :n], dgs


# ``None`` is the structural zero: these helpers fold it away so a sparse
# metric's inverse and contraction carry only the surviving terms (x * 0.0
# is not folded by fp semantics: NaN * 0 = NaN).

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
    """4x4 list of Tensor-or-None views of a symmetric batch ``m``."""
    def get(i, j):
        key = (i, j) if i <= j else (j, i)
        return m[i, j] if key in nz else None

    return [[get(i, j) for j in range(4)] for i in range(4)]


def _inv44_sym_entries(E):
    """Pruned symmetric-4x4 inverse over an entry grid (Tensor-or-None);
    the reference's cofactor algebra with absent entries dropped."""
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


def acceleration_batched(g, x: Tensor, v: Tensor, params,
                         deps=(0, 1, 2, 3), nz: frozenset | None = None
                         ) -> Tensor:
    """Batched geodesic acceleration: x, v of shape (4, N) -> (4, N).

        S_n = v^a v^b (d_a g_nb - 1/2 d_n g_ab),   a = -g^{-1} S

    with terms dropped for coordinates outside ``deps`` and for entries
    outside ``nz`` (in the reference's order of operations)."""

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

    if nz is not None:
        ginv = _inv44_sym_entries(_sym_entries(gab, nz))
    else:
        ginv = _inv44_sym_entries(_sym_entries(
            gab, frozenset((i, j) for i in range(4) for j in range(i, 4))))
    zero = torch.zeros_like(v[0])
    out = []
    for mu in range(4):
        acc = None
        for n in range(4):
            acc = _padd(acc, _pmul(ginv[mu][n], S[n]))
        out.append(-acc if acc is not None else zero)
    return torch.stack(out)


def rank1_partials_batched(h, x: Tensor, params):
    """``(f, l, df, dl)`` of a Kerr-Schild decomposition ``h(x, params) ->
    (f, l)`` at ``x`` of shape (4, N): ``f`` (N,), ``l`` (4, N), and the
    partials by x^1, x^2, x^3 (``df[k]`` (N,), ``dl[k]`` (4, N) for the
    coordinate k + 1), from one ``torch.func.jvp`` of the three coordinate
    tangents over the batch repeated three times (the decomposition does
    not depend on x^0)."""
    n = x.shape[-1]
    xs = x.repeat(1, 3)
    seed = torch.zeros_like(xs)
    for k in range(3):
        seed[k + 1, k * n:(k + 1) * n] = 1.0
    (f, lv), (df, dl) = torch.func.jvp(lambda y: h(y, params), (xs,),
                                       (seed,))
    return (f[:n], lv[:, :n], [df[k * n:(k + 1) * n] for k in range(3)],
            [dl[:, k * n:(k + 1) * n] for k in range(3)])


def acceleration_batched_rank1(h, x: Tensor, v: Tensor, params) -> Tensor:
    """Geodesic acceleration of a Kerr-Schild metric g = eta + f l l
    (``h(x, params) -> (f, l)``, l eta-null), x and v of shape (4, N):

        S_n = (Df lv + f q) l_n + f lv w_n - d_n(1/2 f lv^2)|_v,
        a   = -eta^-1 S + (f / (1 + f l.eta.l)) lt (lt . S)

    with lv = l.v, Df = v^n d_n f, w_b = v^n d_n l_b, q = w.v and
    lt = eta^-1 l (Sherman-Morrison; l.eta.l is 0 but for rounding).  The
    reference's rank-1 path forms the gradient term by transposing one
    linearisation; here the partials come from one forward pass with the
    three coordinate tangents and every sum runs in a fixed order, as
    ``csrc/march.cuh``'s rank-1 branch writes it:
    d_n(1/2 f lv^2) = (1/2 lv^2) d_n f + f lv (v^b d_n l_b)."""
    f, l, df, dl = rank1_partials_batched(h, x, params)

    def dot4(a, b):
        return ((a[0] * b[0] + a[1] * b[1]) + a[2] * b[2]) + a[3] * b[3]

    Df = (v[1] * df[0] + v[2] * df[1]) + v[3] * df[2]
    w = (v[1] * dl[0] + v[2] * dl[1]) + v[3] * dl[2]
    lv = dot4(l, v)
    q = dot4(w, v)
    flv = f * lv
    half_lv2 = 0.5 * lv * lv
    c = lv * Df + f * q
    S = [c * l[0] + flv * w[0]]
    for k in range(3):
        term2 = half_lv2 * df[k] + flv * dot4(v, dl[k])
        S.append((c * l[k + 1] + flv * w[k + 1]) - term2)
    lt = [-l[0], l[1], l[2], l[3]]
    l_eta_l = dot4(lt, l)
    scale = f * recip(1.0 + f * l_eta_l)
    k_lts = scale * dot4(lt, S)
    return torch.stack([S[0] + k_lts * lt[0]]
                       + [k_lts * lt[a] - S[a] for a in range(1, 4)])


def fix_null_batched(gab: Tensor, v: Tensor) -> Tensor:
    """Rescale v^t so that g(v, v) = 0, keeping the root closest to the
    original v^t (gab (4, 4, N), v (4, N))."""
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
