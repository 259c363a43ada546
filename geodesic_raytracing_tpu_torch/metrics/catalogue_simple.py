"""Spherically symmetric / diagonal metrics (port of
``geodesic_raytracing_tpu.metrics.catalogue_simple``): ``minkowski``,
``minkowski_skew``, ``schwarzschild``, ``schwarzschild_fast``,
``schwarzschild_skewed``, ``schwarzschild_ingoing_ef``, ``de_sitter``,
``wormhole (morris-thorne)``, ``black_hole_cosmic_string``, ``ernst`` and,
from catalogue slice B, ``janis_newman_winicour``,
``schwarzschild_ingoing_ef_hawking``, ``configurable_wormhole``,
``ellis_drainhole`` and ``symmetric_warp_drive``, with the reference's
configs field for field.

Quotients are written ``c * recip(x)`` (the reference's ``c / x``; the same
value for ``c = 1``, within an ulp otherwise) and ``x / 3`` as
``x * (1 / 3)``: the forms torch's own division of a scalar takes, written
out so that the CPU, the GPU and the kernel's C++ twin of each metric
(``csrc/<metric>.cuh``, term for term; a change here must be made there
too) do the same operations.  A product or function of parameters alone is
evaluated in double (``geometry.param64``: by Python for float parameters,
in float64 for a fitted tensor); the C++ twin evaluates it in double in the
struct's ``from_params`` and rounds once, as the value meets a tensor.
"""

from __future__ import annotations

import math

import torch

from ..ops.geometry import (arctan, arctan2, param32, param64, param_pow,
                            param_sqrt, pow_pos, recip)
from .base import Metric, diag_metric, make_config, register, sym_metric


def minkowski_fn(x, params):
    """scripts/minkowski.js — flat spacetime, cartesian (t, x, y, z).
    A constant (4, 4) with no batch axis."""
    return diag_metric(-1.0, 1.0, 1.0, 1.0, device=x.device)


minkowski = register(
    Metric(
        name="minkowski",
        fn=minkowski_fn,
        config=make_config(
            "cartesian_base",
            name="minkowski",
            adaptive_precision=False,
            detect_singularities=False,
            description="Totally flat, ordinary spacetime",
        ),
        diagonal=True,
        depends_on=(),
    )
)


def minkowski_skew_fn(x, params):
    """scripts/minkowski_skew.js — flat spacetime with coordinates
    (x, t, y, z)."""
    return diag_metric(1.0, -1.0, 1.0, 1.0, device=x.device)


minkowski_skew = register(
    Metric(
        name="minkowski_skew",
        fn=minkowski_skew_fn,
        config=make_config(
            "cartesian_skew_base",
            name="minkowski_skew",
            adaptive_precision=False,
            detect_singularities=False,
        ),
        diagonal=True,
        depends_on=(),
    )
)


def schwarzschild_fn(x, params):
    """scripts/schwarzschild.js / schwarzschild_accurate.js — standard polar
    Schwarzschild with rs as a parameter."""
    rs = params["rs"]
    r, theta = x[1], x[2]
    st = torch.sin(theta)
    return diag_metric(
        -(1.0 - rs * recip(r)),
        recip(1.0 - rs * recip(r)),
        r * r,
        r * r * st * st,
    )


schwarzschild_fast = register(
    Metric(
        name="schwarzschild_fast",
        fn=schwarzschild_fn,
        config=make_config(
            "polar_base",
            name="schwarzschild_fast",
            adaptive_precision=False,
            singular=True,
            detect_singularities=False,
            singular_terminator=1.05,
            description="An uncharged, non spinning black hole (rs=1 optimised)",
        ),
        defaults={"rs": 1.0},
        diagonal=True,
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)

schwarzschild = register(
    Metric(
        name="schwarzschild",
        fn=schwarzschild_fn,
        config=make_config(
            "polar_base",
            name="schwarzschild",
            description="An uncharged, non spinning black hole",
        ),
        defaults={"rs": 1.0},
        diagonal=True,
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)


def schwarzschild_skewed_fn(x, params):
    """scripts/skewed_schwarzschild.js — coordinates (r, t, theta, phi),
    rs = 1."""
    r, theta = x[0], x[2]
    st = torch.sin(theta)
    return diag_metric(
        recip(1.0 - recip(r)),
        -(1.0 - recip(r)),
        r * r,
        r * r * st * st,
    )


schwarzschild_skewed = register(
    Metric(
        name="schwarzschild_skewed",
        fn=schwarzschild_skewed_fn,
        config=make_config("skewed_polar_base", name="schwarzschild_skewed"),
        diagonal=True,
        depends_on=(0, 2),
    )
)


def schwarzschild_ingoing_ef_fn(x, params):
    """scripts/schwarzschild_ingoing_ef.js — ingoing Eddington-Finkelstein
    (v, r, theta, phi); the horizon is traversable."""
    rs = params["rs"]
    r, theta = x[1], x[2]
    st = torch.sin(theta)
    return sym_metric(
        {
            (0, 0): -(1.0 - rs * recip(r)),
            (0, 1): 1.0,
            (2, 2): r * r,
            (3, 3): r * r * st * st,
        }
    )


schwarzschild_ingoing_ef = register(
    Metric(
        name="schwarzschild_ingoing_ef",
        structure=frozenset({(0, 0), (0, 1), (2, 2), (3, 3)}),
        fn=schwarzschild_ingoing_ef_fn,
        config=make_config(
            "ingoing_ef_base",
            name="schwarzschild_ingoing_ef",
            description="Schwarzschild in ingoing EF coordinates",
        ),
        defaults={"rs": 1.0},
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)


def de_sitter_fn(x, params):
    """scripts/de_sitter.js — expanding universe, positive Lambda."""
    cosmo = params["cosmological_constant"]
    r, theta = x[1], x[2]
    st = torch.sin(theta)
    f = 1.0 - cosmo * r * r * (1.0 / 3.0)
    return diag_metric(-f, recip(f), r * r, r * r * st * st)


de_sitter = register(
    Metric(
        name="de_sitter",
        fn=de_sitter_fn,
        config=make_config(
            "polar_base",
            name="de_sitter",
            adaptive_precision=False,
            detect_singularities=False,
        ),
        defaults={"cosmological_constant": 0.01},
        diagonal=True,
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)


def wormhole_fn(x, params):
    """scripts/wormhole.js — Morris-Thorne wormhole (arXiv:0904.4184);
    p runs through the throat, negative on the far side."""
    n = params["n"]
    p, theta = x[1], x[2]
    st = torch.sin(theta)
    b = p * p + n * n
    return diag_metric(-1.0, 1.0, b, b * st * st)


wormhole = register(
    Metric(
        name="wormhole (morris-thorne)",
        fn=wormhole_fn,
        config=make_config(
            "polar_base",
            name="wormhole (morris-thorne)",
            adaptive_precision=False,
            detect_singularities=False,
        ),
        defaults={"n": 1.0},
        diagonal=True,
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)


def cosmic_string_bh_fn(x, params):
    """scripts/cosmic_string_bh.js — Schwarzschild with a conical deficit."""
    rs, B = params["rs"], params["B"]
    r, theta = x[1], x[2]
    st = torch.sin(theta)
    return diag_metric(
        -(1.0 - rs * recip(r)),
        recip(1.0 - rs * recip(r)),
        r * r,
        r * r * B * B * st * st,
    )


black_hole_cosmic_string = register(
    Metric(
        name="black_hole_cosmic_string",
        fn=cosmic_string_bh_fn,
        config=make_config(
            "polar_base",
            name="black_hole_cosmic_string",
            max_acceleration_change=1e-6,
        ),
        defaults={"rs": 1.0, "B": 0.3},
        diagonal=True,
        depends_on=(1, 2),
    )
)


def ernst_fn(x, params):
    """scripts/ernst.js — black hole in a magnetic field."""
    B, rs = params["B"], params["rs"]
    r, theta = x[1], x[2]
    st = torch.sin(theta)
    lam = 1.0 + B * B * r * r * st * st
    lam2 = lam * lam
    f = 1.0 - rs * recip(r)
    return diag_metric(-lam2 * f, lam2 * recip(f), lam2 * r * r,
                       r * r * st * st * recip(lam2))


ernst = register(
    Metric(
        name="ernst",
        fn=ernst_fn,
        config=make_config(
            "polar_base",
            name="ernst",
            max_acceleration_change=1e-6,
        ),
        defaults={"B": 0.0000025, "rs": 1.0},
        diagonal=True,
        depends_on=(1, 2),
    )
)


# ---------------------------------------------------------------------------
# Catalogue slice B.  The C++ twins are in csrc/wormhole.cuh
# (janis_newman_winicour, schwarzschild_ingoing_ef_hawking,
# configurable_wormhole, ellis_drainhole) and csrc/warp.cuh
# (symmetric_warp_drive); a change here must be made there too.
# ---------------------------------------------------------------------------

def janis_newman_winicour_fn(x, params):
    """scripts/janis_newman_winicour.js (arXiv:1408.6041).  Real powers
    with the parameter exponents 1/mu, 1/mu + 1 and 1/mu - 1."""
    r0, mu = param64(params["r0"]), param64(params["mu"])
    r, theta = x[1], x[2]
    st = torch.sin(theta)
    num = 2.0 * r - param32(r0 * (mu - 1.0))
    den = 2.0 * r + param32(r0 * (mu + 1.0))
    Ar = param_pow(num * recip(den), 1.0 / mu)
    Br = 0.25 * param_pow(den, 1.0 / mu + 1.0) * recip(
        param_pow(num, 1.0 / mu - 1.0))
    return diag_metric(-Ar, recip(Ar), Br, Br * st * st)


janis_newman_winicour = register(
    Metric(
        name="janis_newman_winicour",
        fn=janis_newman_winicour_fn,
        config=make_config(
            "polar_base",
            name="janis_newman_winicour",
            detect_singularities=False,
            max_acceleration_change=1e-6,
        ),
        defaults={"r0": 1.0, "mu": 4.0},
        diagonal=True,
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)


def schwarzschild_ef_hawking_fn(x, params):
    """scripts/schwarzschild_ingoing_ef_hawking.js (arXiv:2103.08340) — an
    evaporating black hole: rs shrinks as (lifetime - v)^(1/3)."""
    rs_base = param64(params["rs_base"])
    lifetime = params["lifetime"]
    v, r, theta = x[0], x[1], x[2]
    M0 = rs_base / 2.0
    k_squiggle = M0 * M0 * M0 / param64(lifetime)
    k_dash = 2.0 * pow_pos(k_squiggle, 1.0 / 3.0)
    negative_branch = param32(k_dash) * pow_pos(
        torch.clamp(lifetime - v, min=0.0), 1.0 / 3.0)
    rs_v = torch.where(v <= lifetime, negative_branch, 0.0)
    st = torch.sin(theta)
    return sym_metric(
        {
            (0, 0): -(1.0 - rs_v * recip(r)),
            (0, 1): 1.0,
            (2, 2): r * r,
            (3, 3): r * r * st * st,
        }
    )


schwarzschild_ingoing_ef_hawking = register(
    Metric(
        name="schwarzschild_ingoing_ef_hawking",
        structure=frozenset({(0, 0), (0, 1), (2, 2), (3, 3)}),
        fn=schwarzschild_ef_hawking_fn,
        config=make_config(
            "ingoing_ef_variable_base",
            name="schwarzschild_ingoing_ef_hawking",
            description="A black hole emitting hawking radiation",
        ),
        defaults={"rs_base": 1.0, "lifetime": 1000.0},
        spherically_symmetric=True,
        depends_on=(0, 1, 2),
    )
)


def configurable_wormhole_fn(x, params):
    """scripts/configurable_wormhole.js — Kip Thorne's interstellar wormhole
    (arXiv:1502.03809)."""
    M, p, a = params["M"], params["p"], params["a"]
    l, theta = x[1], x[2]
    st = torch.sin(theta)
    al = torch.abs(l)
    xx = 2.0 * (al - a) * param32(1.0 / (math.pi * param64(M)))
    r = torch.where(
        al <= a,
        p,
        p + M * (xx * arctan(xx) - 0.5 * torch.log1p(xx * xx)),
    )
    return diag_metric(-1.0, 1.0, r * r, r * r * st * st)


configurable_wormhole = register(
    Metric(
        name="configurable_wormhole",
        fn=configurable_wormhole_fn,
        config=make_config(
            "polar_base",
            name="configurable_wormhole",
            adaptive_precision=True,
            detect_singularities=False,
            max_acceleration_change=1e-5,
        ),
        defaults={"M": 0.01, "p": 1.0, "a": 0.001},
        diagonal=True,
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)


def ellis_drainhole_fn(x, params):
    """scripts/ellis_drainhole.js — the earliest traversable wormhole; an
    off-diagonal (t, r) entry."""
    m, n = params["m"], params["n"]
    m64, n64 = param64(m), param64(n)
    r, theta = x[1], x[2]
    st = torch.sin(theta)
    alpha = param_sqrt(n64 * n64 - m64 * m64)
    rm = r - m
    pseudophi = param32(n64 / alpha) * (
        math.pi / 2 - arctan2(rm, torch.zeros_like(rm) + param32(alpha)))
    Fp = -torch.sqrt(1.0 - torch.exp(param32(-(2.0 * m64 / n64)) * pseudophi))
    Rp2 = (rm * rm + param32(alpha * alpha)) * recip(1.0 - Fp * Fp)
    return sym_metric(
        {
            (0, 0): -(1.0 - Fp * Fp),
            (0, 1): Fp,
            (1, 1): 1.0,
            (2, 2): Rp2,
            (3, 3): Rp2 * st * st,
        }
    )


ellis_drainhole = register(
    Metric(
        name="ellis_drainhole",
        structure=frozenset({(0, 0), (0, 1), (1, 1), (2, 2), (3, 3)}),
        fn=ellis_drainhole_fn,
        config=make_config(
            "polar_base",
            name="ellis_drainhole",
            adaptive_precision=False,
            detect_singularities=False,
        ),
        defaults={"m": 0.5, "n": 1.0},
        spherically_symmetric=True,
        depends_on=(1, 2),
    )
)


def symmetric_warp_drive_fn(x, params):
    """scripts/symmetric_warp_drive.js (arXiv:2010.11031) — warp without
    negative energy; only correct for radial geodesics (per the reference).
    The script pins theta to pi/2, so sin(theta) is Python's 1.0."""
    t, r = x[0], x[1]
    theta = math.pi / 2
    rg = 1.0
    rk = rg
    a20 = 1.0 - rg * recip(r)
    a0 = torch.sqrt(a20)
    a2 = a20 + t * (1.0 / theta)
    st = math.sin(theta)
    yrr0 = recip(1.0 - rg * recip(r))
    gamma_0 = r ** 4 * st * st * recip(1.0 - rg * recip(r))
    littlea = (rk * theta) * recip(a0)
    littleb = rk * theta - torch.sqrt(gamma_0)
    Urt = (littlea * (a20 + t * (1.0 / theta)) ** 1.5 - littleb) * recip(
        littlea * a0 * a0 * a0 - littleb)
    return diag_metric(-a2, Urt * yrr0, Urt * r * r, Urt * r * r * st * st)


symmetric_warp_drive = register(
    Metric(
        name="symmetric_warp_drive",
        fn=symmetric_warp_drive_fn,
        config=make_config(
            "polar_base",
            name="symmetric_warp_drive",
            singular=True,
            singular_terminator=1.001,
            max_acceleration_change=1e-6,
        ),
        defaults={},
        diagonal=True,
        depends_on=(0, 1),
    )
)
