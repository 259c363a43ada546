"""Spherically symmetric / diagonal metrics (port of
``geodesic_raytracing_tpu.metrics.catalogue_simple``): ``minkowski``,
``minkowski_skew``, ``schwarzschild``, ``schwarzschild_fast``,
``schwarzschild_skewed``, ``schwarzschild_ingoing_ef``, ``de_sitter``,
``wormhole (morris-thorne)``, ``black_hole_cosmic_string`` and ``ernst``,
with the reference's configs field for field.

Quotients are written ``c * recip(x)`` (the reference's ``c / x``; the same
value for ``c = 1``, within an ulp otherwise) and ``x / 3`` as
``x * (1 / 3)``: the forms torch's own division of a scalar takes, written
out so that the CPU, the GPU and the kernel's C++ twin of each metric
(``csrc/<metric>.cuh``, term for term; a change here must be made there
too) do the same operations.
"""

from __future__ import annotations

import torch

from ..ops.geometry import recip
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
