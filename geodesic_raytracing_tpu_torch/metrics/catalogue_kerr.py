"""Kerr family (port of ``geodesic_raytracing_tpu.metrics.catalogue_kerr``):
``kerr_boyer``, ``kerr_ingoing_ef``, ``kerr_newman_boyer``,
``kerr_rational_polynomial`` and, in Kerr-Schild cartesian coordinates,
``kerr_schild`` and ``kerr_newman_schild``, whose decompositions
g = eta + f l l (``Metric.rank1``) the integrator's rank-1 acceleration
takes.

The same expressions, term for term, are written once more as the C++ metric
structs of ``csrc/kerr_boyer.cuh`` and ``csrc/kerr_schild.cuh`` for the ray-
march kernel; a change here must be made there too (the kernel-vs-plain
checks in ``tests/test_torch_raymarch_host.py`` and ``chip_smoke.py`` catch
a drift). Quotients are ``c * recip(x)`` and squares ``q * q``, as in
``catalogue_simple``. A product of three or more parameters is evaluated by
Python in double precision and rounded once to float32 where it meets a
tensor; the C++ structs write such a product out in double the same way.
"""

from __future__ import annotations

import torch

from ..ops.geometry import param32, param64, recip
from .base import Metric, make_config, minkowski_plus, register, sym_metric


def kerr_boyer_fn(x, params):
    """scripts/kerr_boyer.js — Kerr in Boyer-Lindquist (t, r, theta, phi)."""
    rs, a = params["rs"], params["a"]
    r, theta = x[1], x[2]
    ct, st = torch.cos(theta), torch.sin(theta)
    st2 = st * st
    E = r * r + a * a * ct * ct
    D = r * r - rs * r + a * a
    invE = recip(E)
    rsr_invE = rs * r * invE
    return sym_metric(
        {
            (0, 0): -(1.0 - rsr_invE),
            (1, 1): E * recip(D),
            (2, 2): E,
            (3, 3): (r * r + a * a + rsr_invE * a * a * st2) * st2,
            (0, 3): -rsr_invE * a * st2,
        }
    )


kerr_boyer = register(
    Metric(
        name="kerr_boyer",
        fn=kerr_boyer_fn,
        config=make_config(
            "polar_base",
            name="kerr_boyer",
            adaptive_precision=True,
            detect_singularities=True,
            use_prepass=True,
            max_acceleration_change=1e-6,
            description="An uncharged, spinning black hole",
        ),
        defaults={"rs": 1.0, "a": -0.5},
        depends_on=(1, 2),
        structure=frozenset({(0, 0), (1, 1), (2, 2), (3, 3), (0, 3)}),
    )
)


def _kerr_schild_r(x, a):
    """The Kerr-Schild radius r (r^2 and r) of the cartesian events and the
    null vector l, shared by the two Kerr-Schild metrics."""
    a64 = param64(a)
    aa = a64 * a64
    xx, y, z = x[1], x[2], x[3]
    R2 = xx * xx + y * y + z * z
    Rm2 = xx * xx + y * y - z * z
    r2 = (param32(-aa) + torch.sqrt(param32(aa * aa) - param32(2.0 * aa) * Rm2
                                    + R2 * R2) + R2) * 0.5
    r = torch.sqrt(r2)
    inv_ra = recip(r2 + param32(aa))
    inv_r = recip(r)
    lv = torch.stack([
        torch.ones_like(r),
        (r * xx + a * y) * inv_ra,
        (r * y - a * xx) * inv_ra,
        z * inv_r,
    ])
    return r2, r, lv, param32(aa)


def kerr_schild_fl(x, params):
    """Kerr-Schild decomposition (f, l) of scripts/kerr_schild.js: the
    metric is eta + f l l with l eta-null."""
    rs = params["rs"]
    z = x[3]
    r2, r, lv, aa = _kerr_schild_r(x, params["a"])
    f = rs * r2 * r * recip(r2 * r2 + aa * z * z)
    return f, lv


def kerr_schild_fn(x, params):
    """scripts/kerr_schild.js — Kerr in Kerr-Schild cartesian coordinates
    (arXiv:0706.0622): g = eta + f l l."""
    return minkowski_plus(*kerr_schild_fl(x, params))


kerr_schild = register(
    Metric(
        name="kerr_schild",
        fn=kerr_schild_fn,
        config=make_config(
            "cartesian_base",
            name="kerr_schild",
            adaptive_precision=True,
            detect_singularities=True,
            use_prepass=True,
            max_acceleration_change=1e-6,
            description="Kerr in Kerr-Schild cartesian coordinates",
        ),
        defaults={"a": -0.5, "rs": 1.0},
        depends_on=(1, 2, 3),
        rank1=kerr_schild_fl,
    )
)


def kerr_ingoing_ef_fn(x, params):
    """scripts/kerr_ingoing_ef.js — Kerr in ingoing EF-like coordinates
    (scholarpedia Kerr-Newman eq. 47, signs flipped for signature)."""
    rs, a = params["rs"], params["a"]
    r, theta = x[1], x[2]
    ct, st = torch.cos(theta), torch.sin(theta)
    R2 = r * r + a * a * ct * ct
    D = r * r + a * a - rs * r
    invR2 = recip(R2)
    dv = 1.0 - rs * r * invR2
    dv_dr = -2.0
    dv_dphi = (2.0 * a * st * st * invR2) * (rs * r)
    dr_dphi = 2.0 * a * st * st
    dtheta = -R2
    q = a * a + r * r
    dphi = (st * st * invR2) * (D * a * a * st * st - q * q)
    return sym_metric(
        {
            (0, 0): -dv,
            (0, 1): -0.5 * dv_dr,
            (0, 3): -0.5 * dv_dphi,
            (1, 3): -0.5 * dr_dphi,
            (2, 2): -dtheta,
            (3, 3): -dphi,
        }
    )


kerr_ingoing_ef = register(
    Metric(
        name="kerr_ingoing_ef",
        fn=kerr_ingoing_ef_fn,
        config=make_config(
            "ingoing_ef_base",
            name="kerr_ingoing_ef",
            use_prepass=True,
            description="Kerr with a traversable horizon (ingoing EF)",
        ),
        defaults={"rs": 1.0, "a": -0.5},
        depends_on=(1, 2),
        structure=frozenset(
            {(0, 0), (0, 1), (0, 3), (1, 3), (2, 2), (3, 3)}
        ),
    )
)


def kerr_newman_boyer_fn(x, params):
    """scripts/kerr_newman_boyer.js — charged spinning black hole in BL."""
    rs, r2q, a = params["rs"], params["r2q"], params["a"]
    r, theta = x[1], x[2]
    ct, st = torch.cos(theta), torch.sin(theta)
    p2 = r * r + a * a * ct * ct
    D = r * r - rs * r + a * a + r2q * r2q
    inv_p2 = recip(p2)
    dr = -p2 * recip(D)
    dtheta = -p2
    dt_1 = D * inv_p2
    dtdphi_1 = -2.0 * a * st * st * D * inv_p2
    u = a * st * st
    dphi_1 = u * u * D * inv_p2
    q = r * r + a * a
    dphi_2 = -(q * q) * st * st * inv_p2
    dtdphi_2 = 2.0 * a * q * st * st * inv_p2
    dt_2 = -a * a * st * st * inv_p2
    dtdphi = dtdphi_1 + dtdphi_2
    return sym_metric(
        {
            (0, 0): -(dt_1 + dt_2),
            (1, 1): -dr,
            (2, 2): -dtheta,
            (3, 3): -(dphi_1 + dphi_2),
            (0, 3): -dtdphi * 0.5,
        }
    )


kerr_newman_boyer = register(
    Metric(
        name="kerr_newman_boyer",
        fn=kerr_newman_boyer_fn,
        config=make_config(
            "polar_base",
            name="kerr_newman_boyer",
            adaptive_precision=True,
            detect_singularities=True,
            max_acceleration_change=1e-6,
            description="A charged, spinning black hole",
        ),
        defaults={"rs": 1.0, "r2q": 0.51, "a": -0.51},
        depends_on=(1, 2),
        structure=frozenset({(0, 0), (1, 1), (2, 2), (3, 3), (0, 3)}),
    )
)


def kerr_newman_schild_fl(x, params):
    """Kerr-Schild decomposition (f, l) of scripts/kerr_newman_schild.js
    (f gains the -Q^2 charge term); see :func:`kerr_schild_fl`."""
    rs, Q = params["rs"], params["Q"]
    z = x[3]
    r2, r, lv, aa = _kerr_schild_r(x, params["a"])
    f = (rs * r - Q * Q) * r * r * recip(r2 * r2 + aa * z * z)
    return f, lv


def kerr_newman_schild_fn(x, params):
    """scripts/kerr_newman_schild.js — Kerr-Newman in Kerr-Schild cartesian
    coordinates (f gains the -Q^2 charge term)."""
    return minkowski_plus(*kerr_newman_schild_fl(x, params))


kerr_newman_schild = register(
    Metric(
        name="kerr_newman_schild",
        fn=kerr_newman_schild_fn,
        config=make_config(
            "cartesian_base",
            name="kerr_newman_schild",
            adaptive_precision=True,
            detect_singularities=True,
            use_prepass=True,
            max_acceleration_change=1e-6,
        ),
        defaults={"a": -0.51, "rs": 1.0, "Q": 0.51},
        depends_on=(1, 2, 3),
        rank1=kerr_newman_schild_fl,
    )
)


def kerr_rational_polynomial_fn(x, params):
    """scripts/kerr_rational_polynomial.js — Kerr with X = cos(theta)."""
    m, a = params["m"], params["a"]
    r, X = x[1], x[2]
    S = r * r + a * a * X * X
    invS = recip(S)
    dt = -(1.0 - 2.0 * m * r * invS)
    dphidt = -(4.0 * a * m * r * (1.0 - X * X)) * invS
    dr = S * recip(r * r - 2.0 * m * r + a * a)
    dX = S * recip(1.0 - X * X)
    dphi = (1.0 - X * X) * (
        r * r + a * a + (2.0 * m * a * a * r * (1.0 - X * X)) * invS
    )
    return sym_metric(
        {
            (0, 0): dt,
            (1, 1): dr,
            (2, 2): dX,
            (3, 3): dphi,
            (0, 3): dphidt * 0.5,
        }
    )


kerr_rational_polynomial = register(
    Metric(
        name="kerr_rational_polynomial",
        fn=kerr_rational_polynomial_fn,
        config=make_config(
            None,
            name="kerr_rational_polynomial",
            coordinate_system="X_Y_THETA_PHI",
            adaptive_precision=True,
            detect_singularities=True,
            max_acceleration_change=1e-6,
            to_polar="rational_to_polar",
            from_polar="polar_to_rational",
            origin_distance="at_origin",
            description="Kerr in rational polynomial form",
        ),
        defaults={"m": 0.5, "a": -0.25},
        depends_on=(1, 2),
        structure=frozenset({(0, 0), (1, 1), (2, 2), (3, 3), (0, 3)}),
    )
)
