"""Exotic spacetimes (port of
``geodesic_raytracing_tpu.metrics.catalogue_exotic``): ``misner_4d``,
``cosmic_string_spinning`` and, from catalogue slice B, ``alcubierre``,
``krasnikov_tube``, ``krasnikov_cylindrical`` and ``godel_cylindrical``, with
the reference's configs field for field.

The same expressions are written once more as the C++ metric structs of
``csrc/exotic.cuh`` (Misner, the spinning string, Godel) and
``csrc/warp.cuh`` (Alcubierre, the Krasnikov tubes) for the ray-march
kernel; a change here must be made there too.  Quotients by a parameter are
written as products with its reciprocal, and parameter-only expressions are
evaluated in double (``geometry.param64``), as in ``catalogue_simple``.
"""

from __future__ import annotations

import math

import torch

from ..ops.geometry import param32, param64, param_tanh, recip
from .base import Metric, make_config, register, sym_metric


def misner_4d_fn(x, params):
    """scripts/misner_4d.js — Misner spacetime extended to 4d
    (arXiv:1102.0907 eq. 25); coordinates (T, phi, y, z).  g_TT = 0: the
    frame basis takes its swap paths (``ops/tetrad.py``)."""
    T = x[0]
    return sym_metric(
        {
            (0, 1): -1.0,
            (1, 1): -T,
            (2, 2): 1.0,
            (3, 3): 1.0,
        }
    )


misner_4d = register(
    Metric(
        name="misner_4d",
        structure=frozenset({(0, 1), (1, 1), (2, 2), (3, 3)}),
        fn=misner_4d_fn,
        config=make_config(
            None,
            name="misner_4d",
            coordinate_system="OTHER",
            adaptive_precision=True,
            detect_singularities=True,
            max_acceleration_change=1e-4,
            to_polar="misner_4d_to_polar",
            from_polar="polar_to_misner_4d",
            origin_distance="at_origin",
            coordinate_periodicity="misner_periodicity",
            description="Misner spacetime; good for time travel",
        ),
        defaults={"phi0": 1.0},
        depends_on=(0,),
    )
)


def cosmic_string_spinning_fn(x, params):
    """scripts/cosmic_string_spinning.js — spinning cosmic string,
    cylindrical (t, p, phi, z)."""
    a, k = params["a"], params["k"]
    p = x[1]
    return sym_metric(
        {
            (0, 0): -1.0,
            (1, 1): 1.0,
            (2, 2): a * a + k * k * p * p,
            (3, 3): 1.0,
            (0, 1): a,  # 0.5 * dtdphi, dtdphi = 2a (the reference indexes 0, 1)
        }
    )


cosmic_string_spinning = register(
    Metric(
        name="cosmic_string_spinning",
        structure=frozenset({(0, 0), (0, 1), (1, 1), (2, 2), (3, 3)}),
        fn=cosmic_string_spinning_fn,
        config=make_config(
            "cylindrical_base",
            name="cosmic_string_spinning",
            adaptive_precision=True,
            detect_singularities=False,
            max_acceleration_change=1e-6,
        ),
        defaults={"a": 0.01, "k": 0.98},
        depends_on=(1,),
    )
)


def alcubierre_fn(x, params):
    """scripts/alcubierre.js — the Alcubierre warp drive; the bubble of
    radius R moves along x at ``velocity``."""
    v_s, sigma, R = params["velocity"], params["sigma"], params["R"]
    t, xx, y, z = x[0], x[1], x[2], x[3]
    v64 = param64(v_s)
    xs_t = v_s * t
    dx = xx - xs_t
    rs_t = torch.sqrt(dx * dx + y * y + z * z)
    f_rs = (torch.tanh(sigma * (rs_t + R)) - torch.tanh(sigma * (rs_t - R))
            ) * param32(1.0 / (2.0 * param_tanh(param64(sigma) * param64(R))))
    dt = param32(v64 * v64) * f_rs * f_rs - 1.0
    dxdt = param32(-2.0 * v64) * f_rs
    return sym_metric(
        {
            (0, 0): dt,
            (0, 1): 0.5 * dxdt,
            (1, 1): 1.0,
            (2, 2): 1.0,
            (3, 3): 1.0,
        }
    )


alcubierre = register(
    Metric(
        name="alcubierre",
        structure=frozenset({(0, 0), (0, 1), (1, 1), (2, 2), (3, 3)}),
        fn=alcubierre_fn,
        config=make_config(
            "cartesian_base",
            name="alcubierre",
            adaptive_precision=True,
            detect_singularities=False,
            max_acceleration_change=1e-5,
            origin_distance="alcubierre_origin",
            unconditionally_nonsingular=True,
            description="The alcubierre warp drive",
        ),
        defaults={"velocity": 2.0, "sigma": 1.0, "R": 2.0},
        depends_on=(0, 1, 2, 3),
    )
)


def _krasnikov_thetae(v, e):
    """theta_e step function shared by both Krasnikov scripts."""
    return 0.5 * (torch.tanh(2.0 * (2.0 * v * param32(1.0 / param64(e))
                                    - 1.0)) + 1.0)


def _krasnikov_k(t, xx, p, e, D, pmax, little_d):
    """The tube's g_xx: 1 inside the unformed tube, little_d - 1 inside the
    formed one."""
    return 1.0 - param32(2.0 - param64(little_d)) * \
        _krasnikov_thetae(pmax - p, e) * \
        _krasnikov_thetae(t - xx - p, e) * (
            _krasnikov_thetae(xx, e) - _krasnikov_thetae(xx + e - D, e))


def krasnikov_cartesian_fn(x, params):
    """scripts/krasnikov_cartesian.js — Krasnikov tube, cartesian."""
    e, D, pmax, little_d = (params["e"], params["D"], params["pmax"],
                            params["littled"])
    t, xx, y, z = x[0], x[1], x[2], x[3]
    p = torch.sqrt(y * y + z * z)
    k = _krasnikov_k(t, xx, p, e, D, pmax, little_d)
    dxdt = 1.0 - k
    return sym_metric(
        {
            (0, 0): -1.0,
            (0, 1): 0.5 * dxdt,
            (1, 1): k,
            (2, 2): 1.0,
            (3, 3): 1.0,
        }
    )


krasnikov_tube = register(
    Metric(
        name="krasnikov_tube",
        structure=frozenset({(0, 0), (0, 1), (1, 1), (2, 2), (3, 3)}),
        fn=krasnikov_cartesian_fn,
        config=make_config(
            "cartesian_base",
            name="krasnikov_tube",
            adaptive_precision=True,
            detect_singularities=False,
            max_acceleration_change=1e-5,
            description="An FTL space tunnel",
        ),
        defaults={"e": 0.75, "D": 5.0, "pmax": 2.0, "littled": 0.01},
        depends_on=(0, 1, 2, 3),
    )
)


def krasnikov_cylindrical_fn(x, params):
    """scripts/krasnikov_cylindrical.js — the original cylindrical form,
    (t, p, phi, x).  The reference script declares its tunables but uses
    the literals e = 0.1, D = 2, pmax = 1, littled = 0.01; so does this."""
    e, D, pmax, little_d = 0.1, 2.0, 1.0, 0.01
    t, p, xx = x[0], x[1], x[3]
    k = _krasnikov_k(t, xx, p, e, D, pmax, little_d)
    dxdt = 1.0 - k
    return sym_metric(
        {
            (0, 0): -1.0,
            (1, 1): 1.0,
            (2, 2): p * p,
            (3, 3): k,
            (0, 3): 0.5 * dxdt,
        }
    )


krasnikov_cylindrical = register(
    Metric(
        name="krasnikov_cylindrical",
        structure=frozenset({(0, 0), (0, 3), (1, 1), (2, 2), (3, 3)}),
        fn=krasnikov_cylindrical_fn,
        config=make_config(
            None,
            name="krasnikov_cylindrical",
            coordinate_system="OTHER",
            adaptive_precision=True,
            detect_singularities=False,
            max_acceleration_change=1e-6,
            to_polar="cylindrical_to_polar",
            from_polar="polar_to_cylindrical",
            origin_distance="at_origin",
        ),
        defaults={"e": 0.1, "D": 2.0, "pmax": 1.0},
        depends_on=(0, 1, 3),
    )
)


def godel_cylinder_fn(x, params):
    """scripts/godel_cylinder.js — Godel's rotating universe, cylindrical
    (t, r, phi, z)."""
    a = params["a"]
    r = x[1]
    q = r * param32(1.0 / (2.0 * param64(a)))
    q2 = q * q
    dt_dphi = -2.0 * r * r * param32(1.0 / (math.sqrt(2.0) * param64(a)))
    return sym_metric(
        {
            (0, 0): -1.0,
            (1, 1): recip(1.0 + q2),
            (2, 2): r * r * (1.0 - q2),
            (3, 3): 1.0,
            (0, 2): 0.5 * dt_dphi,
        }
    )


godel_cylindrical = register(
    Metric(
        name="godel_cylindrical",
        structure=frozenset({(0, 0), (0, 2), (1, 1), (2, 2), (3, 3)}),
        fn=godel_cylinder_fn,
        config=make_config(
            "cylindrical_base",
            name="godel_cylindrical",
            adaptive_precision=True,
            max_acceleration_change=1e-6,
            has_cylindrical_singularity=True,
            description="Godel's metric, a spinning spacetime",
        ),
        defaults={"a": 1000.0},
        depends_on=(1,),
    )
)
