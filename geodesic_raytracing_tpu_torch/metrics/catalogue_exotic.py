"""Exotic spacetimes (port of
``geodesic_raytracing_tpu.metrics.catalogue_exotic``): ``misner_4d`` and
``cosmic_string_spinning``, with the reference's configs field for field.

The same expressions are written once more as the C++ metric structs of
``csrc/exotic.cuh`` for the ray-march kernel; a change here must be made
there too.
"""

from __future__ import annotations

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
