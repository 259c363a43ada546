"""Kerr family (port of ``geodesic_raytracing_tpu.metrics.catalogue_kerr``):
``kerr_boyer`` only so far.

The same expression, term for term, is written once more as the C++
template ``kerr_boyer_g`` in ``csrc/kerr_boyer.cuh`` for the ray-march
kernel; a change here must be made there too (the kernel-vs-plain checks in
``tests/test_torch_raymarch_host.py`` and ``chip_smoke.py`` catch a drift).
"""

from __future__ import annotations

import torch

from ..ops.geometry import recip
from .base import Metric, make_config, register, sym_metric


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
