"""Kerr in Boyer-Lindquist coordinates: ``kerr_boyer_fn`` and its config,
frozen from ``geodesic_raytracing_tpu_torch/metrics/catalogue_kerr.py``
(commit e647ccc)."""

import torch

from benchmark.reference.geometry import recip, sym_metric
from benchmark.reference.spacetime import Spacetime


def kerr_boyer_fn(x, params):
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


METRIC = Spacetime(
    name="kerr_boyer",
    fn=kerr_boyer_fn,
    defaults={"rs": 1.0, "a": -0.5},
    depends_on=(1, 2),
    structure=frozenset({(0, 0), (1, 1), (2, 2), (3, 3), (0, 3)}),
    use_prepass=True,
    max_acceleration_change=1e-6,
)
