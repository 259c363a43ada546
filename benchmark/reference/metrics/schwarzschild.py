"""Polar Schwarzschild: ``schwarzschild_fn`` and the ``schwarzschild``
config, frozen from ``geodesic_raytracing_tpu_torch/metrics/
catalogue_simple.py`` (commit e647ccc).  Spherically symmetric: the frame
traces it in planar mode."""

import torch

from benchmark.reference.geometry import diag_metric, recip
from benchmark.reference.spacetime import Spacetime


def schwarzschild_fn(x, params):
    rs = params["rs"]
    r, theta = x[1], x[2]
    st = torch.sin(theta)
    return diag_metric(
        -(1.0 - rs * recip(r)),
        recip(1.0 - rs * recip(r)),
        r * r,
        r * r * st * st,
    )


METRIC = Spacetime(
    name="schwarzschild",
    fn=schwarzschild_fn,
    defaults={"rs": 1.0},
    depends_on=(1, 2),
    structure=frozenset((i, i) for i in range(4)),
    spherically_symmetric=True,
)
