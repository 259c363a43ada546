"""Example content-pack metric written in torch: Reissner-Nordstrom (charged,
non-spinning), the twin of ``examples/pack/reissner_nordstrom.py``.

Load it with the PyTorch port's CLI; on ``--device cuda`` its metric struct
is emitted from this function (``ops/emit.py``) and built into the
ray-march kernel at first use:

    python -m geodesic_raytracing_tpu_torch.cli --content examples/pack_torch \
        --metric reissner_nordstrom --pitch -90 --out rn.png
"""

import torch

from geodesic_raytracing_tpu_torch.metrics.base import diag_metric

DEFAULTS = {"rs": 1.0, "rq": 0.4}
DIAGONAL = True
SPHERICALLY_SYMMETRIC = True
DEPENDS_ON = (1, 2)


def metric(x, params):
    rs, rq = params["rs"], params["rq"]
    r, theta = x[1], x[2]
    st = torch.sin(theta)
    f = 1.0 - rs / r + (rq * rq) / (r * r)
    return diag_metric(-f, 1.0 / f, r * r, r * r * st * st)
