"""The graphed plain march (``integrate._march_graphed``, the default of
``trace_rays_reference`` on CUDA tensors) against the eager one.

On the card the graphed march replays the step from a CUDA graph; on the
CPU each replay is an eager step, so this file holds its bookkeeping (the
working set that shrinks only when half of it has finished, the finished
rays' iterations that change nothing, the budget counted across chunks of
``GRAPH_CHUNK``) to the eager march's.  Tolerance: every field of every ray
equal bit for bit.  ``chip_smoke.py`` phases 2 and 14 hold the captured graph
to the eager march on the card.
"""

import numpy as np
import pytest
import torch

from geodesic_raytracing_tpu_torch import metrics
from geodesic_raytracing_tpu_torch.ops import integrate
from test_torch_raymarch_host import generic_rays

torch.set_num_threads(1)


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int32).numpy()


# (metric, trace options, step budget): budgets short of the longest ray,
# so that rays end in the march and others stay ACTIVE, and not multiples of
# GRAPH_CHUNK.
CASES = [
    ("kerr_boyer", {}, 333),
    ("kerr_boyer", {}, 1),
    ("kerr_boyer", dict(integrator="euler"), 61),
    ("kerr_boyer", dict(reparameterisation=True), 257),
    ("schwarzschild", dict(planar=True), 83),
    ("alcubierre", {}, 171),
    ("godel_cylindrical", {}, 401),
    ("janis_newman_winicour", dict(planar=True), 263),
]


@pytest.mark.parametrize("name,option,budget", CASES)
def test_graphed_march_equals_eager(name, option, budget):
    m = metrics.get_metric(name)
    params = m.params()
    feats = integrate.Features.for_metric(m)
    st = integrate.init_ray_state(m, *generic_rays(m, params), params, feats)
    st.status[::7] = integrate.DEAD
    opts = integrate.TraceOptions(max_steps=budget, **option)
    eager = integrate.trace_rays_reference(m, st, params, feats, opts,
                                           graphed=False)
    graphed = integrate.trace_rays_reference(m, st, params, feats, opts,
                                             graphed=True)
    for field, a, b in zip(integrate.RayState._fields, graphed, eager):
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=field)
    status = eager.status.numpy()
    # Rays born DEAD stay DEAD and untouched.
    assert (status[::7] == integrate.DEAD).all()
    assert eager.steps.numpy().max() <= budget
    if budget > 1:
        # Both: rays that ended within the budget, and rays still going.
        assert (status == integrate.ACTIVE).any()
        assert (status[np.arange(status.size) % 7 != 0]
                != integrate.ACTIVE).any()
