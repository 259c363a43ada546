"""Port parity of catalogue slice C: two unequal-mass Kerr black holes (Ernst
potentials on complex pairs, a cube root of parameters in double).

The 64-ray march against JAX's ``while`` driver and the 64x64 frame, on the
CPU (the 128^2 golden is in ``_double_unequal_kerr_golden.py``), with the
helpers and tolerances of
``test_torch_metrics_catalogue_b.py`` and
``test_torch_metrics_catalogue_c.py`` (``assert_march_parity_c``); and the
gradient of the metric with respect to a mass through the parameter block
(``csqrt``, ``cabs``, ``cpow`` and ``cdiv`` on float64 tensors) and the
coordinate pairs, against ``jax.grad`` (rtol 1e-4: the reference evaluates
the parameter block in float32, the port in double).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from geodesic_raytracing_tpu import metrics as jmetrics
from geodesic_raytracing_tpu_torch import metrics as tmetrics
from test_torch_metrics_catalogue_b import (
    assert_frame_matches_jax, march_both)
from test_torch_metrics_catalogue_c import assert_march_parity_c, events

torch.set_num_threads(1)

NAMES = ("double_unequal_kerr",)


@pytest.mark.parametrize("name", NAMES)
def test_march_matches_jax(name):
    assert_march_parity_c(name, *march_both(name))


@pytest.mark.parametrize("key", NAMES)
def test_frame_matches_jax(key):
    assert_frame_matches_jax(key)


def test_metric_gradient_wrt_masses_matches_jax():
    """d(sum of g)/d m1 and d/d m2 at seeded events, with every parameter
    a float32 tensor that requires grad, against ``jax.grad``; the value
    equals the float parameters' bit for bit."""
    x = events("double_unequal_kerr", n=64, seed=4)
    tm = tmetrics.get_metric("double_unequal_kerr")
    jm = jmetrics.get_metric("double_unequal_kerr")
    tp = {k: torch.tensor(v, requires_grad=True)
          for k, v in tm.params().items()}
    total = tm.fn(torch.from_numpy(x), tp).sum()
    g = torch.autograd.grad(total, [tp["m1"], tp["m2"]])
    assert float(total) == float(tm.fn(torch.from_numpy(x),
                                       tm.params()).sum())

    def jsum(m1, m2):
        p = dict(jm.params())
        p.update(m1=m1, m2=m2)
        return jnp.sum(jm.fn(jnp.asarray(x), p))

    jg = jax.grad(jsum, argnums=(0, 1))(jnp.float32(0.15), jnp.float32(0.3))
    for a, b in zip(g, jg):
        assert np.isfinite(float(a))
        np.testing.assert_allclose(float(a), float(b), rtol=1e-4)
