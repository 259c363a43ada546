"""Port parity of catalogue slice B: the Janis-Newman-Winicour naked singularity (real powers with parameter
exponents) and the evaporating Schwarzschild hole (pow_pos, clamp and where on
the advanced time).

The 64-ray march against JAX's ``while`` driver, the 64x64 frame and the
128^2 golden of each scene, on the CPU.  The helpers and their tolerances
are those of ``test_torch_metrics_catalogue_b.py``: both packages march
from JAX's launch state (the port's own held to it first); fates and step
counts equal on every ray and escaped positions within 1e-4 (but on the
tanh-wall rays ``assert_march_parity`` names, held to the float64 march
instead); frames sRGB RMSE
< 0.5 and < 0.5% of pixels off by more than 32; the golden gate RMSE < 4
and < 1% of pixels off by more than 32.  The spherically symmetric metrics
march in planar mode too, as the renderer traces them.
"""

import pytest
import torch

from geodesic_raytracing_tpu_torch import metrics as tmetrics
from test_torch_metrics_catalogue_b import (
    assert_frame_matches_jax, assert_golden, assert_march_parity, march_both)

torch.set_num_threads(1)

NAMES = ("janis_newman_winicour", "schwarzschild_ingoing_ef_hawking")
SCENES = ("janis_newman_winicour", "schwarzschild_ingoing_ef_hawking")
MARCHES = [(n, False) for n in NAMES] + [
    (n, True) for n in NAMES if tmetrics.get_metric(n).spherically_symmetric]


@pytest.mark.parametrize("name,planar", MARCHES)
def test_march_matches_jax(name, planar):
    assert_march_parity(name, *march_both(name, planar=planar),
                        planar=planar)


@pytest.mark.parametrize("key", SCENES)
def test_frame_matches_jax(key):
    assert_frame_matches_jax(key)


@pytest.mark.parametrize("key", SCENES)
def test_catalogue_golden(key):
    assert_golden(key)
