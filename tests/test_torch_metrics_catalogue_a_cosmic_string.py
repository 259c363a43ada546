"""Port parity of catalogue slice A: ``black_hole_cosmic_string``.

The 64-ray march, the 64x64 frame and JAX's own adaptive pair against the
JAX package, and the 128^2 golden through the plain path (CPU).  The helpers
and their tolerances are those of ``test_torch_metrics_catalogue_a.py``:
fates and step counts equal on every ray and escaped positions within 1e-4
(but on the ill-conditioned rays ``assert_march_parity`` names); frames sRGB
RMSE < 0.5 and < 0.5% of pixels off by more than 32; the golden gate
RMSE < 4 and < 1% of pixels off by more than 32.
"""

import pytest
import torch

from test_torch_metrics_catalogue_a import (
    assert_adaptive_pair, assert_frame_matches_jax, assert_golden,
    assert_march_parity, march_both)

torch.set_num_threads(1)

NAMES = ("black_hole_cosmic_string",)
MARCHES = [(n, False) for n in NAMES]


@pytest.mark.parametrize("name,planar", MARCHES)
def test_march_matches_jax(name, planar):
    assert_march_parity(name, *march_both(name, planar=planar))


@pytest.mark.parametrize("name", NAMES)
def test_frame_matches_jax(name):
    assert_frame_matches_jax(name)


@pytest.mark.parametrize("name", NAMES)
def test_adaptive_pair_of_jax(name):
    assert_adaptive_pair(name)


@pytest.mark.parametrize("name", NAMES)
def test_catalogue_golden(name):
    assert_golden(name)
