"""Port parity of catalogue slice C: Kerr in Kerr-Schild coordinates, the
rank-1 acceleration's first metric (rays die at its ring).

The 64-ray march against JAX's ``while`` driver and the 64x64 frame, on the
CPU (the march takes the rank-1 path: the metric declares ``rank1``; the
golden is in ``_kerr_schild_golden.py``, each file under a minute on one
core). The helpers and their tolerances are those of
``test_torch_metrics_catalogue_b.py`` (the 64-ray march from JAX's launch
state, the port's own held to it first; the 64x64 frame, sRGB RMSE < 0.5 and
< 0.5% of pixels off by more than 32; the 128^2 golden gate, RMSE < 4 and <
1% of pixels off by more than 32) and of
``test_torch_metrics_catalogue_c.py`` (``assert_march_parity_c``: fates and
step counts equal on every ray and escaped positions within 1e-4, but on the
ill-conditioned classes it names).
"""

import pytest
import torch

from test_torch_metrics_catalogue_b import (
    assert_frame_matches_jax, march_both)
from test_torch_metrics_catalogue_c import assert_march_parity_c

torch.set_num_threads(1)

NAMES = ('kerr_schild',)


@pytest.mark.parametrize("name", NAMES)
def test_march_matches_jax(name):
    assert_march_parity_c(name, *march_both(name))


@pytest.mark.parametrize("key", NAMES)
def test_frame_matches_jax(key):
    assert_frame_matches_jax(key)
