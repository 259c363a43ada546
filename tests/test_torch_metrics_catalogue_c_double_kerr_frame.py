"""Port parity of catalogue slice C: the 64x64 frame of ``double_kerr``
against JAX's, on the CPU, sRGB RMSE < 0.5 and < 0.5% of pixels off by more
than 32 (``test_torch_metrics_catalogue_b.assert_frame_matches_jax``). A
file of its own (~65 s on one core): the scene's trapped rays run the whole
step budget in both packages' marches.
"""

import pytest
import torch

from test_torch_metrics_catalogue_b import assert_frame_matches_jax

torch.set_num_threads(1)


@pytest.mark.parametrize("key", ('double_kerr',))
def test_frame_matches_jax(key):
    assert_frame_matches_jax(key)
