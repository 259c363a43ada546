"""Port parity of catalogue slice C: the 128^2 golden of ``kerr_schild``, on
the CPU, at the golden gate of ``test_torch_metrics_catalogue_b.py`` (RMSE <
4 and < 1% of pixels off by more than 32). A file of its own (~65 s on one
core): the rays that pass the ring or the photon sphere march for thousands
of steps in the eager march.
"""

import pytest
import torch

from test_torch_metrics_catalogue_b import assert_golden

torch.set_num_threads(1)


@pytest.mark.parametrize("key", ('kerr_schild',))
def test_catalogue_golden(key):
    assert_golden(key)
