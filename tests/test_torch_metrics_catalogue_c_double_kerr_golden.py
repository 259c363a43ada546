"""Port parity of catalogue slice C: the 128^2 golden of ``double_kerr``, on
the CPU, at the golden gate of ``test_torch_metrics_catalogue_b.py`` (RMSE <
4 and < 1% of pixels off by more than 32). It has a file of its own: the
scene's trapped rays run the whole 8,192-step budget in the eager march
(~80 s on one core).
"""

import pytest
import torch

from test_torch_metrics_catalogue_b import assert_golden

torch.set_num_threads(1)


@pytest.mark.parametrize("key", ('double_kerr',))
def test_catalogue_golden(key):
    assert_golden(key)
