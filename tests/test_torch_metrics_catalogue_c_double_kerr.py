"""Port parity of catalogue slice C: two equal Kerr black holes on a strut,
Ernst potentials on complex pairs.

The 64-ray march against JAX's ``while`` driver of ``double_kerr``, on the
CPU (its 64x64 frame is in ``_double_kerr_frame.py`` and its golden in
``_double_kerr_golden.py``: the scene's trapped rays run the whole step
budget in the eager march, so each has a file of its own). The helpers and
their tolerances are those of
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

from test_torch_metrics_catalogue_b import march_both
from test_torch_metrics_catalogue_c import assert_march_parity_c

torch.set_num_threads(1)

NAMES = ('double_kerr',)


@pytest.mark.parametrize("name", NAMES)
def test_march_matches_jax(name):
    assert_march_parity_c(name, *march_both(name))
