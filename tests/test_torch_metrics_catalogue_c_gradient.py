"""Port parity of catalogue slice C: the twin of tests/test_gradients.py:174
on the port, the gradient of a march's end points with respect to
``double_unequal_kerr``'s mass m1 through the differentiable scan (windows
of 32), against ``jax.grad`` (rtol 1e-3, ``test_torch_gradients.JAX_RTOL``)
and the central difference (rtol 0.2, atol 5e-3, the reference's tolerance).

The reference's six rays start at p = 10 aimed inward and none escapes
within its 256 trial iterations, so its loss (the mean end height z of the
escaped rays) is 0 for every m1 and its gradient is 0 whatever the reverse
pass computes (ROADMAP Queue 3).  The twin launches six rays from p = 4,
z = 0, next to the two bodies on the axis, aimed outward at 0.5-1.2 rad
from the plane: every ray escapes within 51-61 trial iterations, so a
budget of 64 marches each to its end, and the loss moves with m1.
"""

import numpy as np
import torch

from test_torch_gradients import _check

torch.set_num_threads(1)


def _outward_rays(n, p0, lo, hi):
    """``n`` rays at the cylindrical event (0, p0, pi/2, 0), aimed outward
    at ``lo``-``hi`` rad from the plane z = 0."""
    ang = np.linspace(lo, hi, n)
    pos = np.tile([0.0, p0, np.pi / 2, 0.0], (n, 1)).astype(np.float32)
    vel = np.stack([np.ones(n), np.cos(ang), np.zeros(n), np.sin(ang)],
                   -1).astype(np.float32)
    return pos, vel


def test_grad_wrt_double_unequal_kerr_mass_matches_jax_and_fd():
    pos, vel = _outward_rays(6, 4.0, 0.5, 1.2)

    def params_of(m, m1):
        p = dict(m.params())
        p["m1"] = m1
        return p

    g = _check("double_unequal_kerr", pos, vel, 32, params_of, 0.15, 2e-3,
               dict(rtol=0.2, atol=5e-3), max_steps=64)
    print(f"d loss / d m1 = {g:.6g}")
    assert np.isfinite(g) and abs(g) > 1e-2
