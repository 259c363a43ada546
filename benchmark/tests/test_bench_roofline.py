"""The kernel's bound from the steps that rays ACTIVE at a launch
committed, on hand-made ray states."""

import pytest
import torch

from benchmark import roofline
from benchmark.reference.frame import _launch
from benchmark.reference.march import ACTIVE, DEAD, ESCAPED, RayState


def state(status, steps):
    n = len(status)
    return RayState(torch.zeros(n, 4), torch.zeros(n, 4), torch.zeros(n, 4),
                    torch.zeros(n), torch.ones(n),
                    torch.tensor(status, dtype=torch.int32),
                    torch.tensor(steps, dtype=torch.int32))


def test_a_launch_counts_its_rays_the_active_ones_and_their_steps():
    launch_in = state([ACTIVE, ACTIVE, DEAD, ACTIVE], [0, 0, 0, 0])
    launch_out = state([ESCAPED, DEAD, DEAD, ESCAPED], [120, 7, 0, 3000])
    got = _launch(launch_in, launch_out)
    assert (got.rays, got.active, got.steps) == (4, 3, 3127)


def test_bound_is_the_larger_of_operations_and_bytes():
    launches = [_launch(state([ACTIVE] * 3 + [DEAD], [0] * 4),
                        state([ESCAPED] * 4, [100, 200, 300, 0]))]
    ops = roofline.OPS_BY_INSTANCE[("kerr_boyer", False)]
    assert ops == 265
    bound, b_ops, b_bytes = roofline.bound_s(launches, ops)
    assert b_ops == pytest.approx(600 * 265 / 67e12)
    assert b_bytes == pytest.approx((3 * 132 + 4) / 3.35e12)
    assert bound == max(b_ops, b_bytes)


def test_frozen_table_has_the_cells_instances():
    assert roofline.OPS_BY_INSTANCE[("schwarzschild", True)] == 150
    assert roofline.RAY_BYTES_ACTIVE == 132
