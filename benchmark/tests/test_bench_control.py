"""The check's control at a size the CPU holds: the reference put in the
program's place with its marches in bfloat16 fails the committed limits of
every cell, while the program's frame passes them."""

import pytest
from conftest import ROOT, small_root

from benchmark import check, control, manifest

CELLS = [w["name"] for w in manifest.load(ROOT)["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_and_the_program_passes(tmp_path, cell):
    root = small_root(tmp_path, max_steps=512)
    limits = manifest.limits(root, cell)
    got = control.readings(root, cell, 2147483649, 3, "cpu")
    assert check.judge(got["program"], limits), got
    assert not check.judge(got["control"], limits), got
