"""The emitted structs (``ops/emit.py``) of catalogue slice B
(``janis_newman_winicour``'s dynamic struct takes its parameter exponents as
``PowRule`` members set in ``from_params``), which the kernel is built with:
dynamic and baked, each built by g++ as host code (``torch_emit_host``) and
marched on the host test's 64 rays (every 7th born DEAD, 4096 trial
iterations) against the plain march of its twin parameters, and the dynamic
struct with the float parameters as the kernel launches it, 4-D and, where
the metric is spherically symmetric, planar
(``torch_emit_host.builtin_cases``), by the rule of the metric
(``torch_emit_host.assert_as_host_test``).
"""

import pytest
import torch

import torch_emit_host as eh

torch.set_num_threads(1)

NAMES = ("alcubierre", "configurable_wormhole", "ellis_drainhole",
         "godel_cylindrical", "janis_newman_winicour",
         "krasnikov_cylindrical", "krasnikov_tube",
         "schwarzschild_ingoing_ef_hawking", "symmetric_warp_drive")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    return eh.build_builtins(NAMES, tmp_path_factory.mktemp("emit_b"))


@pytest.mark.parametrize("name,mode", eh.builtin_cases(NAMES))
def test_emitted_builtin_matches_plain(built, name, mode):
    eh.check_builtin(*built, name, mode)
