"""The emitted structs (``ops/emit.py``) of ``double_kerr`` and
``double_kerr_alt`` (complex pairs of coordinates through complex.cuh's dual
``csqrt``; the heaviest plain marches, in a file of their own), which the
kernel is built with: dynamic and baked, each built by g++ as host code
(``torch_emit_host``) and marched on the host test's 64 rays (every 7th born
DEAD, 4096 trial iterations) against the plain march of its twin
parameters, and the dynamic struct with the float parameters as the kernel
launches it (``torch_emit_host.builtin_cases``), by the rule of the metric
(``torch_emit_host.assert_as_host_test``).
"""

import pytest
import torch

import torch_emit_host as eh

torch.set_num_threads(1)

NAMES = ("double_kerr", "double_kerr_alt")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    return eh.build_builtins(NAMES,
                             tmp_path_factory.mktemp("emit_double_kerr"))


@pytest.mark.parametrize("name,mode", eh.builtin_cases(NAMES))
def test_emitted_builtin_matches_plain(built, name, mode):
    eh.check_builtin(*built, name, mode)
