"""The emitted structs (``ops/emit.py``) of catalogue slice C but two
double-Kerr metrics (the rank-1 Kerr-Schild decompositions ``fl``;
``double_unequal_kerr``'s complex pairs, its cube root of parameters in
``from_params`` in double), which the kernel is built with: dynamic and
baked, each built by g++ as host code (``torch_emit_host``) and marched on
the host test's 64 rays (every 7th born DEAD, 4096 trial iterations)
against the plain march of its twin parameters, and the dynamic struct with
the float parameters as the kernel launches it
(``torch_emit_host.builtin_cases``), by the rule of the metric
(``torch_emit_host.assert_as_host_test``).
"""

import pytest
import torch

import torch_emit_host as eh

torch.set_num_threads(1)

NAMES = ("kerr_schild", "kerr_newman_schild", "double_schwarzschild",
         "double_unequal_kerr")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    return eh.build_builtins(NAMES, tmp_path_factory.mktemp("emit_c"))


@pytest.mark.parametrize("name,mode", eh.builtin_cases(NAMES))
def test_emitted_builtin_matches_plain(built, name, mode):
    eh.check_builtin(*built, name, mode)
