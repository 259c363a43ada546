"""The emitted structs (``ops/emit.py``) of the first seven of
``metrics/catalogue_simple.py`` with ``kerr_boyer``, and catalogue slice A,
which the kernel is built with: dynamic and baked, each built by g++ as host
code (``torch_emit_host``) and marched on the host test's 64 rays (every 7th
born DEAD, 4096 trial iterations) against the plain march of its twin
parameters, and the dynamic struct with the float parameters as the kernel
launches it, 4-D and, where the metric is spherically symmetric, planar
(``torch_emit_host.builtin_cases``), by the rule of the metric
(``torch_emit_host.assert_as_host_test``).
"""

import pytest
import torch

import torch_emit_host as eh

torch.set_num_threads(1)

NAMES = ("kerr_boyer", "schwarzschild", "schwarzschild_fast",
         "schwarzschild_skewed", "schwarzschild_ingoing_ef", "de_sitter",
         "minkowski", "minkowski_skew", "black_hole_cosmic_string",
         "cosmic_string_spinning", "ernst", "kerr_ingoing_ef",
         "kerr_newman_boyer", "kerr_rational_polynomial", "misner_4d",
         "wormhole (morris-thorne)")


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    return eh.build_builtins(NAMES, tmp_path_factory.mktemp("emit_a"))


@pytest.mark.parametrize("name,mode", eh.builtin_cases(NAMES))
def test_emitted_builtin_matches_plain(built, name, mode):
    eh.check_builtin(*built, name, mode)
