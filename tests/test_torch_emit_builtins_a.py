"""The emitted structs (``ops/emit.py``) of the first seven of
``metrics/catalogue_simple.py`` with ``kerr_boyer``, and catalogue slice A:
dynamic and baked, each built by g++ as host code (``torch_emit_host``) and
marched on the host test's 64 rays (every 7th born DEAD, 4096 trial
iterations) against the plain march of its twin parameters by the rule
``tests/test_torch_raymarch_host.py`` applies to the metric's hand instance,
and against the hand instance's host march bit for bit.
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
def test_emitted_builtin_matches_plain_and_hand(built, name, mode):
    eh.check_builtin(*built, name, mode)
