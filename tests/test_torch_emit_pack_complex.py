"""A content pack of the new emitted forms against its JAX pack: complex
pairs of coordinates, written into ``tmp_path`` for each package.

The pack is a Schwarzschild hole whose potential is Appell's ring's,
U = -M Re(1 / sqrt(r^2 - b^2 - 2 i b r cos theta)): in torch on the explicit
pairs of ``ops/complexify`` (``csqrt`` and ``cabs`` of coordinates, which
``ops/emit.py`` records as one op each), in JAX in complex64 through the
JAX package's ``complexify.realify``.  Held as
``tests/test_torch_emit_pack_rank1.py`` holds its pack (the 64-ray march and
the 64x64 frame against JAX's at ``tests/test_torch_content.py``'s
tolerances), and its emitted structs, dynamic and baked, against the plain
march by the host test's rule for a registered metric outside the Kerr
family: fates and step counts equal on every ray, positions within 1e-4.
"""

import numpy as np
import pytest
import torch

import test_torch_raymarch_host as host
from test_torch_emit_pack_rank1 import (assert_frame_matches_jax,
                                        assert_march_matches_jax,
                                        emitted_vs_plain, in_both, pack_pair)

torch.set_num_threads(1)

COMPLEX_PACK = """
import {np} as np_
from {pkg}.metrics.base import diag_metric
{imports}

DEFAULTS = {{"M": 0.5, "b": 0.3}}
DIAGONAL = True
DEPENDS_ON = (1, 2)

{body}
"""
TORCH_BODY = """
def metric(x, params):
    M, b = params["M"], params["b"]
    r, theta = x[1], x[2]
    ct, st = np_.cos(theta), np_.sin(theta)
    w = cx.csqrt((r * r - b * b, -2.0 * b * r * ct))
    m = cx.cabs(w)
    f = 1.0 - 2.0 * M * cx.real(w) / (m * m)
    return diag_metric(-f, 1.0 / f, r * r, r * r * st * st)
"""
JAX_BODY = """
def _metric(x, params):
    M, b = params["M"], params["b"]
    r, theta = x[1], x[2]
    ct, st = np_.cos(theta), np_.sin(theta)
    w = np_.sqrt((r * r - b * b) + 1j * (-2.0 * b * r * ct))
    m = np_.abs(w)
    f = 1.0 - 2.0 * M * np_.real(w) / (m * m)
    return diag_metric(-f, 1.0 / f, r * r, r * r * st * st)


metric = realify(_metric)
"""
CONFIG = '{"name": "appell_hole", "inherit_settings": "polar_base"}'


@pytest.fixture
def appell(tmp_path):
    return pack_pair(tmp_path, "appell_hole", *in_both(
        COMPLEX_PACK,
        imports=("from geodesic_raytracing_tpu_torch.ops import complexify "
                 "as cx", "from geodesic_raytracing_tpu.ops.complexify "
                 "import realify"),
        body=(TORCH_BODY, JAX_BODY)), CONFIG)


def test_complex_pack_march_matches_jax(appell):
    assert_march_matches_jax(*appell)


def test_complex_pack_frame_matches_jax(appell):
    assert_frame_matches_jax(*appell)


@pytest.mark.parametrize("mode", ["dynamic", "baked"])
def test_complex_pack_emitted_march_matches_plain(appell, tmp_path, mode):
    h = emitted_vs_plain(appell[0], tmp_path, mode,
                         lambda got, ref: host._assert_same_march(got, ref,
                                                                  16))
    assert "csqrt_dual(" in h.text and "cabs_dual(" in h.text
