"""Port parity: ``render/colour.py`` against the JAX package (CPU).

Random linear RGB in [0, 1] (with greys, primaries and black among them) and
shifts z in [-0.9, 10], made from a seed with numpy, through every function
of both modules: atol 1e-5 (wavelengths, which run to 830, rtol 1e-5).  The
port's copy of the CIE 1931 table equals the original.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from geodesic_raytracing_tpu.render import cie1931_data as jcie
from geodesic_raytracing_tpu.render import colour as jcolour
from geodesic_raytracing_tpu_torch.render import cie1931_data as tcie
from geodesic_raytracing_tpu_torch.render import colour as tcolour

torch.set_num_threads(1)


def _inputs(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rgb[:8] = np.eye(3, dtype=np.float32)[np.arange(8) % 3]   # primaries
    rgb[8:16] = rng.uniform(0, 1, (8, 1))                     # greys
    rgb[16:20] = 0.0                                          # black
    z = rng.uniform(-0.9, 10.0, n).astype(np.float32)
    z[::5] = rng.uniform(-0.9, 0.0, len(z[::5]))              # blueshifts
    return rgb, z


def _cmp(got, want, **tol):
    tol = tol or dict(rtol=0, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)


def test_cie_table_copy_equals_the_original():
    assert tcie.XY_1NM == jcie.XY_1NM
    assert (tcie.WL_START, tcie.WL_END) == (jcie.WL_START, jcie.WL_END)
    assert len(tcie.XY_1NM) == 471


@pytest.mark.parametrize("fn", ["srgb_to_lin", "lin_to_srgb", "energy_of",
                                "linear_rgb_to_xyz", "xyz_to_linear_rgb"])
def test_pointwise_functions_match_jax(fn):
    rgb, _ = _inputs()
    _cmp(getattr(tcolour, fn)(torch.from_numpy(rgb)),
         getattr(jcolour, fn)(jnp.asarray(rgb)))


@pytest.mark.parametrize("fn", ["dominant_wavelength",
                                "dominant_wavelength_cie",
                                "srgb_to_wavelength"])
def test_wavelength_estimates_match_jax(fn):
    """Wavelengths in nm, rtol 1e-5 (5e-3 nm at 500 nm: the chromaticity
    angle's arctan differs in the last ulp between the frameworks), off
    black and grey, where the angle is undefined."""
    rgb, _ = _inputs()
    chroma = rgb.max(-1) - rgb.min(-1) > 0.05
    got = getattr(tcolour, fn)(torch.from_numpy(rgb)).numpy()
    want = np.asarray(getattr(jcolour, fn)(jnp.asarray(rgb)))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got[chroma], want[chroma], rtol=1e-5,
                               atol=2e-2)


def test_wavelength_to_xy_matches_jax():
    wl = np.random.default_rng(1).uniform(340, 850, 2048).astype(np.float32)
    _cmp(tcolour.wavelength_to_xy(torch.from_numpy(wl)),
         jcolour.wavelength_to_xy(jnp.asarray(wl)))


@pytest.mark.parametrize("old", [False, True])
def test_redshift_colour_matches_jax(old):
    rgb, z = _inputs()
    _cmp(tcolour.redshift_colour(torch.from_numpy(rgb), torch.from_numpy(z),
                                 old=old),
         jcolour.redshift_colour(jnp.asarray(rgb), jnp.asarray(z), old=old))


def test_spectral_redshift_matches_jax():
    """atol 2e-4: the rebuilt colour divides by the locus distance and
    rescales by the peak, which amplify the wavelength's last ulp."""
    rgb, z = _inputs(seed=2)
    got = tcolour.spectral_redshift(torch.from_numpy(rgb),
                                    torch.from_numpy(z)).numpy()
    want = np.asarray(jcolour.spectral_redshift(jnp.asarray(rgb),
                                                jnp.asarray(z)))
    assert np.isfinite(got).all()
    assert (np.abs(got - want).max(-1) < 2e-4).mean() > 0.995
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-2)


@pytest.mark.parametrize("kw", [dict(), dict(old=True),
                                dict(dominant_colour=True),
                                dict(spectral=True)])
def test_apply_redshift_matches_jax(kw):
    rgb, z = _inputs(seed=3)
    img, zz = rgb.reshape(64, 64, 3), z.reshape(64, 64)
    got = tcolour.apply_redshift(torch.from_numpy(img), torch.from_numpy(zz),
                                 **kw).numpy()
    want = np.asarray(jcolour.apply_redshift(jnp.asarray(img),
                                             jnp.asarray(zz), **kw))
    assert got.shape == (64, 64, 3) and np.isfinite(got).all()
    assert got.min() >= 0 and got.max() <= 1
    if kw.get("spectral"):
        assert (np.abs(got - want).max(-1) < 2e-4).mean() > 0.995
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
