"""Two equal Kerr black holes held apart by a strut (the reference
renderer's ``scripts/double_kerr.js``, a Kramer-Neugebauer-type exact
solution): ``double_kerr_fn``, its cylindrical (t, p, phi, z) chart and its
config, frozen from ``geodesic_raytracing_tpu_torch/metrics/
catalogue_multibody.py`` and ``coordinates/transforms.py`` (commit
5526645).

The complex Ernst potentials are explicit (re, im) pairs
(``benchmark/reference/complexify.py``).  Every expression of parameters
alone, complex ones included, is evaluated in double and rounded once to
float32 where it meets a coordinate (``param64`` / ``param32``); quotients
by a coordinate expression are products with its reciprocal.

Departures from the copied code, none of which changes a value: the chart
is written as methods of a frozen ``Spacetime`` subclass (the port looks
``cylindrical_to_polar`` and ``polar_to_cylindrical`` up by the names in
its config); the chart's theta takes the reference's ``geometry.arctan2``,
the same polynomial atan2 with the same exact tangent as the port's; the
precision weights are those the port gives a cylindrical chart.
"""

import dataclasses

import torch

from benchmark.reference import complexify as cx
from benchmark.reference.complexify import (cadd, cdiv, cmul, cneg, conj,
                                            csub, imag, param32, param64,
                                            real)
from benchmark.reference.geometry import arctan2, recip, sym_metric
from benchmark.reference.spacetime import Spacetime


def _rad(pp, z, c):
    """csqrt(p^2 + (z + c)^2) for a pair ``c`` of parameter expressions
    (double): the square of z + c as ``cmul`` forms it, with c's imaginary
    part squared in double."""
    cr, ci = cx.c32(c)
    ci2 = param32(c[1] * c[1])
    w = z + cr
    return cx.csqrt((pp + (w * w - ci2), w * ci + ci * w))


def double_kerr_fn(x, params):
    R, M, a = (param64(params[k]) for k in ("R", "M", "a"))
    p, z = x[1], x[3]

    # Parameters alone, in double.
    den0 = R * R + 2.0 * M * R + 4.0 * a * a
    num0 = R * R - 4.0 * M * M + 4.0 * a * a
    d = 2.0 * M * a * num0 / den0
    sigma_sq = M * M - a * a + (4.0 * M * M * a * a * num0) / (den0 * den0)
    sigmap = cx.csqrt(sigma_sq)
    sigman = cneg(sigmap)
    ia = (None, a)
    id_ = (None, d)

    def coef_R(sig):
        return cdiv(cadd(cmul(-M, cadd(cmul(2.0, sig), R)), id_),
                    cadd(2.0 * M * M, cmul(cadd(R, cmul(2.0, ia)),
                                           cadd(sig, ia))))

    def coef_r(sig):
        return cdiv(cadd(cmul(-M, csub(cmul(2.0, sig), R)), id_),
                    csub(2.0 * M * M, cmul(csub(R, cmul(2.0, ia)),
                                           cadd(sig, ia))))

    q = R + 2.0 * M
    K0 = (4.0 * sigma_sq * (den0 * den0 - 16.0 * M * M * a * a)
          / (M * M * (q * q + 4.0 * a * a)))
    two_r_sig = cmul(2.0 * R, sigmap)
    r_plus = cadd(R, cmul(2.0, sigmap))
    r_minus = csub(R, cmul(2.0, sigmap))
    r_sig = cmul(R, sigmap)
    four_sig = cmul(4.0, sigmap)

    # Where they meet the coordinates.
    pp = p * p
    Rp = cmul(cx.c32(coef_R(sigmap)), _rad(pp, z, cadd(0.5 * R, sigmap)))
    Rn = cmul(cx.c32(coef_R(sigman)), _rad(pp, z, cadd(0.5 * R, sigman)))
    rp = cmul(cx.c32(coef_r(sigmap)), _rad(pp, z, cadd(-0.5 * R, sigmap)))
    rn = cmul(cx.c32(coef_r(sigman)), _rad(pp, z, cadd(-0.5 * R, sigman)))

    A = csub(cmul(cmul(param32(R * R), csub(Rp, Rn)), csub(rp, rn)),
             cmul(cmul(param32(4.0 * sigma_sq), csub(Rp, rp)), csub(Rn, rn)))
    B = cmul(cx.c32(two_r_sig),
             csub(cmul(cx.c32(r_plus), csub(Rn, rp)),
                  cmul(cx.c32(r_minus), csub(Rp, rn))))
    G = cadd(cmul(-z, B), cmul(cx.c32(r_sig), csub(cadd(
        cmul(param32(2.0 * R), csub(cmul(Rn, rn), cmul(Rp, rp))),
        cmul(cx.c32(four_sig), csub(cmul(Rp, Rn), cmul(rp, rn)))),
        cmul(param32(R * R - 4.0 * sigma_sq),
             cadd(csub(csub(Rp, Rn), rp), rn)))))

    denom = cx.scm(A) - cx.scm(B)
    inv_denom = recip(denom)
    cab = cadd(conj(A), conj(B))
    w = param32(4.0 * a) - 2.0 * imag(cmul(G, cab)) * inv_denom
    re_ab = real(cmul(cadd(A, B), cab))
    f = denom * recip(re_ab)
    i_f = re_ab * inv_denom
    kk = cmul(cmul(cmul(cmul(param32(K0 * K0), Rp), Rn), rp), rn)
    i_f_e2g = re_ab * recip(real(kk))

    dphi1 = i_f * pp
    dphi2 = -f * w * w
    dt_dphi = 2.0 * f * w
    return sym_metric(
        {
            (0, 0): -f,
            (2, 2): dphi1 + dphi2,
            (0, 2): 0.5 * dt_dphi,
            (1, 1): i_f_e2g,
            (3, 3): i_f_e2g,
        }
    )


def cylindrical_to_polar(x, params):
    """(t, p, phi, z) -> (t, r, theta, phi)."""
    t, p, phi, z = x[0], x[1], x[2], x[3]
    rr = torch.sqrt(p * p + z * z)
    rtheta = arctan2(p, z)
    return torch.stack([t, rr, rtheta, phi])


def polar_to_cylindrical(x, params):
    """(t, r, theta, phi) -> (t, p, phi, z)."""
    t, r, theta, phi = x[0], x[1], x[2], x[3]
    return torch.stack([t, r * torch.sin(theta), phi, r * torch.cos(theta)])


@dataclasses.dataclass(frozen=True)
class CylindricalSpacetime(Spacetime):
    """A spacetime in the cylindrical (t, p, phi, z) chart."""

    def to_polar(self, x, params):
        return cylindrical_to_polar(x, params)

    def from_polar(self, x, params):
        return polar_to_cylindrical(x, params)

    def precision_weights(self) -> tuple:
        """The reference renderer's per-coordinate error weights of a
        cylindrical chart."""
        return (1.0, 1.0, 8.0, 1.0)


METRIC = CylindricalSpacetime(
    name="double_kerr",
    fn=double_kerr_fn,
    defaults={"R": 3.0, "M": 0.3, "a": 0.27},
    depends_on=(1, 3),
    structure=frozenset({(0, 0), (0, 2), (1, 1), (2, 2), (3, 3)}),
    max_acceleration_change=1e-6,
)
