"""Two-body exact solutions on Weyl strips, cylindrical (t, p, phi, z) (port
of ``geodesic_raytracing_tpu.metrics.catalogue_multibody``):
``double_schwarzschild``, and the complex Ernst potentials of
``double_kerr``, ``double_kerr_alt`` and ``double_unequal_kerr`` on explicit
(re, im) pairs (``ops.complexify``).

The ray-march kernel's metric structs are emitted from these functions
(``ops/emit.py``).  Every expression of parameters alone, complex ones
included (the strut's sigma, the constants of the potentials,
``double_unequal_kerr``'s cube root), is evaluated in double
(``geometry.param64``) and rounded once to float32 where it meets a
coordinate, so that no product of two parameter expressions is formed in
float32; the emitted structs evaluate them in double in ``from_params``.
Quotients by a coordinate expression are products with its reciprocal.
"""

from __future__ import annotations

import torch

from ..ops import complexify as cx
from ..ops.complexify import cadd, cdiv, cmul, cneg, conj, csub, imag, real
from ..ops.geometry import param32, param64, recip
from .base import Metric, make_config, register, sym_metric


def double_schwarzschild_fn(x, params):
    """scripts/double_schwarzschild.js — two Schwarzschild black holes held
    apart by a strut (cylindrical (t, p, phi, z))."""
    M1, M2, z0 = (param64(params[k]) for k in ("M1", "M2", "z"))
    p, z = x[1], x[3]

    e = M2 - M1
    M = M1 + M2
    aks = [param32(v) for v in (-0.5 * (M - e) - z0, 0.5 * (M - e) - z0,
                                -0.5 * (M + e) + z0, 0.5 * (M + e) + z0)]
    pp = p * p
    dz = [z - ak for ak in aks]
    Rk = [torch.sqrt(pp + d * d) for d in dz]
    Yk = [Rk[i] + aks[i] - z for i in range(4)]

    def Yij(i, j):
        return Rk[i - 1] * Rk[j - 1] + dz[i - 1] * dz[j - 1] + pp

    e2k = (Yij(4, 3) * Yij(2, 1) * Yij(4, 1) * Yij(3, 2)) * recip(
        4.0 * Yij(4, 2) * Yij(3, 1) * Rk[0] * Rk[1] * Rk[2] * Rk[3])
    e_2U = (Yk[0] * Yk[2]) * recip(Yk[1] * Yk[3])
    e_m2U = recip(e_2U)

    return sym_metric(
        {
            (0, 0): -e_2U,
            (1, 1): e_m2U * e2k,
            (2, 2): e_m2U * pp,
            (3, 3): e_m2U * e2k,
        }
    )


double_schwarzschild = register(
    Metric(
        name="double_schwarzschild",
        structure=frozenset({(0, 0), (1, 1), (2, 2), (3, 3)}),
        fn=double_schwarzschild_fn,
        config=make_config(
            "cylindrical_base",
            name="double_schwarzschild",
            adaptive_precision=True,
            detect_singularities=True,
            max_acceleration_change=1e-5,
            has_cylindrical_singularity=True,
            cylindrical_terminator=0.005,
            description="Two schwarzschild black holes separated by a string",
        ),
        defaults={"M1": 1.0, "M2": 0.1, "z": 2.0},
        depends_on=(1, 3),
    )
)


# ---------------------------------------------------------------------------
# The complex two-body metrics
# ---------------------------------------------------------------------------

I = (None, 1.0)  # the imaginary unit


def _rad(pp, z, c):
    """csqrt(p^2 + (z + c)^2) for a pair ``c`` of parameter expressions
    (double): the square of z + c as ``cmul`` forms it, with c's imaginary
    part squared in double."""
    cr, ci = cx.c32(c)
    ci2 = param32(c[1] * c[1])
    w = z + cr
    return cx.csqrt((pp + (w * w - ci2), w * ci + ci * w))


def double_kerr_fn(x, params):
    """scripts/double_kerr.js — two equal Kerr black holes on a strut
    (Kramer-Neugebauer-type exact solution, cylindrical (t, p, phi, z))."""
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


double_kerr = register(
    Metric(
        name="double_kerr",
        structure=frozenset({(0, 0), (0, 2), (1, 1), (2, 2), (3, 3)}),
        fn=double_kerr_fn,
        config=make_config(
            "cylindrical_base",
            name="double_kerr",
            adaptive_precision=True,
            detect_singularities=True,
            max_acceleration_change=1e-6,
            description="Two Kerr black holes suspended by a cosmic string",
        ),
        defaults={"R": 3.0, "M": 0.3, "a": 0.27},
        depends_on=(1, 3),
    )
)


def double_kerr_alt_fn(x, params):
    """scripts/double_kerr_alt.js — co/counter-rotating double Kerr
    (arXiv:1702.02209)."""
    R, M, q = (param64(params[k]) for k in ("R", "M", "q"))
    p, z = x[1], x[3]

    # Parameters alone, in double.
    s = R * (R + 2.0 * M) + 4.0 * q * q
    sigma = cx.csqrt(M * M - q * q * (
        1.0 - (4.0 * M * M * (R * R - 4.0 * M * M + 4.0 * q * q)) / (s * s)))
    littled = 2.0 * M * q * (R * R - 4.0 * M * M + 4.0 * q * q) / s
    mq = 2.0 * (M * M - q * q)
    q_minus = cmul(q, csub(R, cmul(2.0, sigma)))  # q (R - 2 sigma)
    q_plus = cmul(q, cadd(R, cmul(2.0, sigma)))
    pp_ = cadd(cadd(csub(mq, cmul(R + 2.0 * M, sigma)), M * R),
               cmul(I, cadd(q_minus, littled)))
    pn_ = cadd(csub(csub(mq, cmul(R - 2.0 * M, sigma)), M * R),
               cmul(I, csub(q_minus, littled)))
    sp_ = cadd(csub(cadd(mq, cmul(R - 2.0 * M, sigma)), M * R),
               cmul(I, csub(q_plus, littled)))
    sn_ = cadd(cadd(cadd(mq, cmul(R + 2.0 * M, sigma)), M * R),
               cmul(I, cadd(q_plus, littled)))
    ss = cmul(sigma, sigma)
    k0 = cmul(csub(R * R, cmul(4.0, ss)), cadd(cadd(
        cmul(R * R - 4.0 * M * M, csub(M * M, ss)),
        4.0 * (q * q) * (q * q)), 4.0 * M * q * littled))
    two_iq = cmul(2.0, cmul(I, q))
    kp = cadd(R, cmul(2.0, cadd(sigma, two_iq)))
    kn = csub(R, cmul(2.0, cadd(sigma, two_iq)))
    c = conj
    four_ss = cmul(cmul(4.0, sigma), sigma)
    rr_4ss = csub(R * R, cmul(4.0, ss))

    def prod(*zs):
        out = zs[0]
        for v in zs[1:]:
            out = cmul(out, v)
        return out

    P1234 = prod(pp_, pn_, sp_, sn_)
    Pc1234 = prod(c(pp_), c(pn_), c(sp_), c(sn_))
    Pc12_34 = prod(c(pp_), c(pn_), sp_, sn_)
    P12_c34 = prod(pp_, pn_, c(sp_), c(sn_))
    Pc1_2_c3_4 = prod(c(pp_), pn_, c(sp_), sn_)
    P1_c2_3_c4 = prod(pp_, c(pn_), sp_, c(sn_))
    im_pp_cpn = imag(cmul(pp_, c(pn_)))
    im_sp_csn = imag(cmul(sp_, c(sn_)))
    sp_sn = cmul(sp_, sn_)
    csp_csn = cmul(c(sp_), c(sn_))
    pp_pn = cmul(pp_, pn_)
    cpp_cpn = cmul(c(pp_), c(pn_))
    g_pre = cmul(cmul(cmul(-2.0, I), sigma), R)  # -2 i sigma R
    g_m = cmul(csub(R, cmul(2.0, sigma)), im_pp_cpn)
    g_p = cmul(cadd(R, cmul(2.0, sigma)), im_sp_csn)
    G1 = cmul(csub(R, cmul(2.0, cmul(I, q))), P1234)
    G2 = cmul(cadd(R, cmul(2.0, cmul(I, q))), Pc1234)
    G3 = cmul(csub(sigma, cmul(I, q)), Pc12_34)
    G4 = cmul(cadd(sigma, cmul(I, q)), P12_c34)
    G5 = cmul(cmul(cmul(cmul(2.0, I), q), rr_4ss), real(P1_c2_3_c4))
    G6 = cmul(cmul(I, sigma), R)
    G7 = cmul(c(kp), sp_sn)
    G8 = cmul(kp, csp_csn)
    G9 = cmul(kn, pp_pn)
    G10 = cmul(c(kn), cpp_cpn)
    e2y_pre = (256.0 * real(cmul(ss, ss)) * ((R * R) * (R * R))
               * real(cmul(k0, k0)))

    # Where they meet the coordinates.
    pp = p * p
    r1 = _rad(pp, z, csub(-R / 2, sigma))
    r2 = _rad(pp, z, cadd(-R / 2, sigma))
    r3 = _rad(pp, z, csub(R / 2, sigma))
    r4 = _rad(pp, z, cadd(R / 2, sigma))

    def at(k, *zs):
        """A parameter pair ``k`` (rounded to float32) times the pairs
        ``zs`` of coordinates, left to right."""
        out = cmul(cx.c32(k), zs[0])
        for v in zs[1:]:
            out = cmul(out, v)
        return out

    delta = cadd(csub(
        at(four_ss, cadd(at(P1234, r1, r2), at(Pc1234, r3, r4))),
        at(R * R, cadd(at(Pc12_34, r1, r3), at(P12_c34, r2, r4)))),
        at(rr_4ss, cadd(at(Pc1_2_c3_4, r1, r4), at(P1_c2_3_c4, r2, r3))))

    gamma = at(g_pre, cadd(
        at(g_m, csub(at(sp_sn, r1), at(csp_csn, r4))),
        at(g_p, csub(at(pp_pn, r2), at(cpp_cpn, r3)))))

    G = csub(csub(csub(
        at(four_ss, csub(at(G1, r1, r2), at(G2, r3, r4))),
        at(2.0 * R * R, csub(at(G3, r1, r3), at(G4, r2, r4)))),
        at(G5, cadd(cmul(r1, r4), cmul(r2, r3)))),
        at(G6, cadd(at(g_m, cadd(at(G7, r1), at(G8, r4))),
                    at(g_p, cadd(at(G9, r2), at(G10, r3))))))

    denom = cx.scm(delta) - cx.scm(gamma)
    inv_denom = recip(denom)
    dg = csub(delta, gamma)
    w = 2.0 * imag(cmul(dg, cadd(cmul(z, c(gamma)), c(G)))) * inv_denom
    e2y = denom * recip(param32(e2y_pre) * real(cmul(cmul(cmul(r1, r2), r3),
                                                     r4)))
    f = denom * recip(real(cmul(dg, csub(c(delta), c(gamma)))))
    inv_f = recip(f)

    dp = e2y * inv_f
    dphi_1 = pp * inv_f
    dphi_2 = -f * w * w
    dt_dphi = 2.0 * f * w
    return sym_metric(
        {
            (0, 0): -f,
            (1, 1): dp,
            (2, 2): dphi_1 + dphi_2,
            (3, 3): dp,
            (0, 2): 0.5 * dt_dphi,
        }
    )


double_kerr_alt = register(
    Metric(
        name="double_kerr_alt",
        structure=frozenset({(0, 0), (0, 2), (1, 1), (2, 2), (3, 3)}),
        fn=double_kerr_alt_fn,
        config=make_config(
            "cylindrical_base",
            name="double_kerr_alt",
            adaptive_precision=True,
            detect_singularities=True,
            max_acceleration_change=1e-5,
            description="Two Kerr black holes suspended by a cosmic string",
        ),
        defaults={"R": 4.0, "M": 0.3, "q": 0.2},
        depends_on=(1, 3),
    )
)


def double_unequal_kerr_fn(x, params):
    """scripts/double_unequal_kerr.js — two unequal-mass Kerr black holes
    (ScienceDirect S0370269319303375)."""
    m1, m2, fa1, fa2, R = (param64(params[k])
                           for k in ("m1", "m2", "fa1", "fa2", "R"))
    p, z = x[1], x[3]

    # Parameters alone, in double.
    a1 = fa1 * m1
    a2 = fa2 * m2
    J = m1 * a1 + m2 * a2
    M = m1 + m2
    # The cubic's root for the NUT-free constant a (the reference script's
    # closed form).
    k = a1 + a2
    B_ = R * R - M * M
    C_ = 2.0 * (R + M)
    inner = 18.0 * B_ * k + 27.0 * C_ * J - 9.0 * C_ * k * M + 2.0 * (k * k
                                                                    * k)
    t = 3.0 * B_ + 3.0 * C_ * M - k * k
    inner_val = cx.cpow(cadd(cx.csqrt(inner * inner + 4.0 * (t * t * t)),
                             inner), 1.0 / 3.0)
    third_root_2 = 2.0 ** (1.0 / 3.0)
    a = real(cadd(csub(cmul(1.0 / (3.0 * third_root_2), inner_val),
                       cdiv(third_root_2 * t, cmul(3.0, inner_val))),
                  k / 3.0))

    rm = R + M
    RM2a2 = rm * rm + a * a
    d1 = ((m1 * (a1 - a2 + a) + R * a) * RM2a2 + m2 * a1 * a * a) / (
        RM2a2 * RM2a2)
    d2 = ((m2 * (a2 - a1 + a) + R * a) * RM2a2 + m1 * a2 * a * a) / (
        RM2a2 * RM2a2)
    s1 = cx.csqrt(m1 * m1 - a1 * a1 + 4.0 * m2 * a1 * d1)
    s2 = cx.csqrt(m2 * m2 - a2 * a2 + 4.0 * m1 * a2 * d2)
    ia = (None, a)
    mu0 = cdiv(csub(rm, ia), cadd(rm, ia))
    inv_mu0 = cdiv(1.0, mu0)
    iMrm = (None, M * rm)  # i M (R + M)

    def coef_r(s):
        """1/mu0 times the constant of r+- (s = +-s1)."""
        num = cadd(cmul(csub(csub(s, m1), (None, a1)), RM2a2),
                   cmul(2.0 * a1, cadd(m1 * a, iMrm)))
        den = cadd(cmul(cadd(csub(s, m1), (None, a1)), RM2a2),
                   cmul(2.0 * a1, csub(m1 * a, iMrm)))
        return cmul(inv_mu0, cdiv(num, den))

    def coef_R(s):
        """-mu0 times the constant of R+- (s = +-s2)."""
        num = csub(cmul(csub(cadd(s, m2), (None, a2)), RM2a2),
                   cmul(2.0 * a2, csub(m2 * a, iMrm)))
        den = csub(cmul(cadd(cadd(s, m2), (None, a2)), RM2a2),
                   cmul(2.0 * a2, cadd(m2 * a, iMrm)))
        return cmul(cneg(mu0), cdiv(num, den))

    s1s1, s2s2 = cmul(s1, s1), cmul(s2, s2)
    s12 = cadd(s1, s2)
    ka = csub(R * R, cmul(s12, s12))      # R^2 - (s1 + s2)^2
    kb = cmul(cmul(4.0, s1), s2)          # 4 s1 s2
    kc = cmul(cmul(2.0, s1), cadd(csub(R * R, s1s1), s2s2))
    kd = cmul(cmul(2.0, s2), csub(cadd(R * R, s1s1), s2s2))
    ke = cmul(cmul(cmul(4.0, R), s1), s2)
    kf = cmul(s1, cadd(csub(R * R, s1s1), s2s2))
    kg = cmul(s2, csub(cadd(R * R, s1s1), s2s2))
    kh = cmul(cmul(2.0, s1), s2)
    s1m2 = csub(s1s1, s2s2)
    K0 = (RM2a2 * (R * R - (m1 - m2) * (m1 - m2) + a * a)
          - 4.0 * m1 * m1 * m2 * m2 * a * a) / (m1 * m2 * RM2a2)
    abs1, abs2 = cx.cabs(s1), cx.cabs(s2)
    e2g_pre = 16.0 * (abs1 * abs1) * (abs2 * abs2) * K0 * K0

    # Where they meet the coordinates.
    pp = p * p
    Rsp = _rad(pp, z, cadd(0.5 * R, s2))
    Rsn = _rad(pp, z, csub(0.5 * R, s2))
    rsp = _rad(pp, z, cadd(-0.5 * R, s1))
    rsn = _rad(pp, z, csub(-0.5 * R, s1))
    rp = cmul(cx.c32(coef_r(s1)), rsp)
    rn = cmul(cx.c32(coef_r(cneg(s1))), rsn)
    Rp = cmul(cx.c32(coef_R(s2)), Rsp)
    Rn = cmul(cx.c32(coef_R(cneg(s2))), Rsn)
    R32 = param32(R)

    A = csub(cmul(cmul(cx.c32(ka), csub(Rp, Rn)), csub(rp, rn)),
             cmul(cmul(cx.c32(kb), csub(Rp, rn)), csub(Rn, rp)))
    B = cadd(cadd(cmul(cx.c32(kc), csub(Rn, Rp)),
                  cmul(cx.c32(kd), csub(rn, rp))),
             cmul(cx.c32(ke), csub(csub(cadd(Rp, Rn), rp), rn)))
    G = csub(cadd(cadd(
        cmul(-z, B),
        cmul(cmul(cx.c32(kf), csub(Rn, Rp)), cadd(cadd(rp, rn), R32))),
        cmul(cmul(cx.c32(kg), csub(rn, rp)), csub(cadd(Rp, Rn), R32))),
        cmul(cx.c32(kh), cadd(
            cmul(param32(2.0 * R), cadd(csub(csub(cmul(rp, rn), cmul(Rp, Rn)),
                                             cmul(cx.c32(s1), csub(rn, rp))),
                                        cmul(cx.c32(s2), csub(Rn, Rp)))),
            cmul(cx.c32(s1m2), csub(csub(cadd(rp, rn), Rp), Rn)))))

    denom = cx.scm(A) - cx.scm(B)
    inv_denom = recip(denom)
    cab = cadd(conj(A), conj(B))
    w = param32(2.0 * a) - 2.0 * imag(cmul(G, cab)) * inv_denom
    f = denom * recip(real(cmul(cadd(A, B), cab)))
    e2g = denom * recip(real(cmul(param32(e2g_pre), cmul(cmul(cmul(
        Rsp, Rsn), rsp), rsn))))
    inv_f = recip(f)

    dphi2 = -f * w * w
    dphi1 = inv_f * pp
    dt_dphi = 2.0 * f * w
    dp = inv_f * e2g
    return sym_metric(
        {
            (0, 0): -f,
            (2, 2): dphi1 + dphi2,
            (0, 2): 0.5 * dt_dphi,
            (1, 1): dp,
            (3, 3): dp,
        }
    )


double_unequal_kerr = register(
    Metric(
        name="double_unequal_kerr",
        structure=frozenset({(0, 0), (0, 2), (1, 1), (2, 2), (3, 3)}),
        fn=double_unequal_kerr_fn,
        config=make_config(
            "cylindrical_base",
            name="double_unequal_kerr",
            adaptive_precision=True,
            detect_singularities=True,
            max_acceleration_change=1e-5,
            description="Two unequal mass kerr black holes",
        ),
        defaults={"m1": 0.15, "m2": 0.3, "fa1": 1.0, "fa2": -0.3, "R": 4.0},
        depends_on=(1, 3),
    )
)
