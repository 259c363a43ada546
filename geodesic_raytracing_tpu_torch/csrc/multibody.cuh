// Catalogue slice C's two-body metrics on Weyl strips, cylindrical
// (t, p, phi, z), g depending on p (tangent 0) and z (tangent 1):
// `double_schwarzschild` (real), and `double_kerr`, `double_kerr_alt` and
// `double_unequal_kerr`, whose Ernst potentials are complex pairs of duals
// (complex.cuh).  Term for term the torch metrics of
// `metrics/catalogue_multibody.py`; a change there must be made here too.
// `from_params` evaluates every expression of parameters alone in double,
// with the same pair functions as the torch form's double block (complex
// ones included: sigma, the potentials' constants, the cube root), and keeps
// each one rounded once to float where it meets a coordinate.
#pragma once

#include <math.h>

#include "complex.cuh"
#include "sym.cuh"

namespace grt {

// cylindrical_base with the adaptive step and the singularity kill;
// precision weights (1, 1, 8, 1); g depends on p and z.
struct CylindricalTwoBody {
  static constexpr bool adaptive_precision = true;
  static constexpr bool detect_singularities = true;
  static constexpr bool singular = false;
  static constexpr float singular_terminator = 1.0f;
  static constexpr bool has_cylindrical_singularity = false;
  static constexpr float cylindrical_terminator = 0.005f;
  static constexpr bool unconditionally_nonsingular = false;
  GRT_HD static constexpr float weight(int i) { return i == 2 ? 8.0f : 1.0f; }
  static constexpr double udiv = 8.0;
  static constexpr int n_deps = 2;
  GRT_HD static constexpr int dep(int k) { return k == 0 ? 1 : 3; }
  // cylindrical_to_polar's r: sqrt(p^2 + z^2).
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const {
    return sqrtf(x[1] * x[1] + x[3] * x[3]);
  }
};

// Two Schwarzschild black holes on the axis at a1..a4, held apart by a
// strut; a ray that reaches p < 0.005 dies (the cylindrical terminator).
struct DoubleSchwarzschild : CylindricalTwoBody {
  float ak[4];
  static constexpr const char* name = "double_schwarzschild";
  static constexpr int n_params = 3;  // M1, M2, z
  static constexpr bool has_cylindrical_singularity = true;
  GRT_HD static DoubleSchwarzschild from_params(const float* p) {
    const double M1 = p[0], M2 = p[1], z0 = p[2];
    const double e = M2 - M1, M = M1 + M2;
    DoubleSchwarzschild m;
    m.ak[0] = static_cast<float>(-0.5 * (M - e) - z0);
    m.ak[1] = static_cast<float>(0.5 * (M - e) - z0);
    m.ak[2] = static_cast<float>(-0.5 * (M + e) + z0);
    m.ak[3] = static_cast<float>(0.5 * (M + e) + z0);
    return m;
  }
  template <class T, class P, class X2, class Z>
  GRT_HD GRT_INLINE auto g(const T&, const P& p, const X2&,
                           const Z& z) const {
    const auto pp = p * p;
    using DZ = decltype(z - ak[0]);
    using RK = decltype(grt_sqrt(pp + (z - ak[0]) * (z - ak[0])));
    DZ dz[4];
    RK Rk[4];
    for (int i = 0; i < 4; ++i) {
      dz[i] = z - ak[i];
      Rk[i] = grt_sqrt(pp + dz[i] * dz[i]);
    }
    auto Yk = [&](int i) { return Rk[i] + ak[i] - z; };
    auto Yij = [&](int i, int j) {
      return Rk[i - 1] * Rk[j - 1] + dz[i - 1] * dz[j - 1] + pp;
    };
    const auto e2k = (Yij(4, 3) * Yij(2, 1) * Yij(4, 1) * Yij(3, 2)) *
                     grt_recip(4.0f * Yij(4, 2) * Yij(3, 1) * Rk[0] * Rk[1] *
                               Rk[2] * Rk[3]);
    const auto e_2U = (Yk(0) * Yk(2)) * grt_recip(Yk(1) * Yk(3));
    const auto e_m2U = grt_recip(e_2U);
    return sym(entry<0, 0>(-e_2U), entry<1, 1>(e_m2U * e2k),
               entry<2, 2>(e_m2U * pp), entry<3, 3>(e_m2U * e2k));
  }
};

using CF = Cx<float, float>;
using CD = Cx<double, double>;

// The imaginary unit of the double blocks.
GRT_HD GRT_INLINE Cx<Zero, double> imag_unit() { return {Zero{}, 1.0}; }

// A pair c of parameter expressions as `rad` takes it: c rounded to float,
// and its imaginary part squared in double, then rounded.
struct RadOffset {
  CF c;
  float ci2;
};
GRT_HD GRT_INLINE RadOffset rad_offset(const CD& c) {
  return {f32(c), static_cast<float>(c.im * c.im)};
}

// csqrt(p^2 + (z + c)^2), the square of z + c as cmul forms it (the torch
// form's `_rad`).
template <class PP, class Z>
GRT_HD GRT_INLINE auto rad(const PP& pp, const Z& z, const RadOffset& o) {
  const auto w = z + o.c.re;
  return csqrt(make_cx(pp + (w * w - o.ci2), w * o.c.im + o.c.im * w));
}

// Two equal Kerr black holes on a strut (Kramer-Neugebauer).
struct DoubleKerr : CylindricalTwoBody {
  CF cRp, cRn, crp, crn;  // the constants of R+, R-, r+, r-
  RadOffset oRp, oRn, orp, orn;
  float RR, four_sigma_sq, RR_4sigma_sq, two_R, four_a, K0K0;
  CF two_r_sig, r_plus, r_minus, r_sig, four_sig;
  static constexpr const char* name = "double_kerr";
  static constexpr int n_params = 3;  // R, M, a
  GRT_HD static DoubleKerr from_params(const float* p) {
    const double R = p[0], M = p[1], a = p[2];
    const double den0 = R * R + 2.0 * M * R + 4.0 * a * a;
    const double num0 = R * R - 4.0 * M * M + 4.0 * a * a;
    const double d = 2.0 * M * a * num0 / den0;
    const double sigma_sq =
        M * M - a * a + (4.0 * M * M * a * a * num0) / (den0 * den0);
    const CD sigmap = csqrt(sigma_sq);
    const CD sigman = cneg(sigmap);
    const Cx<Zero, double> ia{Zero{}, a}, id_{Zero{}, d};
    auto coef_R = [&](const CD& sig) {
      return cdiv(cadd(cmul(-M, cadd(cmul(2.0, sig), R)), id_),
                  cadd(2.0 * M * M,
                       cmul(cadd(R, cmul(2.0, ia)), cadd(sig, ia))));
    };
    auto coef_r = [&](const CD& sig) {
      return cdiv(cadd(cmul(-M, csub(cmul(2.0, sig), R)), id_),
                  csub(2.0 * M * M,
                       cmul(csub(R, cmul(2.0, ia)), cadd(sig, ia))));
    };
    const double q = R + 2.0 * M;
    const double K0 = 4.0 * sigma_sq * (den0 * den0 - 16.0 * M * M * a * a) /
                      (M * M * (q * q + 4.0 * a * a));
    DoubleKerr m;
    m.cRp = f32(coef_R(sigmap));
    m.cRn = f32(coef_R(sigman));
    m.crp = f32(coef_r(sigmap));
    m.crn = f32(coef_r(sigman));
    m.oRp = rad_offset(cadd(0.5 * R, sigmap));
    m.oRn = rad_offset(cadd(0.5 * R, sigman));
    m.orp = rad_offset(cadd(-0.5 * R, sigmap));
    m.orn = rad_offset(cadd(-0.5 * R, sigman));
    m.RR = static_cast<float>(R * R);
    m.four_sigma_sq = static_cast<float>(4.0 * sigma_sq);
    m.RR_4sigma_sq = static_cast<float>(R * R - 4.0 * sigma_sq);
    m.two_R = static_cast<float>(2.0 * R);
    m.four_a = static_cast<float>(4.0 * a);
    m.K0K0 = static_cast<float>(K0 * K0);
    m.two_r_sig = f32(cmul(2.0 * R, sigmap));
    m.r_plus = f32(cadd(R, cmul(2.0, sigmap)));
    m.r_minus = f32(csub(R, cmul(2.0, sigmap)));
    m.r_sig = f32(cmul(R, sigmap));
    m.four_sig = f32(cmul(4.0, sigmap));
    return m;
  }
  template <class T, class P, class X2, class Z>
  GRT_HD GRT_INLINE auto g(const T&, const P& p, const X2&,
                           const Z& z) const {
    const auto pp = p * p;
    const auto Rp = cmul(cRp, rad(pp, z, oRp));
    const auto Rn = cmul(cRn, rad(pp, z, oRn));
    const auto rp = cmul(crp, rad(pp, z, orp));
    const auto rn = cmul(crn, rad(pp, z, orn));
    const auto A = csub(cmul(cmul(RR, csub(Rp, Rn)), csub(rp, rn)),
                        cmul(cmul(four_sigma_sq, csub(Rp, rp)), csub(Rn, rn)));
    const auto B = cmul(two_r_sig, csub(cmul(r_plus, csub(Rn, rp)),
                                        cmul(r_minus, csub(Rp, rn))));
    const auto G = cadd(
        cmul(-z, B),
        cmul(r_sig,
             csub(cadd(cmul(two_R, csub(cmul(Rn, rn), cmul(Rp, rp))),
                       cmul(four_sig, csub(cmul(Rp, Rn), cmul(rp, rn)))),
                  cmul(RR_4sigma_sq, cadd(csub(csub(Rp, Rn), rp), rn)))));
    const auto denom = scm(A) - scm(B);
    const auto inv_denom = grt_recip(denom);
    const auto cab = cadd(conj(A), conj(B));
    const auto w = four_a - 2.0f * imag(cmul(G, cab)) * inv_denom;
    const auto re_ab = real(cmul(cadd(A, B), cab));
    const auto f = denom * grt_recip(re_ab);
    const auto i_f = re_ab * inv_denom;
    const auto kk = cmul(cmul(cmul(cmul(K0K0, Rp), Rn), rp), rn);
    const auto i_f_e2g = re_ab * grt_recip(real(kk));
    const auto dphi1 = i_f * pp;
    const auto dphi2 = -f * w * w;
    const auto dt_dphi = 2.0f * f * w;
    return sym(entry<0, 0>(-f), entry<2, 2>(dphi1 + dphi2),
               entry<0, 2>(0.5f * dt_dphi), entry<1, 1>(i_f_e2g),
               entry<3, 3>(i_f_e2g));
  }
};

// Co- and counter-rotating double Kerr (arXiv:1702.02209).
struct DoubleKerrAlt : CylindricalTwoBody {
  RadOffset o1, o2, o3, o4;
  CF four_ss, rr_4ss, P1234, Pc1234, Pc12_34, P12_c34, Pc1_2_c3_4, P1_c2_3_c4;
  CF g_pre, g_m, g_p, sp_sn, csp_csn, pp_pn, cpp_cpn;
  CF G1, G2, G3, G4, G5, G6, G7, G8, G9, G10;
  float RR, two_RR, e2y_pre;
  static constexpr const char* name = "double_kerr_alt";
  static constexpr int n_params = 3;  // R, M, q
  GRT_HD static DoubleKerrAlt from_params(const float* p) {
    const double R = p[0], M = p[1], q = p[2];
    const auto I = imag_unit();
    const double s = R * (R + 2.0 * M) + 4.0 * q * q;
    const CD sigma = csqrt(
        M * M - q * q * (1.0 - (4.0 * M * M * (R * R - 4.0 * M * M +
                                                4.0 * q * q)) /
                                   (s * s)));
    const double littled =
        2.0 * M * q * (R * R - 4.0 * M * M + 4.0 * q * q) / s;
    const double mq = 2.0 * (M * M - q * q);
    const CD q_minus = cmul(q, csub(R, cmul(2.0, sigma)));
    const CD q_plus = cmul(q, cadd(R, cmul(2.0, sigma)));
    const CD pp_ = cadd(cadd(csub(mq, cmul(R + 2.0 * M, sigma)), M * R),
                        cmul(I, cadd(q_minus, littled)));
    const CD pn_ = cadd(csub(csub(mq, cmul(R - 2.0 * M, sigma)), M * R),
                        cmul(I, csub(q_minus, littled)));
    const CD sp_ = cadd(csub(cadd(mq, cmul(R - 2.0 * M, sigma)), M * R),
                        cmul(I, csub(q_plus, littled)));
    const CD sn_ = cadd(cadd(cadd(mq, cmul(R + 2.0 * M, sigma)), M * R),
                        cmul(I, cadd(q_plus, littled)));
    const CD ss = cmul(sigma, sigma);
    const CD k0 = cmul(
        csub(R * R, cmul(4.0, ss)),
        cadd(cadd(cmul(R * R - 4.0 * M * M, csub(M * M, ss)),
                  4.0 * (q * q) * (q * q)),
             4.0 * M * q * littled));
    const auto two_iq = cmul(2.0, cmul(I, q));
    const CD kp = cadd(R, cmul(2.0, cadd(sigma, two_iq)));
    const CD kn = csub(R, cmul(2.0, cadd(sigma, two_iq)));
    auto prod4 = [](const CD& a, const CD& b, const CD& c, const CD& d) {
      return cmul(cmul(cmul(a, b), c), d);
    };
    DoubleKerrAlt m;
    m.o1 = rad_offset(csub(-R / 2, sigma));
    m.o2 = rad_offset(cadd(-R / 2, sigma));
    m.o3 = rad_offset(csub(R / 2, sigma));
    m.o4 = rad_offset(cadd(R / 2, sigma));
    m.four_ss = f32(cmul(cmul(4.0, sigma), sigma));
    m.rr_4ss = f32(csub(R * R, cmul(4.0, ss)));
    m.P1234 = f32(prod4(pp_, pn_, sp_, sn_));
    m.Pc1234 = f32(prod4(conj(pp_), conj(pn_), conj(sp_), conj(sn_)));
    m.Pc12_34 = f32(prod4(conj(pp_), conj(pn_), sp_, sn_));
    m.P12_c34 = f32(prod4(pp_, pn_, conj(sp_), conj(sn_)));
    m.Pc1_2_c3_4 = f32(prod4(conj(pp_), pn_, conj(sp_), sn_));
    const CD P1_c2_3_c4 = prod4(pp_, conj(pn_), sp_, conj(sn_));
    m.P1_c2_3_c4 = f32(P1_c2_3_c4);
    const double im_pp_cpn = imag(cmul(pp_, conj(pn_)));
    const double im_sp_csn = imag(cmul(sp_, conj(sn_)));
    const CD sp_sn = cmul(sp_, sn_);
    const CD csp_csn = cmul(conj(sp_), conj(sn_));
    const CD pp_pn = cmul(pp_, pn_);
    const CD cpp_cpn = cmul(conj(pp_), conj(pn_));
    m.sp_sn = f32(sp_sn);
    m.csp_csn = f32(csp_csn);
    m.pp_pn = f32(pp_pn);
    m.cpp_cpn = f32(cpp_cpn);
    m.g_pre = f32(cmul(cmul(cmul(-2.0, I), sigma), R));
    m.g_m = f32(cmul(csub(R, cmul(2.0, sigma)), im_pp_cpn));
    m.g_p = f32(cmul(cadd(R, cmul(2.0, sigma)), im_sp_csn));
    const CD rr_4ss = csub(R * R, cmul(4.0, ss));
    m.G1 = f32(cmul(csub(R, cmul(2.0, cmul(I, q))),
                    prod4(pp_, pn_, sp_, sn_)));
    m.G2 = f32(cmul(cadd(R, cmul(2.0, cmul(I, q))),
                    prod4(conj(pp_), conj(pn_), conj(sp_), conj(sn_))));
    m.G3 = f32(cmul(csub(sigma, cmul(I, q)),
                    prod4(conj(pp_), conj(pn_), sp_, sn_)));
    m.G4 = f32(cmul(cadd(sigma, cmul(I, q)),
                    prod4(pp_, pn_, conj(sp_), conj(sn_))));
    m.G5 = f32(cmul(cmul(cmul(cmul(2.0, I), q), rr_4ss), real(P1_c2_3_c4)));
    m.G6 = f32(cmul(cmul(I, sigma), R));
    m.G7 = f32(cmul(conj(kp), sp_sn));
    m.G8 = f32(cmul(kp, csp_csn));
    m.G9 = f32(cmul(kn, pp_pn));
    m.G10 = f32(cmul(conj(kn), cpp_cpn));
    m.RR = static_cast<float>(R * R);
    m.two_RR = static_cast<float>(2.0 * R * R);
    m.e2y_pre = static_cast<float>(256.0 * real(cmul(ss, ss)) *
                                   ((R * R) * (R * R)) * real(cmul(k0, k0)));
    return m;
  }
  template <class T, class P, class X2, class Z>
  GRT_HD GRT_INLINE auto g(const T&, const P& p, const X2&,
                           const Z& z) const {
    const auto pp = p * p;
    const auto r1 = rad(pp, z, o1);
    const auto r2 = rad(pp, z, o2);
    const auto r3 = rad(pp, z, o3);
    const auto r4 = rad(pp, z, o4);
    // at(k, z1, z2) of the torch form: k z1 z2, left to right.
    auto at2 = [](const auto& k, const auto& z1, const auto& z2) {
      return cmul(cmul(k, z1), z2);
    };
    const auto delta =
        cadd(csub(cmul(four_ss, cadd(at2(P1234, r1, r2), at2(Pc1234, r3, r4))),
                  cmul(RR, cadd(at2(Pc12_34, r1, r3), at2(P12_c34, r2, r4)))),
             cmul(rr_4ss,
                  cadd(at2(Pc1_2_c3_4, r1, r4), at2(P1_c2_3_c4, r2, r3))));
    const auto gamma =
        cmul(g_pre, cadd(cmul(g_m, csub(cmul(sp_sn, r1), cmul(csp_csn, r4))),
                         cmul(g_p, csub(cmul(pp_pn, r2), cmul(cpp_cpn, r3)))));
    const auto G = csub(
        csub(csub(cmul(four_ss, csub(at2(G1, r1, r2), at2(G2, r3, r4))),
                  cmul(two_RR, csub(at2(G3, r1, r3), at2(G4, r2, r4)))),
             cmul(G5, cadd(cmul(r1, r4), cmul(r2, r3)))),
        cmul(G6, cadd(cmul(g_m, cadd(cmul(G7, r1), cmul(G8, r4))),
                      cmul(g_p, cadd(cmul(G9, r2), cmul(G10, r3))))));
    const auto denom = scm(delta) - scm(gamma);
    const auto inv_denom = grt_recip(denom);
    const auto dg = csub(delta, gamma);
    const auto w =
        2.0f * imag(cmul(dg, cadd(cmul(z, conj(gamma)), conj(G)))) *
        inv_denom;
    const auto e2y =
        denom * grt_recip(e2y_pre * real(cmul(cmul(cmul(r1, r2), r3), r4)));
    const auto f =
        denom * grt_recip(real(cmul(dg, csub(conj(delta), conj(gamma)))));
    const auto inv_f = grt_recip(f);
    const auto dp = e2y * inv_f;
    const auto dphi_1 = pp * inv_f;
    const auto dphi_2 = -f * w * w;
    const auto dt_dphi = 2.0f * f * w;
    return sym(entry<0, 0>(-f), entry<1, 1>(dp), entry<2, 2>(dphi_1 + dphi_2),
               entry<3, 3>(dp), entry<0, 2>(0.5f * dt_dphi));
  }
};

// Two unequal-mass Kerr black holes (ScienceDirect S0370269319303375).
struct DoubleUnequalKerr : CylindricalTwoBody {
  RadOffset oRsp, oRsn, orsp, orsn;
  CF crp, crn, cRp, cRn, ka, kb, kc, kd, ke, kf, kg, kh, s1f, s2f, s1m2;
  float R32, two_R, two_a, e2g_pre;
  static constexpr const char* name = "double_unequal_kerr";
  static constexpr int n_params = 5;  // m1, m2, fa1, fa2, R
  GRT_HD static DoubleUnequalKerr from_params(const float* p) {
    const double m1 = p[0], m2 = p[1], fa1 = p[2], fa2 = p[3], R = p[4];
    const double a1 = fa1 * m1, a2 = fa2 * m2;
    const double J = m1 * a1 + m2 * a2;
    const double M = m1 + m2;
    // The cubic's root for the NUT-free constant a.
    const double k = a1 + a2;
    const double B_ = R * R - M * M;
    const double C_ = 2.0 * (R + M);
    const double inner = 18.0 * B_ * k + 27.0 * C_ * J - 9.0 * C_ * k * M +
                         2.0 * (k * k * k);
    const double t = 3.0 * B_ + 3.0 * C_ * M - k * k;
    const CD inner_val =
        cpow(cadd(csqrt(inner * inner + 4.0 * (t * t * t)), inner),
             1.0 / 3.0);
    const double third_root_2 = pow(2.0, 1.0 / 3.0);
    const double a =
        real(cadd(csub(cmul(1.0 / (3.0 * third_root_2), inner_val),
                       cdiv(third_root_2 * t, cmul(3.0, inner_val))),
                  k / 3.0));
    const double rm = R + M;
    const double RM2a2 = rm * rm + a * a;
    const double d1 =
        ((m1 * (a1 - a2 + a) + R * a) * RM2a2 + m2 * a1 * a * a) /
        (RM2a2 * RM2a2);
    const double d2 =
        ((m2 * (a2 - a1 + a) + R * a) * RM2a2 + m1 * a2 * a * a) /
        (RM2a2 * RM2a2);
    const CD s1 = csqrt(m1 * m1 - a1 * a1 + 4.0 * m2 * a1 * d1);
    const CD s2 = csqrt(m2 * m2 - a2 * a2 + 4.0 * m1 * a2 * d2);
    const Cx<Zero, double> ia{Zero{}, a};
    const CD mu0 = cdiv(csub(rm, ia), cadd(rm, ia));
    const CD inv_mu0 = cdiv(1.0, mu0);
    const Cx<Zero, double> iMrm{Zero{}, M * rm};
    const Cx<Zero, double> ia1{Zero{}, a1}, ia2{Zero{}, a2};
    auto coef_r = [&](const CD& s) {
      const auto num = cadd(cmul(csub(csub(s, m1), ia1), RM2a2),
                            cmul(2.0 * a1, cadd(m1 * a, iMrm)));
      const auto den = cadd(cmul(cadd(csub(s, m1), ia1), RM2a2),
                            cmul(2.0 * a1, csub(m1 * a, iMrm)));
      return cmul(inv_mu0, cdiv(num, den));
    };
    auto coef_R = [&](const CD& s) {
      const auto num = csub(cmul(csub(cadd(s, m2), ia2), RM2a2),
                            cmul(2.0 * a2, csub(m2 * a, iMrm)));
      const auto den = csub(cmul(cadd(cadd(s, m2), ia2), RM2a2),
                            cmul(2.0 * a2, cadd(m2 * a, iMrm)));
      return cmul(cneg(mu0), cdiv(num, den));
    };
    const CD s1s1 = cmul(s1, s1), s2s2 = cmul(s2, s2);
    const CD s12 = cadd(s1, s2);
    const double K0 = (RM2a2 * (R * R - (m1 - m2) * (m1 - m2) + a * a) -
                       4.0 * m1 * m1 * m2 * m2 * a * a) /
                      (m1 * m2 * RM2a2);
    const double abs1 = cabs(s1), abs2 = cabs(s2);
    DoubleUnequalKerr m;
    m.oRsp = rad_offset(cadd(0.5 * R, s2));
    m.oRsn = rad_offset(csub(0.5 * R, s2));
    m.orsp = rad_offset(cadd(-0.5 * R, s1));
    m.orsn = rad_offset(csub(-0.5 * R, s1));
    m.crp = f32(coef_r(s1));
    m.crn = f32(coef_r(cneg(s1)));
    m.cRp = f32(coef_R(s2));
    m.cRn = f32(coef_R(cneg(s2)));
    m.ka = f32(csub(R * R, cmul(s12, s12)));
    m.kb = f32(cmul(cmul(4.0, s1), s2));
    m.kc = f32(cmul(cmul(2.0, s1), cadd(csub(R * R, s1s1), s2s2)));
    m.kd = f32(cmul(cmul(2.0, s2), csub(cadd(R * R, s1s1), s2s2)));
    m.ke = f32(cmul(cmul(cmul(4.0, R), s1), s2));
    m.kf = f32(cmul(s1, cadd(csub(R * R, s1s1), s2s2)));
    m.kg = f32(cmul(s2, csub(cadd(R * R, s1s1), s2s2)));
    m.kh = f32(cmul(cmul(2.0, s1), s2));
    m.s1f = f32(s1);
    m.s2f = f32(s2);
    m.s1m2 = f32(csub(s1s1, s2s2));
    m.R32 = static_cast<float>(R);
    m.two_R = static_cast<float>(2.0 * R);
    m.two_a = static_cast<float>(2.0 * a);
    m.e2g_pre = static_cast<float>(16.0 * (abs1 * abs1) * (abs2 * abs2) * K0 *
                                   K0);
    return m;
  }
  template <class T, class P, class X2, class Z>
  GRT_HD GRT_INLINE auto g(const T&, const P& p, const X2&,
                           const Z& z) const {
    const auto pp = p * p;
    const auto Rsp = rad(pp, z, oRsp);
    const auto Rsn = rad(pp, z, oRsn);
    const auto rsp = rad(pp, z, orsp);
    const auto rsn = rad(pp, z, orsn);
    const auto rp = cmul(crp, rsp);
    const auto rn = cmul(crn, rsn);
    const auto Rp = cmul(cRp, Rsp);
    const auto Rn = cmul(cRn, Rsn);
    const auto A = csub(cmul(cmul(ka, csub(Rp, Rn)), csub(rp, rn)),
                        cmul(cmul(kb, csub(Rp, rn)), csub(Rn, rp)));
    const auto B = cadd(cadd(cmul(kc, csub(Rn, Rp)), cmul(kd, csub(rn, rp))),
                        cmul(ke, csub(csub(cadd(Rp, Rn), rp), rn)));
    const auto G = csub(
        cadd(cadd(cmul(-z, B),
                  cmul(cmul(kf, csub(Rn, Rp)), cadd(cadd(rp, rn), R32))),
             cmul(cmul(kg, csub(rn, rp)), csub(cadd(Rp, Rn), R32))),
        cmul(kh,
             cadd(cmul(two_R,
                       cadd(csub(csub(cmul(rp, rn), cmul(Rp, Rn)),
                                 cmul(s1f, csub(rn, rp))),
                            cmul(s2f, csub(Rn, Rp)))),
                  cmul(s1m2, csub(csub(cadd(rp, rn), Rp), Rn)))));
    const auto denom = scm(A) - scm(B);
    const auto inv_denom = grt_recip(denom);
    const auto cab = cadd(conj(A), conj(B));
    const auto w = two_a - 2.0f * imag(cmul(G, cab)) * inv_denom;
    const auto f = denom * grt_recip(real(cmul(cadd(A, B), cab)));
    const auto e2g = denom * grt_recip(real(
                                 cmul(e2g_pre, cmul(cmul(cmul(Rsp, Rsn), rsp),
                                                    rsn))));
    const auto inv_f = grt_recip(f);
    const auto dphi2 = -f * w * w;
    const auto dphi1 = inv_f * pp;
    const auto dt_dphi = 2.0f * f * w;
    const auto dp = inv_f * e2g;
    return sym(entry<0, 0>(-f), entry<2, 2>(dphi1 + dphi2),
               entry<0, 2>(0.5f * dt_dphi), entry<1, 1>(dp),
               entry<3, 3>(dp));
  }
};

}  // namespace grt
