// The Kerr family: Kerr in Boyer-Lindquist coordinates (t, r, theta, phi),
// the flagship metric; Kerr-Newman in Boyer-Lindquist; Kerr in ingoing
// Eddington-Finkelstein coordinates (v, r, theta, phi); Kerr in the rational
// chart (t, r, X = cos theta, phi).  Term for term the torch metrics of
// `metrics/catalogue_kerr.py`; a change there must be made here too.  A
// product of three parameters is evaluated in double and rounded once, as
// Python evaluates it before it meets a tensor.
#pragma once

#include "schwarzschild.cuh"
#include "sym.cuh"

namespace grt {

// The five structurally nonzero entries, in the order
// g[0] = g_tt, g[1] = g_rr, g[2] = g_thth, g[3] = g_phph, g[4] = g_tph.
// g depends on r = x[1] and theta = x[2] only.  R, Th and G are all float, or
// duals for the partials: R with the r tangent live, Th with the theta
// tangent, G with both (every entry depends on both coordinates).  Each
// intermediate takes the type its operands give it, so a dual carries only
// the tangents that can be nonzero (dual.cuh).
template <class R, class Th, class G>
GRT_HD GRT_INLINE void kerr_boyer_g(const R& r, const Th& theta, float rs,
                                    float a, G g[5]) {
  Th st, ct;
  grt_sincos(theta, st, ct);
  const auto st2 = st * st;
  const auto E = r * r + a * a * ct * ct;
  const auto D = r * r - rs * r + a * a;
  const auto invE = grt_recip(E);
  const auto rsr_invE = rs * r * invE;
  g[0] = -(1.0f - rsr_invE);
  g[1] = E * grt_recip(D);
  g[2] = E;
  g[3] = (r * r + a * a + rsr_invE * a * a * st2) * st2;
  g[4] = -rsr_invE * a * st2;
}

// Metric parameters travel as kernel arguments, so a new value of rs or a
// does not rebuild the kernel.
// MetricConfig of polar_base; precision weights of a polar chart that is not
// spherically symmetric.
struct KerrBoyer : PolarBase, PolarWeights {
  float rs;
  float a;
  static constexpr const char* name = "kerr_boyer";
  static constexpr int n_params = 2;  // rs, a
  GRT_HD static KerrBoyer from_params(const float* p) {
    return {{}, {}, p[0], p[1]};
  }
  // Polar chart with the at_origin distance: polar r is x[1].
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }

  template <class X0, class R, class Th, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const R& r, const Th& theta,
                           const X3&) const {
    Dual<(R::mask | Th::mask)> e[5];
    kerr_boyer_g(r, theta, rs, a, e);
    return sym(entry<0, 0>(e[0]), entry<1, 1>(e[1]), entry<2, 2>(e[2]),
               entry<3, 3>(e[3]), entry<0, 3>(e[4]));
  }
};

// Kerr-Newman in Boyer-Lindquist coordinates: charge r2q (the charge
// radius), spin a.
struct KerrNewmanBoyer : PolarBase, PolarWeights {
  float rs;
  float r2q;
  float a;
  static constexpr const char* name = "kerr_newman_boyer";
  static constexpr int n_params = 3;  // rs, r2q, a
  GRT_HD static KerrNewmanBoyer from_params(const float* p) {
    return {{}, {}, p[0], p[1], p[2]};
  }
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }
  template <class X0, class R, class Th, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const R& r, const Th& theta,
                           const X3&) const {
    Th st, ct;
    grt_sincos(theta, st, ct);
    const auto p2 = r * r + a * a * ct * ct;
    const auto D = r * r - rs * r + a * a + r2q * r2q;
    const auto inv_p2 = grt_recip(p2);
    const auto dr = -p2 * grt_recip(D);
    const auto dtheta = -p2;
    const auto dt_1 = D * inv_p2;
    const auto dtdphi_1 = -2.0f * a * st * st * D * inv_p2;
    const auto u = a * st * st;
    const auto dphi_1 = u * u * D * inv_p2;
    const auto q = r * r + a * a;
    const auto dphi_2 = -(q * q) * st * st * inv_p2;
    const auto dtdphi_2 = 2.0f * a * q * st * st * inv_p2;
    const auto dt_2 = -a * a * st * st * inv_p2;
    const auto dtdphi = dtdphi_1 + dtdphi_2;
    return sym(entry<0, 0>(-(dt_1 + dt_2)), entry<1, 1>(-dr),
               entry<2, 2>(-dtheta), entry<3, 3>(-(dphi_1 + dphi_2)),
               entry<0, 3>(-dtdphi * 0.5f));
  }
};

// Kerr in ingoing Eddington-Finkelstein coordinates (v, r, theta, phi): the
// horizon is traversable; g_rr is absent and g_rphi (entry (1, 3)) is not.
struct KerrIngoingEF : PolarBase, PolarWeights {
  float rs;
  float a;
  static constexpr const char* name = "kerr_ingoing_ef";
  static constexpr int n_params = 2;  // rs, a
  GRT_HD static KerrIngoingEF from_params(const float* p) {
    return {{}, {}, p[0], p[1]};
  }
  // ingoing_ef_to_polar keeps r in slot 1.
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }
  template <class X0, class R, class Th, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const R& r, const Th& theta,
                           const X3&) const {
    Th st, ct;
    grt_sincos(theta, st, ct);
    const auto R2 = r * r + a * a * ct * ct;
    const auto D = r * r + a * a - rs * r;
    const auto invR2 = grt_recip(R2);
    const auto dv = 1.0f - rs * r * invR2;
    constexpr float dv_dr = -2.0f;
    const auto dv_dphi = (2.0f * a * st * st * invR2) * (rs * r);
    const auto dr_dphi = 2.0f * a * st * st;
    const auto dtheta = -R2;
    const auto q = a * a + r * r;
    const auto dphi = (st * st * invR2) * (D * a * a * st * st - q * q);
    return sym(entry<0, 0>(-dv), entry<0, 1>(-0.5f * dv_dr),
               entry<0, 3>(-0.5f * dv_dphi), entry<1, 3>(-0.5f * dr_dphi),
               entry<2, 2>(-dtheta), entry<3, 3>(-dphi));
  }
};

// Kerr in the rational chart (t, r, X = cos theta, phi), mass m: g depends
// on x[1] (tangent 0) and X = x[2] (tangent 1).
struct KerrRationalPolynomial : PolarBase, PolarWeights {
  float m;
  float a;
  static constexpr const char* name = "kerr_rational_polynomial";
  static constexpr int n_params = 2;  // m, a
  GRT_HD static KerrRationalPolynomial from_params(const float* p) {
    return {{}, {}, p[0], p[1]};
  }
  // rational_to_polar keeps r in slot 1.
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }
  template <class X0, class R, class Xc, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const R& r, const Xc& X,
                           const X3&) const {
    const auto S = r * r + a * a * X * X;
    const auto invS = grt_recip(S);
    const auto dt = -(1.0f - 2.0f * m * r * invS);
    const auto dphidt = -(4.0f * a * m * r * (1.0f - X * X)) * invS;
    const auto dr = S * grt_recip(r * r - 2.0f * m * r + a * a);
    const auto dX = S * grt_recip(1.0f - X * X);
    const float two_maa = static_cast<float>(2.0 * m * a * a);
    const auto dphi = (1.0f - X * X) *
                      (r * r + a * a + (two_maa * r * (1.0f - X * X)) * invS);
    return sym(entry<0, 0>(dt), entry<1, 1>(dr), entry<2, 2>(dX),
               entry<3, 3>(dphi), entry<0, 3>(dphidt * 0.5f));
  }
};

}  // namespace grt
