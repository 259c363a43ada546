// Catalogue slice B's spherically symmetric polar metrics:
// `janis_newman_winicour` (real powers with parameter exponents),
// `schwarzschild_ingoing_ef_hawking` (an evaporating hole in the identity
// ingoing-EF chart, g depends on v, r and theta), `configurable_wormhole`
// (the polynomial arctan and log1p under a where on |l|) and
// `ellis_drainhole` (arctan2, exp and sqrt, an off-diagonal (t, r) entry,
// the scheduled step).  Term for term the torch metrics of
// `metrics/catalogue_simple.py`; a change there must be made here too.  A
// parameter-only expression is evaluated in double in `from_params` and
// rounded once, as Python evaluates it before it meets a tensor.
#pragma once

#include <math.h>

#include "schwarzschild.cuh"
#include "sym.cuh"

namespace grt {

// diag(-A, 1/A, B, B sin^2 theta) with A = (num/den)^(1/mu) and
// B = den^(1/mu + 1) / (4 num^(1/mu - 1)), num, den = 2r -+ r0 (mu -+ 1).
struct JanisNewmanWinicour : PolarBase, SymmetricWeights {
  float c_num;  // r0 (mu - 1)
  float c_den;  // r0 (mu + 1)
  PowRule e_a;  // 1/mu
  PowRule e_b;  // 1/mu + 1
  PowRule e_c;  // 1/mu - 1
  static constexpr const char* name = "janis_newman_winicour";
  static constexpr int n_params = 2;  // r0, mu
  static constexpr bool detect_singularities = false;
  GRT_HD static JanisNewmanWinicour from_params(const float* p) {
    JanisNewmanWinicour m;
    const double r0 = p[0], mu = p[1];
    m.c_num = static_cast<float>(r0 * (mu - 1.0));
    m.c_den = static_cast<float>(r0 * (mu + 1.0));
    m.e_a = pow_rule(1.0 / mu);
    m.e_b = pow_rule(1.0 / mu + 1.0);
    m.e_c = pow_rule(1.0 / mu - 1.0);
    return m;
  }
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }
  template <class X0, class R, class Th, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const R& r, const Th& theta,
                           const X3&) const {
    const auto st = grt_sin(theta);
    const auto num = 2.0f * r - c_num;
    const auto den = 2.0f * r + c_den;
    const auto A = grt_pow(num * grt_recip(den), e_a);
    const auto B = 0.25f * grt_pow(den, e_b) * grt_recip(grt_pow(num, e_c));
    return sym(entry<0, 0>(-A), entry<1, 1>(grt_recip(A)), entry<2, 2>(B),
               entry<3, 3>(B * st * st));
  }
};

// The reference's pow_pos of a parameter expression, in double.
GRT_HD inline double pow_pos_double(double b, double e) {
  return b > 0.0 ? exp(log(b > 1e-37 ? b : 1e-37) * e) : 0.0;
}

// Ingoing EF (v, r, theta, phi) with rs(v) = k' (lifetime - v)^(1/3) for
// v <= lifetime, else 0; g_vr = 1, no g_rr.  g depends on v (tangent 0), r
// (tangent 1) and theta (tangent 2).
struct SchwarzschildIngoingEFHawking : PolarBase, SymmetricWeights {
  float lifetime;
  float k_dash;  // 2 pow_pos((rs_base / 2)^3 / lifetime, 1/3)
  static constexpr const char* name = "schwarzschild_ingoing_ef_hawking";
  static constexpr int n_params = 2;  // rs_base, lifetime
  static constexpr int n_deps = 3;
  GRT_HD static constexpr int dep(int k) { return k; }
  GRT_HD static SchwarzschildIngoingEFHawking from_params(const float* p) {
    SchwarzschildIngoingEFHawking m;
    m.lifetime = p[1];
    const double M0 = static_cast<double>(p[0]) / 2.0;
    const double k_squiggle = M0 * M0 * M0 / static_cast<double>(p[1]);
    m.k_dash = static_cast<float>(2.0 * pow_pos_double(k_squiggle, 1.0 / 3.0));
    return m;
  }
  // ingoing_ef_variable_to_polar is the identity.
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }
  template <class V, class R, class Th, class X3>
  GRT_HD GRT_INLINE auto g(const V& v, const R& r, const Th& theta,
                           const X3&) const {
    const auto st = grt_sin(theta);
    const auto negative_branch =
        k_dash * grt_pow_pos(grt_clamp_min(lifetime - v, 0.0f),
                             static_cast<float>(1.0 / 3.0));
    const auto rs_v = grt_where(value(v) <= lifetime, negative_branch, 0.0f);
    return sym(entry<0, 0>(-(1.0f - rs_v * grt_recip(r))), entry<0, 1>(1.0f),
               entry<2, 2>(r * r), entry<3, 3>(r * r * st * st));
  }
};

// Thorne's wormhole: diag(-1, 1, r^2, r^2 sin^2 theta) with r = p inside
// |l| <= a and p + M (x arctan x - log1p(x^2) / 2), x = 2 (|l| - a) / (pi M),
// outside.
struct ConfigurableWormhole : PolarBase, SymmetricWeights {
  float M;
  float p;
  float a;
  float inv_pi_M;  // 1 / (pi M)
  static constexpr const char* name = "configurable_wormhole";
  static constexpr int n_params = 3;  // M, p, a
  static constexpr bool detect_singularities = false;
  GRT_HD static ConfigurableWormhole from_params(const float* q) {
    ConfigurableWormhole m;
    m.M = q[0];
    m.p = q[1];
    m.a = q[2];
    m.inv_pi_M = static_cast<float>(1.0 / (M_PI * static_cast<double>(q[0])));
    return m;
  }
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }
  template <class X0, class L, class Th, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const L& l, const Th& theta,
                           const X3&) const {
    const auto st = grt_sin(theta);
    const auto al = grt_abs(l);
    const auto xx = 2.0f * (al - a) * inv_pi_M;
    const auto r = grt_where(
        value(al) <= a, p,
        p + M * (xx * grt_arctan(xx) - 0.5f * grt_log1p(xx * xx)));
    return sym(entry<0, 0>(-1.0f), entry<1, 1>(1.0f), entry<2, 2>(r * r),
               entry<3, 3>(r * r * st * st));
  }
};

// Ellis's drainhole: F = -sqrt(1 - exp(-(2m/n) phi')), with
// phi' = (n/alpha) (pi/2 - arctan2(r - m, alpha)), alpha = sqrt(n^2 - m^2);
// g_tt = -(1 - F^2), g_tr = F, g_rr = 1, R^2 = ((r - m)^2 + alpha^2) /
// (1 - F^2).  The scheduled step.
struct EllisDrainhole : PolarBase, SymmetricWeights {
  float m;
  float alpha;
  float n_over_alpha;
  float neg_2m_over_n;  // -(2 m / n)
  float alpha2;
  static constexpr const char* name = "ellis_drainhole";
  static constexpr int n_params = 2;  // m, n
  static constexpr bool adaptive_precision = false;
  static constexpr bool detect_singularities = false;
  GRT_HD static EllisDrainhole from_params(const float* p) {
    EllisDrainhole e;
    e.m = p[0];
    const double m = p[0], n = p[1];
    const double alpha = sqrt(n * n - m * m);
    e.alpha = static_cast<float>(alpha);
    e.n_over_alpha = static_cast<float>(n / alpha);
    e.neg_2m_over_n = static_cast<float>(-(2.0 * m / n));
    e.alpha2 = static_cast<float>(alpha * alpha);
    return e;
  }
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }
  template <class X0, class R, class Th, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const R& r, const Th& theta,
                           const X3&) const {
    const auto st = grt_sin(theta);
    const auto rm = r - m;
    const auto pseudophi =
        n_over_alpha *
        (static_cast<float>(M_PI / 2) - grt_arctan2(rm, alpha));
    const auto Fp = -grt_sqrt(1.0f - grt_exp(neg_2m_over_n * pseudophi));
    const auto F2 = Fp * Fp;
    const auto Rp2 = (rm * rm + alpha2) * grt_recip(1.0f - F2);
    return sym(entry<0, 0>(-(1.0f - F2)), entry<0, 1>(Fp), entry<1, 1>(1.0f),
               entry<2, 2>(Rp2), entry<3, 3>(Rp2 * st * st));
  }
};

}  // namespace grt
