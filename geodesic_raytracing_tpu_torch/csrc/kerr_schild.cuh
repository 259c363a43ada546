// Catalogue slice C's Kerr-Schild metrics: `kerr_schild` and
// `kerr_newman_schild` (cartesian (t, x, y, z), g = eta + f l l with l
// eta-null).  A struct gives the decomposition `fl` instead of a metric
// function: the march takes its rank-1 acceleration (march.cuh,
// `rank1_acceleration`).  Term for term `_kerr_schild_r`, `kerr_schild_fl`
// and `kerr_newman_schild_fl` of `metrics/catalogue_kerr.py`; a change there
// must be made here too.  Parameter-only expressions are evaluated in double
// in `from_params` and rounded once, as Python evaluates them.
#pragma once

#include <math.h>

#include <utility>

#include "sym.cuh"

namespace grt {

// The decomposition at an event: f and the spatial components of l
// (l_0 = 1).
template <class F, class L1, class L2, class L3>
struct Rank1 {
  F f;
  L1 l1;
  L2 l2;
  L3 l3;
};

// cartesian_base with the adaptive step and the singularity kill; precision
// weights (1, 1, 1, 1); (f, l) depends on x, y, z (tangents 0, 1, 2).
struct KerrSchildBase {
  static constexpr bool adaptive_precision = true;
  static constexpr bool detect_singularities = true;
  static constexpr bool singular = false;
  static constexpr float singular_terminator = 1.0f;
  static constexpr bool has_cylindrical_singularity = false;
  static constexpr float cylindrical_terminator = 0.005f;
  static constexpr bool unconditionally_nonsingular = false;
  GRT_HD static constexpr float weight(int) { return 1.0f; }
  static constexpr double udiv = 1.0;
  static constexpr int n_deps = 3;
  GRT_HD static constexpr int dep(int k) { return k + 1; }
  // cartesian_to_polar's r.
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const {
    return sqrtf(x[1] * x[1] + x[2] * x[2] + x[3] * x[3]);
  }

  float a;
  float neg_aa;  // -a^2
  float aaaa;    // a^4
  float two_aa;  // 2 a^2
  float aa;      // a^2
  GRT_HD void set_spin(double a_) {
    const double aa_ = a_ * a_;
    a = static_cast<float>(a_);
    neg_aa = static_cast<float>(-aa_);
    aaaa = static_cast<float>(aa_ * aa_);
    two_aa = static_cast<float>(2.0 * aa_);
    aa = static_cast<float>(aa_);
  }

  // r^2, r and l of the Kerr-Schild radius (`_kerr_schild_r`).
  template <class X, class Y, class Z, class R2, class R, class L1, class L2,
            class L3>
  GRT_HD GRT_INLINE void radius(const X& xx, const Y& y, const Z& z, R2& r2,
                                R& r, L1& l1, L2& l2, L3& l3) const {
    const auto R2_ = xx * xx + y * y + z * z;
    const auto Rm2 = xx * xx + y * y - z * z;
    r2 = (neg_aa + grt_sqrt(aaaa - two_aa * Rm2 + R2_ * R2_) + R2_) * 0.5f;
    r = grt_sqrt(r2);
    const auto inv_ra = grt_recip(r2 + aa);
    const auto inv_r = grt_recip(r);
    l1 = (r * xx + a * y) * inv_ra;
    l2 = (r * y - a * xx) * inv_ra;
    l3 = z * inv_r;
  }
};

// The (r, l) chain's types: every value depends on x, y and z.
template <class X, class Y, class Z>
using KSDual = decltype(std::declval<X>() * std::declval<Y>() *
                        std::declval<Z>());

// Kerr in Kerr-Schild coordinates: f = rs r^3 / (r^4 + a^2 z^2).
struct KerrSchild : KerrSchildBase {
  float rs;
  static constexpr const char* name = "kerr_schild";
  static constexpr int n_params = 2;  // a, rs
  GRT_HD static KerrSchild from_params(const float* p) {
    KerrSchild m;
    m.set_spin(p[0]);
    m.rs = p[1];
    return m;
  }
  template <class X, class Y, class Z>
  GRT_HD GRT_INLINE auto fl(const X& xx, const Y& y, const Z& z) const {
    using D = KSDual<X, Y, Z>;
    D r2, r, l1, l2, l3;
    radius(xx, y, z, r2, r, l1, l2, l3);
    const auto f = rs * r2 * r * grt_recip(r2 * r2 + aa * z * z);
    return Rank1<D, D, D, D>{f, l1, l2, l3};
  }
};

// Kerr-Newman in Kerr-Schild coordinates: f = (rs r - Q^2) r^2 /
// (r^4 + a^2 z^2).
struct KerrNewmanSchild : KerrSchildBase {
  float rs;
  float QQ;  // Q^2
  static constexpr const char* name = "kerr_newman_schild";
  static constexpr int n_params = 3;  // a, rs, Q
  GRT_HD static KerrNewmanSchild from_params(const float* p) {
    KerrNewmanSchild m;
    m.set_spin(p[0]);
    m.rs = p[1];
    m.QQ = static_cast<float>(static_cast<double>(p[2]) * p[2]);
    return m;
  }
  template <class X, class Y, class Z>
  GRT_HD GRT_INLINE auto fl(const X& xx, const Y& y, const Z& z) const {
    using D = KSDual<X, Y, Z>;
    D r2, r, l1, l2, l3;
    radius(xx, y, z, r2, r, l1, l2, l3);
    const auto f = (rs * r - QQ) * r * r * grt_recip(r2 * r2 + aa * z * z);
    return Rank1<D, D, D, D>{f, l1, l2, l3};
  }
};

}  // namespace grt
