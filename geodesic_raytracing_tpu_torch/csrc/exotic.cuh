// Metrics of the exotic catalogue: `misner_4d` (coordinates (T, phi, y, z),
// g_TT = 0, g depends on T alone), `cosmic_string_spinning` and
// `godel_cylindrical` (cylindrical (t, p, phi, z), g depends on p alone;
// Godel's chart ends at the axis, the cylindrical terminator).  Term for term the torch metrics of
// `metrics/catalogue_exotic.py`; a change there must be made here too.  Each
// chart's polar r is computed in float from the plain coordinates, as the
// torch step takes it from the chart's to_polar.
#pragma once

#include <math.h>

#include "sym.cuh"

namespace grt {

// MetricConfig fields that every metric here shares with polar_base.
struct ExoticBase {
  static constexpr bool adaptive_precision = true;
  static constexpr bool singular = false;
  static constexpr float singular_terminator = 1.0f;
  static constexpr bool has_cylindrical_singularity = false;
  static constexpr float cylindrical_terminator = 0.005f;
  static constexpr bool unconditionally_nonsingular = false;
  static constexpr int n_deps = 1;
};

// Misner space extended to 4-D (arXiv:1102.0907 eq. 25): g_Tphi = -1,
// g_phiphi = -T, g_yy = g_zz = 1.  Chart OTHER: precision weights of ones.
// The parameter phi0 is declared by the reference and used by nothing.
struct Misner4D : ExoticBase {
  float phi0;
  static constexpr const char* name = "misner_4d";
  static constexpr int n_params = 1;  // phi0
  static constexpr bool detect_singularities = true;
  GRT_HD static constexpr float weight(int) { return 1.0f; }
  static constexpr double udiv = 1.0;
  GRT_HD static constexpr int dep(int) { return 0; }
  GRT_HD static Misner4D from_params(const float* p) {
    Misner4D m;
    m.phi0 = p[0];
    return m;
  }
  // misner_4d_to_polar's r: the cartesian x = T e^(phi/2) + e^(-phi/2).
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const {
    const float xx = x[0] * expf(x[1] * 0.5f) + expf(-x[1] * 0.5f);
    return sqrtf(xx * xx + x[2] * x[2] + x[3] * x[3]);
  }
  template <class T, class X1, class X2, class X3>
  GRT_HD GRT_INLINE auto g(const T& t, const X1&, const X2&,
                           const X3&) const {
    return sym(entry<0, 1>(-1.0f), entry<1, 1>(-t), entry<2, 2>(1.0f),
               entry<3, 3>(1.0f));
  }
};

// A spinning cosmic string: g_tt = -1, g_pp = g_zz = 1,
// g_phiphi = a^2 + k^2 p^2 and the reference's g_tp = a.  Cylindrical chart:
// precision weights (1, 1, 8, 1).
struct CosmicStringSpinning : ExoticBase {
  float a;
  float k;
  static constexpr const char* name = "cosmic_string_spinning";
  static constexpr int n_params = 2;  // a, k
  static constexpr bool detect_singularities = false;
  GRT_HD static constexpr float weight(int i) { return i == 2 ? 8.0f : 1.0f; }
  static constexpr double udiv = 8.0;
  GRT_HD static constexpr int dep(int) { return 1; }
  GRT_HD static CosmicStringSpinning from_params(const float* p) {
    return {{}, p[0], p[1]};
  }
  // cylindrical_to_polar's r: sqrt(p^2 + z^2).
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const {
    return sqrtf(x[1] * x[1] + x[3] * x[3]);
  }
  template <class X0, class P, class X2, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const P& p, const X2&,
                           const X3&) const {
    return sym(entry<0, 0>(-1.0f), entry<1, 1>(1.0f),
               entry<2, 2>(a * a + k * k * p * p), entry<3, 3>(1.0f),
               entry<0, 1>(a));
  }
};

// Godel's rotating universe: g_tt = -1, g_pp = 1 / (1 + q^2),
// g_phiphi = p^2 (1 - q^2), g_zz = 1, g_tphi = -p^2 / (sqrt(2) a), with
// q = p / (2a).  A ray that reaches p < 0.005 dies (the cylindrical
// terminator).
struct GodelCylindrical : ExoticBase {
  float inv_2a;        // 1 / (2 a)
  float inv_sqrt2_a;   // 1 / (sqrt(2) a)
  static constexpr const char* name = "godel_cylindrical";
  static constexpr int n_params = 1;  // a
  static constexpr bool detect_singularities = true;
  static constexpr bool has_cylindrical_singularity = true;
  GRT_HD static constexpr float weight(int i) { return i == 2 ? 8.0f : 1.0f; }
  static constexpr double udiv = 8.0;
  GRT_HD static constexpr int dep(int) { return 1; }
  GRT_HD static GodelCylindrical from_params(const float* p) {
    GodelCylindrical m;
    m.inv_2a = static_cast<float>(1.0 / (2.0 * static_cast<double>(p[0])));
    m.inv_sqrt2_a =
        static_cast<float>(1.0 / (sqrt(2.0) * static_cast<double>(p[0])));
    return m;
  }
  // cylindrical_to_polar's r: sqrt(p^2 + z^2).
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const {
    return sqrtf(x[1] * x[1] + x[3] * x[3]);
  }
  template <class X0, class P, class X2, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const P& p, const X2&,
                           const X3&) const {
    const auto q = p * inv_2a;
    const auto q2 = q * q;
    const auto dt_dphi = -2.0f * p * p * inv_sqrt2_a;
    return sym(entry<0, 0>(-1.0f), entry<1, 1>(grt_recip(1.0f + q2)),
               entry<2, 2>(p * p * (1.0f - q2)), entry<3, 3>(1.0f),
               entry<0, 2>(0.5f * dt_dphi));
  }
};

}  // namespace grt
