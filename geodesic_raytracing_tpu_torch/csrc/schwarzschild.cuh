// The diagonal polar metrics (and Schwarzschild in ingoing EF): `schwarzschild`,
// `schwarzschild_fast` (the same metric with the scheduled step and a
// singular terminator), `schwarzschild_skewed` (coordinates
// (r, t, theta, phi), rs = 1), `schwarzschild_ingoing_ef` (ingoing
// Eddington-Finkelstein), `de_sitter`, `wormhole (morris-thorne)`,
// `black_hole_cosmic_string` and `ernst`.  Term for term the torch metrics
// of `metrics/catalogue_simple.py`; a change there must be made here too.
#pragma once

#include "sym.cuh"

namespace grt {

// MetricConfig defaults of polar_base; a struct overrides what differs.
struct PolarBase {
  static constexpr bool adaptive_precision = true;
  static constexpr bool detect_singularities = true;
  static constexpr bool singular = false;
  static constexpr float singular_terminator = 1.0f;
  static constexpr bool has_cylindrical_singularity = false;
  static constexpr float cylindrical_terminator = 0.005f;
  static constexpr bool unconditionally_nonsingular = false;
  // g depends on x[1] (tangent 0) and x[2] (tangent 1).
  static constexpr int n_deps = 2;
  GRT_HD static constexpr int dep(int k) { return k == 0 ? 1 : 2; }
};

// Precision weights (1, 1, 8, 8) of a spherically symmetric polar chart.
struct SymmetricWeights {
  GRT_HD static constexpr float weight(int i) { return i >= 2 ? 8.0f : 1.0f; }
  static constexpr double udiv = 8.0;
};

// diag(-(1 - rs/r), 1/(1 - rs/r), r^2, r^2 sin^2 theta), the time entry at
// slot T and the radial one at slot R (0, 1 or 1, 0).
template <int T, int R, class Rd, class Th>
GRT_HD GRT_INLINE auto schwarzschild_g(const Rd& r, const Th& theta,
                                       float rs) {
  const auto st = grt_sin(theta);
  return sym(entry<T, T>(-(1.0f - rs * grt_recip(r))),
             entry<R, R>(grt_recip(1.0f - rs * grt_recip(r))),
             entry<2, 2>(r * r), entry<3, 3>(r * r * st * st));
}

struct Schwarzschild : PolarBase, SymmetricWeights {
  float rs;
  static constexpr const char* name = "schwarzschild";
  static constexpr int n_params = 1;
  GRT_HD static Schwarzschild from_params(const float* p) {
    Schwarzschild m;
    m.rs = p[0];
    return m;
  }
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }
  template <class X0, class R, class Th, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const R& r, const Th& theta,
                           const X3&) const {
    return schwarzschild_g<0, 1>(r, theta, rs);
  }
};

// The scheduled step, and rays that reach |r| < 1.05 escape (to be shaded
// black by the |r| <= 1 test of the render data, or not).
struct SchwarzschildFast : Schwarzschild {
  static constexpr const char* name = "schwarzschild_fast";
  static constexpr bool adaptive_precision = false;
  static constexpr bool detect_singularities = false;
  static constexpr bool singular = true;
  static constexpr float singular_terminator = 1.05f;
  GRT_HD static SchwarzschildFast from_params(const float* p) {
    SchwarzschildFast m;
    m.rs = p[0];
    return m;
  }
};

// Coordinates (r, t, theta, phi): g depends on x[0] (tangent 0) and x[2]
// (tangent 1); not flagged spherically symmetric, so weights (1, 1, 8, 32).
struct SchwarzschildSkewed : PolarBase {
  static constexpr const char* name = "schwarzschild_skewed";
  static constexpr int n_params = 0;
  GRT_HD static SchwarzschildSkewed from_params(const float*) { return {}; }
  GRT_HD static constexpr float weight(int i) {
    return i == 2 ? 8.0f : i == 3 ? 32.0f : 1.0f;
  }
  static constexpr double udiv = 32.0;
  GRT_HD static constexpr int dep(int k) { return k == 0 ? 0 : 2; }
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[0]; }
  template <class R, class X1, class Th, class X3>
  GRT_HD GRT_INLINE auto g(const R& r, const X1&, const Th& theta,
                           const X3&) const {
    const auto st = grt_sin(theta);
    return sym(entry<0, 0>(grt_recip(1.0f - grt_recip(r))),
               entry<1, 1>(-(1.0f - grt_recip(r))), entry<2, 2>(r * r),
               entry<3, 3>(r * r * st * st));
  }
};

// Ingoing Eddington-Finkelstein (v, r, theta, phi): g_vr = 1, no g_rr.
struct SchwarzschildIngoingEF : PolarBase, SymmetricWeights {
  float rs;
  static constexpr const char* name = "schwarzschild_ingoing_ef";
  static constexpr int n_params = 1;
  GRT_HD static SchwarzschildIngoingEF from_params(const float* p) {
    SchwarzschildIngoingEF m;
    m.rs = p[0];
    return m;
  }
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }
  template <class X0, class R, class Th, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const R& r, const Th& theta,
                           const X3&) const {
    const auto st = grt_sin(theta);
    return sym(entry<0, 0>(-(1.0f - rs * grt_recip(r))), entry<0, 1>(1.0f),
               entry<2, 2>(r * r), entry<3, 3>(r * r * st * st));
  }
};

// diag(-f, 1/f, r^2, r^2 sin^2 theta) with f = 1 - Lambda r^2 / 3.
struct DeSitter : PolarBase, SymmetricWeights {
  float cosmological_constant;
  static constexpr const char* name = "de_sitter";
  static constexpr int n_params = 1;
  static constexpr bool adaptive_precision = false;
  static constexpr bool detect_singularities = false;
  GRT_HD static DeSitter from_params(const float* p) {
    DeSitter m;
    m.cosmological_constant = p[0];
    return m;
  }
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }
  template <class X0, class R, class Th, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const R& r, const Th& theta,
                           const X3&) const {
    const auto st = grt_sin(theta);
    const auto f =
        1.0f - cosmological_constant * r * r * static_cast<float>(1.0 / 3.0);
    return sym(entry<0, 0>(-f), entry<1, 1>(grt_recip(f)), entry<2, 2>(r * r),
               entry<3, 3>(r * r * st * st));
  }
};

// Precision weights (1, 1, 8, 32) of a polar chart that is not flagged
// spherically symmetric.
struct PolarWeights {
  GRT_HD static constexpr float weight(int i) {
    return i == 2 ? 8.0f : i == 3 ? 32.0f : 1.0f;
  }
  static constexpr double udiv = 32.0;
};

// Morris-Thorne: diag(-1, 1, b, b sin^2 theta) with b = p^2 + n^2; p runs
// through the throat (negative on the far side).  The scheduled step.
struct Wormhole : PolarBase, SymmetricWeights {
  float n;
  static constexpr const char* name = "wormhole (morris-thorne)";
  static constexpr int n_params = 1;
  static constexpr bool adaptive_precision = false;
  static constexpr bool detect_singularities = false;
  GRT_HD static Wormhole from_params(const float* p) {
    Wormhole m;
    m.n = p[0];
    return m;
  }
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }
  template <class X0, class P, class Th, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const P& p, const Th& theta,
                           const X3&) const {
    const auto st = grt_sin(theta);
    const auto b = p * p + n * n;
    return sym(entry<0, 0>(-1.0f), entry<1, 1>(1.0f), entry<2, 2>(b),
               entry<3, 3>(b * st * st));
  }
};

// Schwarzschild with a conical deficit B in g_phph; not flagged spherically
// symmetric.
struct BlackHoleCosmicString : PolarBase, PolarWeights {
  float rs;
  float B;
  static constexpr const char* name = "black_hole_cosmic_string";
  static constexpr int n_params = 2;  // rs, B
  GRT_HD static BlackHoleCosmicString from_params(const float* p) {
    return {{}, {}, p[0], p[1]};
  }
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }
  template <class X0, class R, class Th, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const R& r, const Th& theta,
                           const X3&) const {
    const auto st = grt_sin(theta);
    return sym(entry<0, 0>(-(1.0f - rs * grt_recip(r))),
               entry<1, 1>(grt_recip(1.0f - rs * grt_recip(r))),
               entry<2, 2>(r * r), entry<3, 3>(r * r * B * B * st * st));
  }
};

// Ernst: a black hole in a magnetic field B, lambda = 1 + B^2 r^2 sin^2 theta.
struct Ernst : PolarBase, PolarWeights {
  float B;
  float rs;
  static constexpr const char* name = "ernst";
  static constexpr int n_params = 2;  // B, rs
  GRT_HD static Ernst from_params(const float* p) {
    return {{}, {}, p[0], p[1]};
  }
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }
  template <class X0, class R, class Th, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const R& r, const Th& theta,
                           const X3&) const {
    const auto st = grt_sin(theta);
    const auto lam = 1.0f + B * B * r * r * st * st;
    const auto lam2 = lam * lam;
    const auto f = 1.0f - rs * grt_recip(r);
    return sym(entry<0, 0>(-lam2 * f), entry<1, 1>(lam2 * grt_recip(f)),
               entry<2, 2>(lam2 * r * r),
               entry<3, 3>(r * r * st * st * grt_recip(lam2)));
  }
};

}  // namespace grt
