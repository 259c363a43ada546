// Catalogue slice B's warp metrics: `alcubierre` (cartesian, g depends on
// all four coordinates, the origin distance is the distance to the moving
// bubble), `krasnikov_tube` (cartesian, all four coordinates),
// `krasnikov_cylindrical` ((t, p, phi, x), three coordinates, the reference
// script's literals) and `symmetric_warp_drive` (polar, g depends on t and
// r, theta pinned to pi/2).  Term for term the torch metrics of
// `metrics/catalogue_exotic.py` and `metrics/catalogue_simple.py`; a change
// there must be made here too.  A parameter-only expression is evaluated in
// double in `from_params` and rounded once, as Python evaluates it.
#pragma once

#include <math.h>

#include "schwarzschild.cuh"
#include "sym.cuh"

namespace grt {

// MetricConfig of cartesian_base with the adaptive step and no singularity
// detection; precision weights (1, 1, 1, 1); g depends on all four
// coordinates, tangent k on coordinate k.
struct CartesianWarpBase {
  static constexpr bool adaptive_precision = true;
  static constexpr bool detect_singularities = false;
  static constexpr bool singular = false;
  static constexpr float singular_terminator = 1.0f;
  static constexpr bool has_cylindrical_singularity = false;
  static constexpr float cylindrical_terminator = 0.005f;
  static constexpr bool unconditionally_nonsingular = false;
  GRT_HD static constexpr float weight(int) { return 1.0f; }
  static constexpr double udiv = 1.0;
  static constexpr int n_deps = 4;
  GRT_HD static constexpr int dep(int k) { return k; }
  // cartesian_to_polar's r.
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const {
    return sqrtf(x[1] * x[1] + x[2] * x[2] + x[3] * x[3]);
  }
};

// Alcubierre's warp drive: a bubble of radius R and wall sharpness sigma
// moving along x at `velocity`; g_tt = v^2 f^2 - 1, g_tx = -v f, the rest
// of the identity.  No blow-up test (unconditionally_nonsingular).
struct Alcubierre : CartesianWarpBase {
  float velocity;
  float sigma;
  float R;
  float vv;         // velocity^2
  float m2v;        // -2 velocity
  float inv_2tanh;  // 1 / (2 tanh(sigma R))
  static constexpr const char* name = "alcubierre";
  static constexpr int n_params = 3;  // velocity, sigma, R
  static constexpr bool unconditionally_nonsingular = true;
  GRT_HD static Alcubierre from_params(const float* p) {
    Alcubierre m;
    m.velocity = p[0];
    m.sigma = p[1];
    m.R = p[2];
    const double v = p[0], sigma = p[1], R = p[2];
    m.vv = static_cast<float>(v * v);
    m.m2v = static_cast<float>(-2.0 * v);
    m.inv_2tanh = static_cast<float>(1.0 / (2.0 * tanh(sigma * R)));
    return m;
  }
  // alcubierre_origin of the cartesian chart's polar event: the chart's
  // to_polar (the polynomial arctan2 for theta and phi), then the bubble's
  // distance from r sin(theta) cos(phi), r sin(theta) sin(phi), r cos(theta)
  // (metrics/base.py::alcubierre_origin).
  GRT_HD GRT_INLINE float origin_distance(const float x[4]) const {
    const float r = polar_r(x);
    const float theta =
        grt_arctan2(sqrtf(x[1] * x[1] + x[2] * x[2]), x[3]);
    const float phi = grt_arctan2(x[2], x[1]);
    float st, ct, sp, cp;
    grt_sincos(theta, st, ct);
    grt_sincos(phi, sp, cp);
    const float cx = r * st * cp;
    const float cy = r * st * sp;
    const float cz = r * ct;
    const float x_pos = cx - velocity * x[0];
    return sqrtf(x_pos * x_pos + cy * cy + cz * cz);
  }
  template <class T, class X, class Y, class Z>
  GRT_HD GRT_INLINE auto g(const T& t, const X& xx, const Y& y,
                           const Z& z) const {
    const auto dx = xx - velocity * t;
    const auto rs_t = grt_sqrt(dx * dx + y * y + z * z);
    const auto f = (grt_tanh(sigma * (rs_t + R)) -
                    grt_tanh(sigma * (rs_t - R))) * inv_2tanh;
    return sym(entry<0, 0>(vv * f * f - 1.0f), entry<0, 1>(0.5f * (m2v * f)),
               entry<1, 1>(1.0f), entry<2, 2>(1.0f), entry<3, 3>(1.0f));
  }
};

// The Krasnikov tubes' step theta_e(v) = (tanh(2 (2 v / e - 1)) + 1) / 2
// and g_xx = k = 1 - (2 - d) theta_e(pmax - p) theta_e(t - x - p)
// (theta_e(x) - theta_e(x + e - D)).
struct KrasnikovShape {
  float e;
  float D;
  float pmax;
  float two_minus_d;  // 2 - littled
  float inv_e;        // 1 / e
  template <class V>
  GRT_HD GRT_INLINE auto thetae(const V& v) const {
    return 0.5f * (grt_tanh(2.0f * (2.0f * v * inv_e - 1.0f)) + 1.0f);
  }
  template <class T, class X, class P>
  GRT_HD GRT_INLINE auto k(const T& t, const X& xx, const P& p) const {
    return 1.0f - two_minus_d * thetae(pmax - p) * thetae(t - xx - p) *
                      (thetae(xx) - thetae(xx + e - D));
  }
  GRT_HD static KrasnikovShape make(double e, double D, double pmax,
                                    double littled) {
    return {static_cast<float>(e), static_cast<float>(D),
            static_cast<float>(pmax), static_cast<float>(2.0 - littled),
            static_cast<float>(1.0 / e)};
  }
};

// The cartesian tube along x: g_tx = (1 - k) / 2, g_xx = k, p^2 = y^2 + z^2.
struct KrasnikovTube : CartesianWarpBase {
  KrasnikovShape shape;
  static constexpr const char* name = "krasnikov_tube";
  static constexpr int n_params = 4;  // e, D, pmax, littled
  GRT_HD static KrasnikovTube from_params(const float* p) {
    return {{}, KrasnikovShape::make(p[0], p[1], p[2], p[3])};
  }
  template <class T, class X, class Y, class Z>
  GRT_HD GRT_INLINE auto g(const T& t, const X& xx, const Y& y,
                           const Z& z) const {
    const auto p = grt_sqrt(y * y + z * z);
    const auto k = shape.k(t, xx, p);
    return sym(entry<0, 0>(-1.0f), entry<0, 1>(0.5f * (1.0f - k)),
               entry<1, 1>(k), entry<2, 2>(1.0f), entry<3, 3>(1.0f));
  }
};

// The cylindrical tube (t, p, phi, x): g_pp = 1, g_phiphi = p^2, g_xx = k,
// g_tx = (1 - k) / 2, with the reference script's literals e = 0.1, D = 2,
// pmax = 1, littled = 0.01 (its parameters are declared and unused).  Chart
// OTHER (precision weights of ones) with cylindrical_to_polar.
struct KrasnikovCylindrical : CartesianWarpBase {
  static constexpr const char* name = "krasnikov_cylindrical";
  static constexpr int n_params = 3;  // e, D, pmax (unused)
  static constexpr int n_deps = 3;
  GRT_HD static constexpr int dep(int k) { return k == 2 ? 3 : k; }
  GRT_HD static KrasnikovCylindrical from_params(const float*) { return {}; }
  // cylindrical_to_polar's r: sqrt(p^2 + z^2), the tube's axis z = x[3].
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const {
    return sqrtf(x[1] * x[1] + x[3] * x[3]);
  }
  template <class T, class P, class X2, class X>
  GRT_HD GRT_INLINE auto g(const T& t, const P& p, const X2&,
                           const X& xx) const {
    const KrasnikovShape shape = KrasnikovShape::make(0.1, 2.0, 1.0, 0.01);
    const auto k = shape.k(t, xx, p);
    return sym(entry<0, 0>(-1.0f), entry<1, 1>(1.0f), entry<2, 2>(p * p),
               entry<3, 3>(k), entry<0, 3>(0.5f * (1.0f - k)));
  }
};

// The symmetric warp drive (t, r, theta, phi) with theta pinned to pi/2 by
// the script (so sin(theta) is Python's 1.0): a2 = 1 - 1/r + t / theta,
// U = (a a2^1.5 - b) / (a a0^3 - b) with a0 = sqrt(1 - 1/r),
// a = theta / a0, b = theta - sqrt(r^4 / (1 - 1/r));
// diag(-a2, U / (1 - 1/r), U r^2, U r^2).  g depends on t (tangent 0) and r
// (tangent 1); rays that reach |r| < 1.001 escape (the singular terminator).
struct SymmetricWarpDrive : PolarBase, PolarWeights {
  static constexpr const char* name = "symmetric_warp_drive";
  static constexpr int n_params = 0;
  static constexpr bool singular = true;
  static constexpr float singular_terminator = 1.001f;
  GRT_HD static constexpr int dep(int k) { return k == 0 ? 0 : 1; }
  GRT_HD static SymmetricWarpDrive from_params(const float*) { return {}; }
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const { return x[1]; }
  template <class T, class R, class X2, class X3>
  GRT_HD GRT_INLINE auto g(const T& t, const R& r, const X2&,
                           const X3&) const {
    constexpr double theta = M_PI / 2;
    constexpr float inv_theta = static_cast<float>(1.0 / theta);
    constexpr float rk_theta = static_cast<float>(1.0 * theta);
    constexpr float st = 1.0f;  // math.sin(math.pi / 2)
    constexpr PowRule pow4 = pow_rule(4.0);
    constexpr PowRule pow15 = pow_rule(1.5);
    const auto a20 = 1.0f - 1.0f * grt_recip(r);
    const auto a0 = grt_sqrt(a20);
    const auto a2 = a20 + t * inv_theta;
    const auto yrr0 = grt_recip(1.0f - 1.0f * grt_recip(r));
    const auto gamma0 =
        grt_pow(r, pow4) * st * st * grt_recip(1.0f - 1.0f * grt_recip(r));
    const auto la = rk_theta * grt_recip(a0);
    const auto lb = rk_theta - grt_sqrt(gamma0);
    const auto U = (la * grt_pow(a2, pow15) - lb) *
                   grt_recip(la * a0 * a0 * a0 - lb);
    return sym(entry<0, 0>(-a2), entry<1, 1>(U * yrr0), entry<2, 2>(U * r * r),
               entry<3, 3>(U * r * r * st * st));
  }
};

}  // namespace grt
