// Flat spacetime in cartesian coordinates: `minkowski` (t, x, y, z) and
// `minkowski_skew` (x, t, y, z).  Constant metrics: no coordinate seeds a
// tangent, every acceleration is zero and the inverse is never formed.
// Term for term `metrics/catalogue_simple.py`.
#pragma once

#include <math.h>

#include "sym.cuh"

namespace grt {

// MetricConfig of cartesian_base with the scheduled step and no singularity
// detection; precision weights (1, 1, 1, 1) of a cartesian chart.
struct FlatBase {
  static constexpr int n_params = 0;
  static constexpr bool adaptive_precision = false;
  static constexpr bool detect_singularities = false;
  static constexpr bool singular = false;
  static constexpr float singular_terminator = 1.0f;
  static constexpr bool has_cylindrical_singularity = false;
  static constexpr float cylindrical_terminator = 0.005f;
  static constexpr bool unconditionally_nonsingular = false;
  GRT_HD static constexpr float weight(int) { return 1.0f; }
  static constexpr double udiv = 1.0;
  static constexpr int n_deps = 0;
  GRT_HD static constexpr int dep(int) { return -1; }
};

struct Minkowski : FlatBase {
  static constexpr const char* name = "minkowski";
  GRT_HD static Minkowski from_params(const float*) { return {}; }
  // cartesian_to_polar: r of the spatial slots 1, 2, 3.
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const {
    return sqrtf(x[1] * x[1] + x[2] * x[2] + x[3] * x[3]);
  }
  template <class X0, class X1, class X2, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const X1&, const X2&, const X3&) const {
    return sym(entry<0, 0>(-1.0f), entry<1, 1>(1.0f), entry<2, 2>(1.0f),
               entry<3, 3>(1.0f));
  }
};

struct MinkowskiSkew : FlatBase {
  static constexpr const char* name = "minkowski_skew";
  GRT_HD static MinkowskiSkew from_params(const float*) { return {}; }
  // cartesian_skew_to_polar: time in slot 1, r of the slots 0, 2, 3.
  GRT_HD GRT_INLINE float polar_r(const float x[4]) const {
    return sqrtf(x[0] * x[0] + x[2] * x[2] + x[3] * x[3]);
  }
  template <class X0, class X1, class X2, class X3>
  GRT_HD GRT_INLINE auto g(const X0&, const X1&, const X2&, const X3&) const {
    return sym(entry<0, 0>(1.0f), entry<1, 1>(-1.0f), entry<2, 2>(1.0f),
               entry<3, 3>(1.0f));
  }
};

}  // namespace grt
