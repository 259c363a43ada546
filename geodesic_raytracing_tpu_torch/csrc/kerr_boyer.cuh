// Kerr in Boyer-Lindquist coordinates (t, r, theta, phi): the metric the
// ray-march kernel is instantiated for.  Term for term the torch metric
// `metrics/catalogue_kerr.py::kerr_boyer_fn` (and the JAX reference's);
// a change there must be made here too.
#pragma once

#include "dual.cuh"

namespace grt {

// The five structurally nonzero entries, in the order
// g[0] = g_tt, g[1] = g_rr, g[2] = g_thth, g[3] = g_phph, g[4] = g_tph.
// T is float, or Dual<K> for the partials (g depends on x[1] and x[2]).
template <class T>
GRT_HD GRT_INLINE void kerr_boyer_g(const T x[4], float rs, float a, T g[5]) {
  const T& r = x[1];
  const T& theta = x[2];
  const T ct = grt_cos(theta);
  const T st = grt_sin(theta);
  const T st2 = st * st;
  const T E = r * r + a * a * ct * ct;
  const T D = r * r - rs * r + a * a;
  const T invE = grt_recip(E);
  const T rsr_invE = rs * r * invE;
  g[0] = -(1.0f - rsr_invE);
  g[1] = E * grt_recip(D);
  g[2] = E;
  g[3] = (r * r + a * a + rsr_invE * a * a * st2) * st2;
  g[4] = -rsr_invE * a * st2;
}

// Metric parameters travel as kernel arguments, so a new value of rs or a
// does not rebuild the kernel.
struct KerrBoyer {
  float rs;
  float a;
  // MetricConfig of kerr_boyer (polar_base).  The step branches on
  // detect_singularities; march_ray static_asserts the rest, which the
  // step assumes (the Python side refuses other configs in
  // integrate.check_ported_metric).
  static constexpr bool detect_singularities = true;
  static constexpr bool adaptive_precision = true;
  static constexpr bool singular = false;
  static constexpr bool has_cylindrical_singularity = false;
  static constexpr bool unconditionally_nonsingular = false;
  // Polar chart (to_polar = polar_to_polar) with the at_origin distance:
  // the step reads |r| straight from x[1].
  static constexpr bool polar_at_origin = true;

  template <class T>
  GRT_HD GRT_INLINE void g(const T x[4], T out[5]) const {
    kerr_boyer_g(x, rs, a, out);
  }
};

}  // namespace grt
