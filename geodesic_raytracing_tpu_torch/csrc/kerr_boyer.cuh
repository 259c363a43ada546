// Kerr in Boyer-Lindquist coordinates (t, r, theta, phi): the metric the
// ray-march kernel is instantiated for.  Term for term the torch metric
// `metrics/catalogue_kerr.py::kerr_boyer_fn` (and the JAX reference's);
// a change there must be made here too.
#pragma once

#include "dual.cuh"

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
struct KerrBoyer {
  float rs;
  float a;
  // MetricConfig of kerr_boyer (polar_base).  The step branches on
  // detect_singularities and static_asserts the rest, which it assumes
  // (the Python side refuses other configs in
  // integrate.check_ported_metric).
  static constexpr bool detect_singularities = true;
  static constexpr bool adaptive_precision = true;
  static constexpr bool singular = false;
  static constexpr bool has_cylindrical_singularity = false;
  static constexpr bool unconditionally_nonsingular = false;
  // Polar chart (to_polar = polar_to_polar) with the at_origin distance:
  // the step reads |r| straight from x[1].
  static constexpr bool polar_at_origin = true;

  template <class R, class Th, class G>
  GRT_HD GRT_INLINE void g(const R& r, const Th& theta, G out[5]) const {
    kerr_boyer_g(r, theta, rs, a, out);
  }
};

}  // namespace grt
