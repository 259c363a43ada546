// Kerr in Boyer-Lindquist coordinates (t, r, theta, phi): the metric the
// ray-march kernel is instantiated for.  Term for term the torch metric
// `metrics/catalogue_kerr.py::kerr_boyer_fn` (and the JAX reference's);
// a change there must be made here too.
#pragma once

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
struct KerrBoyer {
  float rs;
  float a;
  static constexpr const char* name = "kerr_boyer";
  static constexpr int n_params = 2;  // rs, a
  GRT_HD static KerrBoyer from_params(const float* p) { return {p[0], p[1]}; }

  // MetricConfig of kerr_boyer (polar_base).
  static constexpr bool adaptive_precision = true;
  static constexpr bool detect_singularities = true;
  static constexpr bool singular = false;
  static constexpr float singular_terminator = 1.0f;
  static constexpr bool has_cylindrical_singularity = false;
  static constexpr float cylindrical_terminator = 0.005f;
  static constexpr bool unconditionally_nonsingular = false;
  // Precision weights of a polar chart that is not spherically symmetric.
  GRT_HD static constexpr float weight(int i) {
    return i == 2 ? 8.0f : i == 3 ? 32.0f : 1.0f;
  }
  static constexpr double udiv = 32.0;
  // g depends on x[1] (tangent 0) and x[2] (tangent 1).
  static constexpr int n_deps = 2;
  GRT_HD static constexpr int dep(int k) { return k == 0 ? 1 : 2; }
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

}  // namespace grt
