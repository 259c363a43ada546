// The per-ray geodesic march: one integrator step and the loop that repeats
// it, for one ray held in registers.
//
// Term for term the reference's `integrate.make_step_fn`, every branch of it,
// run as its `while` method runs it: a ray takes trial iterations until it
// leaves ACTIVE or `max_steps` iterations have run.  The CUDA kernel
// (raymarch.cu) calls `march_ray`; the host tests compile this same header
// with g++ and check it against the plain torch march.
//
// The metric is a template parameter M (metrics.cuh): its MetricConfig picks
// the step's branches with `if constexpr` (the adaptive controller or the
// scheduled step, the singular and the cylindrical terminator, the blow-up
// test, the singularity kill), as the trace options do (StepOptions: planar
// mode, the Euler integrator, affine reparameterisation).  Its metric
// function returns typed entries (sym.cuh), so that the Christoffel
// contraction and the cofactor inverse below, written once, drop every term
// of an absent entry or a dead tangent at compile time and keep the
// reference's order of operations for the terms that stay
// (ops/geometry.py::acceleration_batched is the plain form they mirror).
#pragma once

#include <math.h>

#include <cmath>
#include <type_traits>
#include <utility>

#include "metrics.cuh"

namespace grt {

enum { ACTIVE = 0, ESCAPED = 1, DEAD = 2 };

// The reference's Features (float32 on the device), and the two constants of
// the scheduled step that the host derives from them
// (ops/integrate.py::schedule_constants): 1 / (max_precision_radius - 3) and
// subambient_precision - ambient_precision.
struct Features {
  float universe_size;
  float max_acceleration_change;
  float max_precision_radius;
  float min_step;
  float ambient_precision;
  float subambient_precision;
  float sched_inv_span;
  float sched_slope;
};
constexpr int kFeatureFloats = 8;

GRT_HD GRT_INLINE Features features_from(const float* f) {
  return {f[0], f[1], f[2], f[3], f[4], f[5], f[6], f[7]};
}

// The trace options as compile-time facts of a kernel instance.
template <bool PLANAR, bool EULER, bool REPARAM>
struct StepOptions {
  static constexpr bool planar = PLANAR;
  static constexpr bool euler = EULER;
  // The Euler step has K = 1 whatever the option says.
  static constexpr bool reparameterisation = REPARAM && !EULER;
};
using DefaultOptions = StepOptions<false, false, false>;

struct Ray {
  float pos[4];
  float vel[4];
  float acc[4];
  float next_ds;
  float rdl;  // running_dlambda_dnew
  int status;
  int steps;
};

GRT_HD GRT_INLINE bool grt_isfinite(float x) {
#ifdef __CUDA_ARCH__
  return isfinite(x);
#else
  return std::isfinite(x);
#endif
}

// The metric's origin distance (the step schedule's |r|): M::origin_distance
// where the metric defines one (its config's origin_distance is not
// at_origin), else polar[1] of its chart.
template <class M, class = void>
struct HasOriginDistance : std::false_type {};
template <class M>
struct HasOriginDistance<M, std::void_t<decltype(std::declval<const M&>()
                                                     .origin_distance(
                                                         std::declval<
                                                             const float*>()))>>
    : std::true_type {};

template <class M>
GRT_HD GRT_INLINE float origin_distance(const M& m, const float x[4],
                                        float polar_r) {
  if constexpr (HasOriginDistance<M>::value) {
    return m.origin_distance(x);
  } else {
    return polar_r;
  }
}

// A Kerr-Schild metric (g = eta + f l l): M::fl(x, y, z) gives the
// decomposition, and the march takes the rank-1 acceleration.
template <class M, class = void>
struct HasRank1 : std::false_type {};
template <class M>
struct HasRank1<M, std::void_t<decltype(std::declval<const M&>().fl(
                       std::declval<Dual<1u>>(), std::declval<Dual<2u>>(),
                       std::declval<Dual<4u>>()))>> : std::true_type {};

// jnp.maximum / jnp.minimum on finite operands.
GRT_HD GRT_INLINE float fmax2(float a, float b) { return a > b ? a : b; }
GRT_HD GRT_INLINE float fmin2(float a, float b) { return a < b ? a : b; }

// The tangents a coordinate seeds: bit k where it is the k-th coordinate the
// metric depends on; none in planar mode for theta, which is pinned.
template <class M, bool PLANAR, int C>
GRT_HD constexpr unsigned seed_mask() {
  unsigned own = 0u;
  for (int k = 0; k < M::n_deps; ++k)
    if (M::dep(k) == C && !(PLANAR && C == 2)) own |= 1u << k;
  return own;
}

// The tangents a coordinate's dual carries: the ones it seeds.
// GRT_FULL_TANGENTS widens every seeding coordinate to all the seeded
// tangents (the added ones hold 0), which computes every structural zero
// (the unpruned pass; a measurement and test switch).
template <class M, bool PLANAR, int C>
GRT_HD constexpr unsigned carry_mask() {
#ifdef GRT_FULL_TANGENTS
  return seed_mask<M, PLANAR, C>() == 0u
             ? 0u
             : (seed_mask<M, PLANAR, 0>() | seed_mask<M, PLANAR, 1>() |
                seed_mask<M, PLANAR, 2>() | seed_mask<M, PLANAR, 3>());
#else
  return seed_mask<M, PLANAR, C>();
#endif
}

// Coordinate C of an event as the dual the metric function takes.
template <class M, bool PLANAR, int C>
GRT_HD GRT_INLINE Dual<carry_mask<M, PLANAR, C>()> coordinate(float v) {
  return widen<carry_mask<M, PLANAR, C>()>(
      dual_seeded<seed_mask<M, PLANAR, C>()>(v));
}

// The tangent that coordinate C seeds, or -1.
template <class M, int C>
GRT_HD constexpr int tangent_of() {
  for (int k = 0; k < M::n_deps; ++k)
    if (M::dep(k) == C) return k;
  return -1;
}

// v^A v^B, the lower index first (ops/geometry.py's vvp).
template <int A, int B>
GRT_HD GRT_INLINE float vvp(const float v[4]) {
  return v[A < B ? A : B] * v[A < B ? B : A];
}

// First half of S_N: the sum over the tangents k (a = dep(k)) and b of
// v^a v^b d_a g_Nb, in that order.  IDX = 4 k + b.
template <class M, int N, int IDX, class G, class Acc>
GRT_HD GRT_INLINE auto contract_first(const G& g, const float v[4], Acc acc) {
  if constexpr (IDX == 4 * M::n_deps) {
    return acc;
  } else {
    constexpr int k = IDX / 4, b = IDX % 4, a = M::dep(k);
    return contract_first<M, N, IDX + 1>(
        g, v, padd(acc, pmul(vvp<a, b>(v), gtan<k, N, b>(g))));
  }
}

// Second half: minus the sum over a <= b of (1/2 or 1) v^a v^b d_N g_ab,
// where K is the tangent coordinate N seeds.  IDX = 4 a + b.
template <int K, int IDX, class G, class Acc>
GRT_HD GRT_INLINE auto contract_second(const G& g, const float v[4],
                                       Acc acc) {
  if constexpr (IDX == 16) {
    return acc;
  } else if constexpr (IDX / 4 > IDX % 4) {
    return contract_second<K, IDX + 1>(g, v, acc);
  } else {
    constexpr int a = IDX / 4, b = IDX % 4;
    constexpr float half_w = a == b ? 0.5f : 1.0f;
    return contract_second<K, IDX + 1>(
        g, v, psub(acc, pmul(half_w * vvp<a, b>(v), gtan<K, a, b>(g))));
  }
}

// S_N = v^a v^b (d_a g_Nb - 1/2 d_N g_ab): float, or Zero.
template <class M, int N, class G>
GRT_HD GRT_INLINE auto contraction(const G& g, const float v[4]) {
  const auto first = contract_first<M, N, 0>(g, v, Zero{});
  constexpr int K = tangent_of<M, N>();
  if constexpr (K < 0) {
    return first;
  } else {
    return contract_second<K, 0>(g, v, first);
  }
}

// x p - y q + z r with absent factors folded away.
template <class X, class P, class Y, class Q, class Z, class R>
GRT_HD GRT_INLINE auto tri(X x, P p, Y y, Q q, Z z, R r) {
  return padd(psub(pmul(x, p), pmul(y, q)), pmul(z, r));
}

// -(sum_n (C_n / det) S_n): one component of -g^{-1} S from a row of
// cofactors.
template <class C0, class T0, class C1, class T1, class C2, class T2,
          class C3, class T3>
GRT_HD GRT_INLINE float inverse_row(float inv_det, C0 c0, T0 s0, C1 c1, T1 s1,
                                    C2 c2, T2 s2, C3 c3, T3 s3) {
  return to_float(pneg(padd(
      padd(padd(pmul(pmul(c0, inv_det), s0), pmul(pmul(c1, inv_det), s1)),
           pmul(pmul(c2, inv_det), s2)),
      pmul(pmul(c3, inv_det), s3))));
}

// The rank-1 acceleration of a Kerr-Schild metric g = eta + f l l
// (ops/geometry.py::acceleration_batched_rank1, term for term): f and l with
// their partials by x, y, z from one dual pass of M::fl (tangent k is
// coordinate k + 1; l_0 = 1 carries none), the contractions in that
// function's order, then Sherman-Morrison.
template <class M, bool PLANAR>
GRT_HD GRT_INLINE void rank1_acceleration(const M& m, const float x[4],
                                          const float v[4], float out[4]) {
  static_assert(M::n_deps == 3 && M::dep(0) == 1 && M::dep(1) == 2 &&
                    M::dep(2) == 3,
                "a decomposition in the spatial coordinates");
  const auto d = m.fl(coordinate<M, PLANAR, 1>(x[1]),
                      coordinate<M, PLANAR, 2>(x[2]),
                      coordinate<M, PLANAR, 3>(x[3]));
  const float f = d.f.v;
  const float l[4] = {1.0f, d.l1.v, d.l2.v, d.l3.v};
  // df[k] and dl[k][b] (b = 1, 2, 3): the partials by coordinate k + 1.
  float df[3], dl[3][4];
  for (int k = 0; k < 3; ++k) {
    df[k] = d.f.d[k];
    dl[k][0] = 0.0f;
    dl[k][1] = d.l1.d[k];
    dl[k][2] = d.l2.d[k];
    dl[k][3] = d.l3.d[k];
  }
  const float Df = (v[1] * df[0] + v[2] * df[1]) + v[3] * df[2];
  float w[4];
  w[0] = 0.0f;
  for (int b = 1; b < 4; ++b)
    w[b] = (v[1] * dl[0][b] + v[2] * dl[1][b]) + v[3] * dl[2][b];
  const float lv = ((v[0] + l[1] * v[1]) + l[2] * v[2]) + l[3] * v[3];
  const float q = (w[1] * v[1] + w[2] * v[2]) + w[3] * v[3];
  const float flv = f * lv;
  const float half_lv2 = 0.5f * lv * lv;
  const float c = lv * Df + f * q;
  float S[4];
  S[0] = c;
  for (int k = 0; k < 3; ++k) {
    const float vdl = (v[1] * dl[k][1] + v[2] * dl[k][2]) + v[3] * dl[k][3];
    const float term2 = half_lv2 * df[k] + flv * vdl;
    S[k + 1] = (c * l[k + 1] + flv * w[k + 1]) - term2;
  }
  // lt = eta^-1 l = (-1, l1, l2, l3); l.eta.l is 0 but for rounding.
  const float l_eta_l = ((-1.0f + l[1] * l[1]) + l[2] * l[2]) + l[3] * l[3];
  const float scale = f * (1.0f / (1.0f + f * l_eta_l));
  const float k_lts =
      scale * (((-S[0] + l[1] * S[1]) + l[2] * S[2]) + l[3] * S[3]);
  out[0] = S[0] - k_lts;
  for (int a = 1; a < 4; ++a) out[a] = k_lts * l[a] - S[a];
}

// The dense acceleration a = -g^{-1} S: partials by one dual pass of the
// metric function, the inverse by the reference's cofactor algebra
// (ops/geometry.py::_inv44_sym_entries, letter for letter).
template <class M, bool PLANAR>
GRT_HD GRT_INLINE void dense_acceleration(const M& m, const float x[4],
                                          const float v[4], float out[4]) {
  const auto G = m.g(coordinate<M, PLANAR, 0>(x[0]),
                     coordinate<M, PLANAR, 1>(x[1]),
                     coordinate<M, PLANAR, 2>(x[2]),
                     coordinate<M, PLANAR, 3>(x[3]));
  const auto S0 = contraction<M, 0>(G, v);
  const auto S1 = contraction<M, 1>(G, v);
  const auto S2 = contraction<M, 2>(G, v);
  const auto S3 = contraction<M, 3>(G, v);

  const auto a = gval<0, 0>(G);
  const auto b = gval<0, 1>(G);
  const auto c = gval<0, 2>(G);
  const auto d = gval<0, 3>(G);
  const auto e = gval<1, 1>(G);
  const auto f = gval<1, 2>(G);
  const auto g_ = gval<1, 3>(G);
  const auto h = gval<2, 2>(G);
  const auto i = gval<2, 3>(G);
  const auto j = gval<3, 3>(G);

  const auto hj_ii = psub(pmul(h, j), pmul(i, i));
  const auto fj_gi = psub(pmul(f, j), pmul(g_, i));
  const auto fi_gh = psub(pmul(f, i), pmul(g_, h));
  const auto ej_gg = psub(pmul(e, j), pmul(g_, g_));
  const auto ei_gf = psub(pmul(e, i), pmul(g_, f));
  const auto eh_ff = psub(pmul(e, h), pmul(f, f));
  const auto cj_di = psub(pmul(c, j), pmul(d, i));
  const auto ci_dh = psub(pmul(c, i), pmul(d, h));
  const auto cg_df = psub(pmul(c, g_), pmul(d, f));
  const auto bj_dg = psub(pmul(b, j), pmul(d, g_));
  const auto bi_df = psub(pmul(b, i), pmul(d, f));
  const auto bg_de = psub(pmul(b, g_), pmul(d, e));
  const auto bh_cf = psub(pmul(b, h), pmul(c, f));
  const auto bf_ce = psub(pmul(b, f), pmul(c, e));

  const auto C00 = tri(e, hj_ii, f, fj_gi, g_, fi_gh);
  const auto C01 = pneg(tri(b, hj_ii, f, cj_di, g_, ci_dh));
  const auto C02 = tri(b, fj_gi, e, cj_di, g_, cg_df);
  const auto C03 = pneg(tri(b, fi_gh, e, ci_dh, f, cg_df));
  const auto C11 = tri(a, hj_ii, c, cj_di, d, ci_dh);
  const auto C12 = pneg(tri(a, fj_gi, b, cj_di, d, cg_df));
  const auto C13 = tri(a, fi_gh, b, ci_dh, c, cg_df);
  const auto C22 = tri(a, ej_gg, b, bj_dg, d, bg_de);
  const auto C23 = pneg(tri(a, ei_gf, b, bi_df, c, bg_de));
  const auto C33 = tri(a, eh_ff, b, bh_cf, c, bf_ce);

  const auto det = padd(padd(pmul(a, C00), pmul(b, C01)),
                        padd(pmul(c, C02), pmul(d, C03)));
  static_assert(!IsZero<decltype(det)>::value, "a singular metric structure");
  const float inv_det = 1.0f / det;

  out[0] = inverse_row(inv_det, C00, S0, C01, S1, C02, S2, C03, S3);
  out[1] = inverse_row(inv_det, C01, S0, C11, S1, C12, S2, C13, S3);
  out[2] = inverse_row(inv_det, C02, S0, C12, S1, C22, S2, C23, S3);
  out[3] = inverse_row(inv_det, C03, S0, C13, S1, C23, S2, C33, S3);
}

// Geodesic acceleration: the rank-1 path for a Kerr-Schild metric, else the
// dense one.
template <class M, bool PLANAR>
GRT_HD GRT_INLINE void acceleration(const M& m, const float x[4],
                                    const float v[4], float out[4]) {
  if constexpr (HasRank1<M>::value) {
    rank1_acceleration<M, PLANAR>(m, x, v, out);
  } else {
    dense_acceleration<M, PLANAR>(m, x, v, out);
  }
}

// cl.cl:3400-3429: error estimate `diff` and ideal step with the chart's
// precision weights.  The division-free forms of the reference: 1e-30 clamp,
// sqrt(e*S)*rsqrt(diff).
template <class M>
GRT_HD GRT_INLINE void acceleration_to_precision(const float acc[4],
                                                 float err, float* diff,
                                                 float* ideal) {
  const float wa0 = acc[0] * M::weight(0), wa1 = acc[1] * M::weight(1),
              wa2 = acc[2] * M::weight(2), wa3 = acc[3] * M::weight(3);
  const float ss = wa0 * wa0 + wa1 * wa1 + wa2 * wa2 + wa3 * wa3;
  const float err_scale =
      sqrtf(fmax2(ss, 1e-30f)) * static_cast<float>(0.01 / M::udiv);
  const float floor_ =
      err * static_cast<float>(65536.0 / (100000.0 * 100000.0));
  *diff = fmax2(err_scale * 65536.0f, floor_);
  *ideal = sqrtf(err * 65536.0f) * grt_rsqrt(*diff);
}

// One trial iteration of an ACTIVE ray (the reference's masked step, with
// the mask resolved per ray).  The order of the status updates is the
// reference's: escape (the universe sphere or a singular metric's
// terminator) beats dead; then the finiteness probe on the trial state after
// the planar pins; then the adaptive controller's kill.
template <class Opt = DefaultOptions, class M>
GRT_HD GRT_INLINE void step(const M& m, const Features& f, float f_in_x,
                            Ray& s) {
  constexpr bool adaptive = M::adaptive_precision && !Opt::euler;
  // The schedule, the near zone and the far-field step take the origin
  // distance; the universe sphere and the singular terminator take the
  // chart's polar r (integrate.py's step, as the reference's).
  const float polar_r = m.polar_r(s.pos);
  const float abs_r = fabsf(polar_r);
  const float dist = fabsf(origin_distance(m, s.pos, polar_r));
  const float new_max = f.max_precision_radius;
  const bool near = dist < new_max;
  float ds;
  if constexpr (adaptive) {
    ds = s.next_ds;
  } else {
    // The step schedule (cl.cl:4059-4086): linear in the distance between 3
    // and the precision radius.
    const float mixd =
        fmin2(fmax2((dist - 3.0f) * f.sched_inv_span, 0.0f), 1.0f);
    ds = f.ambient_precision + f.sched_slope * mixd;
  }
  ds = near ? fmin2(ds, f.ambient_precision)
            : 0.1f * (dist - new_max) + f.ambient_precision;

  // Termination tests on the current position; escape takes precedence.
  bool escaped = abs_r >= f.universe_size;
  if constexpr (M::singular) escaped = escaped || abs_r < M::singular_terminator;
  if (escaped) {
    s.status = ESCAPED;
    return;
  }
  bool dead = false;
  if constexpr (M::has_cylindrical_singularity)
    dead = s.pos[1] < M::cylindrical_terminator;
  if constexpr (!M::unconditionally_nonsingular) {
    // |v/rd| > t  <=>  |v| > t*rd  (rd > 0); f_in_x is the launch |v^t|.
    dead = dead || (fabsf(s.vel[0]) > (1000.0f + f_in_x) * s.rdl &&
                    fabsf(s.acc[0]) > 100.0f * s.rdl);
  }
  if (dead) {
    s.status = DEAD;
    return;
  }

  float np[4], nv[4], na[4];
  float K = 1.0f;
  if constexpr (Opt::euler) {
    // step_euler (cl.cl:3352-3377): acceleration at the current event, then
    // a semi-implicit update.
    acceleration<M, Opt::planar>(m, s.pos, s.vel, na);
    for (int i = 0; i < 4; ++i) {
      nv[i] = s.vel[i] + na[i] * ds;
      np[i] = s.pos[i] + nv[i] * ds;
    }
  } else {
    // Trial Verlet step (cl.cl:3273-3346).
    float iv[4];
    for (int i = 0; i < 4; ++i) {
      np[i] = s.pos[i] + s.vel[i] * ds + 0.5f * s.acc[i] * ds * ds;
      iv[i] = s.vel[i] + s.acc[i] * ds;
    }
    acceleration<M, Opt::planar>(m, np, iv, na);
    for (int i = 0; i < 4; ++i)
      nv[i] = s.vel[i] + 0.5f * (s.acc[i] + na[i]) * ds;
    if constexpr (Opt::reparameterisation) {
      // Affine reparameterisation: K = 1 / max |v'|.
      K = 1.0f / fmax2(fmax2(fabsf(nv[0]), fabsf(nv[1])),
                       fmax2(fabsf(nv[2]), fabsf(nv[3])));
      const float KK = K * K;
      for (int i = 0; i < 4; ++i) {
        nv[i] = nv[i] * K;
        na[i] = na[i] * KK;
      }
    }
  }
  if constexpr (Opt::planar) {
    // IS_CONSTANT_THETA pins (cl.cl:3990-3995): theta is the float pi/2.
    np[2] = static_cast<float>(M_PI / 2);
    nv[2] = 0.0f;
    na[2] = 0.0f;
  }

  // Finiteness probe: the sum of the 12 trial components, before commit
  // (an overflow of the sum itself also kills).
  const float probe = np[0] + np[1] + np[2] + np[3] + nv[0] + nv[1] + nv[2] +
                      nv[3] + na[0] + na[1] + na[2] + na[3];
  if (!grt_isfinite(probe)) {
    s.status = DEAD;
    return;
  }

  if constexpr (adaptive) {
    // calculate_ds_error (cl.cl:3431-3456), division-free:
    // clip(ideal, .3ds, 2ds), 1.95*cand < ds, diff > err*1e4*65536.
    const float err = f.max_acceleration_change;
    float diff, ideal;
    acceleration_to_precision<M>(na, err, &diff, &ideal);
    float cand = 0.99f * fmin2(fmax2(ideal, 0.3f * ds), 2.0f * ds);
    cand = fmax2(cand, f.min_step);
    bool skip = 1.95f * cand < ds;
    bool kill = M::detect_singularities && cand <= f.min_step &&
                diff > err * (10000.0f * 65536.0f);
    // Error control applies only in the near zone.
    skip = skip && near;
    kill = kill && near;
    s.next_ds = cand;
    if (kill) {
      s.status = DEAD;
      return;
    }
    if (skip) return;
  }
  for (int i = 0; i < 4; ++i) {
    s.pos[i] = np[i];
    s.vel[i] = nv[i];
    s.acc[i] = na[i];
  }
  if constexpr (Opt::reparameterisation) s.rdl = s.rdl * K;
  s.steps += 1;
}

// Trial iterations until the ray leaves ACTIVE or max_steps have run (the
// reference `while` loop's per-ray budget).  Returns their number.
template <class Opt = DefaultOptions, class M>
GRT_HD GRT_INLINE int march_ray(const M& m, const Features& f, float f_in_x,
                                int max_steps, Ray& s) {
  int it = 0;
  for (; it < max_steps && s.status == ACTIVE; ++it)
    step<Opt>(m, f, f_in_x, s);
  return it;
}

}  // namespace grt
