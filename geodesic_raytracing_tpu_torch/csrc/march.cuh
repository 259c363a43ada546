// The per-ray adaptive Verlet march: one integrator step and the loop that
// repeats it, for one ray held in registers.
//
// Term for term the reference's `integrate.make_step_fn` (Verlet, adaptive
// precision, polar coordinates with the at_origin distance) driven as its
// `while` driver drives it: a ray takes trial iterations until it leaves
// ACTIVE or `max_steps` iterations have run.  The CUDA kernel
// (raymarch.cu) calls `march_ray`; the host tests compile this same header
// with g++ and check it against the plain torch march.
//
// The metric is a template parameter M providing `g(r, theta, out[5])` for
// the Kerr Boyer-Lindquist structure: g depends on x[1], x[2] only and its
// nonzero entries are tt, rr, thth, phph and t-phi.  The contraction and the
// inverse below are the reference's sparsity-pruned forms for exactly that
// structure, with the reference's order of operations.
#pragma once

#include <math.h>

#include <cmath>

#include "dual.cuh"
#include "kerr_boyer.cuh"

namespace grt {

enum { ACTIVE = 0, ESCAPED = 1, DEAD = 2 };

// The reference's Features (float32 on the device).
struct Features {
  float universe_size;
  float max_acceleration_change;
  float max_precision_radius;
  float min_step;
  float ambient_precision;
  float subambient_precision;
};

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

GRT_HD GRT_INLINE float grt_rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

// jnp.maximum / jnp.minimum on finite operands.
GRT_HD GRT_INLINE float fmax2(float a, float b) { return a > b ? a : b; }
GRT_HD GRT_INLINE float fmin2(float a, float b) { return a < b ? a : b; }

// Geodesic acceleration a = -g^{-1} S with
// S_n = v^a v^b (d_a g_nb - 1/2 d_n g_ab), partials by one dual pass: r seeds
// tangent 0 and theta tangent 1, each with the other tangent pruned.
// GRT_FULL_TANGENTS widens both seeds to all tangents, which computes every
// structural zero (the unpruned pass; a measurement and test switch).
template <class M>
GRT_HD GRT_INLINE void acceleration(const M& m, const float x[4],
                                    const float v[4], float out[4]) {
#ifdef GRT_FULL_TANGENTS
  const auto r = widen<kAllTangents>(dual_seed<0>(x[1]));
  const auto theta = widen<kAllTangents>(dual_seed<1>(x[2]));
#else
  const auto r = dual_seed<0>(x[1]);
  const auto theta = dual_seed<1>(x[2]);
#endif
  Dual<kAllTangents> g[5];
  m.g(r, theta, g);
  // d_r g (tangent 0) and d_theta g (tangent 1) per entry.
  const float r00 = g[0].d[0], r11 = g[1].d[0], r22 = g[2].d[0],
              r33 = g[3].d[0], r03 = g[4].d[0];
  const float t00 = g[0].d[1], t11 = g[1].d[1], t22 = g[2].d[1],
              t33 = g[3].d[1], t03 = g[4].d[1];

  const float v00 = v[0] * v[0], v01 = v[0] * v[1], v02 = v[0] * v[2],
              v03 = v[0] * v[3], v11 = v[1] * v[1], v12 = v[1] * v[2],
              v13 = v[1] * v[3], v22 = v[2] * v[2], v23 = v[2] * v[3],
              v33 = v[3] * v[3];

  const float S0 = v01 * r00 + v13 * r03 + v02 * t00 + v23 * t03;
  float S1 = v11 * r11 + v12 * t11;
  S1 = S1 - 0.5f * v00 * r00;
  S1 = S1 - 1.0f * v03 * r03;
  S1 = S1 - 0.5f * v11 * r11;
  S1 = S1 - 0.5f * v22 * r22;
  S1 = S1 - 0.5f * v33 * r33;
  float S2 = v12 * r22 + v22 * t22;
  S2 = S2 - 0.5f * v00 * t00;
  S2 = S2 - 1.0f * v03 * t03;
  S2 = S2 - 0.5f * v11 * t11;
  S2 = S2 - 0.5f * v22 * t22;
  S2 = S2 - 0.5f * v33 * t33;
  const float S3 = v01 * r03 + v13 * r33 + v02 * t03 + v23 * t33;

  // Pruned symmetric inverse: the cofactor algebra of the reference with
  // the absent entries (01, 02, 12, 13, 23) dropped.
  const float a = g[0].v, d = g[4].v, e = g[1].v, h = g[2].v, j = g[3].v;
  const float hj = h * j, ej = e * j, eh = e * h;
  const float ci_dh = -(d * h);
  const float bg_de = -(d * e);
  const float C00 = e * hj;
  const float C03 = e * ci_dh;
  const float C11 = a * hj + d * ci_dh;
  const float C22 = a * ej + d * bg_de;
  const float C33 = a * eh;
  const float det = a * C00 + d * C03;
  const float inv_det = 1.0f / det;
  const float G00 = C00 * inv_det, G03 = C03 * inv_det,
              G11 = C11 * inv_det, G22 = C22 * inv_det,
              G33 = C33 * inv_det;

  out[0] = -(G00 * S0 + G03 * S3);
  out[1] = -(G11 * S1);
  out[2] = -(G22 * S2);
  out[3] = -(G03 * S0 + G33 * S3);
}

// cl.cl:3400-3429: error estimate `diff` and ideal step, weights
// (1, 1, 8, 32) of the non-symmetric polar chart, udiv = 32.  The
// division-free forms of the reference: 1e-30 clamp, sqrt(e*S)*rsqrt(diff).
GRT_HD GRT_INLINE void acceleration_to_precision(const float acc[4],
                                                 float err, float* diff,
                                                 float* ideal) {
  const float wa0 = acc[0] * 1.0f, wa1 = acc[1] * 1.0f, wa2 = acc[2] * 8.0f,
              wa3 = acc[3] * 32.0f;
  const float ss = wa0 * wa0 + wa1 * wa1 + wa2 * wa2 + wa3 * wa3;
  const float err_scale =
      sqrtf(fmax2(ss, 1e-30f)) * static_cast<float>(0.01 / 32.0);
  const float floor_ =
      err * static_cast<float>(65536.0 / (100000.0 * 100000.0));
  *diff = fmax2(err_scale * 65536.0f, floor_);
  *ideal = sqrtf(err * 65536.0f) * grt_rsqrt(*diff);
}

// One trial iteration of an ACTIVE ray (the reference's masked step, with
// the mask resolved per ray).
template <class M>
GRT_HD GRT_INLINE void step(const M& m, const Features& f, float f_in_x,
                            Ray& s) {
  static_assert(M::adaptive_precision, "the step is the adaptive controller");
  static_assert(!M::singular, "no singular terminator in the step");
  static_assert(!M::has_cylindrical_singularity,
                "no cylindrical terminator in the step");
  static_assert(!M::unconditionally_nonsingular,
                "the step always runs the blow-up test");
  static_assert(M::polar_at_origin, "the step reads |r| from x[1]");
  const float abs_r = fabsf(s.pos[1]);
  const float new_max = f.max_precision_radius;
  const bool near = abs_r < new_max;
  const float ds = near ? fmin2(s.next_ds, f.ambient_precision)
                        : 0.1f * (abs_r - new_max) + f.ambient_precision;

  // Termination tests on the current position; escape takes precedence.
  if (fabsf(s.pos[1]) >= f.universe_size) {
    s.status = ESCAPED;
    return;
  }
  // |v/rd| > t  <=>  |v| > t*rd  (rd > 0); f_in_x is the launch |v^t|.
  if (fabsf(s.vel[0]) > (1000.0f + f_in_x) * s.rdl &&
      fabsf(s.acc[0]) > 100.0f * s.rdl) {
    s.status = DEAD;
    return;
  }

  // Trial Verlet step (cl.cl:3273-3346).
  float np[4], iv[4], nv[4], na[4];
  for (int i = 0; i < 4; ++i) {
    np[i] = s.pos[i] + s.vel[i] * ds + 0.5f * s.acc[i] * ds * ds;
    iv[i] = s.vel[i] + s.acc[i] * ds;
  }
  acceleration(m, np, iv, na);
  for (int i = 0; i < 4; ++i) nv[i] = s.vel[i] + 0.5f * (s.acc[i] + na[i]) * ds;

  // Finiteness probe: the sum of the 12 trial components, before commit
  // (an overflow of the sum itself also kills).
  const float probe = np[0] + np[1] + np[2] + np[3] + nv[0] + nv[1] + nv[2] +
                      nv[3] + na[0] + na[1] + na[2] + na[3];
  if (!grt_isfinite(probe)) {
    s.status = DEAD;
    return;
  }

  // calculate_ds_error (cl.cl:3431-3456), division-free:
  // clip(ideal, .3ds, 2ds), 1.95*cand < ds, diff > err*1e4*65536.
  const float err = f.max_acceleration_change;
  float diff, ideal;
  acceleration_to_precision(na, err, &diff, &ideal);
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
  for (int i = 0; i < 4; ++i) {
    s.pos[i] = np[i];
    s.vel[i] = nv[i];
    s.acc[i] = na[i];
  }
  s.steps += 1;  // rdl *= K with K = 1 (no reparameterisation)
}

// Trial iterations until the ray leaves ACTIVE or max_steps have run (the
// reference `while` loop's per-ray budget).  Returns their number.
template <class M>
GRT_HD GRT_INLINE int march_ray(const M& m, const Features& f, float f_in_x,
                                int max_steps, Ray& s) {
  int it = 0;
  for (; it < max_steps && s.status == ACTIVE; ++it) step(m, f, f_in_x, s);
  return it;
}

}  // namespace grt
