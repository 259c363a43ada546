// The launch state of one ray: what `init_rays_generic` (cl.cl:3143-3251)
// hands the march, computed in registers.
//
// Term for term `render/pipeline.py::rays_for_pixels_reference` (with
// `camera.py::directions_for_pixels`, `ops/planar.py::to_planar` of an
// identity chart and `ops/integrate.py::init_ray_state`), in the eager order
// of its float32 operations: the pixel's camera-space direction rotated by
// the camera quaternion, the velocity from the observer tetrad, in planar
// mode the rotation of the ray into the equator (its inverse quaternion is
// kept for render data) with theta pinned to pi/2 and v^theta to 0, the null
// fix of v^t (`geometry.fix_null_batched`, root choice and guards included),
// the launch acceleration, the seed of the adaptive step, the planar pins of
// v^theta and a^theta, and ku_uobsu, the ray's energy in the observer's
// frame.  A ray whose chart is not the identity comes in as its generic
// position and velocity instead (the chart's eager `to_planar` made them),
// and the kernel starts at the null fix.
//
// As in render_data.cuh: sums run in the eager order, every term of a
// structural zero included; the eager where-selects are selects and a clamp
// keeps a NaN, so that NaNs and the signs of zeros travel as there; `rsqrt`
// is the card's rsqrtf, as torch's rsqrt is there.  The null fix takes the
// metric as its torch function returns it (`metric_at`), the acceleration
// takes march.cuh's `acceleration` with every coordinate the metric depends
// on seeded, as the eager twin differentiates it in planar mode too before
// it pins a^theta, and the adaptive step seed is march.cuh's
// `acceleration_to_precision`.
//
// Compiled into every ray-march library (raymarch.cu, `grt_launch_state`)
// and, as plain C++, by the host test (tests/test_torch_launch_state_host.py).
#pragma once

#include <math.h>

#include "render_data.cuh"

namespace grt {

// What every ray of a launch shares: the image's half sides (width / 2.0 and
// height / 2.0 as the eager op casts them), the trace sign (+1 forwards in
// affine time, -1 backwards), the step controller's max_acceleration_change
// and planar mode.
struct LaunchConsts {
  float half_w;
  float half_h;
  float sign;
  float max_acceleration_change;
  int planar;
};

// torch.clamp(x, lo, hi) on the card: a NaN stays.
GRT_HD GRT_INLINE float clamp_nan(float x, float lo, float hi) {
  return is_nan(x) ? x : fminf(fmaxf(x, lo), hi);
}

GRT_HD GRT_INLINE float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// ops/planar.py::_normalize3: v / |v|, with 1 for a norm below 1e-12.
GRT_HD GRT_INLINE void normalize3(const float v[3], float out[3]) {
  float n = sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]);
  n = n < 1e-12f ? 1.0f : n;
  for (int i = 0; i < 3; ++i) out[i] = v[i] / n;
}

// The observer's lowered 4-velocity g(x) e0 at the camera's one point
// (geometry.matvec: column order, from the first product).
template <class M>
GRT_HD GRT_INLINE void observer_low(const M& m, const float x[4],
                                    const float e0[4], float out[4]) {
  float g[4][4];
  metric_at(m, x, g);
  for (int a = 0; a < 4; ++a) {
    float s = g[a][0] * e0[0];
    for (int b = 1; b < 4; ++b) s = s + g[a][b] * e0[b];
    out[a] = s;
  }
}

// camera.py::directions_for_pixels of one pixel: the direction through
// (cx, cy) at focal length f_stop, normalised by rsqrt, rotated by the
// camera quaternion q (x, y, z, w).
GRT_HD GRT_INLINE void pixel_direction(float cx, float cy, float half_w,
                                       float half_h, float f_stop,
                                       const float q[4], float d[3]) {
  const float dx = cx - half_w;
  const float dy = cy - half_h;
  const float dz = f_stop;
  const float inv = grt_rsqrt(dx * dx + dy * dy + dz * dz);
  const float vx = dx * inv, vy = dy * inv, vz = dz * inv;
  const float ux = q[0], uy = q[1], uz = q[2], w = q[3];
  const float c1x = uy * vz - uz * vy + w * vx;
  const float c1y = uz * vx - ux * vz + w * vy;
  const float c1z = ux * vy - uy * vx + w * vz;
  d[0] = vx + 2.0f * (uy * c1z - uz * c1y);
  d[1] = vy + 2.0f * (uz * c1x - ux * c1z);
  d[2] = vz + 2.0f * (ux * c1y - uy * c1x);
}

// The ray's generic velocity d0 e1 + d1 e2 + d2 e3 + sign e0 from the
// tetrad es (row-major, es[4 a + mu] = e_a^mu).
GRT_HD GRT_INLINE void launch_velocity(const float d[3], const float* es,
                                       float sign, float v[4]) {
  for (int mu = 0; mu < 4; ++mu)
    v[mu] = d[0] * es[4 + mu] + d[1] * es[8 + mu] + d[2] * es[12 + mu] +
            sign * es[mu];
}

// ops/planar.py::rot_quat_batched: v rotated by the quaternion q.
GRT_HD GRT_INLINE void rotate3(const float v[3], const float q[4],
                               float out[3]) {
  const float u[3] = {q[0], q[1], q[2]};
  float uv[3], uuv[3];
  cross3(u, v, uv);
  for (int i = 0; i < 3; ++i) uv[i] = uv[i] + q[3] * v[i];
  cross3(u, uv, uuv);
  for (int i = 0; i < 3; ++i) out[i] = v[i] + 2.0f * uuv[i];
}

// ops/planar.py::theta_adjustment_quat from the plane normal's z component
// on: the quaternion by the angle acos(cos_z) * angle_sign about `axis`.
GRT_HD GRT_INLINE void adjustment_quat(const float axis[3], float cosang,
                                       float angle_sign, float q[4]) {
  const float angle = acosf(cosang) * angle_sign;
  const float s = sinf(angle * 0.5f);  // angle / 2
  q[0] = axis[0] * s;
  q[1] = axis[1] * s;
  q[2] = axis[2] * s;
  q[3] = cosf(angle * 0.5f);
  float qn = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  qn = qn < 1e-12f ? 1.0f : qn;
  for (int i = 0; i < 4; ++i) q[i] = q[i] / qn;
}

// ops/planar.py::to_planar of an identity chart: the ray (pos, vel) rotated
// into the equatorial plane, theta pinned to the float pi/2 and v^theta to
// 0; inv_quat the rotation back.
GRT_HD GRT_INLINE void rotate_into_equator(float pos[4], float vel[4],
                                           float inv_quat[4]) {
  const float fsign = sign_or_one(pos[1]);
  const float r = fabsf(pos[1]), th = pos[2], ph = pos[3];
  const float vr = vel[1] * fsign, vth = vel[2], vph = vel[3];
  // _polar3_to_cart and _polar_vel_to_cart.
  const float st = sinf(th), ct = cosf(th);
  const float sp = sinf(ph), cp = cosf(ph);
  const float cart[3] = {r * st * cp, r * st * sp, r * ct};
  const float cv[3] = {
      vr * st * cp + r * ct * cp * vth - r * st * sp * vph,
      vr * st * sp + r * ct * sp * vth + r * st * cp * vph,
      vr * ct - r * st * vth};

  // theta_adjustment_quat, shared by the rotation and its inverse up to
  // the sign of the angle.
  const bool small = dot3(cv, cv) < 1e-10f;
  const float pd[3] = {small ? 0.0f : cv[0], small ? 1.0f : cv[1],
                       small ? 0.0f : cv[2]};
  float bx[3], by[3], t[3];
  normalize3(pd, bx);
  const float neg[3] = {-cart[0], -cart[1], -cart[2]};
  normalize3(neg, by);
  const float bxy = dot3(bx, by);
  for (int i = 0; i < 3; ++i) t[i] = bx[i] - bxy * by[i];
  normalize3(t, bx);
  float cr[3], pn[3];
  cross3(bx, by, cr);
  normalize3(cr, pn);
  for (int i = 0; i < 3; ++i) pn[i] = -pn[i];
  const float z[3] = {0.0f, 0.0f, 1.0f};
  const float cosang = clamp_nan(dot3(pn, z), -1.0f, 1.0f);
  float axis[3];
  cross3(pn, z, axis);
  const float an = sqrtf(axis[0] * axis[0] + axis[1] * axis[1] +
                         axis[2] * axis[2]);
  const bool degenerate = an < 1e-9f;
  const float den = degenerate ? 1.0f : an;
  for (int i = 0; i < 3; ++i)
    axis[i] = degenerate ? (i == 0 ? 1.0f : 0.0f) : axis[i] / den;
  float quat[4];
  adjustment_quat(axis, cosang, 1.0f, quat);
  adjustment_quat(axis, cosang, -1.0f, inv_quat);

  float c[3], v[3];
  rotate3(cart, quat, c);
  rotate3(cv, quat, v);
  // _cart_to_polar3 and _cart_vel_to_polar, but for theta and v^theta,
  // which the pins replace.
  const float nr = sqrtf(c[0] * c[0] + c[1] * c[1] + c[2] * c[2]);
  const float nph = atan2f(c[1], c[0]);
  const float rho2 = c[0] * c[0] + c[1] * c[1];
  const float r2 = rho2 + c[2] * c[2];
  const float rr = sqrtf(clamp_min_nan(r2, 1e-20f));
  const float nvr = (c[0] * v[0] + c[1] * v[1] + c[2] * v[2]) / rr;
  const float nvph = (c[0] * v[1] - c[1] * v[0]) / rho2;

  pos[1] = nr * fsign;
  pos[2] = static_cast<float>(M_PI / 2);
  pos[3] = nph;
  vel[1] = nvr * fsign;
  vel[2] = 0.0f;
  vel[3] = nvph;
}

// geometry.fix_null_batched: v^t rescaled so that g(v, v) = 0, the root
// closest to the old v^t, the linear root where g_tt is 0.
GRT_HD GRT_INLINE void fix_null(const float g[4][4], float v[4]) {
  const float vs[4] = {0.0f, v[1], v[2], v[3]};
  const float a = g[0][0];
  const float b = 2.0f * (g[0][0] * vs[0] + g[0][1] * vs[1] +
                          g[0][2] * vs[2] + g[0][3] * vs[3]);
  float c = 0.0f;
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) c = c + g[i][j] * vs[i] * vs[j];
  const float disc = clamp_min_nan(b * b - 4.0f * a * c, 0.0f);
  const float sq = sqrtf(disc);
  const float r0 = (-b - sq) / (2.0f * a);
  const float r1 = (-b + sq) / (2.0f * a);
  const float want = v[0];
  float vt = fabsf(r0 - want) < fabsf(r1 - want) ? r0 : r1;
  const float lin = -c / (fabsf(b) < 1e-12f ? 1e-12f : b);
  vt = fabsf(a) < 1e-12f ? lin : vt;
  v[0] = vt;
}

// integrate.init_ray_state and the pins of rays_for_directions from a
// generic (pos, vel): the null fix, the launch acceleration, the step seed,
// then in planar mode v^theta = a^theta = 0, and ku_uobsu = v . obs_low.
template <class M>
GRT_HD GRT_INLINE void launch_ray(const M& m, const LaunchConsts& c,
                                  const float obs_low[4], const float pos[4],
                                  const float vel[4], Ray& s, float& ku) {
  float g[4][4];
  metric_at(m, pos, g);
  for (int i = 0; i < 4; ++i) {
    s.pos[i] = pos[i];
    s.vel[i] = vel[i];
  }
  fix_null(g, s.vel);
  acceleration<M, false>(m, s.pos, s.vel, s.acc);
  if constexpr (M::adaptive_precision) {
    float diff, ideal;
    acceleration_to_precision<M>(s.acc, c.max_acceleration_change, &diff,
                                 &ideal);
    // The eager clamps keep a NaN, which acceleration_to_precision's
    // maxima (written for the march, whose state is finite) do not.
    const bool nan = is_nan(s.acc[0]) || is_nan(s.acc[1]) ||
                     is_nan(s.acc[2]) || is_nan(s.acc[3]);
    s.next_ds = nan ? NAN : ideal;
  } else {
    s.next_ds = 1e-5f;
  }
  if (c.planar) {
    s.vel[2] = 0.0f;
    s.acc[2] = 0.0f;
  }
  s.rdl = 1.0f;
  s.status = ACTIVE;
  s.steps = 0;
  ku = s.vel[0] * obs_low[0] + s.vel[1] * obs_low[1] +
       s.vel[2] * obs_low[2] + s.vel[3] * obs_low[3];
}

// The launch state of pixel (cx, cy) from the camera at x with tetrad es;
// inv_quat is written in planar mode only.
template <class M>
GRT_HD GRT_INLINE void launch_pixel(const M& m, const LaunchConsts& c,
                                    const float obs_low[4], float cx,
                                    float cy, float f_stop, const float q[4],
                                    const float x[4], const float* es,
                                    Ray& s, float& ku, float inv_quat[4]) {
  float d[3], pos[4], vel[4];
  pixel_direction(cx, cy, c.half_w, c.half_h, f_stop, q, d);
  launch_velocity(d, es, c.sign, vel);
  for (int i = 0; i < 4; ++i) pos[i] = x[i];
  if (c.planar) rotate_into_equator(pos, vel, inv_quat);
  launch_ray(m, c, obs_low, pos, vel, s, ku);
}

}  // namespace grt
