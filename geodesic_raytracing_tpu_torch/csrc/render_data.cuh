// Render data of one ray endpoint: what `calculate_render_data`
// (cl.cl:5135-5220) hands the shader, computed in registers.
//
// Term for term `render/pipeline.py::compute_render_data_reference` (with
// `_fix_ray_position_batched`, `ops/planar.py::unrotate_angles`,
// `ops/tetrad.py::frame_basis_batched` and `angle_to_tex`), in the eager
// order of its float32 operations: the snap of the endpoint to the universe
// sphere (or a singular metric's terminator sphere), the planar rays'
// rotation back out of the equator, the side of the universe, the two-pass
// frame basis at the endpoint (only its timelike leg is kept), the redshift
// factor z_shift, the texture coordinates and the black test of endpoints
// inside |r| <= 1.  Sums run left to right from a 0 as the eager ones do,
// every term of a structural zero included, and the eager where-selects are
// selects, so that NaNs and the signs of zeros travel as there.  Two rules
// follow torch's CUDA kernels rather than a literal reading of the Python:
// a division by a Python scalar is a multiplication by the float32
// reciprocal of the scalar (torch's div_true_kernel_cuda), and a clamp keeps
// a NaN (clamp_min).  The metric is the march's emitted struct, evaluated
// at the endpoint with constant duals, so `g` is the value the march
// evaluates.
//
// Compiled into every ray-march library (raymarch.cu, `grt_render_data`) and,
// as plain C++, by the host test (tests/test_torch_render_data_host.py).
#pragma once

#include <math.h>

#include "march.cuh"

namespace grt {

// The render data's scalars, each as the eager op casts its Python scalar to
// float32: the squared radii of the universe and terminator spheres (Python
// multiplies in double), the singular metrics' far test radius
// 0.5 * (universe + terminator), and the config's branches.
struct RenderConsts {
  float universe_sq;
  float terminator_sq;
  float far_r;
  int singular;
  int traversable;
};

// What the kernel reads of one ray: its generic state, its launch energy,
// its polar position and velocity (slots 1, 2, 3 of the chart's to_polar)
// and, planar, its inverse quaternion (x, y, z, w).
struct RayEnd {
  float pos[4];
  float vel[4];
  float rdl;
  int status;
  float ku_uobsu;
  float polar[3];
  float polar_vel[3];
  bool planar;
  float inv_quat[4];
};

struct RayRender {
  float tex[2];
  float z_shift;
  int side;
  int terminated;
  float angles[2];
};

GRT_HD GRT_INLINE bool is_nan(float x) { return x != x; }

// torch.clamp(x, min=lo) on the card: a NaN stays, else fmaxf.
GRT_HD GRT_INLINE float clamp_min_nan(float x, float lo) {
  return is_nan(x) ? x : fmaxf(x, lo);
}

// torch.sign(x) with 1 where it is 0 (ops/planar.py::_signed; a NaN too).
GRT_HD GRT_INLINE float sign_or_one(float x) {
  const float s = static_cast<float>((0.0f < x) - (x < 0.0f));
  return s == 0.0f ? 1.0f : s;
}

// torch.remainder of floats: fmod, moved into the divisor's sign.
GRT_HD GRT_INLINE float remainder_f(float a, float b) {
  float mod = fmodf(a, b);
  if (mod != 0.0f && ((b < 0.0f) != (mod < 0.0f))) mod += b;
  return mod;
}

// _fix_ray_position_batched: the polar endpoint p (r, theta, phi) moved
// along its velocity v onto the sphere of squared radius r_sq.
GRT_HD GRT_INLINE void snap_to_sphere(const float p[3], const float v[3],
                                      float r_sq, float out[3]) {
  const float sign = sign_or_one(p[0]);
  const float r = fabsf(p[0]);
  const float th = p[1], ph = p[2];
  const float vr = v[0] * sign;
  const float vth = v[1], vph = v[2];

  const float st = sinf(th), ct = cosf(th);
  const float sp = sinf(ph), cp = cosf(ph);
  const float px = r * st * cp;
  const float py = r * st * sp;
  const float pz = r * ct;
  float vx = vr * st * cp + r * ct * cp * vth - r * st * sp * vph;
  float vy = vr * st * sp + r * ct * sp * vth + r * st * cp * vph;
  float vz = vr * ct - r * st * vth;

  float vn = sqrtf(vx * vx + vy * vy + vz * vz);
  vn = vn < 1e-12f ? 1.0f : vn;
  vx = vx / vn;
  vy = vy / vn;
  vz = vz / vn;

  const float b = 2.0f * (vx * px + vy * py + vz * pz);
  const float c = px * px + py * py + pz * pz - r_sq;
  const float disc = b * b - 4.0f * c;
  const float sq = sqrtf(clamp_min_nan(disc, 0.0f));
  const float t0 = (-b - sq) * 0.5f;  // (...) / 2.0
  const float t1 = (-b + sq) * 0.5f;
  float t = fabsf(t0) < fabsf(t1) ? t0 : t1;
  t = disc < 0.0f ? 0.0f : t;
  const float nx = px + t * vx, ny = py + t * vy, nz = pz + t * vz;

  const float nr = sqrtf(nx * nx + ny * ny + nz * nz);
  out[0] = nr * sign;
  out[1] = atan2f(sqrtf(nx * nx + ny * ny), nz);
  out[2] = atan2f(ny, nx);
}

GRT_HD GRT_INLINE void cross3(const float a[3], const float b[3],
                              float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// ops/planar.py::unrotate_angles: (r, theta, phi) rotated by the inverse
// quaternion q, the sign of r kept.
GRT_HD GRT_INLINE void unrotate(const float s[3], const float q[4],
                                float out[3]) {
  const float fsign = sign_or_one(s[0]);
  const float r = fabsf(s[0]);
  const float st = sinf(s[1]), ct = cosf(s[1]);
  const float v[3] = {r * st * cosf(s[2]), r * st * sinf(s[2]), r * ct};
  const float u[3] = {q[0], q[1], q[2]};
  const float w = q[3];
  float uv[3], uuv[3];
  cross3(u, v, uv);
  for (int i = 0; i < 3; ++i) uv[i] = uv[i] + w * v[i];
  cross3(u, uv, uuv);
  float c[3];
  for (int i = 0; i < 3; ++i) c[i] = v[i] + 2.0f * uuv[i];
  out[0] = sqrtf(c[0] * c[0] + c[1] * c[1] + c[2] * c[2]) * fsign;
  out[1] = atan2f(sqrtf(c[0] * c[0] + c[1] * c[1]), c[2]);
  out[2] = atan2f(c[1], c[0]);
}

// Entry (I, J) of a Sym as a float (0 where the metric has none), into g.
template <int IDX, class S>
GRT_HD GRT_INLINE void fill_metric(const S& G, float g[4][4]) {
  if constexpr (IDX < 16) {
    g[IDX / 4][IDX % 4] = to_float(gval<IDX / 4, IDX % 4>(G));
    fill_metric<IDX + 1>(G, g);
  }
}

// The metric's 4x4 value at x, as its torch function returns it: the struct's
// entries, or for a Kerr-Schild struct minkowski_plus's (f l_a) l_b + eta_ab.
template <class M>
GRT_HD GRT_INLINE void metric_at(const M& m, const float x[4],
                                 float g[4][4]) {
  if constexpr (HasRank1<M>::value) {
    const auto d = m.fl(dual_constant(x[1]), dual_constant(x[2]),
                        dual_constant(x[3]));
    const float f = value(d.f);
    const float l[4] = {1.0f, value(d.l1), value(d.l2), value(d.l3)};
    for (int a = 0; a < 4; ++a)
      for (int b = 0; b < 4; ++b) {
        const float eta = a != b ? 0.0f : (a == 0 ? -1.0f : 1.0f);
        g[a][b] = f * l[a] * l[b] + eta;
      }
  } else {
    fill_metric<0>(m.g(dual_constant(x[0]), dual_constant(x[1]),
                       dual_constant(x[2]), dual_constant(x[3])),
                   g);
  }
}

// ops/tetrad.py::_dot_g_b: g_ab u^a v^b, a-major, from 0.
GRT_HD GRT_INLINE float dot_g(const float g[4][4], const float u[4],
                              const float v[4]) {
  float out = 0.0f;
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b) out = out + g[a][b] * u[a] * v[b];
  return out;
}

// _swap0_batched on the index rows: rows 0 and j exchanged, by selects.
GRT_HD GRT_INLINE void swap0(int order[4], int j) {
  const int rj = j == 0 ? order[0]
               : j == 1 ? order[1]
               : j == 2 ? order[2]
               : order[3];
  const int r0 = order[0];
  order[0] = rj;
  for (int i = 1; i < 4; ++i) order[i] = i == j ? r0 : order[i];
}

// One pass of _frame_basis_swap_batched with the starting swap `swap`, up to
// its swap of the timelike leg: the legs sorted by slot (its `es`) and tl.
GRT_HD GRT_INLINE int frame_basis_legs(const float g[4][4], int swap,
                                       float es[4][4]) {
  int order[4] = {0, 1, 2, 3};
  swap0(order, swap);
  // diag_gather, the nonzero test and the first nonzero index (argmax of
  // the mask, 0 where none is set).
  int first_nz = -1;
  for (int i = 0; i < 4; ++i) {
    float len = 0.0f;
    for (int mu = 0; mu < 4; ++mu)
      len = len + (order[i] == mu ? g[mu][mu] : 0.0f);
    if (first_nz < 0 && fabsf(len) > 1e-5f) first_nz = i;
  }
  swap0(order, first_nz < 0 ? 0 : first_nz);

  // Metric Gram-Schmidt of the one-hot rows of `order`.
  float vs[4][4];
  for (int i = 0; i < 4; ++i)
    for (int mu = 0; mu < 4; ++mu) vs[i][mu] = order[i] == mu ? 1.0f : 0.0f;
  float u[4][4];
  for (int mu = 0; mu < 4; ++mu) u[0][mu] = vs[0][mu];
  for (int k = 1; k < 4; ++k) {
    float q[3];
    for (int j = 0; j < k; ++j)
      q[j] = dot_g(g, u[j], vs[k]) / dot_g(g, u[j], u[j]);
    for (int mu = 0; mu < 4; ++mu) {
      float x = vs[k][mu];
      for (int j = 0; j < k; ++j) x = x - q[j] * u[j][mu];
      u[k][mu] = x;
    }
  }
  float us[4][4];
  for (int i = 0; i < 4; ++i) {
    const float n = sqrtf(fabsf(dot_g(g, u[i], u[i])));
    for (int mu = 0; mu < 4; ++mu) us[i][mu] = u[i][mu] / n;
  }

  // Legs sorted by their slot in `order`, their norms, and tl: the first
  // leg of least norm where that is negative (a NaN gives 0).
  for (int slot = 0; slot < 4; ++slot)
    for (int mu = 0; mu < 4; ++mu) {
      float acc = 0.0f;
      for (int i = 0; i < 4; ++i)
        acc = acc + (order[i] == slot ? 1.0f : 0.0f) * us[i][mu];
      es[slot][mu] = acc;
    }
  bool nan = false;
  int tl = 0;
  float least = 0.0f;
  for (int slot = 0; slot < 4; ++slot) {
    const float d = dot_g(g, es[slot], es[slot]);
    nan = nan || is_nan(d);
    if (slot == 0 || d < least) {
      least = d;
      tl = slot;
    }
  }
  if (nan || !(least < 0.0f)) tl = 0;
  return tl;
}

// The e_tl of a pass: its leg tl, as the eager sum of selects from 0.
GRT_HD GRT_INLINE void leg_tl(const float es[4][4], int tl, float e0[4]) {
  for (int mu = 0; mu < 4; ++mu) {
    float acc = 0.0f;
    for (int i = 0; i < 4; ++i) acc = acc + (tl == i ? es[i][mu] : 0.0f);
    e0[mu] = acc;
  }
}

// One pass of _frame_basis_swap_batched with the starting swap `swap`: the
// timelike leg it returns first (es_sw[0]) in e0, and its tl.
GRT_HD GRT_INLINE int frame_basis_pass(const float g[4][4], int swap,
                                       float e0[4]) {
  float es[4][4];
  const int tl = frame_basis_legs(g, swap, es);
  leg_tl(es, tl, e0);
  return tl;
}

// frame_basis_batched's leg 0: the second pass (swap tl1) where the first
// found its timelike leg elsewhere than at 0.
GRT_HD GRT_INLINE void timelike_leg(const float g[4][4], float e0[4]) {
  const int tl1 = frame_basis_pass(g, 0, e0);
  if (tl1 != 0) frame_basis_pass(g, tl1, e0);
}

// pi and 2 pi as the eager ops cast them to float32, and their reciprocals:
// torch on the card divides a float32 tensor by a Python scalar as a
// multiplication by the scalar's float32 reciprocal.
constexpr float kPi = static_cast<float>(M_PI);
constexpr float kTwoPi = static_cast<float>(2.0 * M_PI);
constexpr float kInvPi = 1.0f / kPi;
constexpr float kInvTwoPi = 1.0f / kTwoPi;

// The render data of one endpoint.
template <class M>
GRT_HD GRT_INLINE void render_ray(const M& m, const RenderConsts& c,
                                  const RayEnd& e, RayRender& out) {
  float snapped[3];
  const bool far = !c.singular || fabsf(e.polar[0]) >= c.far_r;
  if (far) {
    snap_to_sphere(e.polar, e.polar_vel, c.universe_sq, snapped);
  } else if (c.traversable) {
    snap_to_sphere(e.polar, e.polar_vel, c.terminator_sq, snapped);
  } else {
    for (int i = 0; i < 3; ++i) snapped[i] = e.polar[i];
  }
  if (e.planar) {
    float rot[3];
    unrotate(snapped, e.inv_quat, rot);
    for (int i = 0; i < 3; ++i) snapped[i] = rot[i];
  }
  out.side = e.polar[0] < 0.0f ? 0 : 1;

  float g[4][4], e0[4];
  metric_at(m, e.pos, g);
  timelike_leg(g, e0);
  float obs_low[4];
  for (int a = 0; a < 4; ++a) {
    float s = 0.0f;
    for (int b = 0; b < 4; ++b) s = s + g[a][b] * e0[b];
    obs_low[a] = s;
  }
  float k_obs = 0.0f;
  for (int a = 0; a < 4; ++a) k_obs = k_obs + (e.vel[a] / e.rdl) * obs_low[a];
  out.z_shift = clamp_min_nan(k_obs / e.ku_uobsu - 1.0f, -0.999f);

  out.angles[0] = snapped[1];
  out.angles[1] = snapped[2];
  // angle_to_tex
  float theta = remainder_f(snapped[1], kTwoPi);
  float phi = snapped[2];
  const bool over = theta >= kPi;
  phi = over ? phi + kPi : phi;
  theta = over ? theta - kPi : theta;
  phi = remainder_f(phi, kTwoPi);
  out.tex[0] = phi * kInvTwoPi + 0.5f;
  out.tex[1] = theta * kInvPi;

  out.terminated = (!c.traversable && e.status == ESCAPED &&
                    fabsf(snapped[0]) <= 1.0f)
                       ? DEAD
                       : e.status;
}

}  // namespace grt
