// The observer tetrad at the camera's one point: what `init_basis_vectors`
// (cl.cl:2484) builds in one thread, the frame basis there, its orientation
// to the global polar axes and the Lorentz boost to the camera's speed.
//
// Term for term `camera.py::observer_tetrad_reference` from the metric on
// (the chart part that makes the three generic axes stays eager, and its
// axes are inputs): the metric at the position, `ops/tetrad.py::
// frame_basis` with all four legs (each pass's es_sw, leg tl swapped to 0),
// `tetrad_inverse` (geometry.inverse44 of es.T), `coordinate_to_tetrad` of
// the axes, `_orthonormalise3`, the legs taken back to coordinates in the
// order x <- basis2, y <- basis1, z <- basis3, then `boost_tetrad`.  As in
// render_data.cuh, the float32 operations run in the eager order: matvec and
// dot start from their first product, the Gram-Schmidt sums from 0, every
// structural zero term is computed, and `1.0 / x` is torch's reciprocal.
//
// Compiled into every ray-march library (raymarch.cu, `grt_observer_tetrad`)
// and, as plain C++, by the host test (tests/test_torch_observer_tetrad_
// host.py).
#pragma once

#include "render_data.cuh"

namespace grt {

// _frame_basis_swap_batched's es_sw of one pass: leg tl first, leg 0 in
// slot tl.  Returns tl.
GRT_HD GRT_INLINE int frame_basis_pass_all(const float g[4][4], int swap,
                                           float es_sw[4][4]) {
  float es[4][4];
  const int tl = frame_basis_legs(g, swap, es);
  leg_tl(es, tl, es_sw[0]);
  for (int a = 1; a < 4; ++a)
    for (int mu = 0; mu < 4; ++mu)
      es_sw[a][mu] = a == tl ? es[0][mu] : es[a][mu];
  return tl;
}

// frame_basis_batched of one event, every leg.
GRT_HD GRT_INLINE void frame_basis_all(const float g[4][4], float es[4][4]) {
  const int tl1 = frame_basis_pass_all(g, 0, es);
  if (tl1 != 0) frame_basis_pass_all(g, tl1, es);
}

// geometry.matvec: m @ v in column order, from the first product.
GRT_HD GRT_INLINE void matvec4(const float m[4][4], const float v[4],
                               float out[4]) {
  for (int i = 0; i < 4; ++i) {
    float s = m[i][0] * v[0];
    for (int j = 1; j < 4; ++j) s = s + m[i][j] * v[j];
    out[i] = s;
  }
}

// geometry.dot of n-vectors, from the first product.
GRT_HD GRT_INLINE float dot_n(const float* u, const float* v, int n) {
  float s = u[0] * v[0];
  for (int j = 1; j < n; ++j) s = s + u[j] * v[j];
  return s;
}

// tetrad_inverse: geometry.inverse44 of es.T (a[i][j] = es[j][i]).
GRT_HD GRT_INLINE void tetrad_inverse(const float es[4][4], float b[4][4]) {
  float a[4][4];
  for (int i = 0; i < 4; ++i)
    for (int j = 0; j < 4; ++j) a[i][j] = es[j][i];
  const float s0 = a[0][0] * a[1][1] - a[1][0] * a[0][1];
  const float s1 = a[0][0] * a[1][2] - a[1][0] * a[0][2];
  const float s2 = a[0][0] * a[1][3] - a[1][0] * a[0][3];
  const float s3 = a[0][1] * a[1][2] - a[1][1] * a[0][2];
  const float s4 = a[0][1] * a[1][3] - a[1][1] * a[0][3];
  const float s5 = a[0][2] * a[1][3] - a[1][2] * a[0][3];

  const float c5 = a[2][2] * a[3][3] - a[3][2] * a[2][3];
  const float c4 = a[2][1] * a[3][3] - a[3][1] * a[2][3];
  const float c3 = a[2][1] * a[3][2] - a[3][1] * a[2][2];
  const float c2 = a[2][0] * a[3][3] - a[3][0] * a[2][3];
  const float c1 = a[2][0] * a[3][2] - a[3][0] * a[2][2];
  const float c0 = a[2][0] * a[3][1] - a[3][0] * a[2][1];

  const float det = s0 * c5 - s1 * c4 + s2 * c3 + s3 * c2 - s4 * c1 + s5 * c0;
  const float invdet = 1.0f / det;

  b[0][0] = (a[1][1] * c5 - a[1][2] * c4 + a[1][3] * c3) * invdet;
  b[0][1] = (-a[0][1] * c5 + a[0][2] * c4 - a[0][3] * c3) * invdet;
  b[0][2] = (a[3][1] * s5 - a[3][2] * s4 + a[3][3] * s3) * invdet;
  b[0][3] = (-a[2][1] * s5 + a[2][2] * s4 - a[2][3] * s3) * invdet;

  b[1][0] = (-a[1][0] * c5 + a[1][2] * c2 - a[1][3] * c1) * invdet;
  b[1][1] = (a[0][0] * c5 - a[0][2] * c2 + a[0][3] * c1) * invdet;
  b[1][2] = (-a[3][0] * s5 + a[3][2] * s2 - a[3][3] * s1) * invdet;
  b[1][3] = (a[2][0] * s5 - a[2][2] * s2 + a[2][3] * s1) * invdet;

  b[2][0] = (a[1][0] * c4 - a[1][1] * c2 + a[1][3] * c0) * invdet;
  b[2][1] = (-a[0][0] * c4 + a[0][1] * c2 - a[0][3] * c0) * invdet;
  b[2][2] = (a[3][0] * s4 - a[3][1] * s2 + a[3][3] * s0) * invdet;
  b[2][3] = (-a[2][0] * s4 + a[2][1] * s2 - a[2][3] * s0) * invdet;

  b[3][0] = (-a[1][0] * c3 + a[1][1] * c1 - a[1][2] * c0) * invdet;
  b[3][1] = (a[0][0] * c3 - a[0][1] * c1 + a[0][2] * c0) * invdet;
  b[3][2] = (-a[3][0] * s3 + a[3][1] * s1 - a[3][2] * s0) * invdet;
  b[3][3] = (a[2][0] * s3 - a[2][1] * s1 + a[2][2] * s0) * invdet;
}

// camera.py::_orthonormalise3: Euclidean Gram-Schmidt of three 3-vectors.
GRT_HD GRT_INLINE void orthonormalise3(const float v1[3], const float v2[3],
                                       const float v3[3], float u1[3],
                                       float u2[3], float u3[3]) {
  const float n1 = sqrtf(dot_n(v1, v1, 3));
  for (int i = 0; i < 3; ++i) u1[i] = v1[i] / n1;
  const float d21 = dot_n(v2, u1, 3);
  for (int i = 0; i < 3; ++i) u2[i] = v2[i] - d21 * u1[i];
  const float n2 = sqrtf(dot_n(u2, u2, 3));
  for (int i = 0; i < 3; ++i) u2[i] = u2[i] / n2;
  const float d31 = dot_n(v3, u1, 3), d32 = dot_n(v3, u2, 3);
  for (int i = 0; i < 3; ++i) u3[i] = v3[i] - d31 * u1[i] - d32 * u2[i];
  const float n3 = sqrtf(dot_n(u3, u3, 3));
  for (int i = 0; i < 3; ++i) u3[i] = u3[i] / n3;
}

// tetrad_to_coordinate of the spatial frame vector (0, b): matvec(es.T, v).
GRT_HD GRT_INLINE void to_coordinate(const float es[4][4], const float b[3],
                                     float out[4]) {
  const float v[4] = {0.0f, b[0], b[1], b[2]};
  for (int mu = 0; mu < 4; ++mu) {
    float s = es[0][mu] * v[0];
    for (int j = 1; j < 4; ++j) s = s + es[j][mu] * v[j];
    out[mu] = s;
  }
}

// tetrad.boost_tetrad: e0 boosted to the frame 3-speed s, and the spatial
// legs by the same boost (get_timelike_vector, lorentz_boost, matvec).
GRT_HD GRT_INLINE void boost_tetrad(const float es[4][4], const float s[3],
                                    const float g[4][4], float out[4][4]) {
  const float gamma = 1.0f / sqrtf(1.0f - dot_n(s, s, 3));
  float uobs[4];
  for (int mu = 0; mu < 4; ++mu)
    uobs[mu] = 1.0f * gamma * es[0][mu] + gamma * s[0] * es[1][mu] +
               gamma * s[1] * es[2][mu] + gamma * s[2] * es[3][mu];

  float lT[4], lu[4];
  matvec4(g, es[0], lT);
  matvec4(g, uobs, lu);
  const float coef = 1.0f / (-dot_n(lT, uobs, 4) + 1.0f);
  float B[4][4];
  for (int a = 0; a < 4; ++a)
    for (int b = 0; b < 4; ++b) {
      const float delta = a == b ? 1.0f : 0.0f;
      B[a][b] = delta + coef * ((es[0][a] + uobs[a]) * (lT[b] + lu[b])) -
                uobs[a] * lT[b] * 2.0f;
    }
  for (int mu = 0; mu < 4; ++mu) out[0][mu] = uobs[mu];
  for (int k = 1; k < 4; ++k) matvec4(B, es[k], out[k]);
}

// The observer tetrad es[a][mu] = e_a^mu at the generic position x, with
// the generic axes gx, gy, gz the chart part made and the frame 3-speed s.
template <class M>
GRT_HD GRT_INLINE void observer_tetrad(const M& m, const float x[4],
                                       const float gx[4], const float gy[4],
                                       const float gz[4], const float s[3],
                                       float out[4][4]) {
  float g[4][4], es[4][4], inv[4][4];
  metric_at(m, x, g);
  frame_basis_all(g, es);
  tetrad_inverse(es, inv);

  // Normalised with y first (cl.cl:2389-2398).
  float t1[4], t2[4], t3[4];
  matvec4(inv, gy, t1);
  matvec4(inv, gx, t2);
  matvec4(inv, gz, t3);
  float b1[3], b2[3], b3[3];
  orthonormalise3(t1 + 1, t2 + 1, t3 + 1, b1, b2, b3);

  // x <- basis2, y <- basis1, z <- basis3.
  float oriented[4][4];
  for (int mu = 0; mu < 4; ++mu) oriented[0][mu] = es[0][mu];
  to_coordinate(es, b2, oriented[1]);
  to_coordinate(es, b1, oriented[2]);
  to_coordinate(es, b3, oriented[3]);
  boost_tetrad(oriented, s, g, out);
}

}  // namespace grt
