// Forward-mode dual numbers for the ray-march kernel's metric partials.
//
// Dual<K> carries a value and K tangents.  The tangent rules are the ones
// the JAX reference's jvp applies (and torch.func.jvp for the plain twin):
//   (x*y)' = x'*y + x*y'        cos(x)' = x' * (-sin x)
//   sin(x)' = x' * cos x        recip(x)' = (-y*y) * x',  y = 1/x
// in that order of operations, so that a build without FMA contraction
// (nvcc -fmad=false) reproduces the reference op for op up to the last ulp
// of the transcendentals.
//
// The header compiles as CUDA (device and host) and as plain C++ (g++, for
// the host test of the march), where the qualifier macros are empty.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define GRT_HD __host__ __device__
#define GRT_INLINE __forceinline__
#else
#define GRT_HD
#define GRT_INLINE inline
#endif

namespace grt {

template <int K>
struct Dual {
  float v;
  float d[K];
};

// A constant (all tangents zero) and the seed of coordinate sweep `k`.
template <int K>
GRT_HD GRT_INLINE Dual<K> dual_const(float v) {
  Dual<K> r;
  r.v = v;
  for (int k = 0; k < K; ++k) r.d[k] = 0.0f;
  return r;
}

template <int K>
GRT_HD GRT_INLINE Dual<K> dual_seed(float v, int k_seed) {
  Dual<K> r = dual_const<K>(v);
  r.d[k_seed] = 1.0f;
  return r;
}

template <int K>
GRT_HD GRT_INLINE Dual<K> operator+(const Dual<K>& x, const Dual<K>& y) {
  Dual<K> r;
  r.v = x.v + y.v;
  for (int k = 0; k < K; ++k) r.d[k] = x.d[k] + y.d[k];
  return r;
}

template <int K>
GRT_HD GRT_INLINE Dual<K> operator+(const Dual<K>& x, float c) {
  Dual<K> r = x;
  r.v = x.v + c;
  return r;
}

template <int K>
GRT_HD GRT_INLINE Dual<K> operator+(float c, const Dual<K>& y) {
  Dual<K> r = y;
  r.v = c + y.v;
  return r;
}

template <int K>
GRT_HD GRT_INLINE Dual<K> operator-(const Dual<K>& x) {
  Dual<K> r;
  r.v = -x.v;
  for (int k = 0; k < K; ++k) r.d[k] = -x.d[k];
  return r;
}

template <int K>
GRT_HD GRT_INLINE Dual<K> operator-(const Dual<K>& x, const Dual<K>& y) {
  Dual<K> r;
  r.v = x.v - y.v;
  for (int k = 0; k < K; ++k) r.d[k] = x.d[k] - y.d[k];
  return r;
}

template <int K>
GRT_HD GRT_INLINE Dual<K> operator-(const Dual<K>& x, float c) {
  Dual<K> r = x;
  r.v = x.v - c;
  return r;
}

template <int K>
GRT_HD GRT_INLINE Dual<K> operator-(float c, const Dual<K>& y) {
  Dual<K> r;
  r.v = c - y.v;
  for (int k = 0; k < K; ++k) r.d[k] = -y.d[k];
  return r;
}

template <int K>
GRT_HD GRT_INLINE Dual<K> operator*(const Dual<K>& x, const Dual<K>& y) {
  Dual<K> r;
  r.v = x.v * y.v;
  for (int k = 0; k < K; ++k) r.d[k] = x.d[k] * y.v + x.v * y.d[k];
  return r;
}

template <int K>
GRT_HD GRT_INLINE Dual<K> operator*(const Dual<K>& x, float c) {
  Dual<K> r;
  r.v = x.v * c;
  for (int k = 0; k < K; ++k) r.d[k] = x.d[k] * c;
  return r;
}

template <int K>
GRT_HD GRT_INLINE Dual<K> operator*(float c, const Dual<K>& y) {
  Dual<K> r;
  r.v = c * y.v;
  for (int k = 0; k < K; ++k) r.d[k] = c * y.d[k];
  return r;
}

GRT_HD GRT_INLINE float grt_cos(float x) { return cosf(x); }
GRT_HD GRT_INLINE float grt_sin(float x) { return sinf(x); }
GRT_HD GRT_INLINE float grt_recip(float x) { return 1.0f / x; }

template <int K>
GRT_HD GRT_INLINE Dual<K> grt_cos(const Dual<K>& x) {
  Dual<K> r;
  r.v = cosf(x.v);
  const float ns = -sinf(x.v);
  for (int k = 0; k < K; ++k) r.d[k] = x.d[k] * ns;
  return r;
}

template <int K>
GRT_HD GRT_INLINE Dual<K> grt_sin(const Dual<K>& x) {
  Dual<K> r;
  r.v = sinf(x.v);
  const float c = cosf(x.v);
  for (int k = 0; k < K; ++k) r.d[k] = x.d[k] * c;
  return r;
}

// 1/x with the division-free tangent -y*y*dx (the reference's recip).
template <int K>
GRT_HD GRT_INLINE Dual<K> grt_recip(const Dual<K>& x) {
  Dual<K> r;
  r.v = 1.0f / x.v;
  const float nyy = -r.v * r.v;
  for (int k = 0; k < K; ++k) r.d[k] = nyy * x.d[k];
  return r;
}

}  // namespace grt
