// Forward-mode dual numbers for the ray-march kernel's metric partials.
//
// Dual<MASK> carries a value and up to kTangents tangents.  MASK is the set
// of tangents that can be nonzero: bit k set means tangent k is live.  A dead
// tangent is a structural zero; it is never computed and always reads 0.
// The operators give the result the union of their operands' masks and drop,
// with `if constexpr`, every term that multiplies or adds a dead tangent, so
// that cos(theta) carries only a theta tangent, r*r only an r tangent, and
// their sum both.  Dual<kAllTangents> for every operand is the unpruned
// computation: all terms, structural zeros included.  For finite values the
// two differ in no bit except the sign of a zero.
//
// The tangent rules are the ones the JAX reference's jvp applies (and
// torch.func.jvp for the plain twin):
//   (x*y)' = x'*y + x*y'        cos(x)' = x' * (-sin x)
//   sin(x)' = x' * cos x        recip(x)' = (-y*y) * x',  y = 1/x
// in that order of operations, so that a build without FMA contraction
// (nvcc -fmad=false) reproduces the reference op for op up to the last ulp
// of the transcendentals.
//
// The header compiles as CUDA (device and host) and as plain C++17 (g++, for
// the host tests), where the qualifier macros are empty.
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

constexpr int kTangents = 2;
constexpr unsigned kAllTangents = (1u << kTangents) - 1u;

template <unsigned MASK>
struct Dual {
  static_assert(MASK <= kAllTangents, "a mask bit beyond kTangents");
  float v = 0.0f;
  float d[kTangents] = {};  // d[k] stays 0 where bit k of MASK is clear
};

GRT_HD constexpr bool live(unsigned mask, int k) { return (mask >> k) & 1u; }

// The seed of coordinate sweep K: tangent K is 1, no other is live.
template <int K>
GRT_HD GRT_INLINE Dual<(1u << K)> dual_seed(float v) {
  Dual<(1u << K)> r;
  r.v = v;
  r.d[K] = 1.0f;
  return r;
}

// The same value with more tangents declared live (the added ones hold 0):
// widening every operand to kAllTangents gives the unpruned computation.
template <unsigned TO, unsigned FROM>
GRT_HD GRT_INLINE Dual<TO> widen(const Dual<FROM>& x) {
  static_assert((FROM & ~TO) == 0u, "widen cannot drop a live tangent");
  Dual<TO> r;
  r.v = x.v;
  for (int k = 0; k < kTangents; ++k) r.d[k] = x.d[k];
  return r;
}

// Tangent K of each binary operator, with the dead terms dropped.
template <int K, unsigned A, unsigned B>
GRT_HD GRT_INLINE float add_tangent(const Dual<A>& x, const Dual<B>& y) {
  if constexpr (live(A, K) && live(B, K)) return x.d[K] + y.d[K];
  else if constexpr (live(A, K)) return x.d[K];
  else if constexpr (live(B, K)) return y.d[K];
  else return 0.0f;
}

template <int K, unsigned A, unsigned B>
GRT_HD GRT_INLINE float sub_tangent(const Dual<A>& x, const Dual<B>& y) {
  if constexpr (live(A, K) && live(B, K)) return x.d[K] - y.d[K];
  else if constexpr (live(A, K)) return x.d[K];
  else if constexpr (live(B, K)) return -y.d[K];
  else return 0.0f;
}

template <int K, unsigned A, unsigned B>
GRT_HD GRT_INLINE float mul_tangent(const Dual<A>& x, const Dual<B>& y) {
  if constexpr (live(A, K) && live(B, K)) return x.d[K] * y.v + x.v * y.d[K];
  else if constexpr (live(A, K)) return x.d[K] * y.v;
  else if constexpr (live(B, K)) return x.v * y.d[K];
  else return 0.0f;
}

template <int K, unsigned A>
GRT_HD GRT_INLINE float neg_tangent(const Dual<A>& x) {
  if constexpr (live(A, K)) return -x.d[K];
  else return 0.0f;
}

// Tangent K of a unary rule d[K] * scale.
template <int K, unsigned A>
GRT_HD GRT_INLINE float scale_tangent(const Dual<A>& x, float scale) {
  if constexpr (live(A, K)) return x.d[K] * scale;
  else return 0.0f;
}

static_assert(kTangents == 2, "the operators below write tangents 0 and 1");

template <unsigned A, unsigned B>
GRT_HD GRT_INLINE Dual<(A | B)> operator+(const Dual<A>& x, const Dual<B>& y) {
  Dual<(A | B)> r;
  r.v = x.v + y.v;
  r.d[0] = add_tangent<0>(x, y);
  r.d[1] = add_tangent<1>(x, y);
  return r;
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> operator+(const Dual<A>& x, float c) {
  Dual<A> r = x;
  r.v = x.v + c;
  return r;
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> operator+(float c, const Dual<A>& y) {
  Dual<A> r = y;
  r.v = c + y.v;
  return r;
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> operator-(const Dual<A>& x) {
  Dual<A> r;
  r.v = -x.v;
  r.d[0] = neg_tangent<0>(x);
  r.d[1] = neg_tangent<1>(x);
  return r;
}

template <unsigned A, unsigned B>
GRT_HD GRT_INLINE Dual<(A | B)> operator-(const Dual<A>& x, const Dual<B>& y) {
  Dual<(A | B)> r;
  r.v = x.v - y.v;
  r.d[0] = sub_tangent<0>(x, y);
  r.d[1] = sub_tangent<1>(x, y);
  return r;
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> operator-(const Dual<A>& x, float c) {
  Dual<A> r = x;
  r.v = x.v - c;
  return r;
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> operator-(float c, const Dual<A>& y) {
  Dual<A> r = -y;
  r.v = c - y.v;
  return r;
}

template <unsigned A, unsigned B>
GRT_HD GRT_INLINE Dual<(A | B)> operator*(const Dual<A>& x, const Dual<B>& y) {
  Dual<(A | B)> r;
  r.v = x.v * y.v;
  r.d[0] = mul_tangent<0>(x, y);
  r.d[1] = mul_tangent<1>(x, y);
  return r;
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> operator*(const Dual<A>& x, float c) {
  Dual<A> r;
  r.v = x.v * c;
  r.d[0] = scale_tangent<0>(x, c);
  r.d[1] = scale_tangent<1>(x, c);
  return r;
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> operator*(float c, const Dual<A>& y) {
  Dual<A> r;
  r.v = c * y.v;
  r.d[0] = scale_tangent<0>(y, c);
  r.d[1] = scale_tangent<1>(y, c);
  return r;
}

// sin and cos of one angle.  On the device one sincosf call shares the range
// reduction between the two; its results are those of sinf and cosf.
// GRT_SEPARATE_TRIG keeps the two separate calls (a measurement switch).
GRT_HD GRT_INLINE void grt_sincos(float x, float& s, float& c) {
#if defined(__CUDA_ARCH__) && !defined(GRT_SEPARATE_TRIG)
  sincosf(x, &s, &c);
#else
  s = sinf(x);
  c = cosf(x);
#endif
}

GRT_HD GRT_INLINE float grt_recip(float x) { return 1.0f / x; }

template <unsigned A>
GRT_HD GRT_INLINE void grt_sincos(const Dual<A>& x, Dual<A>& s, Dual<A>& c) {
  grt_sincos(x.v, s.v, c.v);
  const float ns = -s.v;
  s.d[0] = scale_tangent<0>(x, c.v);
  s.d[1] = scale_tangent<1>(x, c.v);
  c.d[0] = scale_tangent<0>(x, ns);
  c.d[1] = scale_tangent<1>(x, ns);
}

// 1/x with the division-free tangent -y*y*dx (the reference's recip).
template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_recip(const Dual<A>& x) {
  Dual<A> r;
  r.v = 1.0f / x.v;
  const float nyy = -r.v * r.v;
  r.d[0] = scale_tangent<0>(x, nyy);
  r.d[1] = scale_tangent<1>(x, nyy);
  return r;
}

}  // namespace grt
