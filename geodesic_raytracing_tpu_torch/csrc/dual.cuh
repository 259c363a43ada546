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
// The tangent rules are the ones the JAX reference's jvp applies and, for
// the functions the reference leaves to its framework, the forward-mode
// formulas of the installed torch (torch.func.jvp of the plain twin), in
// their order of operations:
//   (x*y)' = x'*y + x*y'        cos(x)' = x' * (-sin x)
//   sin(x)' = x' * cos x        recip(x)' = (-y*y) * x',  y = 1/x
//   sqrt(x)' = x' / (2*y)       exp(x)' = x' * y
//   log(x)' = x' / x            log1p(x)' = x' / (x + 1)
//   tanh(x)' = x' * fma(-y, y, 1)  (torch's fused tanh_backward, contracted)
//   pow(x, e)' = x' * (e * pow(x, e - 1)), each pow as torch evaluates it
//   |x|' = x' * sgn(x)          where(c, a, b)' = where(c, a', b')
//   clamp(x, lo)' = where(x >= lo, x', 0)
//   arctan(x)' = x' / (1 + x*x)
//   arctan2(y, x)' = (x*y' - y*x') / max(x*x + y*y, 1e-37)
// so that a build without FMA contraction (nvcc -fmad=false) reproduces the
// reference op for op up to the last ulp of the transcendentals.
//
// Every operator writes its tangents with a compile-time loop over the live
// ones (`make_dual`); a dead tangent is never written and keeps its 0.
//
// The header compiles as CUDA (device and host) and as plain C++17 (g++, for
// the host tests), where the qualifier macros are empty.
#pragma once

#include <math.h>

#include <type_traits>
#include <utility>

#ifdef __CUDACC__
#define GRT_HD __host__ __device__
#define GRT_INLINE __forceinline__
#else
#define GRT_HD
#define GRT_INLINE inline
#endif

namespace grt {

constexpr int kTangents = 4;
constexpr unsigned kAllTangents = (1u << kTangents) - 1u;

template <unsigned MASK>
struct Dual {
  static_assert(MASK <= kAllTangents, "a mask bit beyond kTangents");
  static constexpr unsigned mask = MASK;
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

// A coordinate that seeds every tangent of MASK (none: a constant, which the
// metric is not differentiated by).  Tangents are named by seed order, not by
// coordinate index: tangent k belongs to the k-th coordinate the metric
// depends on.
template <unsigned MASK>
GRT_HD GRT_INLINE Dual<MASK> dual_seeded(float v) {
  Dual<MASK> r;
  r.v = v;
  for (int k = 0; k < kTangents; ++k)
    if (live(MASK, k)) r.d[k] = 1.0f;
  return r;
}

GRT_HD GRT_INLINE Dual<0u> dual_constant(float v) { return dual_seeded<0u>(v); }

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

// A dual of MASK with value v and tangent K = f(std::integral_constant<int,
// K>) for every live K: the loop unrolls at compile time, and f is not even
// instantiated for a dead tangent.
template <unsigned MASK, int K, class F>
GRT_HD GRT_INLINE void fill_tangent(Dual<MASK>& r, F& f) {
  if constexpr (live(MASK, K)) r.d[K] = f(std::integral_constant<int, K>{});
}

template <unsigned MASK, class F, int... K>
GRT_HD GRT_INLINE void fill_tangents(Dual<MASK>& r, F& f,
                                     std::integer_sequence<int, K...>) {
  (fill_tangent<MASK, K>(r, f), ...);
}

template <unsigned MASK, class F>
GRT_HD GRT_INLINE Dual<MASK> make_dual(float v, F&& f) {
  Dual<MASK> r;
  r.v = v;
  fill_tangents(r, f, std::make_integer_sequence<int, kTangents>{});
  return r;
}

// The index of an integral_constant argument of a tangent lambda.
#define GRT_K(k) decltype(k)::value

template <unsigned A, unsigned B>
GRT_HD GRT_INLINE Dual<(A | B)> operator+(const Dual<A>& x, const Dual<B>& y) {
  return make_dual<(A | B)>(x.v + y.v, [&](auto k) {
    return add_tangent<GRT_K(k)>(x, y);
  });
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
  return make_dual<A>(-x.v, [&](auto k) { return neg_tangent<GRT_K(k)>(x); });
}

template <unsigned A, unsigned B>
GRT_HD GRT_INLINE Dual<(A | B)> operator-(const Dual<A>& x, const Dual<B>& y) {
  return make_dual<(A | B)>(x.v - y.v, [&](auto k) {
    return sub_tangent<GRT_K(k)>(x, y);
  });
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
  return make_dual<(A | B)>(x.v * y.v, [&](auto k) {
    return mul_tangent<GRT_K(k)>(x, y);
  });
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> operator*(const Dual<A>& x, float c) {
  return make_dual<A>(x.v * c, [&](auto k) {
    return scale_tangent<GRT_K(k)>(x, c);
  });
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> operator*(float c, const Dual<A>& y) {
  return make_dual<A>(c * y.v, [&](auto k) {
    return scale_tangent<GRT_K(k)>(y, c);
  });
}

// The value of a dual or of a float.
GRT_HD GRT_INLINE float value(float x) { return x; }
template <unsigned A>
GRT_HD GRT_INLINE float value(const Dual<A>& x) {
  return x.v;
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

// CUDA's rsqrtf on the device (what torch's rsqrt computes there), 1/sqrt on
// the host.
GRT_HD GRT_INLINE float grt_rsqrt(float x) {
#ifdef __CUDA_ARCH__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

template <unsigned A>
GRT_HD GRT_INLINE void grt_sincos(const Dual<A>& x, Dual<A>& s, Dual<A>& c) {
  float sv, cv;
  grt_sincos(x.v, sv, cv);
  const float ns = -sv;
  s = make_dual<A>(sv, [&](auto k) { return scale_tangent<GRT_K(k)>(x, cv); });
  c = make_dual<A>(cv, [&](auto k) { return scale_tangent<GRT_K(k)>(x, ns); });
}

// sin alone (a metric that needs cos only for the tangent): without a live
// tangent no cosine is computed at all.
template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_sin(const Dual<A>& x) {
  if constexpr (A == 0u) {
    return dual_constant(sinf(x.v));
  } else {
    Dual<A> s, c;
    grt_sincos(x, s, c);
    return s;
  }
}

// 1/x with the division-free tangent -y*y*dx (the reference's recip).
template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_recip(const Dual<A>& x) {
  const float y = 1.0f / x.v;
  const float nyy = -y * y;
  return make_dual<A>(y, [&](auto k) { return scale_tangent<GRT_K(k)>(x, nyy); });
}

// Tangent K of a unary rule d[K] / den.
template <int K, unsigned A>
GRT_HD GRT_INLINE float div_tangent(const Dual<A>& x, float den) {
  if constexpr (live(A, K)) return x.d[K] / den;
  else return 0.0f;
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_sqrt(const Dual<A>& x) {
  const float y = sqrtf(x.v);
  const float two_y = 2.0f * y;
  return make_dual<A>(y, [&](auto k) { return div_tangent<GRT_K(k)>(x, two_y); });
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_exp(const Dual<A>& x) {
  const float y = expf(x.v);
  return make_dual<A>(y, [&](auto k) { return scale_tangent<GRT_K(k)>(x, y); });
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_log(const Dual<A>& x) {
  return make_dual<A>(logf(x.v), [&](auto k) {
    return div_tangent<GRT_K(k)>(x, x.v);
  });
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_log1p(const Dual<A>& x) {
  const float xp1 = x.v + 1.0f;
  return make_dual<A>(log1pf(x.v), [&](auto k) {
    return div_tangent<GRT_K(k)>(x, xp1);
  });
}

// torch's tanh_backward(t, y) = t * (1 - y*y), whose subtraction of the
// product its CUDA and CPU builds contract into one fused multiply-add.
template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_tanh(const Dual<A>& x) {
  const float y = tanhf(x.v);
  const float s = fmaf(-y, y, 1.0f);
  return make_dual<A>(y, [&](auto k) { return scale_tangent<GRT_K(k)>(x, s); });
}

// |x| with the tangent x' * sgn(x).
template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_abs(const Dual<A>& x) {
  const float sgn = static_cast<float>((x.v > 0.0f) - (x.v < 0.0f));
  return make_dual<A>(fabsf(x.v), [&](auto k) {
    return scale_tangent<GRT_K(k)>(x, sgn);
  });
}

// torch.where(c, a, b) with a dual or a constant on either side: the
// tangents are selected with the value (a constant's are 0).
template <unsigned A, unsigned B>
GRT_HD GRT_INLINE Dual<(A | B)> grt_where(bool c, const Dual<A>& a,
                                          const Dual<B>& b) {
  return make_dual<(A | B)>(c ? a.v : b.v, [&](auto k) {
    constexpr int K = GRT_K(k);
    float ta = 0.0f, tb = 0.0f;
    if constexpr (live(A, K)) ta = a.d[K];
    if constexpr (live(B, K)) tb = b.d[K];
    return c ? ta : tb;
  });
}
template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_where(bool c, const Dual<A>& a, float b) {
  return grt_where(c, a, dual_constant(b));
}
template <unsigned B>
GRT_HD GRT_INLINE Dual<B> grt_where(bool c, float a, const Dual<B>& b) {
  return grt_where(c, dual_constant(a), b);
}

// torch.clamp(x, min=lo): the value max(x, lo) (NaN stays NaN), the tangent
// where(x >= lo, x', 0).
template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_clamp_min(const Dual<A>& x, float lo) {
  const bool keep = x.v >= lo;
  return make_dual<A>(x.v < lo ? lo : x.v, [&](auto k) {
    return keep ? x.d[GRT_K(k)] : 0.0f;
  });
}

// torch's x ** e for a float32 tensor and a Python-number exponent e:
// e = 0 fills 1 and e = 1 copies; 0.5, -0.5 and -1 go to sqrt, rsqrt and
// reciprocal; 2 and 3 are products, -2 a double reciprocal of x*x; any other
// e is powf(x, (float)e).  The choice is made once, on the host.
struct TorchPow {
  enum Kind { kOne, kCopy, kSqrt, kRsqrt, kRecip, kSquare, kCube, kInvSquare,
              kPowf };
  int kind;
  float e;
};

GRT_HD constexpr TorchPow torch_pow_plan(double e) {
  return {e == 0.0    ? TorchPow::kOne
          : e == 1.0  ? TorchPow::kCopy
          : e == 0.5  ? TorchPow::kSqrt
          : e == -0.5 ? TorchPow::kRsqrt
          : e == -1.0 ? TorchPow::kRecip
          : e == 2.0  ? TorchPow::kSquare
          : e == 3.0  ? TorchPow::kCube
          : e == -2.0 ? TorchPow::kInvSquare
                      : TorchPow::kPowf,
          static_cast<float>(e)};
}

GRT_HD GRT_INLINE float torch_pow(float x, const TorchPow& p) {
  switch (p.kind) {
    case TorchPow::kOne: return 1.0f;
    case TorchPow::kCopy: return x;
    case TorchPow::kSqrt: return sqrtf(x);
    case TorchPow::kRsqrt: return grt_rsqrt(x);
    case TorchPow::kRecip: return 1.0f / x;
    case TorchPow::kSquare: return x * x;
    case TorchPow::kCube: return x * x * x;
    case TorchPow::kInvSquare:
      return static_cast<float>(1.0 / static_cast<double>(x * x));
    default: return powf(x, p.e);
  }
}

// The forward rule of x ** e (torch's pow_backward): the value, the factor
// (float)e and the power e - 1 (in double) of the tangent
// x' * (e * x ** (e - 1)); e = 0 has the tangent 0.
struct PowRule {
  TorchPow value;
  float factor;
  TorchPow slope;
};

GRT_HD constexpr PowRule pow_rule(double e) {
  return {torch_pow_plan(e), static_cast<float>(e), torch_pow_plan(e - 1.0)};
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_pow(const Dual<A>& x, const PowRule& p) {
  const float y = torch_pow(x.v, p.value);
  const float s = p.value.kind == TorchPow::kOne
                      ? 0.0f
                      : p.factor * torch_pow(x.v, p.slope);
  return make_dual<A>(y, [&](auto k) {
    return p.value.kind == TorchPow::kOne ? 0.0f
                                          : scale_tangent<GRT_K(k)>(x, s);
  });
}

// The reference's pow_pos (geometry.py): exp(log(max(b, 1e-37)) * e) where
// b > 0, else exactly 0, as its torch form computes it and its tangent.
template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_pow_pos(const Dual<A>& b, float e) {
  return grt_where(b.v > 0.0f, grt_exp(grt_log(grt_clamp_min(b, 1e-37f)) * e),
                   0.0f);
}

// The reference's polynomial atan (geometry.py::arctan, ~2 ulp), operation
// for operation as its torch form: Python constants meet float32 tensors as
// float32, in comparisons too.
GRT_HD GRT_INLINE float grt_arctan(float x) {
  const float ax = fabsf(x);
  const bool inv = ax > 1.0f;
  const float t = inv ? (1.0f / (ax < 1e-37f ? 1e-37f : ax)) * 1.0f : ax;
  const bool red = t > static_cast<float>(0.4142135623730951);
  const float u = red ? (t - 1.0f) / (t + 1.0f) : t;
  const float z = u * u;
  const float p =
      (((static_cast<float>(8.05374449538e-2) * z -
         static_cast<float>(1.38776856032e-1)) * z +
        static_cast<float>(1.99777106478e-1)) * z -
       static_cast<float>(3.33329491539e-1)) * z * u + u;
  float y = red ? p + static_cast<float>(0.7853981633974483) : p;
  y = inv ? static_cast<float>(1.5707963267948966) - y : y;
  return x < 0.0f ? -y : y;
}

// The reference's polynomial atan2 with numpy's quadrant conventions.
GRT_HD GRT_INLINE float grt_arctan2(float y, float x) {
  const float safe_x = x == 0.0f ? 1.0f : x;
  float base = grt_arctan(y / safe_x);
  constexpr float half_pi = static_cast<float>(1.5707963267948966);
  constexpr float pi = static_cast<float>(3.141592653589793);
  if (x == 0.0f) base = y > 0.0f ? half_pi : (y < 0.0f ? -half_pi : 0.0f);
  const float corr = y < 0.0f ? -pi : pi;
  return x < 0.0f ? base + corr : base;
}

template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_arctan(const Dual<A>& x) {
  const float den = 1.0f + x.v * x.v;
  return make_dual<A>(grt_arctan(x.v), [&](auto k) {
    return div_tangent<GRT_K(k)>(x, den);
  });
}

// arctan2 of a dual y and a constant x (whose tangent torch.func.jvp
// materialises as zeros, so the rule keeps its y * 0 term).
template <unsigned A>
GRT_HD GRT_INLINE Dual<A> grt_arctan2(const Dual<A>& y, float x) {
  const float d0 = x * x + y.v * y.v;
  const float d = d0 < 1e-37f ? 1e-37f : d0;
  return make_dual<A>(grt_arctan2(y.v, x), [&](auto k) {
    constexpr int K = GRT_K(k);
    return (x * y.d[K] - y.v * 0.0f) / d;
  });
}

}  // namespace grt
