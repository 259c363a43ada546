// Complex arithmetic on explicit (re, im) pairs: the kernel's side of
// `ops/complexify.py`, function for function.
//
// A pair Cx<R, I> holds each part as a dual number (dual.cuh), a float (an
// expression of parameters alone, rounded once from double), a double (such
// an expression while `from_params` evaluates it), or Zero (sym.cuh): the
// structural zero that the torch form writes as None.  The generic z*
// helpers fold Zero away at compile time, so that a real value carried as a
// pair costs what the real value costs, and Zero keeps the pair type out of
// every metric that has no complex value.  Otherwise each helper is the
// plain operator, so a pair function applies the same operations in the same
// order as its torch twin (the product, the quotient through one reciprocal,
// z * conj(z)).  `csqrt` of a dual pair is the principal root by the
// half-angle form with the reference's derivative dw = dz / (2 w), |w|^2
// floored at 1e-37 (the half-angle form's own derivative is inf * 0 at a
// positive real): torch's `_Csqrt.jvp`, term for term.  The double
// functions (`csqrt`, `cabs`, `cpow` of double pairs) are those of the torch
// form's Python-float path, on the host's libm as Python's math module.
#pragma once

#include <math.h>

#include <type_traits>

#include "sym.cuh"

namespace grt {

template <class R, class I>
struct Cx {
  R re;
  I im;
};

template <class R, class I>
GRT_HD GRT_INLINE Cx<R, I> make_cx(const R& re, const I& im) {
  return {re, im};
}

// The parts of a pair, or of a real value.
template <class T>
struct AsPair {
  using type = Cx<T, Zero>;
  GRT_HD static type of(const T& x) { return {x, Zero{}}; }
};
template <class R, class I>
struct AsPair<Cx<R, I>> {
  using type = Cx<R, I>;
  GRT_HD static type of(const Cx<R, I>& x) { return x; }
};
template <class T>
GRT_HD GRT_INLINE typename AsPair<T>::type pair(const T& x) {
  return AsPair<T>::of(x);
}

// -- parts: Zero is an exact zero --------------------------------------------

template <class A, class B>
GRT_HD GRT_INLINE auto zadd(const A& a, const B& b) {
  if constexpr (IsZero<A>::value) {
    return b;
  } else if constexpr (IsZero<B>::value) {
    return a;
  } else {
    return a + b;
  }
}

template <class A>
GRT_HD GRT_INLINE auto zneg(const A& a) {
  if constexpr (IsZero<A>::value) {
    return Zero{};
  } else {
    return -a;
  }
}

template <class A, class B>
GRT_HD GRT_INLINE auto zsub(const A& a, const B& b) {
  if constexpr (IsZero<B>::value) {
    return a;
  } else if constexpr (IsZero<A>::value) {
    return -b;
  } else {
    return a - b;
  }
}

template <class A, class B>
GRT_HD GRT_INLINE auto zmul(const A& a, const B& b) {
  if constexpr (IsZero<A>::value || IsZero<B>::value) {
    return Zero{};
  } else {
    return a * b;
  }
}

// 1/x of a dual (the division-free tangent), a float or a double.
template <unsigned A>
GRT_HD GRT_INLINE Dual<A> zrecip(const Dual<A>& x) {
  return grt_recip(x);
}
GRT_HD GRT_INLINE float zrecip(float x) { return 1.0f / x; }
GRT_HD GRT_INLINE double zrecip(double x) { return 1.0 / x; }

// -- pairs ----------------------------------------------------------------

template <class A, class B>
GRT_HD GRT_INLINE auto cadd(const A& x, const B& y) {
  const auto a = pair(x);
  const auto b = pair(y);
  return make_cx(zadd(a.re, b.re), zadd(a.im, b.im));
}

template <class A, class B>
GRT_HD GRT_INLINE auto csub(const A& x, const B& y) {
  const auto a = pair(x);
  const auto b = pair(y);
  return make_cx(zsub(a.re, b.re), zsub(a.im, b.im));
}

template <class A>
GRT_HD GRT_INLINE auto cneg(const A& x) {
  const auto a = pair(x);
  return make_cx(zneg(a.re), zneg(a.im));
}

template <class A>
GRT_HD GRT_INLINE auto conj(const A& x) {
  const auto a = pair(x);
  return make_cx(a.re, zneg(a.im));
}

template <class A>
GRT_HD GRT_INLINE auto real(const A& x) {
  return pair(x).re;
}

template <class A>
GRT_HD GRT_INLINE auto imag(const A& x) {
  return pair(x).im;
}

template <class A, class B>
GRT_HD GRT_INLINE auto cmul(const A& x, const B& y) {
  const auto a = pair(x);
  const auto b = pair(y);
  return make_cx(zsub(zmul(a.re, b.re), zmul(a.im, b.im)),
                 zadd(zmul(a.re, b.im), zmul(a.im, b.re)));
}

// a / b through one reciprocal: of b alone where b is real, else of |b|^2.
template <class A, class B>
GRT_HD GRT_INLINE auto cdiv(const A& x, const B& y) {
  const auto a = pair(x);
  const auto b = pair(y);
  if constexpr (IsZero<decltype(b.im)>::value) {
    const auto inv = zrecip(b.re);
    return make_cx(zmul(a.re, inv), zmul(a.im, inv));
  } else {
    const auto inv = zrecip(zadd(zmul(b.re, b.re), zmul(b.im, b.im)));
    return make_cx(zmul(zadd(zmul(a.re, b.re), zmul(a.im, b.im)), inv),
                   zmul(zsub(zmul(a.im, b.re), zmul(a.re, b.im)), inv));
  }
}

// z * conj(z), real.
template <class A>
GRT_HD GRT_INLINE auto scm(const A& x) {
  return real(cmul(x, conj(x)));
}

// -- float and double parts -------------------------------------------------

// A pair of parameter expressions (double) rounded to float where it will
// meet a coordinate (the torch form's c32).
GRT_HD GRT_INLINE float f32(double x) { return static_cast<float>(x); }
GRT_HD GRT_INLINE Zero f32(Zero) { return {}; }
template <class R, class I>
GRT_HD GRT_INLINE auto f32(const Cx<R, I>& a) {
  return make_cx(f32(a.re), f32(a.im));
}

template <class T>
struct IsDual : std::false_type {};
template <unsigned A>
struct IsDual<Dual<A>> : std::true_type {};

GRT_HD GRT_INLINE double to_double(double x) { return x; }
GRT_HD GRT_INLINE double to_double(Zero) { return 0.0; }

// A part of a pair as the dual csqrt takes: a dual as it is, a float as a
// constant (dual.cuh's as_dual), Zero as the constant 0 (the torch form
// fills it with zeros).
GRT_HD GRT_INLINE Dual<0u> as_dual(Zero) { return dual_constant(0.0f); }

GRT_HD GRT_INLINE float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// The principal sqrt of a dual pair with the derivative dz / (2 w).
template <unsigned A, unsigned B>
GRT_HD GRT_INLINE Cx<Dual<(A | B)>, Dual<(A | B)>> csqrt_dual(
    const Dual<A>& ar, const Dual<B>& ai) {
  const float m = sqrtf(ar.v * ar.v + ai.v * ai.v);
  const float wr = sqrtf(clamp_min(0.5f * (m + ar.v), 0.0f));
  const float im = sqrtf(clamp_min(0.5f * (m - ar.v), 0.0f));
  const float wi = ai.v < 0.0f ? -im : im;
  const float inv = 0.5f * (1.0f / clamp_min(wr * wr + wi * wi, 1e-37f));
  const auto re_t = make_dual<(A | B)>(wr, [&](auto k) {
    constexpr int K = GRT_K(k);
    if constexpr (live(A, K) && live(B, K))
      return (ar.d[K] * wr + ai.d[K] * wi) * inv;
    else if constexpr (live(A, K))
      return (ar.d[K] * wr) * inv;
    else
      return (ai.d[K] * wi) * inv;
  });
  const auto im_t = make_dual<(A | B)>(wi, [&](auto k) {
    constexpr int K = GRT_K(k);
    if constexpr (live(A, K) && live(B, K))
      return (ai.d[K] * wr - ar.d[K] * wi) * inv;
    else if constexpr (live(A, K))
      return (-(ar.d[K] * wi)) * inv;
    else
      return (ai.d[K] * wr) * inv;
  });
  return {re_t, im_t};
}

// The principal sqrt of a double pair (the half-angle form).
GRT_HD GRT_INLINE Cx<double, double> csqrt_double(double ar, double ai) {
  const double m = sqrt(ar * ar + ai * ai);
  const double a = 0.5 * (m + ar), b = 0.5 * (m - ar);
  // Python's max(x, 0.0).
  const double re = sqrt(0.0 > a ? 0.0 : a);
  const double im = sqrt(0.0 > b ? 0.0 : b);
  return {re, ai < 0.0 ? -im : im};
}

template <class R, class I>
GRT_HD GRT_INLINE auto csqrt(const Cx<R, I>& a) {
  if constexpr (IsDual<R>::value || IsDual<I>::value) {
    return csqrt_dual(as_dual(a.re), as_dual(a.im));
  } else {
    return csqrt_double(to_double(a.re), to_double(a.im));
  }
}
GRT_HD GRT_INLINE Cx<double, double> csqrt(double a) {
  return csqrt_double(a, 0.0);
}

// |z| of a double pair.
GRT_HD GRT_INLINE double cabs(const Cx<double, double>& a) {
  return sqrt(a.re * a.re + a.im * a.im);
}

// |z| of a dual pair with the reference's derivative
// (re dre + im dim) / max(|z|, 1e-37): torch's `_Cabs.jvp`, term for term.
template <unsigned A, unsigned B>
GRT_HD GRT_INLINE Dual<(A | B)> cabs_dual(const Dual<A>& ar,
                                          const Dual<B>& ai) {
  const float m = sqrtf(ar.v * ar.v + ai.v * ai.v);
  const float inv = 1.0f / clamp_min(m, 1e-37f);
  return make_dual<(A | B)>(m, [&](auto k) {
    constexpr int K = GRT_K(k);
    if constexpr (live(A, K) && live(B, K))
      return (ar.v * ar.d[K] + ai.v * ai.d[K]) * inv;
    else if constexpr (live(A, K))
      return (ar.v * ar.d[K]) * inv;
    else
      return (ai.v * ai.d[K]) * inv;
  });
}

// z ** c of a double pair by the polar form, |z| floored at 1e-37.
GRT_HD GRT_INLINE Cx<double, double> cpow(const Cx<double, double>& a,
                                          double c) {
  const double m = cabs(a);
  const double theta = atan2(a.im, a.re);
  const double mc = pow(m < 1e-37 ? 1e-37 : m, c);
  return {mc * cos(c * theta), mc * sin(c * theta)};
}

}  // namespace grt
