// A symmetric 4x4 metric as a set of typed entries, and the structural zero.
//
// A metric function returns `sym(entry<0, 0>(...), entry<1, 1>(...), ...)`:
// one Entry<I, J, MASK> per structurally nonzero upper-triangle entry
// (I <= J), each holding a dual whose MASK says which tangents it carries
// (dual.cuh).  An entry the metric does not return is absent: `gval` and
// `gtan` give it the type Zero, as they give a tangent an entry does not
// carry.  The helpers pmul, padd, psub and pneg fold Zero away at compile
// time, so that the inverse and the Christoffel contraction of march.cuh
// hold only the surviving terms; they are the `None`-folding helpers of
// the plain torch form (ops/geometry.py: _pmul, _padd, _psub, _pneg), with
// which that code is written out once for every sparsity.
#pragma once

#include "dual.cuh"

namespace grt {

struct Zero {};

template <class T>
struct IsZero {
  static constexpr bool value = false;
};
template <>
struct IsZero<Zero> {
  static constexpr bool value = true;
};

GRT_HD GRT_INLINE float pmul(float x, float y) { return x * y; }
GRT_HD GRT_INLINE Zero pmul(Zero, float) { return {}; }
GRT_HD GRT_INLINE Zero pmul(float, Zero) { return {}; }
GRT_HD GRT_INLINE Zero pmul(Zero, Zero) { return {}; }

GRT_HD GRT_INLINE float padd(float x, float y) { return x + y; }
GRT_HD GRT_INLINE float padd(Zero, float y) { return y; }
GRT_HD GRT_INLINE float padd(float x, Zero) { return x; }
GRT_HD GRT_INLINE Zero padd(Zero, Zero) { return {}; }

GRT_HD GRT_INLINE float psub(float x, float y) { return x - y; }
GRT_HD GRT_INLINE float psub(Zero, float y) { return -y; }
GRT_HD GRT_INLINE float psub(float x, Zero) { return x; }
GRT_HD GRT_INLINE Zero psub(Zero, Zero) { return {}; }

GRT_HD GRT_INLINE float pneg(float x) { return -x; }
GRT_HD GRT_INLINE Zero pneg(Zero) { return {}; }

GRT_HD GRT_INLINE float to_float(float x) { return x; }
GRT_HD GRT_INLINE float to_float(Zero) { return 0.0f; }

template <int I, int J, unsigned MASK>
struct Entry {
  static_assert(0 <= I && I <= J && J < 4, "an upper-triangle entry");
  Dual<MASK> x;
};

template <int I, int J, unsigned MASK>
GRT_HD GRT_INLINE Entry<I, J, MASK> entry(const Dual<MASK>& x) {
  return {x};
}

// A constant entry (no tangent).
template <int I, int J>
GRT_HD GRT_INLINE Entry<I, J, 0u> entry(float c) {
  return {dual_constant(c)};
}

template <class... E>
struct Sym : E... {
  GRT_HD GRT_INLINE explicit Sym(const E&... e) : E(e)... {}
};

template <class... E>
GRT_HD GRT_INLINE Sym<E...> sym(const E&... e) {
  return Sym<E...>(e...);
}

// The dual of entry (I, J) of a Sym, or Zero when it has none (a pointer to
// a base class is a better conversion than one to void).
template <int I, int J, unsigned MASK>
GRT_HD GRT_INLINE Dual<MASK> fetch(const Entry<I, J, MASK>* e) {
  return e->x;
}
template <int I, int J>
GRT_HD GRT_INLINE Zero fetch(const void*) {
  return {};
}

// g_IJ (either order of the indices): float, or Zero.
template <int I, int J, class S>
GRT_HD GRT_INLINE auto gval(const S& g) {
  auto e = fetch<(I < J ? I : J), (I < J ? J : I)>(&g);
  if constexpr (IsZero<decltype(e)>::value) {
    return Zero{};
  } else {
    return e.v;
  }
}

// Tangent K of g_IJ: float, or Zero when the entry is absent or does not
// carry that tangent.
template <int K, int I, int J, class S>
GRT_HD GRT_INLINE auto gtan(const S& g) {
  auto e = fetch<(I < J ? I : J), (I < J ? J : I)>(&g);
  if constexpr (IsZero<decltype(e)>::value) {
    return Zero{};
  } else if constexpr (live(decltype(e)::mask, K)) {
    return e.d[K];
  } else {
    return Zero{};
  }
}

}  // namespace grt
