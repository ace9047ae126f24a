// Device helpers shared by the port's kernels (fused_cape.cu, diag_tail.cu):
// the working type's transcendentals, NaN and infinity, the NaN-keeping
// sign, and the duplicate-aware running anchors of ops/interp.py.
//
// The helpers sit in an anonymous namespace, so every kernel file that
// includes them keeps its own internal copies.  _build.py hashes this file
// with the sources: an edited header builds a new library.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float dexp(float x) { return expf(x); }
__device__ __forceinline__ double dexp(double x) { return exp(x); }
__device__ __forceinline__ float dlog(float x) { return logf(x); }
__device__ __forceinline__ double dlog(double x) { return log(x); }
__device__ __forceinline__ float dabs(float x) { return fabsf(x); }
__device__ __forceinline__ double dabs(double x) { return fabs(x); }

template <typename T> struct Num;
template <> struct Num<float> {
  static __device__ __forceinline__ float nan() {
    return __int_as_float(0x7fffffff);
  }
  static __device__ __forceinline__ float inf() {
    return __int_as_float(0x7f800000);
  }
  static constexpr double eps = 1.1920928955078125e-07;
};
template <> struct Num<double> {
  static __device__ __forceinline__ double nan() {
    return __longlong_as_double(0x7ff8000000000000LL);
  }
  static __device__ __forceinline__ double inf() {
    return __longlong_as_double(0x7ff0000000000000LL);
  }
  static constexpr double eps = 2.220446049250313e-16;
};

template <typename T> __device__ __forceinline__ bool isnan_(T x) {
  return x != x;
}

// sign(d) that keeps NaN (ops/safe.py nan_sign): a NaN sign differs from
// every sign, itself included, so a NaN level counts as a crossing.
template <typename T> __device__ __forceinline__ T nan_sign(T d) {
  return d > T(0) ? T(1) : (d < T(0) ? T(-1) : (d == T(0) ? T(0)
                                                         : Num<T>::nan()));
}

// Duplicate-aware interpolation from the masked sums at the two anchors
// (ops/interp.py): nanmean before/after, passthrough when equal.
template <typename T>
__device__ __forceinline__ T interp_sums(T sb, int nb, T sa, int na,
                                         T frac) {
  const T xb = nb > 0 ? sb / T(nb) : Num<T>::nan();
  const T xa = na > 0 ? sa / T(na) : Num<T>::nan();
  return xb == xa ? xb : xb + (xa - xb) * frac;
}

template <typename T>
__device__ __forceinline__ T anchor_frac(T at, T before, T after) {
  T span = after - before;
  if (!(span != T(0) && span == span)) span = T(1);
  return (at - before) / span;
}

template <typename T>
__device__ __forceinline__ T or_nan(T v, T sentinel) {
  return v == sentinel ? Num<T>::nan() : v;
}

// Running interpolation anchors of two variables at one log-pressure
// target (ops/interp.py interp_many with log=True): the closest
// log-pressure at or above and at or below the target, with the sums and
// counts of each variable's non-NaN values there -- reset when a closer
// anchor appears, ties folded in, so duplicate levels average.
template <typename T> struct Anchors {
  T at;                  // the target, already in log space (NaN: none)
  T cb, ca;              // closest log-pressure >= at, and <= at
  T sb[2], sa[2];        // sums of each variable's non-NaN values there
  int nb[2], na[2];

  __device__ explicit Anchors(T log_target) : at(log_target) {
    cb = Num<T>::inf();
    ca = -Num<T>::inf();
    for (int v = 0; v < 2; ++v) {
      sb[v] = sa[v] = T(0);
      nb[v] = na[v] = 0;
    }
  }

  // Level with log-pressure lp (NaN never anchors) and values x0, x1.
  __device__ void add(T lp, T x0, T x1) {
    const T x[2] = {x0, x1};
    if (lp >= at) {
      if (lp < cb) {
        cb = lp;
        for (int v = 0; v < 2; ++v) { sb[v] = T(0); nb[v] = 0; }
      }
      if (lp == cb)
        for (int v = 0; v < 2; ++v)
          if (!isnan_(x[v])) { sb[v] += x[v]; ++nb[v]; }
    }
    if (lp <= at) {
      if (lp > ca) {
        ca = lp;
        for (int v = 0; v < 2; ++v) { sa[v] = T(0); na[v] = 0; }
      }
      if (lp == ca)
        for (int v = 0; v < 2; ++v)
          if (!isnan_(x[v])) { sa[v] += x[v]; ++na[v]; }
    }
  }

  // Interpolated value of variable v; NaN for a target outside the column.
  __device__ T value(int v) const {
    const T frac = anchor_frac(at, or_nan(cb, Num<T>::inf()),
                               or_nan(ca, -Num<T>::inf()));
    return interp_sums(sb[v], nb[v], sa[v], na[v], frac);
  }
};

}  // namespace
