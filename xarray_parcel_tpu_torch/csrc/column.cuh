// Device helpers shared by the port's kernels: the working type's
// transcendentals, NaN and infinity, the NaN-keeping sign, and, for the two
// that solve a column with one warp, its lanes striding over the levels
// (fused_cape.cu, diag_tail.cu), the warp reductions and the duplicate-aware
// interpolation anchors of ops/interp.py, and, for the three that stage a
// tile of rows in shared memory (neighbors.cu, mix_layer.cu,
// most_unstable.cu), the tile's walk, a group's max and the launch.
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
__device__ __forceinline__ float dpow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double dpow(double x, double y) {
  return pow(x, y);
}
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

// --- warp reductions (every lane of the warp must take part) -----------------
// Butterfly (xor) reductions: every lane ends with the result, and because
// each step combines a pair commutatively, every lane ends with the same
// bits.  None of them is given a NaN: the kernels reduce sentinels
// (+-inf, 0) and map them to NaN afterwards, as their serial loops did.

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarp = 32;

__device__ __forceinline__ int lane_id() { return threadIdx.x % kWarp; }

template <typename T> __device__ __forceinline__ T shfl_xor(T v, int m) {
  return __shfl_xor_sync(kFullMask, v, m);
}

template <typename T> __device__ __forceinline__ T warp_min(T v) {
  for (int m = kWarp / 2; m > 0; m >>= 1) {
    const T o = shfl_xor(v, m);
    v = o < v ? o : v;
  }
  return v;
}

template <typename T> __device__ __forceinline__ T warp_max(T v) {
  for (int m = kWarp / 2; m > 0; m >>= 1) {
    const T o = shfl_xor(v, m);
    v = o > v ? o : v;
  }
  return v;
}

template <typename T> __device__ __forceinline__ T warp_sum(T v) {
  for (int m = kWarp / 2; m > 0; m >>= 1) v += shfl_xor(v, m);
  return v;
}

__device__ __forceinline__ bool warp_any(bool b) {
  return __any_sync(kFullMask, b);
}

__device__ __forceinline__ unsigned warp_ballot(bool b) {
  return __ballot_sync(kFullMask, b);
}

// Sum of a per-lane partial that only the lanes in `holders` can have
// made non-zero (every other lane's is 0): zero when no lane holds one, a
// broadcast from the lane that does in the usual case of one, else the
// warp sum -- the same bits as a warp sum of every lane's partial.
template <typename T>
__device__ __forceinline__ T held_sum(T v, unsigned holders) {
  if (holders == 0) return T(0);
  if (__popc(holders) == 1) return __shfl_sync(kFullMask, v, __ffs(holders) - 1);
  return warp_sum((holders >> lane_id()) & 1u ? v : T(0));
}

// Extremal x with the largest y among the entries at it (the serial loops'
// tie_max rule): the x furthest in the direction `kMax` wins, and the
// lanes at it give the largest y.  y is never NaN here (-inf stands for an
// all-NaN tie).
template <bool kMax, typename T>
__device__ __forceinline__ void warp_tie(T& x, T& y) {
  const T best = kMax ? warp_max(x) : warp_min(x);
  const unsigned at = warp_ballot(x == best);
  y = __popc(at) == 1 ? __shfl_sync(kFullMask, y, __ffs(at) - 1)
                      : warp_max(x == best ? y : -Num<T>::inf());
  x = best;
}

// Interpolation anchors of two variables at one log-pressure target
// (ops/interp.py interp_many with log=True): the closest log-pressure at
// or above and at or below the target, with the sums and counts of each
// variable's non-NaN values there, so that duplicate levels average.
// With `linear` the coordinate is the pressure itself (log=False): the
// caller gives bound() pressures and a pressure target.
// Found across a warp in four steps, which keep few registers live while
// the lanes walk their levels:
//   bound()   each lane, over its levels: its closest log-pressures and the
//             first of its levels at each;
//   reduce()  the warp's extremes are the column's anchors;
//   gather()  the lanes holding a level there add its values, read by its
//             index; a lane with more than one (duplicates 32 levels
//             apart) walks its levels again;
//   finish()  the sums of the lanes at each anchor -- usually one lane,
//             whose sums are broadcast.
// Only the order of the sums over duplicates in different lanes can differ
// from the serial fold over the levels.
template <typename T> struct Anchors {
  T at;                  // the target, in coordinate space (NaN: none)
  bool linear;           // coordinates are pressures, not log-pressures
  T cb, ca;              // closest log-pressure >= at, and <= at
  T sb[2], sa[2];        // sums of each variable's non-NaN values there
  int nb[2], na[2];
  int ib, ia;            // this lane's first level at cb, at ca
  bool db, da;           // ... and whether it has another there
  bool hb, ha;           // this lane holds the column's cb, ca

  __device__ explicit Anchors(T target, bool linear = false)
      : at(target), linear(linear) {
    cb = Num<T>::inf();
    ca = -Num<T>::inf();
    ib = ia = 0;
    db = da = false;
    for (int v = 0; v < 2; ++v) {
      sb[v] = sa[v] = T(0);
      nb[v] = na[v] = 0;
    }
  }

  // Level i, of coordinate lp (NaN never anchors).
  __device__ void bound(T lp, int i) {
    if (lp >= at) {
      if (lp < cb) {
        cb = lp;
        ib = i;
        db = false;
      } else if (lp == cb) {
        db = true;
      }
    }
    if (lp <= at) {
      if (lp > ca) {
        ca = lp;
        ia = i;
        da = false;
      } else if (lp == ca) {
        da = true;
      }
    }
  }

  __device__ void reduce() {
    const T inf = Num<T>::inf();
    const T gb = warp_min(cb), ga = warp_max(ca);
    hb = gb != inf && cb == gb;
    ha = ga != -inf && ca == ga;
    cb = gb;
    ca = ga;
  }

  // The column's rows: log-pressures from p, the variables x0 and x1.
  __device__ void gather(const T* p, const T* x0, const T* x1, int L) {
    if (hb && !db) add(sb, nb, x0[ib], x1[ib]);
    if (ha && !da) add(sa, na, x0[ia], x1[ia]);
    if ((hb && db) || (ha && da))
      for (int i = lane_id(); i < L; i += kWarp) {
        const T lp = linear ? p[i] : dlog(p[i]);
        if (hb && db && lp == cb) add(sb, nb, x0[i], x1[i]);
        if (ha && da && lp == ca) add(sa, na, x0[i], x1[i]);
      }
  }

  static __device__ void add(T* s, int* n, T x0, T x1) {
    if (!isnan_(x0)) { s[0] += x0; ++n[0]; }
    if (!isnan_(x1)) { s[1] += x1; ++n[1]; }
  }

  __device__ void finish() {
    const unsigned lanes_b = warp_ballot(hb), lanes_a = warp_ballot(ha);
    for (int v = 0; v < 2; ++v) {
      sb[v] = held_sum(sb[v], lanes_b);
      nb[v] = held_sum(nb[v], lanes_b);
      sa[v] = held_sum(sa[v], lanes_a);
      na[v] = held_sum(na[v], lanes_a);
    }
  }

  // Interpolated value of variable v; NaN for a target outside the column.
  __device__ T value(int v) const {
    const T frac = anchor_frac(at, or_nan(cb, Num<T>::inf()),
                               or_nan(ca, -Num<T>::inf()));
    return interp_sums(sb[v], nb[v], sa[v], na[v], frac);
  }
};

// --- tiles of rows (neighbors.cu, mix_layer.cu, most_unstable.cu) ----------
// A block owns a tile of consecutive rows of L levels, staged in shared
// memory at an odd pitch (L | 1), so that threads on different rows fall
// on distinct banks, with coalesced loads, and written back with coalesced
// stores.

// The block's walk over the n = rows x L levels of its tile, level e being
// row e / L, level e % L: each of the kBlock threads steps by kBlock
// levels from its own, carrying (row, level) without a divide, and calls
// f(e, row, level).
template <int kBlock, int kUnroll, typename F>
__device__ __forceinline__ void tile_walk(int n, int L, F&& f) {
  const int step_r = kBlock / L, step_c = kBlock - step_r * L;
  int r = threadIdx.x / L, c = threadIdx.x - r * L;
#pragma unroll (kUnroll)
  for (int e = threadIdx.x; e < n; e += kBlock) {
    f(e, r, c);
    r += step_r;
    c += step_c;
    if (c >= L) {
      c -= L;
      ++r;
    }
  }
}

// The largest v of a group of G consecutive lanes (G a power of two up to
// a warp), on every lane of it.  None is given a NaN.
template <typename T> __device__ __forceinline__ T group_max(T v, int G) {
  for (int m = G / 2; m > 0; m >>= 1) {
    const T o = __shfl_xor_sync(kFullMask, v, m, G);
    if (o > v) v = o;
  }
  return v;
}

// Rows a tile, where a tile of R rows takes base + R * per_row shared
// bytes: as many as fit `budget`, up to `most`, at least one (a longer
// row takes a block alone).
inline int64_t fit_rows(int64_t base, int64_t per_row, int64_t budget,
                        int64_t most) {
  int64_t rows = (budget - base) / per_row;
  if (rows > most) rows = most;
  return rows < 1 ? 1 : rows;
}

// The shared memory a block may opt in to on the current card, in bytes;
// 0 where the query fails.
inline int64_t smem_optin() {
  int dev, bytes;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

// Launch `kernel` on `stream`, `blocks` blocks of kBlock threads with
// `bytes` of dynamic shared memory each, opting in past 48 KiB.  Returns
// the CUDA error (0 on success), cudaErrorInvalidValue past the card's
// opt-in limit.
template <int kBlock, typename... P, typename... A>
int launch_tiles(void (*kernel)(P...), int64_t blocks, int64_t bytes,
                 void* stream, A... args) {
  if (bytes > smem_optin()) return (int)cudaErrorInvalidValue;
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, kBlock, (size_t)bytes, (cudaStream_t)stream>>>(
      args...);
  return (int)cudaGetLastError();
}

}  // namespace
