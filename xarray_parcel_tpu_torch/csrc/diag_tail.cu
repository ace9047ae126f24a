// Scalar-diagnostics tail for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel benchmarks/diag_kernel_ab.py::_diag_kernel
// (launched by diag_fused), whose body _diag_body is the tail both fused
// pipelines end with.  The plain PyTorch twin is
// xarray_parcel_tpu_torch/diagnostics.py::_diag_body; this file computes
// the same values, output for output:
//   t850, td850   log-pressure interpolation at 850 hPa (the DCI anchors);
//   lapse, t500   the 700-500 hPa lapse rate and its 500 hPa temperature;
//   freezing      the lowest height where T crosses 273.15 K;
//   melting       the same for the Knox one-third wet bulb.
//
// What bounds it: device memory.  The kernel must read p, t, td and h
// once, 16 bytes (float32) per level and column, and write 6 values per
// column: at 786,432 x 90 float32 that is 1,151 MB, 0.34 ms at 3.35 TB/s.
// The arithmetic is a log and a few dozen flops per level.
//
// Design: one warp per column, kWarps = 4 columns a block.  Lane l
// takes levels l, l+32, l+64, ..., so every load of the warp is one
// contiguous run of the row.  In the one pass over the levels each lane
// keeps its closest levels to the three interpolation targets (Anchors in
// column.cuh, which fused_cape.cu pass A uses for the LCL) and folds the
// freezing and melting crossings of the gaps it owns, taking the level
// below from its neighbour lane (lane 0 from lane 31 of the previous
// stride), into a running minimum crossing height, by value, as nanmin
// over find_intersections does: not the first crossing from the bottom.
// The warp then reduces them; the lanes holding a level at an anchor sum
// its values, and lanes 0-5 compute the six outputs side by side.  The
// ragged edges (any B, any L) are masked here; the TPU form's fixed
// (256, 90) blocks are not carried over.
//
// What limits it (kernel_ab.py on an H100 at 700 W): 1.36 ms at the shape
// above, four times the bound.  The per-column reductions and epilogue,
// which the warp does once for all its lanes, are about 70% of it (1.23
// ms at L = 45, 1.36 at 90, 1.83 at 180).  8 columns a block measured the
// same in float32 (1.35 ms) and slower in float64 (2.62 against 2.41 ms).
//
// Built with -fmad=false (see _build.py): the crossing heights and the
// anchor selections compare values that the twin computes op by op.
//
// Output rows, each (B,): t850, td850, lapse_rate_700_500, temp_500,
// freezing_level, melting_level.

#include "thermo.cuh"

namespace {

constexpr int kWarps = 4;   // columns per block (128 threads)

// Fold the crossing of d = curve - 273.15 over height in the gap between
// levels (d0, h0) and (d1, h1) into the running minimum (ops/intersect.py
// with linear x).  A gap whose sign pair holds a NaN is a crossing with a
// NaN height, which nanmin skips; a level at exactly 273.15 K has sign 0,
// which differs from +-1 and so counts.
template <typename T>
__device__ __forceinline__ void lowest_crossing(T d0, T h0, T d1, T h1,
                                                T& lowest) {
  if (nan_sign(d0) == nan_sign(d1)) return;   // a NaN sign never equals
  if (isnan_(d0) || isnan_(d1) || isnan_(h0) || isnan_(h1)) return;
  T dy = d1 - d0;
  if (dy == T(0)) dy = T(1);
  const T x = (d1 * h0 - d0 * h1) / dy;
  if (x < lowest) lowest = x;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * kWarp)
diag_tail_kernel(const T* __restrict__ p, const T* __restrict__ t,
                 const T* __restrict__ td, const T* __restrict__ h,
                 T* __restrict__ out, int64_t B, int L) {
  const int lane = threadIdx.x % kWarp;
  const int64_t col = (int64_t)blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (col >= B) return;   // the whole warp: no lane is left to reduce with
  const T nan = Num<T>::nan(), inf = Num<T>::inf();
  const T* pc = p + col * L;
  const T* tc = t + col * L;
  const T* tdc = td + col * L;
  const T* hc = h + col * L;

  // One pass over the levels: the anchors' bounds and the crossings.
  Anchors<T> a850(dlog(T(850))), a700(dlog(T(700))), a500(dlog(T(500)));
  T freezing = inf, melting = inf;
  T dt_below = nan, dw_below = nan, h_below = nan;   // level base - 1
  for (int base = 0; base < L; base += kWarp) {
    const int i = base + lane;
    const bool in = i < L;
    const T pi = in ? pc[i] : nan, ti = in ? tc[i] : nan;
    const T tdi = in ? tdc[i] : nan, hi = in ? hc[i] : nan;
    const T lp = dlog(pi);            // NaN past the end: never anchors
    a850.bound(lp, i);
    a700.bound(lp, i);
    a500.bound(lp, i);
    const T dt = ti - T(kZeroC);
    const T wet_bulb = ti - T(1.0 / 3.0) * (ti - tdi);
    const T dw = wet_bulb - T(kZeroC);
    // The level below: the neighbour lane's, or the previous stride's last.
    T dt0 = __shfl_up_sync(kFullMask, dt, 1);
    T dw0 = __shfl_up_sync(kFullMask, dw, 1);
    T h0 = __shfl_up_sync(kFullMask, hi, 1);
    if (lane == 0) {
      dt0 = dt_below;
      dw0 = dw_below;
      h0 = h_below;
    }
    if (in && i > 0) {
      lowest_crossing(dt0, h0, dt, hi, freezing);
      lowest_crossing(dw0, h0, dw, hi, melting);
    }
    dt_below = __shfl_sync(kFullMask, dt, kWarp - 1);
    dw_below = __shfl_sync(kFullMask, dw, kWarp - 1);
    h_below = __shfl_sync(kFullMask, hi, kWarp - 1);
  }
  freezing = warp_min(freezing);
  melting = warp_min(melting);

  // The column's anchors; the lanes holding a level there add its values.
  a850.reduce();
  a700.reduce();
  a500.reduce();
  a850.gather(pc, tc, tdc, L);
  a700.gather(pc, tc, hc, L);
  a500.gather(pc, tc, hc, L);
  a850.finish();
  a700.finish();
  a500.finish();

  // Lane v < 6 interpolates variable v % 2 at anchor v / 2 (t850, td850,
  // t700, h700, t500, h500): one instruction stream for all six.
  const bool odd = lane & 1;
  auto pick = [&](auto x850, auto x700, auto x500) {
    return lane < 2 ? x850 : (lane < 4 ? x700 : x500);
  };
  const T at = pick(a850.at, a700.at, a500.at);
  const T cb = pick(a850.cb, a700.cb, a500.cb);
  const T ca = pick(a850.ca, a700.ca, a500.ca);
  const T sb = odd ? pick(a850.sb[1], a700.sb[1], a500.sb[1])
                   : pick(a850.sb[0], a700.sb[0], a500.sb[0]);
  const T sa = odd ? pick(a850.sa[1], a700.sa[1], a500.sa[1])
                   : pick(a850.sa[0], a700.sa[0], a500.sa[0]);
  const int nb = odd ? pick(a850.nb[1], a700.nb[1], a500.nb[1])
                     : pick(a850.nb[0], a700.nb[0], a500.nb[0]);
  const int na = odd ? pick(a850.na[1], a700.na[1], a500.na[1])
                     : pick(a850.na[0], a700.na[0], a500.na[0]);
  const T x = interp_sums(sb, nb, sa, na,
                          anchor_frac(at, or_nan(cb, inf), or_nan(ca, -inf)));
  const T t700 = __shfl_sync(kFullMask, x, 2);
  const T h700 = __shfl_sync(kFullMask, x, 3);
  const T t500 = __shfl_sync(kFullMask, x, 4);
  const T h500 = __shfl_sync(kFullMask, x, 5);
  // Lane r writes output row r.
  T o = x;                                               // t850, td850
  if (lane == 2) o = (t500 - t700) / ((h500 - h700) / T(1000));
  if (lane == 3) o = t500;
  if (lane == 4) o = or_nan(freezing, inf);
  if (lane == 5) o = or_nan(melting, inf);
  if (lane < 6) out[lane * B + col] = o;
}

template <typename T>
int launch(const void* p, const void* t, const void* td, const void* h,
           void* out, int64_t B, int L, void* stream) {
  const int64_t blocks = (B + kWarps - 1) / kWarps;
  diag_tail_kernel<T><<<(unsigned)blocks, kWarps * kWarp, 0,
                        (cudaStream_t)stream>>>(
      (const T*)p, (const T*)t, (const T*)td, (const T*)h, (T*)out, B, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; `out` is (6, B).  Returns cudaGetLastError() (0 on
// success).
int diag_tail_f32(const void* p, const void* t, const void* td,
                  const void* h, void* out, int64_t B, int L, void* stream) {
  return launch<float>(p, t, td, h, out, B, L, stream);
}

int diag_tail_f64(const void* p, const void* t, const void* td,
                  const void* h, void* out, int64_t B, int L, void* stream) {
  return launch<double>(p, t, td, h, out, B, L, stream);
}

}  // extern "C"
