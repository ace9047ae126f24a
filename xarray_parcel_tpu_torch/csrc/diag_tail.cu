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
// Design: one thread per column and one pass over its levels.  The three
// interpolation targets keep running anchors (Anchors in column.cuh, which
// fused_cape.cu pass A uses for the LCL).  The two crossing sets keep the
// running minimum crossing height over all gaps, by value, as nanmin over
// find_intersections does: not the first crossing from the bottom.  The
// ragged edge (any B, any L) is masked here; the TPU form's fixed
// (256, 90) blocks are not carried over.
//
// What bounds it: memory.  The kernel reads p, t, td and h once, 16 bytes
// (float32) per level and column, and writes 6 values per column; the
// arithmetic is a log and a few dozen flops per level.  Thread i reads row
// i of the row-major (B, L) inputs, so neighbouring threads touch
// addresses L elements apart and rely on L1 to reuse each line; coalesced
// or shared-memory staged loads are later work.
//
// Built with -fmad=false (see _build.py): the crossing heights and the
// anchor selections compare values that the twin computes op by op.
//
// Output rows, each (B,): t850, td850, lapse_rate_700_500, temp_500,
// freezing_level, melting_level.

#include "column.cuh"

namespace {

constexpr double kZeroC = 273.15;

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
__global__ void __launch_bounds__(128)
diag_tail_kernel(const T* __restrict__ p, const T* __restrict__ t,
                 const T* __restrict__ td, const T* __restrict__ h,
                 T* __restrict__ out, int64_t B, int L) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  const T inf = Num<T>::inf();
  const T* pc = p + col * L;
  const T* tc = t + col * L;
  const T* tdc = td + col * L;
  const T* hc = h + col * L;

  Anchors<T> a850(dlog(T(850))), a700(dlog(T(700))), a500(dlog(T(500)));
  T freezing = inf, melting = inf;
  T dt_prev = Num<T>::nan(), dw_prev = Num<T>::nan(), h_prev = Num<T>::nan();
  for (int i = 0; i < L; ++i) {
    const T pi = pc[i], ti = tc[i], tdi = tdc[i], hi = hc[i];
    const T lp = dlog(pi);
    a850.add(lp, ti, tdi);
    a700.add(lp, ti, hi);
    a500.add(lp, ti, hi);
    const T dt = ti - T(kZeroC);
    const T wet_bulb = ti - T(1.0 / 3.0) * (ti - tdi);
    const T dw = wet_bulb - T(kZeroC);
    if (i > 0) {
      lowest_crossing(dt_prev, h_prev, dt, hi, freezing);
      lowest_crossing(dw_prev, h_prev, dw, hi, melting);
    }
    dt_prev = dt;
    dw_prev = dw;
    h_prev = hi;
  }

  const T t700 = a700.value(0), h700 = a700.value(1);
  const T t500 = a500.value(0), h500 = a500.value(1);
  T* o = out + col;
  o[0 * B] = a850.value(0);
  o[1 * B] = a850.value(1);
  o[2 * B] = (t500 - t700) / ((h500 - h700) / T(1000));
  o[3 * B] = t500;
  o[4 * B] = or_nan(freezing, inf);
  o[5 * B] = or_nan(melting, inf);
}

template <typename T>
int launch(const void* p, const void* t, const void* td, const void* h,
           void* out, int64_t B, int L, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  diag_tail_kernel<T><<<blocks, threads, 0, (cudaStream_t)stream>>>(
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
