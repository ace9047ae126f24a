// Per-column pre-pass of the fused CAPE/CIN solve for NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The JAX package leaves this O(B) work to XLA
// (xarray_parcel_tpu/fused.py, fused_cape_cin's pre-pass), which fuses it
// into a few loops.  Its plain PyTorch form,
// xarray_parcel_tpu_torch/fused.py::_prepass_twin, is some 1,800
// elementwise launches a call, each a few microseconds of card work behind
// a whole host dispatch: the host's launch rate, not the card, set the
// pace of the fused pipelines.  This kernel is that pre-pass in one launch
// and computes the same values, op for op in the input dtype:
//   * the LCL of the parcel (lcl.py: the 30-iteration fixed point on safe
//     dummies, then the LCL temperature and virtual temperature, NaN where
//     the parcel state holds a NaN) and its mixing ratio w0;
//   * the fractional curve index (adiabat.py curve_index_integrate: 12 RK4
//     substeps of dT/dln p = p * moist_lapse_rate from ln(lcl_p) to
//     ln 1100, stepping from logp0 + i*h; the family's envelope and clamp);
//   * k0, the first level of finite pressure (0 for an all-NaN column);
//   * the (B, 42) coefficient row blended from the two rows of the table
//     that bracket the index (adiabat.py blend_coeff_rows; all NaN for a
//     NaN index), and the (B, 6) scalars in fused.SCALARS order.
// A division by a constant is a multiply by its reciprocal, rounded in the
// input dtype, as the card's PyTorch divides a tensor by a Python number.
//
// What bounds it: by count, device memory.  Per column it reads the parcel
// (12 bytes in float32) and the column's leading pressure levels, and
// writes the row, the scalars and k0 (196 bytes): 786,432 columns move
// about 169 MB with the 2.4 MB table, 0.05 ms at 3.35 TB/s
// (chip_smoke.prepass_work).  What limits it is the instruction rate: the
// chain is some 6,000 instructions a column (30 powf, logs and divides for
// the LCL, 48 moist-lapse evaluations of two exp and four IEEE divides
// each for the curve index).  On an H100 at 700 W (chip_smoke.py) it takes
// 0.30 ms at that batch in float32, the plain twin 24 ms.
//
// Design: one thread per column for the scalar chain, kThreads columns a
// block; each thread scans its own column for k0 (one level unless the
// column starts with NaN levels).  The block then stages each column's
// lower curve and blend weight and its six scalars in shared memory, and
// writes its tile of rows and scalars with consecutive threads on
// consecutive addresses: the row's coefficients are read as 84 contiguous
// table values a column.
//
// Built with -fmad=false (see _build.py), as the twin's separate torch ops
// round each multiply and add on its own.

#include "thermo.cuh"

namespace {

constexpr int kThreads = 128;   // columns per block
constexpr int kCurves = 14300;  // adiabat.N_CURVES: rows of the table
constexpr int kCoef = 42;       // adiabat.N_COEF: coefficients a row

// Derived from constants.py (thermo.cuh), as the twin's torch ops take
// them (a Python number rounded to the tensor's dtype).
constexpr double kLvLv = 6254200705600.0;        // Lv * Lv, in double
constexpr double kInvKappa = 3.4999999999999996;  // 1 / kappa, in double
// adiabat.py.
constexpr double kLnPTop = 7.003065458786462;     // ln 1100 hPa
constexpr double kTMin = 173.0;
constexpr double kCurveSpacing = 0.01;            // K between curves

// dT/dln p = p * moist_lapse_rate(p, T) at p = exp(lp): adiabat.rk4_step's
// f.
template <typename T> __device__ __forceinline__ T lapse(T lp, T t) {
  const T p = dexp(lp);
  const T rs = saturation_mixing_ratio(p, t);
  const T den = T(kCpd) + T(kLvLv) * rs * T(kEpsilon) / (T(kRd) * (t * t));
  const T frac = (T(kRd) * t + T(kLv) * rs) / den;
  return p * (frac / p);
}

// adiabat.rk4_step.
template <typename T> __device__ __forceinline__ T rk4_step(T lp, T h, T t) {
  const T k1 = lapse(lp, t);
  const T k2 = lapse(lp + div_c(h, 2.0), t + div_c(h * k1, 2.0));
  const T k3 = lapse(lp + div_c(h, 2.0), t + div_c(h * k2, 2.0));
  const T k4 = lapse(lp + h, t + h * k3);
  return t + div_c(h, 6.0) * (k1 + T(2) * k2 + T(2) * k3 + k4);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
parcel_prepass_kernel(const T* __restrict__ p, const T* __restrict__ p0,
                      const T* __restrict__ t0, const T* __restrict__ td0,
                      const T* __restrict__ coeffs, T* __restrict__ row,
                      T* __restrict__ scalars, int* __restrict__ k0,
                      int64_t B, int L) {
  __shared__ int lower[kThreads];          // lower curve; -1: NaN row
  __shared__ T weight[kThreads];           // the upper curve's weight
  __shared__ T staged[kThreads * kScalars];
  const T nan = Num<T>::nan();
  const int64_t first = (int64_t)blockIdx.x * kThreads;
  const int64_t col = first + threadIdx.x;

  if (col < B) {
    const T pp = p0[col], pt = t0[col], ptd = td0[col];

    // The LCL on safe dummies (lcl.lcl).
    const bool valid = !isnan_(pp) && !isnan_(pt) && !isnan_(ptd);
    const T sp = valid ? pp : T(1000), st = valid ? pt : T(288);
    const T sd = valid ? ptd : T(283);
    const T w = saturation_mixing_ratio(sp, sd);
    T lcl_p = sp;
    for (int i = 0; i < 30; ++i) {
      const T td = dewpoint(vapor_pressure(lcl_p, w));
      lcl_p = sp * dpow(td / st, T(kInvKappa));
    }
    T lcl_t = dewpoint(vapor_pressure(lcl_p, w));
    T lcl_vt = virtual_temperature(lcl_t, mixing_ratio(lcl_t, lcl_t, lcl_p));
    if (!valid) lcl_p = lcl_t = lcl_vt = nan;

    // The fractional curve index (adiabat.curve_index_integrate).
    const bool on = !isnan_(lcl_p) && !isnan_(lcl_t) && lcl_p > T(0);
    const T lp0 = dlog(on ? lcl_p : T(1100));
    const T h = div_c(T(kLnPTop) - lp0, 12.0);
    T ts = on ? lcl_t : T(kZeroC);
    for (int i = 0; i < 12; ++i) ts = rk4_step(lp0 + T(i) * h, h, ts);
    const T fidx = div_c(ts - T(kTMin), kCurveSpacing);
    const bool ok = on && fidx >= T(-1) && fidx <= T(kCurves);

    // The bracketing rows (adiabat.blend_coeff_rows).
    int c0 = -1;
    T a = T(0);
    if (ok) {
      const T safe = fidx < T(0) ? T(0)
                   : (fidx > T(kCurves - 1) ? T(kCurves - 1) : fidx);
      T f = floor(safe);
      f = f > T(kCurves - 2) ? T(kCurves - 2) : f;
      c0 = (int)f;
      a = safe - T(c0);
      a = a < T(0) ? T(0) : (a > T(1) ? T(1) : a);
    }
    lower[threadIdx.x] = c0;
    weight[threadIdx.x] = a;

    // k0: the first level of finite pressure (ops.first_valid_index).
    const T* pc = p + col * L;
    int first_valid = 0;
    for (int i = 0; i < L; ++i) {
      if (!isnan_(pc[i])) {
        first_valid = i;
        break;
      }
    }
    k0[col] = first_valid;

    T* s = staged + threadIdx.x * kScalars;
    s[0] = lcl_p;
    s[1] = lcl_t;
    s[2] = lcl_vt;
    s[3] = mixing_ratio(pt, ptd, pp);
    s[4] = pt;
    s[5] = pp;
  }
  __syncthreads();

  // The block's tiles, consecutive threads on consecutive addresses.
  const int n = (int)(B - first < kThreads ? B - first : kThreads);
  for (int e = threadIdx.x; e < n * kScalars; e += kThreads)
    scalars[first * kScalars + e] = staged[e];
  for (int e = threadIdx.x; e < n * kCoef; e += kThreads) {
    const int c = e / kCoef;
    const int c0 = lower[c];
    T v = nan;
    if (c0 >= 0) {
      const T a = weight[c];
      const T* lo = coeffs + (int64_t)c0 * kCoef + (e - c * kCoef);
      v = lo[0] * (T(1) - a) + lo[kCoef] * a;
    }
    row[first * kCoef + e] = v;
  }
}

template <typename T>
int launch(const void* p, const void* p0, const void* t0, const void* td0,
           const void* coeffs, void* row, void* scalars, void* k0, int64_t B,
           int L, void* stream) {
  const int64_t blocks = (B + kThreads - 1) / kThreads;
  parcel_prepass_kernel<T><<<(unsigned)blocks, kThreads, 0,
                             (cudaStream_t)stream>>>(
      (const T*)p, (const T*)p0, (const T*)t0, (const T*)td0,
      (const T*)coeffs, (T*)row, (T*)scalars, (int*)k0, B, L);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  p is
// (B, L), p0/t0/td0 (B,), coeffs (14300, 42); row (B, 42), scalars (B, 6)
// and k0 (B,) int32 are written.
int parcel_prepass_f32(const void* p, const void* p0, const void* t0,
                       const void* td0, const void* coeffs, void* row,
                       void* scalars, void* k0, int64_t B, int L,
                       void* stream) {
  return launch<float>(p, p0, t0, td0, coeffs, row, scalars, k0, B, L,
                       stream);
}

int parcel_prepass_f64(const void* p, const void* p0, const void* t0,
                       const void* td0, const void* coeffs, void* row,
                       void* scalars, void* k0, int64_t B, int L,
                       void* stream) {
  return launch<double>(p, p0, t0, td0, coeffs, row, scalars, k0, B, L,
                        stream);
}

}  // extern "C"
