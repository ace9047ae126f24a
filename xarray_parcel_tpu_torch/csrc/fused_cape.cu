// Per-column CAPE/CIN solve for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel xarray_parcel_tpu/fused.py::_kernel (launched
// by _diff_core.pallas_path), whose body is fused._column_program.  The
// plain PyTorch twin is xarray_parcel_tpu_torch/fused.py::_column_program;
// this file computes the same values, output for output.
//
// What bounds it: device memory.  At 786,432 x 90 float32 the solve must
// move about 1,025 MB (p/t/td 849 MB, coefficient rows 132 MB, scalars,
// k0 and outputs 44 MB): 0.31 ms at 3.35 TB/s.  One evaluation of each
// spliced slot (a 14-term Clenshaw series, four exp, a log and five IEEE
// divides, about 100 operations) is 7.2 GFLOP, 0.11 ms at the 67 TFLOP/s
// FP32 peak; issued without contraction (-fmad=false) and with the IEEE
// sequences it lands near 0.4 ms of FP32 issue.
//
// Design: one warp solves one column, a block holds kWarps = 8
// columns.  Lane l takes levels (and spliced slots) l, l+32, l+64, ...:
//   * the column's p/t/td rows are read with consecutive lanes on
//     consecutive addresses, so each input byte comes from HBM once; its
//     coefficient row is staged once per warp in shared memory;
//   * pass A  source levels: insertion index (the warp max of i+1 over the
//             levels with p >= lcl_p: the LAST such level), the LCL
//             interpolation anchors (Anchors in column.cuh: the warp's
//             closest levels, then the sums of the lanes that hold them),
//             the 500 hPa anchors and the lowest log-pressure;
//   * pass B  each lane evaluates each of its slots once -- the LCL splice
//             is virtual: slot j is source level j below the insertion
//             index, the LCL at it, level j-1 above it -- folds in its
//             top-level, positive-parcel and 500 hPa terms, and keeps the
//             slot's log-pressure and parcel and environment virtual
//             temperature in per-warp shared memory; then each lane folds
//             the crossings of the gaps it owns (the lower slot from shared
//             memory) into LFC/EL candidates with their tie rules, and
//             the warp reduces them;
//   * pass T  the parcel/environment maxima at the top level, a second
//             reduction over the stored slots whose log-pressure equals it
//             (not only the valid ones: a NaN environment may sit beside a
//             finite parcel value there);
//   * pass C  CAPE/CIN over the now-known LFC/EL windows from the stored
//             slots, per-lane partial sums then a warp sum.
// No track is evaluated twice.  Shared memory is sized from L at launch;
// when one column's L+1 slots do not fit beside the others, fewer columns
// share a block, and beyond what one warp can hold the slots pass through
// the buffer in windows (passes T and C then evaluate them again), so every
// B and L is taken.  Only the order of the CAPE/CIN and duplicate-anchor
// sums differs from the serial loop; every selection is bit-identical.
//
// What limits it (kernel_ab.py on an H100 at 700 W): 2.92 ms at the shape
// above, 9.6 times the bound.  The per-column work that a warp does once
// for all its lanes -- about fifteen warp reductions and the scalar
// prologue and epilogue -- is about half of it (2.47 ms at L = 45, 2.92 at
// 90, 4.53 at 180), and issue and latency, not bytes, set the rest: in
// float32 ptxas gives 64 registers a thread and spills 96 bytes, which
// leaves 32 resident warps an SM.  Persistent blocks, 4 columns a block
// and loading several strides ahead were each measured slower.
//
// Built with nvcc by xarray_parcel_tpu_torch/_build.py without fast math and
// with -fmad=false: the selections depend on exact NaN semantics and on
// comparing values that the plain twin computes op by op with IEEE
// exp/log/divide, so no multiply-add may be fused into one rounding.
//
// The solve's four options (fused.solve_options) come as a flags word, one
// bit per non-default setting, uniform over the grid.  The default
// instances (kDefaults) take it as the constant 0, so the compiler removes
// every option's code from them; one further instance per type and profile
// flag reads the word at run time:
//   * kRealTemperature  the crossing set, LFC/EL and the areas run on the
//                       real parcel and environment temperature tracks, the
//                       LCL slot on lcl_t and the environment temperature
//                       there (the slots' PT/ET take the values of TP/TE);
//   * kLinearLcl        the environment at the LCL is interpolated in
//                       pressure, not log-pressure (pass A's anchors);
//   * kSignedAreas      every area of the window counts toward CAPE and
//                       CIN with its sign (pass C);
//   * kZeroCin          a CIN that is not <= 0 becomes 0.
//
// Output rows, each (B,): cape, cin, lfc_p, lfc_t, el_p, el_t, lifted index.
// With a non-null profile pointer, pass B also stores the spliced column's
// pressure, parcel temperature and environment temperature tracks,
// (3, B, L+1) (fused._column_program with_profile), one coalesced store per
// slot by the lane that owns it; with a null one the kernel is
// instantiated without those stores.

#include "thermo.cuh"

namespace {

constexpr int kWarps = 8;   // columns per block (256 threads)

// adiabat.py's constants as exact doubles (constants.py's are in
// thermo.cuh); tests/test_torch_adiabat.py checks them.
constexpr double kPTop = 1100.0;
constexpr double kPBot = 2.5;
// Segment bounds of the piecewise Chebyshev fit in log-pressure, and each
// segment's affine map of log-pressure onto [-1, 1].
constexpr double kSegLnp1 = 3.912023005428146;   // log(50)
constexpr double kSegLnp2 = 5.438079308923196;   // log(230)
constexpr double kSegScale0 = 0.6676164013906681;
constexpr double kSegScale1 = 1.3105676346406756;
constexpr double kSegScale2 = 1.2779665814772492;
constexpr double kSegShift0 = 1.6117307210414449;
constexpr double kSegShift1 = 6.126970736883871;
constexpr double kSegShift2 = 7.949683624226738;

// Bits of the flags word (fused.py FLAG_*).
constexpr int kRealTemperature = 1;
constexpr int kLinearLcl = 2;
constexpr int kSignedAreas = 4;
constexpr int kZeroCin = 8;

// Piecewise Clenshaw evaluation of one blended coefficient row at one
// log-pressure (adiabat._eval_spectral).  `row` is in shared memory; lanes
// in different segments read different parts of it.
template <typename T>
__device__ T eval_spectral(const T* row, int seg_k, T lnp) {
  int s;
  T scale, shift;
  if (lnp < T(kSegLnp1)) {
    s = 0; scale = T(kSegScale0); shift = T(kSegShift0);
  } else if (lnp < T(kSegLnp2)) {
    s = 1; scale = T(kSegScale1); shift = T(kSegShift1);
  } else {
    s = 2; scale = T(kSegScale2); shift = T(kSegShift2);
  }
  T u = lnp * scale - shift;
  u = u < T(-1) ? T(-1) : (u > T(1) ? T(1) : u);
  const T* c = row + s * seg_k;
  T b1 = T(0), b2 = T(0);
  const T two_u = T(2) * u;
  for (int k = seg_k - 1; k > 0; --k) {
    T nb = c[k] + two_u * b1 - b2;
    b2 = b1;
    b1 = nb;
  }
  return c[0] + u * b1 - b2;
}

// What the gaps need of a slot: log-pressure, parcel and environment
// virtual temperature.
template <typename T> struct Point {
  T LP, PT, ET;
};

// One slot of the spliced column: pressure, log-pressure, parcel and
// environment virtual temperature, parcel and environment temperature.
template <typename T> struct Slot {
  T P, LP, PT, ET, TP, TE;
};

// The per-warp slot buffer in shared memory, slots [base, base + cap): what
// the gaps of pass B, pass T and pass C read of each slot.
template <typename T> struct Tracks {
  static constexpr int kArrays = 3;
  T* lp;
  T* pt;
  T* et;
  __device__ Tracks(T* at, int cap) : lp(at), pt(at + cap), et(at + 2 * cap) {}
  __device__ void put(int k, const Slot<T>& s) {
    lp[k] = s.LP;
    pt[k] = s.PT;
    et[k] = s.ET;
  }
  __device__ Point<T> get(int k) const { return Point<T>{lp[k], pt[k], et[k]}; }
};

template <typename T> struct Column {
  const T* p;
  const T* t;
  const T* td;
  const T* row;   // the coefficient row, staged in shared memory
  int seg_k, k0, idx;
  bool flood;   // NaN LCL pressure: every slot takes the LCL's values
  bool real;    // kRealTemperature: PT/ET are the real temperatures
  T lcl_p, lcl_t, lcl_vt, w0, t0, log_p0, llcl;
  T t_at, envvt_at;   // environment at the LCL

  // Tracks of source level i (fused._column_program, first block).
  __device__ Slot<T> level(int i) const {
    const T nan = Num<T>::nan();
    Slot<T> s;
    T pi = p[i];
    s.P = pi;
    if (isnan_(pi)) {   // slots from NaN-pressure levels are NaN throughout
      s.LP = s.PT = s.ET = s.TP = s.TE = nan;
      return s;
    }
    T lp = dlog(pi);
    s.LP = lp;
    T dry = t0 * dexp(T(kKappa) * (lp - log_p0));
    T moist = (pi >= T(kPBot) && pi <= T(kPTop))
                  ? eval_spectral(row, seg_k, lp) : nan;
    T temp = pi >= lcl_p ? dry : moist;
    s.TP = temp;
    if (isnan_(temp)) {
      s.PT = nan;
    } else {
      T w = pi <= lcl_p ? saturation_mixing_ratio(pi, temp) : w0;
      s.PT = virtual_temperature(temp, w);
    }
    T ti = t[i], tdi = td[i];
    s.TE = ti;
    s.ET = (isnan_(ti) || isnan_(tdi)) ? nan
           : virtual_temperature(ti, mixing_ratio(ti, tdi, pi));
    return s;
  }

  __device__ Slot<T> slot(int j) const {
    if (flood || j == idx) {
      if (real) return Slot<T>{lcl_p, llcl, lcl_t, t_at, lcl_t, t_at};
      return Slot<T>{lcl_p, llcl, lcl_vt, envvt_at, lcl_t, t_at};
    }
    Slot<T> s = level(j < idx ? j : j - 1);
    if (real) {
      s.PT = s.TP;
      s.ET = s.TE;
    }
    return s;
  }
};

// Crossing of the parcel and environment tracks in the gap between slots
// a and b (ops/intersect.py): log-pressure ix and value iy (NaN where there
// is none), and the direction from the sign at b.  A NaN sign counts as a
// crossing with NaN coordinates, as in the reference.
template <typename T>
__device__ __forceinline__ void crossing(const Point<T>& a, const Point<T>& b,
                                         T& ix, T& iy, bool& inc,
                                         bool& dec) {
  const T d0 = a.PT - a.ET, d1 = b.PT - b.ET;
  const T s0 = nan_sign(d0), s1 = nan_sign(d1);
  const bool cross = s0 != s1;
  const T x0 = a.LP, x1 = b.LP;
  ix = iy = Num<T>::nan();
  if (cross && !isnan_(d0) && !isnan_(d1) && !isnan_(x0) && !isnan_(x1)) {
    T dy = d1 - d0;
    if (dy == T(0)) dy = T(1);
    T dx = x1 - x0;
    if (dx == T(0)) dx = T(1);
    ix = (d1 * x0 - d0 * x1) / dy;
    if (x1 != x0) iy = ((ix - x0) / dx) * (b.PT - a.PT) + a.PT;
  }
  inc = cross && s1 > T(0);
  dec = cross && s1 < T(0);
}

// Running nanmax of y over the entries whose x equals the running
// extremum of x: reset on a new extremum, fold in ties.
template <typename T>
__device__ __forceinline__ void tie_max(T y, T& best_y, bool reset) {
  const T ninf = -Num<T>::inf();
  if (reset) best_y = isnan_(y) ? ninf : y;
  else if (y > best_y) best_y = y;
}

template <typename T, bool kProfile, bool kDefaults>
__global__ void __launch_bounds__(kWarps * kWarp)
fused_cape_cin_kernel(const T* __restrict__ p, const T* __restrict__ t,
                      const T* __restrict__ td, const T* __restrict__ row,
                      const T* __restrict__ sc, const int* __restrict__ k0s,
                      T* __restrict__ out, T* __restrict__ prof, int64_t B,
                      int L, int K, int cap, int flags) {
  extern __shared__ double smem[];   // double: aligned for either type
  const int opts = kDefaults ? 0 : flags;
  const bool linear_lcl = opts & kLinearLcl;
  const bool signed_areas = opts & kSignedAreas;
  const int lane = threadIdx.x % kWarp, warp = threadIdx.x / kWarp;
  const int64_t col = (int64_t)blockIdx.x * (blockDim.x / kWarp) + warp;
  if (col >= B) return;   // the whole warp: no lane is left to reduce with
  const T nan = Num<T>::nan(), inf = Num<T>::inf();

  T* const srow = reinterpret_cast<T*>(smem) +
                  (int64_t)warp * (K + Tracks<T>::kArrays * cap);
  Tracks<T> tr(srow + K, cap);
  for (int k = lane; k < K; k += kWarp) srow[k] = row[col * K + k];

  Column<T> c;
  c.p = p + col * L;
  c.t = t + col * L;
  c.td = td + col * L;
  c.row = srow;
  c.seg_k = K / 3;
  c.k0 = k0s[col];
  const T* s = sc + col * kScalars;
  c.lcl_p = s[0];
  c.lcl_t = s[1];
  c.lcl_vt = s[2];
  c.w0 = s[3];
  c.t0 = s[4];
  c.log_p0 = dlog(s[5]);
  c.flood = isnan_(c.lcl_p);
  c.real = opts & kRealTemperature;
  c.llcl = c.flood ? nan : dlog(c.lcl_p);
  const T llcl = c.llcl;
  const T l500 = dlog(T(500));

  // --- pass A: source levels ---------------------------------------------
  int idx = 0;
  // t and td at the LCL, in log-pressure or (kLinearLcl) in pressure
  Anchors<T> lcl(linear_lcl ? c.lcl_p : llcl, linear_lcl);
  T cb5 = inf, ca5 = -inf;            // 500 hPa anchors of the splice
  T lpmin = inf;
  for (int i = lane; i < L; i += kWarp) {
    const T pi = c.p[i];
    if (pi >= c.lcl_p) idx = i + 1;   // the lane's last level with p >= lcl_p
    const T lp = dlog(pi);
    lcl.bound(linear_lcl ? pi : lp, i);
    if (lp < lpmin) lpmin = lp;
    if (lp >= l500 && lp < cb5) cb5 = lp;
    if (lp <= l500 && lp > ca5) ca5 = lp;
  }
  idx = warp_max(idx);                // the column's last such level
  lpmin = warp_min(lpmin);
  cb5 = warp_min(cb5);
  ca5 = warp_max(ca5);
  lcl.reduce();
  lcl.gather(c.p, c.t, c.td, L);
  lcl.finish();
  if (c.flood) {
    cb5 = ca5 = lpmin = nan;
  } else {
    if (llcl < lpmin) lpmin = llcl;
    if (llcl >= l500 && llcl < cb5) cb5 = llcl;
    if (llcl <= l500 && llcl > ca5) ca5 = llcl;
    cb5 = or_nan(cb5, inf);
    ca5 = or_nan(ca5, -inf);
    lpmin = or_nan(lpmin, inf);
  }
  c.idx = idx > c.k0 ? idx : c.k0;
  c.t_at = lcl.value(0);
  c.envvt_at = virtual_temperature(
      c.t_at, mixing_ratio(c.t_at, lcl.value(1), c.lcl_p));

  // --- pass B: spliced slots, each evaluated once -------------------------
  const int k0 = c.k0, slots = L + 1;
  const bool windowed = slots > cap;  // the slots do not all fit at once
  bool same_first = false, pos_parcel = false, any_inc = false;
  T top = inf;
  T lfc = -inf, lfc_t = -inf;         // bottom-most increasing crossing
  T el = inf, el_t = -inf;            // top-most decreasing crossing
  T se5 = 0, sp5 = 0, se5a = 0, sp5a = 0;
  int ne5 = 0, np5 = 0, ne5a = 0, np5a = 0;
  Point<T> below{nan, nan, nan};      // slot base - 1 of a later window
  for (int base = 0; base < slots; base += cap) {
    const int end = min(base + cap, slots);
    if (base > 0) below = tr.get(cap - 1);
    __syncwarp();                     // the buffer is free to overwrite
    for (int j = base + lane; j < end; j += kWarp) {
      const Slot<T> cur = c.slot(j);
      tr.put(j - base, cur);
      if (kProfile) {
        const int64_t plane = B * slots, at = col * slots + j;
        prof[at] = cur.P;
        prof[plane + at] = cur.TP;
        prof[2 * plane + at] = cur.TE;
      }
      if (!isnan_(cur.PT) && !isnan_(cur.ET) && cur.LP < top) top = cur.LP;
      if (cur.LP < llcl && cur.PT > cur.ET) pos_parcel = true;
      if (cur.LP == cb5) {
        if (!isnan_(cur.TE)) { se5 += cur.TE; ++ne5; }
        if (!isnan_(cur.TP)) { sp5 += cur.TP; ++np5; }
      }
      if (cur.LP == ca5) {
        if (!isnan_(cur.TE)) { se5a += cur.TE; ++ne5a; }
        if (!isnan_(cur.TP)) { sp5a += cur.TP; ++np5a; }
      }
    }
    __syncwarp();                     // the window's slots are stored
    if (k0 >= base && k0 < end) {
      // Ulp-scaled first-level equality (cape.lfc_el), read by every lane.
      const Point<T> first = tr.get(k0 - base);
      const T a = first.ET, b = first.PT;
      const T m = dabs(a) > dabs(b) ? dabs(a) : dabs(b);
      same_first = !isnan_(a) && !isnan_(b) &&
                   dabs(a - b) <= T(8.0 * Num<T>::eps) * m;
    }
    for (int j = (base > 0 ? base : 1) + lane; j < end; j += kWarp) {
      const Point<T> lo = j > base ? tr.get(j - 1 - base) : below;
      T ix, iy;
      bool inc, dec;
      crossing(lo, tr.get(j - base), ix, iy, inc, dec);
      const bool gap0 = (j - 1) == k0;
      if (inc && !(gap0 && same_first) && !isnan_(ix)) {
        any_inc = true;
        if (ix < llcl && ix >= lfc) {
          tie_max(iy, lfc_t, ix > lfc);
          lfc = ix;
        }
      }
      if (dec && !gap0 && !isnan_(ix) && ix <= el) {
        tie_max(iy, el_t, ix < el);
        el = ix;
      }
    }
  }
  any_inc = warp_any(any_inc);
  pos_parcel = warp_any(pos_parcel);
  top = warp_min(top);
  warp_tie<true>(lfc, lfc_t);
  warp_tie<false>(el, el_t);
  // The 500 hPa sums: only lanes with a slot at an anchor hold any.
  const unsigned h5 = warp_ballot(ne5 + np5 > 0);
  const unsigned h5a = warp_ballot(ne5a + np5a > 0);
  se5 = held_sum(se5, h5);
  sp5 = held_sum(sp5, h5);
  ne5 = held_sum(ne5, h5);
  np5 = held_sum(np5, h5);
  se5a = held_sum(se5a, h5a);
  sp5a = held_sum(sp5a, h5a);
  ne5a = held_sum(ne5a, h5a);
  np5a = held_sum(np5a, h5a);
  lfc = or_nan(lfc, -inf);
  lfc_t = or_nan(lfc_t, -inf);
  el = or_nan(el, inf);
  el_t = or_nan(el_t, -inf);
  top = or_nan(top, inf);

  // Windowed only: evaluate the slots of [base, end) into the buffer again.
  auto refill = [&](int base, int end) {
    __syncwarp();
    for (int j = base + lane; j < end; j += kWarp) tr.put(j - base, c.slot(j));
    __syncwarp();
  };

  // --- pass T: parcel and environment at the top level ---------------------
  // Every stored slot at the top log-pressure, valid or not.
  T top_prof = -inf, top_env = -inf;
  if (!isnan_(top)) {
    for (int base = 0; base < slots; base += cap) {
      const int end = min(base + cap, slots);
      if (windowed) refill(base, end);
      for (int j = base + lane; j < end; j += kWarp) {
        if (tr.lp[j - base] != top) continue;
        const T pt = tr.pt[j - base], et = tr.et[j - base];
        if (pt > top_prof) top_prof = pt;
        if (et > top_env) top_env = et;
      }
    }
  }
  top_prof = or_nan(warp_max(top_prof), -inf);
  top_env = or_nan(warp_max(top_env), -inf);

  // --- LFC/EL under the USAF1990 rules --------------------------------------
  const bool el_exists = top_prof <= top_env && el < llcl;
  if (!el_exists) el = el_t = nan;
  const bool lfc_missing = !any_inc;
  const bool no_lfc_pos_parcel = pos_parcel && lfc_missing;
  const bool lfc_below_el_above = !lfc_missing && isnan_(lfc) && el < llcl;
  const bool replace = no_lfc_pos_parcel || lfc_below_el_above;
  const T lfc_lp = replace ? llcl : lfc;
  const T el_lp = isnan_(el) ? lpmin : el;   // missing EL: top of sounding

  // --- pass C: CAPE/CIN from the stored slots --------------------------------
  T cape_t = 0, cape_r = 0, cin_t = 0, cin_r = 0;
  for (int base = 0; base < slots; base += cap) {
    const int end = min(base + cap, slots);
    if (windowed) {
      if (base > 0) below = tr.get(cap - 1);
      refill(base, end);
    }
    for (int j = (base > 0 ? base : 1) + lane; j < end; j += kWarp) {
      const Point<T> lo = j > base ? tr.get(j - 1 - base) : below;
      const Point<T> hi = tr.get(j - base);
      T ix, iy;
      bool inc, dec;
      crossing(lo, hi, ix, iy, inc, dec);
      const T d0 = lo.PT - lo.ET, d1 = hi.PT - hi.ET;
      const T x0 = lo.LP, x1 = hi.LP;
      if (isnan_(ix)) {
        // Whole-gap trapezoid, both endpoints in the window.
        if (!isnan_(d0) && !isnan_(d1) && !isnan_(x0) && !isnan_(x1)) {
          const T area = dabs(x1 - x0) * (T(0.5) * (d0 + d1));
          if ((signed_areas || area > T(0)) && x0 <= lfc_lp && x0 >= el_lp &&
              x1 <= lfc_lp && x1 >= el_lp)
            cape_t += area;
          if ((signed_areas || area < T(0)) && x0 >= lfc_lp && x1 >= lfc_lp)
            cin_t += area;
        }
      } else {
        // Rectangles from each endpoint to the crossing, height y/2.
        const T px[2] = {x0, x1}, py[2] = {d0, d1};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          if (isnan_(px[r]) || isnan_(py[r])) continue;
          const T dx = px[r] - ix;
          const T area = (py[r] * T(0.5)) * dabs(dx);
          const T pos = px[r] - dx * T(0.5);
          if ((signed_areas || area > T(0)) && pos <= lfc_lp && pos >= el_lp)
            cape_r += area;
          if ((signed_areas || area < T(0)) && pos >= lfc_lp) cin_r += area;
        }
      }
    }
  }
  cape_t = warp_sum(cape_t);
  cape_r = warp_sum(cape_r);
  cin_t = warp_sum(cin_t);
  cin_r = warp_sum(cin_r);

  // --- lifted index: environment minus parcel temperature at 500 hPa ------
  if (lane != 0) return;
  const T frac5 = anchor_frac(l500, cb5, ca5);
  const T env500 = interp_sums(se5, ne5, se5a, ne5a, frac5);
  const T par500 = interp_sums(sp5, np5, sp5a, np5a, frac5);

  T* o = out + col;
  o[0 * B] = T(kRd) * cape_t + T(kRd) * cape_r;
  T cin = T(kRd) * cin_t + T(kRd) * cin_r;
  if ((opts & kZeroCin) && !(cin <= T(0))) cin = T(0);
  o[1 * B] = cin;
  o[2 * B] = replace ? c.lcl_p : (isnan_(lfc) ? nan : dexp(lfc));
  o[3 * B] = replace ? (c.real ? c.lcl_t : c.lcl_vt) : lfc_t;
  o[4 * B] = isnan_(el) ? nan : dexp(el);
  o[5 * B] = el_t;
  o[6 * B] = env500 - par500;
}

template <typename T, bool kProfile, bool kDefaults>
int launch_solve(const void* p, const void* t, const void* td,
                 const void* row, const void* sc, const void* k0, void* out,
                 void* prof, int64_t B, int L, int K, int flags,
                 cudaStream_t stream) {
  int dev, smem_max;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  // Per warp: the coefficient row and three tracks of `cap` slots.  All
  // L+1 slots if they fit, with as many columns a block as fit beside each
  // other; else one column a block, its slots in windows.
  auto per_warp = [&](int64_t cap) {
    return (int64_t)(K + Tracks<T>::kArrays * cap) * (int64_t)sizeof(T);
  };
  int warps = kWarps;
  int64_t cap = (int64_t)L + 1;
  while (warps > 1 && warps * per_warp(cap) > smem_max) warps /= 2;
  if (per_warp(cap) > smem_max)
    cap = (smem_max / (int64_t)sizeof(T) - K) / Tracks<T>::kArrays;
  if (cap < 1) return (int)cudaErrorInvalidValue;
  const int64_t bytes = warps * per_warp(cap);
  auto kernel = fused_cape_cin_kernel<T, kProfile, kDefaults>;
  if (bytes > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (B + warps - 1) / warps;
  kernel<<<(unsigned)blocks, warps * kWarp, (size_t)bytes, stream>>>(
      (const T*)p, (const T*)t, (const T*)td, (const T*)row, (const T*)sc,
      (const int*)k0, (T*)out, (T*)prof, B, L, K, (int)cap, flags);
  return (int)cudaGetLastError();
}

// The instance for the profile pointer and the flags word: the default
// options (flags == 0) take the instances compiled without them.
template <typename T>
int launch(const void* p, const void* t, const void* td, const void* row,
           const void* sc, const void* k0, void* out, void* prof, int64_t B,
           int L, int K, int flags, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (flags == 0) {
    if (prof)
      return launch_solve<T, true, true>(p, t, td, row, sc, k0, out, prof, B,
                                         L, K, 0, s);
    return launch_solve<T, false, true>(p, t, td, row, sc, k0, out, nullptr,
                                        B, L, K, 0, s);
  }
  if (prof)
    return launch_solve<T, true, false>(p, t, td, row, sc, k0, out, prof, B,
                                        L, K, flags, s);
  return launch_solve<T, false, false>(p, t, td, row, sc, k0, out, nullptr, B,
                                       L, K, flags, s);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `prof`
// may be null: then no profile tracks are stored.  The first pair runs the
// default options; the `_flags_` pair takes the flags word after K.
int fused_cape_cin_f32(const void* p, const void* t, const void* td,
                       const void* row, const void* sc, const void* k0,
                       void* out, void* prof, int64_t B, int L, int K,
                       void* stream) {
  return launch<float>(p, t, td, row, sc, k0, out, prof, B, L, K, 0, stream);
}

int fused_cape_cin_f64(const void* p, const void* t, const void* td,
                       const void* row, const void* sc, const void* k0,
                       void* out, void* prof, int64_t B, int L, int K,
                       void* stream) {
  return launch<double>(p, t, td, row, sc, k0, out, prof, B, L, K, 0, stream);
}

int fused_cape_cin_flags_f32(const void* p, const void* t, const void* td,
                             const void* row, const void* sc, const void* k0,
                             void* out, void* prof, int64_t B, int L, int K,
                             int flags, void* stream) {
  return launch<float>(p, t, td, row, sc, k0, out, prof, B, L, K, flags,
                       stream);
}

int fused_cape_cin_flags_f64(const void* p, const void* t, const void* td,
                             const void* row, const void* sc, const void* k0,
                             void* out, void* prof, int64_t B, int L, int K,
                             int flags, void* stream) {
  return launch<double>(p, t, td, row, sc, k0, out, prof, B, L, K, flags,
                        stream);
}

}  // extern "C"
