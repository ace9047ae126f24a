// Per-column CAPE/CIN solve for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas kernel xarray_parcel_tpu/fused.py::_kernel (launched
// by _diff_core.pallas_path), whose body is fused._column_program.  The
// plain PyTorch twin is xarray_parcel_tpu_torch/fused.py::_column_program;
// this file computes the same values, output for output.
//
// Design: one thread per column.  The TPU form materialises the LCL-spliced
// (TB, L+1) column and walks it with shift/concat/select networks; here the
// splice is virtual -- spliced slot j is source level j below the insertion
// index, the LCL at it, and source level j-1 above it -- and every level-axis
// reduction is a loop-carried scalar.  Nothing is allocated: per-level
// tracks are recomputed in each pass instead of stored.
//   pass A  source levels: insertion index, the LCL interpolation anchors,
//           the 500 hPa anchors and the lowest log-pressure;
//   pass B  spliced slots: crossings, LFC/EL candidates with their tie
//           rules, the top-of-sounding level, pos_parcel, the first-level
//           equality test and the 500 hPa lifted-index sums;
//   pass T  the parcel/environment values at the top level;
//   pass C  CAPE/CIN over the now-known LFC/EL windows.
// The ragged edge (B not a multiple of the block) is masked here; no
// padding is needed.
//
// What bounds it: FP32/FP64 issue (two full track evaluations per level,
// each a 14-term Clenshaw series plus three exp and a log) and the
// uncoalesced reads -- thread i reads row i of the row-major (B, L) inputs,
// so neighbouring threads touch addresses L elements apart.  Coalesced
// (or shared-memory staged) loads and keeping tracks between passes are
// later work.
//
// Built with nvcc by xarray_parcel_tpu_torch/_build.py without fast math and
// with -fmad=false: the selections depend on exact NaN semantics and on
// comparing values that the plain twin computes op by op with IEEE
// exp/log/divide, so no multiply-add may be fused into one rounding.
//
// Output rows, each (B,): cape, cin, lfc_p, lfc_t, el_p, el_t, lifted index.
// With a non-null profile pointer, pass B also stores the spliced column's
// pressure, parcel temperature and environment temperature tracks,
// (3, B, L+1) (fused._column_program with_profile); with a null one the
// kernel is instantiated without those stores.

#include "column.cuh"

namespace {

// Constants as exact doubles of the Python values (constants.py and
// adiabat.py of the port); tests/test_torch_adiabat.py checks them.
constexpr double kRd = 287.04749097718457;
constexpr double kKappa = 0.28571428571428575;
constexpr double kEpsilon = 0.6219569100577033;
constexpr double kSatPressure0c = 6.112;
constexpr double kVirtualEps = 0.608;
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

constexpr int kScalars = 6;   // lcl_p, lcl_t, lcl_vt, w0, t0, p0

// --- thermodynamics (same evaluation order as thermo.py) -----------------

template <typename T> __device__ __forceinline__ T svp(T t) {
  return T(kSatPressure0c) *
         dexp(T(17.67) * (t - T(273.15)) / (t - T(29.65)));
}

// Saturation mixing ratio at (p, T).
template <typename T> __device__ __forceinline__ T sat_mr(T p, T temp) {
  T e = svp(temp);
  return T(kEpsilon) * e / (p - e);
}

// RH-route mixing ratio, algebraically fused.
template <typename T>
__device__ __forceinline__ T mixing_ratio(T t, T td, T p) {
  return T(kEpsilon) * svp(td) / (p - svp(t));
}

template <typename T> __device__ __forceinline__ T virt(T t, T w) {
  return t * (T(1) + T(kVirtualEps) * w);
}

// Piecewise Clenshaw evaluation of one blended coefficient row at one
// log-pressure (adiabat._eval_spectral).
template <typename T>
__device__ T eval_spectral(const T* __restrict__ row, int seg_k, T lnp) {
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

// One slot of the spliced column: pressure, log-pressure, parcel and
// environment virtual temperature, parcel and environment temperature.
template <typename T> struct Slot {
  T P, LP, PT, ET, TP, TE;
};

template <typename T> struct Column {
  const T* p;
  const T* t;
  const T* td;
  const T* row;
  int seg_k, k0, idx;
  bool flood;   // NaN LCL pressure: every slot takes the LCL's values
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
      T w = pi <= lcl_p ? sat_mr(pi, temp) : w0;
      s.PT = virt(temp, w);
    }
    T ti = t[i], tdi = td[i];
    s.TE = ti;
    s.ET = (isnan_(ti) || isnan_(tdi)) ? nan : virt(ti, mixing_ratio(ti, tdi, pi));
    return s;
  }

  __device__ Slot<T> lcl_slot() const {
    return Slot<T>{lcl_p, llcl, lcl_vt, envvt_at, lcl_t, t_at};
  }

  __device__ Slot<T> slot(int j) const {
    if (flood || j == idx) return lcl_slot();
    return level(j < idx ? j : j - 1);
  }

  // Log-pressure of slot j alone (no track evaluation).
  __device__ T slot_lp(int j) const {
    if (flood || j == idx) return llcl;
    T pi = p[j < idx ? j : j - 1];
    return isnan_(pi) ? Num<T>::nan() : dlog(pi);
  }
};

// Crossing of the parcel and environment tracks in the gap between slots
// a and b (ops/intersect.py): log-pressure ix and value iy (NaN where there
// is none), and the direction from the sign at b.  A NaN sign counts as a
// crossing with NaN coordinates, as in the reference.
template <typename T>
__device__ __forceinline__ void crossing(const Slot<T>& a, const Slot<T>& b,
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

template <typename T, bool kProfile>
__global__ void __launch_bounds__(128)
fused_cape_cin_kernel(const T* __restrict__ p, const T* __restrict__ t,
                      const T* __restrict__ td, const T* __restrict__ row,
                      const T* __restrict__ sc, const int* __restrict__ k0s,
                      T* __restrict__ out, T* __restrict__ prof, int64_t B,
                      int L, int K) {
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col >= B) return;
  const T nan = Num<T>::nan(), inf = Num<T>::inf();

  Column<T> c;
  c.p = p + col * L;
  c.t = t + col * L;
  c.td = td + col * L;
  c.row = row + col * K;
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
  c.llcl = c.flood ? nan : dlog(c.lcl_p);
  const T llcl = c.llcl;
  const T l500 = dlog(T(500));

  // --- pass A: source levels ---------------------------------------------
  int idx = 0;
  Anchors<T> lcl(llcl);               // t and td at the LCL
  T cb5 = inf, ca5 = -inf;            // 500 hPa anchors of the splice
  T lpmin = inf;
  for (int i = 0; i < L; ++i) {
    const T pi = c.p[i];
    if (pi >= c.lcl_p) idx = i + 1;   // last valid level with p >= lcl_p
    if (isnan_(pi)) continue;
    const T lp = dlog(pi);
    if (lp < lpmin) lpmin = lp;
    if (lp >= l500 && lp < cb5) cb5 = lp;
    if (lp <= l500 && lp > ca5) ca5 = lp;
    lcl.add(lp, c.t[i], c.td[i]);
  }
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
  c.envvt_at = virt(c.t_at, mixing_ratio(c.t_at, lcl.value(1), c.lcl_p));

  // --- pass B: spliced slots ----------------------------------------------
  const int k0 = c.k0;
  bool same_first = false, pos_parcel = false, any_inc = false;
  T top = inf;
  T lfc = -inf, lfc_t = -inf;         // bottom-most increasing crossing
  T el = inf, el_t = -inf;            // top-most decreasing crossing
  T se5 = 0, sp5 = 0, se5a = 0, sp5a = 0;
  int ne5 = 0, np5 = 0, ne5a = 0, np5a = 0;
  Slot<T> prev = c.slot(0);
  for (int j = 0; j <= L; ++j) {
    const Slot<T> cur = j == 0 ? prev : c.slot(j);
    if (kProfile) {
      const int64_t plane = B * (L + 1), at = col * (L + 1) + j;
      prof[at] = cur.P;
      prof[plane + at] = cur.TP;
      prof[2 * plane + at] = cur.TE;
    }
    if (j == k0) {
      // Ulp-scaled first-level equality (cape.lfc_el).
      const T a = cur.ET, b = cur.PT;
      const T m = dabs(a) > dabs(b) ? dabs(a) : dabs(b);
      same_first = !isnan_(a) && !isnan_(b) &&
                   dabs(a - b) <= T(8.0 * Num<T>::eps) * m;
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
    if (j > 0) {
      T ix, iy;
      bool inc, dec;
      crossing(prev, cur, ix, iy, inc, dec);
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
    prev = cur;
  }
  lfc = or_nan(lfc, -inf);
  lfc_t = or_nan(lfc_t, -inf);
  el = or_nan(el, inf);
  el_t = or_nan(el_t, -inf);
  top = or_nan(top, inf);

  // --- pass T: parcel and environment at the top level ---------------------
  T top_prof = -inf, top_env = -inf;
  if (!isnan_(top)) {
    for (int j = 0; j <= L; ++j) {
      if (c.slot_lp(j) != top) continue;
      const Slot<T> cur = c.slot(j);
      if (cur.PT > top_prof) top_prof = cur.PT;
      if (cur.ET > top_env) top_env = cur.ET;
    }
  }
  top_prof = or_nan(top_prof, -inf);
  top_env = or_nan(top_env, -inf);

  // --- LFC/EL under the USAF1990 rules --------------------------------------
  const bool el_exists = top_prof <= top_env && el < llcl;
  if (!el_exists) el = el_t = nan;
  const bool lfc_missing = !any_inc;
  const bool no_lfc_pos_parcel = pos_parcel && lfc_missing;
  const bool lfc_below_el_above = !lfc_missing && isnan_(lfc) && el < llcl;
  const bool replace = no_lfc_pos_parcel || lfc_below_el_above;
  const T lfc_lp = replace ? llcl : lfc;
  const T el_lp = isnan_(el) ? lpmin : el;   // missing EL: top of sounding

  // --- pass C: CAPE/CIN ------------------------------------------------------
  T cape_t = 0, cape_r = 0, cin_t = 0, cin_r = 0;
  prev = c.slot(0);
  for (int j = 1; j <= L; ++j) {
    const Slot<T> cur = c.slot(j);
    T ix, iy;
    bool inc, dec;
    crossing(prev, cur, ix, iy, inc, dec);
    const T d0 = prev.PT - prev.ET, d1 = cur.PT - cur.ET;
    const T x0 = prev.LP, x1 = cur.LP;
    if (isnan_(ix)) {
      // Whole-gap trapezoid, both endpoints in the window.
      if (!isnan_(d0) && !isnan_(d1) && !isnan_(x0) && !isnan_(x1)) {
        const T area = dabs(x1 - x0) * (T(0.5) * (d0 + d1));
        if (area > T(0) && x0 <= lfc_lp && x0 >= el_lp && x1 <= lfc_lp &&
            x1 >= el_lp)
          cape_t += area;
        if (area < T(0) && x0 >= lfc_lp && x1 >= lfc_lp) cin_t += area;
      }
    } else {
      // Rectangles from each endpoint to the crossing, height y/2.
      const T px[2] = {x0, x1}, py[2] = {d0, d1};
      for (int r = 0; r < 2; ++r) {
        if (isnan_(px[r]) || isnan_(py[r])) continue;
        const T dx = px[r] - ix;
        const T area = (py[r] * T(0.5)) * dabs(dx);
        const T pos = px[r] - dx * T(0.5);
        if (area > T(0) && pos <= lfc_lp && pos >= el_lp) cape_r += area;
        if (area < T(0) && pos >= lfc_lp) cin_r += area;
      }
    }
    prev = cur;
  }

  // --- lifted index: environment minus parcel temperature at 500 hPa ------
  const T frac5 = anchor_frac(l500, cb5, ca5);
  const T env500 = interp_sums(se5, ne5, se5a, ne5a, frac5);
  const T par500 = interp_sums(sp5, np5, sp5a, np5a, frac5);

  T* o = out + col;
  o[0 * B] = T(kRd) * cape_t + T(kRd) * cape_r;
  o[1 * B] = T(kRd) * cin_t + T(kRd) * cin_r;
  o[2 * B] = replace ? c.lcl_p : (isnan_(lfc) ? nan : dexp(lfc));
  o[3 * B] = replace ? c.lcl_vt : lfc_t;
  o[4 * B] = isnan_(el) ? nan : dexp(el);
  o[5 * B] = el_t;
  o[6 * B] = env500 - par500;
}

template <typename T>
int launch(const void* p, const void* t, const void* td, const void* row,
           const void* sc, const void* k0, void* out, void* prof, int64_t B,
           int L, int K, void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((B + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  if (prof)
    fused_cape_cin_kernel<T, true><<<blocks, threads, 0, s>>>(
        (const T*)p, (const T*)t, (const T*)td, (const T*)row, (const T*)sc,
        (const int*)k0, (T*)out, (T*)prof, B, L, K);
  else
    fused_cape_cin_kernel<T, false><<<blocks, threads, 0, s>>>(
        (const T*)p, (const T*)t, (const T*)td, (const T*)row, (const T*)sc,
        (const int*)k0, (T*)out, nullptr, B, L, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  `prof`
// may be null: then no profile tracks are stored.
int fused_cape_cin_f32(const void* p, const void* t, const void* td,
                       const void* row, const void* sc, const void* k0,
                       void* out, void* prof, int64_t B, int L, int K,
                       void* stream) {
  return launch<float>(p, t, td, row, sc, k0, out, prof, B, L, K, stream);
}

int fused_cape_cin_f64(const void* p, const void* t, const void* td,
                       const void* row, const void* sc, const void* k0,
                       void* out, void* prof, int64_t B, int L, int K,
                       void* stream) {
  return launch<double>(p, t, td, row, sc, k0, out, prof, B, L, K, stream);
}

}  // extern "C"
