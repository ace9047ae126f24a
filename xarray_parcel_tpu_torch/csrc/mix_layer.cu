// Every mixed-layer prep of a fused pipeline call in one launch, for NVIDIA
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  XLA fuses the JAX package's mixed layers
// (xarray_parcel_tpu/parcels.py: conserved_fields, bridge_neighbors,
// mixed_layer, mix_layer) into a few loops.  Their plain PyTorch form,
// xarray_parcel_tpu_torch/parcels.py::_mix_layers_twin, is some 540 torch
// launches a call at two depths: the level mask and nanmax(p) rebuilt per
// depth, a duplicate-aware log interpolation of the layer top, a dozen
// masked (B, L) reductions, some 320 passes over (B, L) float32 fields.
// This kernel computes, for each column and each depth d of the call, what
// mix_layer(p, t, td, depth=d, grow=False) returns there, with the
// conserved fields and the neighbour scans of a shared level mask:
//   * the three (B, L) fields: p, t and td where p < nanmax(p) - d, else
//     NaN, with the mixed parcel written into the slot below the first
//     kept level (slot 0 with nothing kept, none if level 0 is kept);
//   * the parcel: nanmax(p), and the temperature and dewpoint of theta and
//     the saturation mixing ratio of td, mass-weighted over the layer
//     (bridged trapezoids, the boundary area up to the log-interpolated
//     layer top, over the span the integral covers).
// The masked fields are copies of input values, bit for bit the twin's;
// the parcel's temperature and dewpoint differ from the twin's only by the
// order in which the sums add their terms.  The point thermodynamics are
// thermo.cuh's, op for op as the card's torch computes them.
//
// What bounds it: device memory.  Per level it reads t and td and writes
// 3 x D values: 32 bytes at D = 2 in float32 with a pressure shared by
// every row (row stride 0: the broadcast of 1-D isobaric levels, one row
// read in place), 36 with a contiguous one (64 and 72 in float64); the
// parcels add 3 x D values a column.  At 786,432 x 90 contiguous in
// float32 that is 2.55 GB, 0.77 ms at 3.35 TB/s; 0.36 ms at 1,038,240 x 35
// and 0.68 ms at 5,191,200 x 13 broadcast.  On an H100 at 700 W
// (chip_smoke.py) it takes 1.7, 0.72 and 1.2 ms there, the twin 44, 31
// and 50 ms.
//
// Design: a block owns a tile of consecutive rows.  Its kThreads threads
// stage the tile's t, td and pressure (one row where the rows are one) and
// a byte a level saying whether all three hold a number, with coalesced
// loads (consecutive threads on consecutive levels).  G consecutive lanes
// then take each row, a contiguous segment of its levels each, and make
// two passes over it in shared memory: backward, the largest pressure and
// each level's next valid pressure within the segment (kept in shared
// memory); forward, for every depth at once, the previous valid pressure
// as it goes, the in-layer trapezoid sums, the last in-layer level, the
// first kept level and the two interpolation anchors (the smallest log p
// at or above the layer top's and the largest at or below it, duplicates
// summed as they come).  Between the passes, shuffles within the G lanes
// give each segment nanmax(p) and the neighbours across its ends; after
// the second they combine the segments' results, and the first lane makes
// the parcel.  Theta and the mixing ratio are computed only at the levels
// that enter a sum or an anchor.  The block then writes its tile of 3 x D
// fields from shared memory with coalesced stores.  The rows sit at an
// odd pitch (L | 1), so that threads on different rows fall on distinct
// banks.  The tile's rows R come from L, the dtype, D and the pressure's
// row stride: as many as fit kTileBytes, up to kThreads (a row longer
// than that takes a block alone, up to the opt-in shared memory: some
// 7,000 float64 or 13,000 float32 levels); G is the largest power of two
// up to a warp with R x G threads in the block and kMinSegment levels a
// segment: 1 at 13 levels, 2 at 35, 8 at 90 in float32.  A warp per
// column would leave 19 of 32 lanes idle at 13 levels; a thread per row
// left a warp or less of a block at work at 90 levels (3.0 ms there).
//
// Built with -fmad=false (see _build.py), as every kernel of the port.

#include "thermo.cuh"

namespace {

constexpr int kThreads = 128;          // threads a block, rows at most
constexpr int kTileBytes = 24 * 1024;  // shared memory a block, but one row
constexpr int kMaxDepths = 2;          // depths a launch
constexpr int kMinSegment = 8;         // levels a thread, where a row has more

template <typename T> struct Depths {
  T v[kMaxDepths];
};

// Shared bytes of a tile of R rows: t, td and the next valid pressure (R
// rows each), the pressure (R rows, or one shared row), per row the bottom
// and per depth the layer top, the parcel's t and td (T) and the slot
// (int), then the valid bytes (R rows).
template <typename T>
int64_t tile_bytes(int64_t R, int L, bool shared_rows, int D) {
  const int64_t pitch = L | 1;
  return (int64_t)sizeof(T) * (3 * R * pitch + (shared_rows ? L : R * pitch) +
                               R * (1 + 3 * D)) +
         4 * (int64_t)D * R + R * pitch;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    mix_layers_kernel(const T* __restrict__ p, const T* __restrict__ t,
                      const T* __restrict__ td, T* __restrict__ fields,
                      T* __restrict__ parcel, int64_t B, int L,
                      int row_stride, int tile_rows, int group,
                      Depths<T> depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = L | 1;
  const int R = tile_rows;
  const bool shared_rows = row_stride == 0;
  T* ts = reinterpret_cast<T*>(smem);         // t
  T* ds = ts + R * pitch;                     // td
  T* nx = ds + R * pitch;                     // next valid pressure
  T* pr = nx + R * pitch;                     // the pressure
  T* bottom_s = pr + (shared_rows ? L : R * pitch);
  T* top_s = bottom_s + R;                    // [D][R]
  T* tp_s = top_s + D * R;
  T* tdp_s = tp_s + D * R;
  int* slot_s = reinterpret_cast<int*>(tdp_s + D * R);
  unsigned char* ok = reinterpret_cast<unsigned char*>(slot_s + D * R);

  const int64_t row0 = (int64_t)blockIdx.x * R;
  const int rows = (int)(B - row0 < R ? B - row0 : R);
  const int n = rows * L;
  const T inf = Num<T>::inf(), nan = Num<T>::nan();
  const T* tt = t + row0 * L;
  const T* dt = td + row0 * L;

  if (shared_rows)
    for (int c = threadIdx.x; c < L; c += kThreads) pr[c] = p[c];
  tile_walk<kThreads, 4>(n, L, [&](int e, int r, int c) {
    const T x = p[(row0 + r) * row_stride + c];
    const T tv = tt[e], dv = dt[e];
    ts[r * pitch + c] = tv;
    ds[r * pitch + c] = dv;
    ok[r * pitch + c] = !isnan_(x) && !isnan_(tv) && !isnan_(dv);
    if (!shared_rows) pr[r * pitch + c] = x;
  });
  __syncthreads();

  // Each row's G threads (consecutive lanes of a warp) take a contiguous
  // segment of its levels each, in both passes; what a pass carries from
  // one level to the next is combined across them with shuffles.
  const int G = group;
  const int q = threadIdx.x / G, g = threadIdx.x - q * G;
  const bool active = q < rows;
  const int seg = (L + G - 1) / G;
  const int k0 = active ? min(L, g * seg) : 0;
  const int k1 = active ? min(L, k0 + seg) : 0;
  const T* pp = shared_rows ? pr : pr + q * pitch;
  const unsigned char* okq = ok + q * pitch;
  T* nxq = nx + q * pitch;
  const T* tq = ts + q * pitch;
  const T* dq = ds + q * pitch;

  // Backward over the segment: its largest pressure (for nanmax(p)), each
  // level's next valid pressure within it (-inf if none), as
  // bridge_neighbors' scan with its update rule, and its smallest and
  // largest valid pressure.
  T pmax = -inf, run = -inf, seg_min = inf;
  for (int k = k1 - 1; k >= k0; --k) {
    const T x = pp[k];
    if (x > pmax) pmax = x;
    nxq[k] = run;
    if (okq[k]) {
      if (x >= run) run = x;
      if (x < seg_min) seg_min = x;
    }
  }
  // Across the row's segments: nanmax(p), the smallest valid pressure
  // before this segment (the previous valid pressure of its first level,
  // +inf if none) and the largest after it.
  T prev = inf, later = -inf;
  for (int j = 1; j < G; ++j) {
    const T a = __shfl_up_sync(kFullMask, seg_min, j, G);
    const T b = __shfl_down_sync(kFullMask, run, j, G);
    if (g >= j && a < prev) prev = a;
    if (g + j < G && b > later) later = b;
  }
  const T bottom = or_nan(group_max(pmax, G), -inf);
  const T safe_bottom = isnan_(bottom) ? T(0) : bottom;

  T top[D], at[D];
  int first_keep[D], last[D], count[D];
  T p_last[D], th_last[D], w_last[D], p_in[D], sum_th[D], sum_w[D];
  // The anchors: lo the smallest log p >= at, hi the largest <= at, with
  // the sums and counts of theta and w over their duplicates.
  T lo[D], lo_th[D], lo_w[D], hi[D], hi_th[D], hi_w[D];
  int lo_nth[D], lo_nw[D], hi_nth[D], hi_nw[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    top[d] = bottom - depth.v[d];
    at[d] = isnan_(top[d]) ? nan : dlog(top[d]);
    first_keep[d] = last[d] = -1;
    count[d] = lo_nth[d] = lo_nw[d] = hi_nth[d] = hi_nw[d] = 0;
    p_last[d] = th_last[d] = w_last[d] = T(0);
    sum_th[d] = sum_w[d] = T(0);
    lo_th[d] = lo_w[d] = hi_th[d] = hi_w[d] = T(0);
    p_in[d] = -inf;
    lo[d] = inf;
    hi[d] = -inf;
  }

  // Forward over the segment, every depth at once.
  for (int k = k0; k < k1; ++k) {
    const T x = pp[k];
#pragma unroll
    for (int d = 0; d < D; ++d)
      if (first_keep[d] < 0 && x < top[d]) first_keep[d] = k;
    if (!okq[k]) continue;
    const T lp = dlog(x);
    bool need = false;
#pragma unroll
    for (int d = 0; d < D; ++d)
      need = need || x >= top[d] || (lp >= at[d] && lp <= lo[d]) ||
             (lp <= at[d] && lp >= hi[d]);
    T th = T(0), w = T(0);
    if (need) {
      th = potential_temperature(x, tq[k]);
      w = saturation_mixing_ratio(x, dq[k]);
    }
    const bool th_ok = !isnan_(th), w_ok = !isnan_(w);
    const T next = nxq[k] > later ? nxq[k] : later;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      if (x >= top[d]) {
        const T prev_p = prev != inf && prev != -inf ? prev : x;
        const T next_p = next >= top[d] ? next : x;
        sum_th[d] += th * (prev_p - next_p);
        sum_w[d] += w * (prev_p - next_p);
        last[d] = k;
        p_last[d] = x;
        th_last[d] = th;
        w_last[d] = w;
        if (x > p_in[d]) p_in[d] = x;
        ++count[d];
      }
      if (lp >= at[d]) {
        if (lp < lo[d]) {
          lo[d] = lp;
          lo_th[d] = lo_w[d] = T(0);
          lo_nth[d] = lo_nw[d] = 0;
        }
        if (lp == lo[d]) {
          lo_th[d] += th_ok ? th : T(0);
          lo_nth[d] += th_ok;
          lo_w[d] += w_ok ? w : T(0);
          lo_nw[d] += w_ok;
        }
      }
      if (lp <= at[d]) {
        if (lp > hi[d]) {
          hi[d] = lp;
          hi_th[d] = hi_w[d] = T(0);
          hi_nth[d] = hi_nw[d] = 0;
        }
        if (lp == hi[d]) {
          hi_th[d] += th_ok ? th : T(0);
          hi_nth[d] += th_ok;
          hi_w[d] += w_ok ? w : T(0);
          hi_nw[d] += w_ok;
        }
      }
    }
    if (x <= prev) prev = x;
  }

  // The segments' results combined: the first kept level, the last
  // in-layer level with its values, the sums, and the anchors with their
  // duplicates.
#pragma unroll
  for (int d = 0; d < D; ++d) {
    for (int m = G / 2; m > 0; m >>= 1) {
      const int fk = __shfl_xor_sync(kFullMask, first_keep[d], m, G);
      if (fk >= 0 && (first_keep[d] < 0 || fk < first_keep[d]))
        first_keep[d] = fk;
      const int ls = __shfl_xor_sync(kFullMask, last[d], m, G);
      const T pl = __shfl_xor_sync(kFullMask, p_last[d], m, G);
      const T tl = __shfl_xor_sync(kFullMask, th_last[d], m, G);
      const T wl = __shfl_xor_sync(kFullMask, w_last[d], m, G);
      if (ls > last[d]) {
        last[d] = ls;
        p_last[d] = pl;
        th_last[d] = tl;
        w_last[d] = wl;
      }
      const T pi = __shfl_xor_sync(kFullMask, p_in[d], m, G);
      if (pi > p_in[d]) p_in[d] = pi;
      count[d] += __shfl_xor_sync(kFullMask, count[d], m, G);
      sum_th[d] += __shfl_xor_sync(kFullMask, sum_th[d], m, G);
      sum_w[d] += __shfl_xor_sync(kFullMask, sum_w[d], m, G);
      const T l = __shfl_xor_sync(kFullMask, lo[d], m, G);
      const T lth = __shfl_xor_sync(kFullMask, lo_th[d], m, G);
      const T lw = __shfl_xor_sync(kFullMask, lo_w[d], m, G);
      const int lnth = __shfl_xor_sync(kFullMask, lo_nth[d], m, G);
      const int lnw = __shfl_xor_sync(kFullMask, lo_nw[d], m, G);
      if (l < lo[d]) {
        lo[d] = l;
        lo_th[d] = lth;
        lo_w[d] = lw;
        lo_nth[d] = lnth;
        lo_nw[d] = lnw;
      } else if (l == lo[d]) {
        lo_th[d] += lth;
        lo_w[d] += lw;
        lo_nth[d] += lnth;
        lo_nw[d] += lnw;
      }
      const T h = __shfl_xor_sync(kFullMask, hi[d], m, G);
      const T hth = __shfl_xor_sync(kFullMask, hi_th[d], m, G);
      const T hw = __shfl_xor_sync(kFullMask, hi_w[d], m, G);
      const int hnth = __shfl_xor_sync(kFullMask, hi_nth[d], m, G);
      const int hnw = __shfl_xor_sync(kFullMask, hi_nw[d], m, G);
      if (h > hi[d]) {
        hi[d] = h;
        hi_th[d] = hth;
        hi_w[d] = hw;
        hi_nth[d] = hnth;
        hi_nw[d] = hnw;
      } else if (h == hi[d]) {
        hi_th[d] += hth;
        hi_w[d] += hw;
        hi_nth[d] += hnth;
        hi_nw[d] += hnw;
      }
    }
  }

  if (active && g == 0) {
    bottom_s[q] = bottom;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      const bool any = last[d] >= 0;
      const T safe_top = isnan_(top[d]) ? T(0) : top[d];
      const T pk = any ? p_last[d] : T(0);
      // amax over the layer's pressures and the zeros outside it.
      const T p_first =
          count[d] == L ? p_in[d] : (p_in[d] > T(0) ? p_in[d] : T(0));
      const T before = or_nan(lo[d], inf), after = or_nan(hi[d], -inf);
      const bool b_none = isnan_(before), a_none = isnan_(after);
      const T frac = anchor_frac(at[d], before, after);
      const T ft_th = interp_sums(lo_th[d], b_none ? 0 : lo_nth[d], hi_th[d],
                                  a_none ? 0 : hi_nth[d], frac);
      const T ft_w = interp_sums(lo_w[d], b_none ? 0 : lo_nw[d], hi_w[d],
                                 a_none ? 0 : hi_nw[d], frac);
      const T dep = depth.v[d];
      auto mixed = [&](T sum, T f_last, T ft) {
        const bool b_ok = any && !isnan_(ft);
        const T f_k = any ? f_last : T(0);
        const T b_area =
            T(0.5) * (f_k + (b_ok ? ft : T(0))) * dabs(pk - safe_top);
        const T span = b_ok ? (p_first == safe_bottom ? dep
                                                      : p_first - safe_top)
                            : p_first - pk;
        const T inv = any && span > T(0) ? T(1) / span : nan;
        return (T(0.5) * sum + (b_ok ? b_area : T(0))) * inv;
      };
      const T m_th = mixed(sum_th[d], th_last[d], ft_th);
      const T m_w = mixed(sum_w[d], w_last[d], ft_w);
      const T tp = m_th * exner_function(bottom);
      const T tdp = dewpoint(vapor_pressure(bottom, m_w));
      const int64_t col = row0 + q;
      parcel[(3 * d) * B + col] = bottom;
      parcel[(3 * d + 1) * B + col] = tp;
      parcel[(3 * d + 2) * B + col] = tdp;
      top_s[d * R + q] = top[d];
      tp_s[d * R + q] = tp;
      tdp_s[d * R + q] = tdp;
      slot_s[d * R + q] = first_keep[d] >= 0 ? first_keep[d] - 1 : 0;
    }
  }
  __syncthreads();

  const int64_t BL = B * (int64_t)L;
  T* out = fields + row0 * L;
  tile_walk<kThreads, 2>(n, L, [&](int e, int r, int c) {
    const T x = shared_rows ? pr[c] : pr[r * pitch + c];
    const T tv = ts[r * pitch + c], dv = ds[r * pitch + c];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      T* o = out + 3 * d * BL + e;
      if (c == slot_s[d * R + r]) {
        o[0] = bottom_s[r];
        o[BL] = tp_s[d * R + r];
        o[2 * BL] = tdp_s[d * R + r];
      } else {
        const bool keep = x < top_s[d * R + r];
        o[0] = keep ? x : nan;
        o[BL] = keep ? tv : nan;
        o[2 * BL] = keep ? dv : nan;
      }
    }
  });
}

template <typename T, int D>
int launch_depths(const void* p, const void* t, const void* td, void* fields,
                  void* parcel, int64_t B, int L, int row_stride,
                  const Depths<T>& depth, void* stream) {
  const bool shared_rows = row_stride == 0;
  const int64_t base = tile_bytes<T>(0, L, shared_rows, D);
  const int64_t tile_rows =
      fit_rows(base, tile_bytes<T>(1, L, shared_rows, D) - base, kTileBytes,
               kThreads);
  // Threads a row: the most a power of two that the block's threads cover,
  // up to a warp, while a segment keeps kMinSegment levels.
  int group = 1;
  while (2 * group * tile_rows <= kThreads && 2 * group <= 32 &&
         L >= 2 * group * kMinSegment)
    group *= 2;
  return launch_tiles<kThreads>(
      mix_layers_kernel<T, D>, (B + tile_rows - 1) / tile_rows,
      tile_bytes<T>(tile_rows, L, shared_rows, D), stream, (const T*)p,
      (const T*)t, (const T*)td, (T*)fields, (T*)parcel, B, L, row_stride,
      (int)tile_rows, group, depth);
}

template <typename T>
int launch(const void* p, const void* t, const void* td, void* fields,
           void* parcel, int64_t B, int L, int row_stride, int D, double d0,
           double d1, void* stream) {
  const Depths<T> depth{{T(d0), T(d1)}};
  switch (D) {
    case 1:
      return launch_depths<T, 1>(p, t, td, fields, parcel, B, L, row_stride,
                                 depth, stream);
    case 2:
      return launch_depths<T, 2>(p, t, td, fields, parcel, B, L, row_stride,
                                 depth, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  p holds
// B rows of L levels at `row_stride` values apart (0: one row for all, or
// L) with unit level stride; t and td (B, L) contiguous; D (1 or 2)
// depths d0 (and d1) in hPa.  fields (D, 3, B, L) and parcel (D, 3, B),
// each depth's pressure, temperature and dewpoint, are written.
int mix_layers_f32(const void* p, const void* t, const void* td,
                   void* fields, void* parcel, int64_t B, int L,
                   int row_stride, int D, double d0, double d1,
                   void* stream) {
  return launch<float>(p, t, td, fields, parcel, B, L, row_stride, D, d0, d1,
                       stream);
}

int mix_layers_f64(const void* p, const void* t, const void* td,
                   void* fields, void* parcel, int64_t B, int L,
                   int row_stride, int D, double d0, double d1,
                   void* stream) {
  return launch<double>(p, t, td, fields, parcel, B, L, row_stride, D, d0,
                        d1, stream);
}

}  // extern "C"
