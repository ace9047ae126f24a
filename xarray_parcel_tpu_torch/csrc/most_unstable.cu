// The most-unstable prep of a fused pipeline call in one launch, for NVIDIA
// Hopper (sm_90a).
//
// Replaces no TPU kernel.  XLA fuses the JAX package's most-unstable prep
// (xarray_parcel_tpu/parcels.py: most_unstable_parcel,
// from_most_unstable_parcel, with ops/levels.py's get_layer and
// bound_pressure) into a few loops.  Its plain PyTorch form,
// xarray_parcel_tpu_torch/parcels.py::_most_unstable_twin, is some 75 torch
// launches a call: the layer's bounds, theta-e at every level, a first
// maximum, three masked selections and three masked copies, each a pass
// over (B, L) fields.  This kernel computes, for each column, what
// from_most_unstable_parcel(p, t, td, depth) returns there:
//   * the layer: bottom, the NaN-skipping max of p; top, the valid level
//     closest to bottom - depth (one depth a call, or one a column), the
//     larger pressure on a tie; the levels with top <= p <= bottom;
//   * the parcel: p, t and td at the first level of the layer's largest
//     theta-e (NaN-skipping), NaN where there is none;
//   * the three (B, L) fields: p, t and td where p <= the parcel's p, else
//     NaN (everywhere NaN where there is no parcel).
// Every value is an elementwise function, a maximum or a selection: no sum,
// so the outputs are bit for bit the twin's as long as theta-e is.  Theta-e
// is thermo.cuh's, op for op as the card's torch computes it.
//
// What bounds it: device memory.  Per level it reads t and td and writes
// three values: 20 bytes in float32 with a pressure shared by every row
// (row stride 0: the broadcast of 1-D isobaric levels, one row read in
// place), 24 with a contiguous one (40 and 48 in float64); the parcel adds
// three values a column.  At 786,432 x 90 contiguous in float32 that is
// 1.71 GB, 0.51 ms at 3.35 TB/s; 0.22 ms at 1,038,240 x 35 and 0.44 ms at
// 5,191,200 x 13 broadcast.
//
// Design, as csrc/mix_layer.cu's, on column.cuh's tile of rows (its walk
// and its launch): a block owns a tile of consecutive rows.
// Its kThreads threads stage the tile's t, td and pressure (one row where
// the rows are one) in shared memory with coalesced loads (consecutive
// threads on consecutive levels).  G consecutive lanes then take each row,
// lane g the levels g, g + G, ... (the layer's levels, where theta-e is
// computed, fall to every lane alike), in three passes over shared memory:
// the largest pressure, the level closest to the layer's top, and the first
// largest theta-e; after each pass shuffles within the G lanes combine the
// lanes' results, and every combination is exact (a max, a min with its
// tie rule, a max with the lower level on a tie), so the order of the
// levels does not matter.  The row's first lane writes the parcel; the
// block then writes its tile of three fields from shared memory with
// coalesced stores.  The rows sit at an odd pitch (L | 1), so that threads
// on different rows fall on distinct banks.  G is the largest power of two
// up to a warp that leaves each lane kMinLevels levels (1 at 13 levels, 4
// at 35, 8 at 90); the tile holds kThreads / G rows, or as many as fit
// kTileBytes (a row longer than that takes a block alone, in the opt-in
// shared memory up to some 9,000 float64 or 18,000 float32 levels, read
// in place from device memory beyond).  No level byte is staged: validity
// here is a NaN test of the values.
//
// Built with -fmad=false (see _build.py), as every kernel of the port.

#include "thermo.cuh"

namespace {

constexpr int kThreads = 128;          // threads a block
constexpr int kTileBytes = 24 * 1024;  // shared memory a block, but one row
constexpr int kMinLevels = 8;          // levels a lane, where a row has more

// Shared bytes of a tile of R rows: the parcel's pressure a row, t and td
// (R rows each) and the pressure (R rows, or one shared row).
template <typename T>
int64_t tile_bytes(int64_t R, int L, bool shared_rows) {
  const int64_t pitch = L | 1;
  return (int64_t)sizeof(T) *
         (2 * R * pitch + (shared_rows ? L : R * pitch) + R);
}

// kStaged: the tile in shared memory; else a row too long for it, a block
// alone, read in place (an instance of its own, so that the staged one's
// loads are shared-memory loads).
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    most_unstable_kernel(const T* __restrict__ p, const T* __restrict__ t,
                         const T* __restrict__ td,
                         const T* __restrict__ depths,
                         T* __restrict__ fields, T* __restrict__ parcel,
                         int64_t B, int L, int row_stride, int tile_rows,
                         int group, T depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = tile_rows;
  const bool shared_rows = row_stride == 0;
  const int64_t row0 = (int64_t)blockIdx.x * R;
  const int rows = (int)(B - row0 < R ? B - row0 : R);
  const int n = rows * L;
  const T inf = Num<T>::inf(), nan = Num<T>::nan();

  // The tile's t, td and pressure as the passes read them: staged in
  // shared memory at an odd pitch, or in place.
  const int pitch = kStaged ? L | 1 : L;
  const T* ts = t + row0 * L;
  const T* ds = td + row0 * L;
  const T* pr = p + row0 * row_stride;
  T* pp_s = reinterpret_cast<T*>(smem);  // the parcel's pressure a row
  if constexpr (kStaged) {
    T* st = pp_s + R;
    T* sd = st + R * pitch;
    T* sp = sd + R * pitch;
    if (shared_rows)
      for (int c = threadIdx.x; c < L; c += kThreads) sp[c] = p[c];
    tile_walk<kThreads, 4>(n, L, [&](int e, int r, int c) {
      st[r * pitch + c] = ts[e];
      sd[r * pitch + c] = ds[e];
      if (!shared_rows) sp[r * pitch + c] = pr[r * row_stride + c];
    });
    ts = st;
    ds = sd;
    pr = sp;
  }
  __syncthreads();

  // Each row's G threads (consecutive lanes of a warp) take every G-th
  // level, from their lane's; the shuffles combine them.
  const int G = group;
  const int q = threadIdx.x / G, g = threadIdx.x - q * G;
  const int k1 = q < rows ? L : 0;
  const T* pq = shared_rows ? pr : pr + q * pitch;
  const T* tq = ts + q * pitch;
  const T* dq = ds + q * pitch;

  // bottom: nanmax(p), a max over the levels that hold a number (NaN fails
  // every comparison), -inf standing for none.
  T pmax = -inf;
  for (int k = g; k < k1; k += G)
    if (pq[k] > pmax) pmax = pq[k];
  const T bottom = or_nan(group_max(pmax, G), -inf);

  // top: bound_pressure(p, bottom - depth), the level of the smallest
  // |p - bound| (NaN skipped, +inf standing for none), the largest
  // pressure among the levels at it.
  const T bound =
      bottom - (depths != nullptr && q < rows ? depths[row0 + q] : depth);
  T dmin = inf, ptop = -inf;
  for (int k = g; k < k1; k += G) {
    const T x = pq[k];
    const T d = dabs(x - bound);
    if (d < dmin) {
      dmin = d;
      ptop = x;
    } else if (d == dmin && x > ptop) {
      ptop = x;
    }
  }
  for (int m = G / 2; m > 0; m >>= 1) {
    const T od = __shfl_xor_sync(kFullMask, dmin, m, G);
    const T op = __shfl_xor_sync(kFullMask, ptop, m, G);
    if (od < dmin || (od == dmin && op > ptop)) {
      dmin = od;
      ptop = op;
    }
  }
  const T top = dmin == inf ? nan : or_nan(ptop, -inf);

  // The parcel: the first level of the largest theta-e in the layer (NaN
  // skipped; -inf standing for none, as for nanmax).
  T best = -inf;
  int kb = L;
  for (int k = g; k < k1; k += G) {
    const T x = pq[k];
    if (x <= bottom && x >= top) {
      const T th = equivalent_potential_temperature(x, tq[k], dq[k]);
      if (th > best) {
        best = th;
        kb = k;
      }
    }
  }
  for (int m = G / 2; m > 0; m >>= 1) {
    const T ob = __shfl_xor_sync(kFullMask, best, m, G);
    const int ok = __shfl_xor_sync(kFullMask, kb, m, G);
    if (ob > best || (ob == best && ok < kb)) {
      best = ob;
      kb = ok;
    }
  }

  if (q < rows && g == 0) {
    const bool any = best != -inf;
    // nanmax of the one selected value: -inf reads as none.
    const T pp = any ? or_nan(pq[kb], -inf) : nan;
    const int64_t col = row0 + q;
    parcel[col] = pp;
    parcel[B + col] = any ? or_nan(tq[kb], -inf) : nan;
    parcel[2 * B + col] = any ? or_nan(dq[kb], -inf) : nan;
    pp_s[q] = pp;
  }
  __syncthreads();

  const int64_t BL = B * (int64_t)L;
  T* out = fields + row0 * L;
  tile_walk<kThreads, 2>(n, L, [&](int e, int r, int c) {
    const T x = shared_rows ? pr[c] : pr[r * pitch + c];
    const bool keep = x <= pp_s[r];
    out[e] = keep ? x : nan;
    out[BL + e] = keep ? ts[r * pitch + c] : nan;
    out[2 * BL + e] = keep ? ds[r * pitch + c] : nan;
  });
}

template <typename T>
int launch(const void* p, const void* t, const void* td, const void* depths,
           void* fields, void* parcel, int64_t B, int L, int row_stride,
           double depth, void* stream) {
  const bool shared_rows = row_stride == 0;
  // Lanes a row: the most a power of two up to a warp while each keeps
  // kMinLevels levels; rows a tile: the rest of the block, or as many as
  // fit kTileBytes.
  int group = 1;
  while (2 * group <= 32 && L >= 2 * group * kMinLevels) group *= 2;
  // A row too long for the card's shared memory takes a block alone and
  // is read in place.
  const bool staged = tile_bytes<T>(1, L, shared_rows) <= smem_optin();
  const int64_t base = tile_bytes<T>(0, L, shared_rows);
  const int64_t tile_rows =
      staged ? fit_rows(base, tile_bytes<T>(1, L, shared_rows) - base,
                        kTileBytes, kThreads / group)
             : 1;
  return launch_tiles<kThreads>(
      staged ? most_unstable_kernel<T, true> : most_unstable_kernel<T, false>,
      (B + tile_rows - 1) / tile_rows,
      staged ? tile_bytes<T>(tile_rows, L, shared_rows) : (int64_t)sizeof(T),
      stream, (const T*)p, (const T*)t, (const T*)td, (const T*)depths,
      (T*)fields, (T*)parcel, B, L, row_stride, (int)tile_rows, group,
      T(depth));
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  p holds
// B rows of L levels at `row_stride` values apart (0: one row for all, or
// L) with unit level stride; t and td (B, L) contiguous; depths B values,
// a depth in hPa a row, or null for `depth` in every row.  fields (3, B,
// L) and parcel (3, B), each the pressure, temperature and dewpoint, are
// written.
int most_unstable_f32(const void* p, const void* t, const void* td,
                      const void* depths, void* fields, void* parcel,
                      int64_t B, int L, int row_stride, double depth,
                      void* stream) {
  return launch<float>(p, t, td, depths, fields, parcel, B, L, row_stride,
                       depth, stream);
}

int most_unstable_f64(const void* p, const void* t, const void* td,
                      const void* depths, void* fields, void* parcel,
                      int64_t B, int L, int row_stride, double depth,
                      void* stream) {
  return launch<double>(p, t, td, depths, fields, parcel, B, L, row_stride,
                        depth, stream);
}

}  // extern "C"
