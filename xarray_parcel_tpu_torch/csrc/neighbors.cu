// Previous and next valid pressure of every level, for NVIDIA Hopper
// (sm_90a).
//
// Replaces no TPU kernel.  The JAX package leaves bridge_neighbors
// (xarray_parcel_tpu/parcels.py) to XLA's lax.cummin and lax.cummax.  Its
// plain PyTorch form, xarray_parcel_tpu_torch/parcels.py::
// _bridge_neighbors_twin, is ten torch ops over whole (B, L) tensors, 12
// launches on the card: two where, two flip, two full_like, two cat and
// the scans torch.cummin and torch.cummax.  Those scans are PyTorch's
// innermost-dimension scan, built for long rows, and write an int64 index
// the program drops: about 9.8 ns a row at 13 to 90 levels on an H100, 43%
// of the fused pipeline's card time at 13 levels.  This kernel is the
// function in one launch, with the twin's values bit for bit (its outputs
// are copies of input values):
//   * prev[k], the smallest valid pressure at levels < k, +inf if none;
//   * next[k], the largest valid pressure at levels > k, -inf if none.
// An invalid level enters prev's scan as +inf and next's as -inf, as the
// twin's where makes it.  Each scan takes torch.cummin's (cummax's) update
// rule: a level replaces the running value if it is NaN, or if the running
// value is not NaN and the level is <= it (>= for next).  So a NaN under a
// true mask runs on through prev and back through next.
//
// What bounds it: device memory, with almost no arithmetic.  Per level it
// reads the pressure (4 bytes in float32) and the mask (1) and writes prev
// and next (8): 13 bytes, 25 in float64.  A pressure shared by every row
// (row stride 0: the broadcast of 1-D isobaric levels) is one row, read in
// place, which leaves 9 (17).  At 5,191,200 x 13 in float32 that is
// 0.61 GB, 0.18 ms at 3.35 TB/s.  On an H100 at 700 W (chip_smoke.py) the
// kernel takes 0.26 ms there, the plain twin 102 ms; 0.38 ms at 786,432
// contiguous columns of 90 levels (bound 0.27), the twin 17 ms.
//
// Design: a block owns a tile of consecutive rows, one thread a row for
// the scans.  Its kThreads threads stage the tile's pressure and mask into
// shared memory with coalesced loads (consecutive threads on consecutive
// levels of the tile, R x L values contiguous when the row stride is L),
// already masked: one copy for each scan.  Each row's thread then runs the
// forward scan and the backward scan in place on its two rows, and the
// block writes both tiles back with coalesced stores.  The rows sit at an
// odd pitch (L | 1) so that the threads of a warp, one row each, fall on
// distinct banks at every level; a vector load would scatter into that
// pitch with four-way conflicts, so the loads are scalar, kept in flight
// by unrolling and by the blocks an SM holds.  The tile's rows R come from
// L and the dtype: as many as fit kTileBytes, up to kThreads, so that some
// 16 blocks (the SM's 2,048 threads) fit an SM's shared memory at any L;
// a row longer than that tile takes a block alone, up to the opt-in
// shared memory.  A warp per row would leave 19 of 32 lanes idle at 13
// levels.
//
// Built with -fmad=false (see _build.py), as every kernel of the port; it
// does no arithmetic on the values.

#include "column.cuh"

namespace {

constexpr int kThreads = 128;          // threads a block, rows at most
constexpr int kTileBytes = 12 * 1024;  // shared memory a block, but one row

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bridge_neighbors_kernel(const T* __restrict__ p,
                            const unsigned char* __restrict__ valid,
                            T* __restrict__ prev, T* __restrict__ next,
                            int64_t B, int L, int row_stride, int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int pitch = L | 1;
  T* lo = reinterpret_cast<T*>(smem);  // prev's scan: its input, then prev
  T* hi = lo + tile_rows * pitch;      // next's scan: its input, then next
  const int64_t row0 = (int64_t)blockIdx.x * tile_rows;
  const int rows = (int)(B - row0 < tile_rows ? B - row0 : tile_rows);
  const int n = rows * L;
  const T inf = Num<T>::inf();

  const unsigned char* vt = valid + row0 * L;
  tile_walk<kThreads, 4>(n, L, [&](int e, int r, int c) {
    const T x = p[(row0 + r) * row_stride + c];
    const bool ok = vt[e] != 0;
    lo[r * pitch + c] = ok ? x : inf;
    hi[r * pitch + c] = ok ? x : -inf;
  });
  __syncthreads();

  if (threadIdx.x < rows) {
    T* f = lo + threadIdx.x * pitch;
    T run = inf;
    for (int k = 0; k < L; ++k) {
      const T x = f[k];
      f[k] = run;
      if (isnan_(x) || (!isnan_(run) && x <= run)) run = x;
    }
    T* b = hi + threadIdx.x * pitch;
    run = -inf;
    for (int k = L - 1; k >= 0; --k) {
      const T x = b[k];
      b[k] = run;
      if (isnan_(x) || (!isnan_(run) && x >= run)) run = x;
    }
  }
  __syncthreads();

  T* pt = prev + row0 * L;
  T* nt = next + row0 * L;
  tile_walk<kThreads, 4>(n, L, [&](int e, int r, int c) {
    pt[e] = lo[r * pitch + c];
    nt[e] = hi[r * pitch + c];
  });
}

template <typename T>
int launch(const void* p, const void* valid, void* prev, void* next,
           int64_t B, int L, int row_stride, void* stream) {
  const int64_t row_bytes = 2 * (int64_t)(L | 1) * (int64_t)sizeof(T);
  const int64_t tile_rows = fit_rows(0, row_bytes, kTileBytes, kThreads);
  return launch_tiles<kThreads>(
      bridge_neighbors_kernel<T>, (B + tile_rows - 1) / tile_rows,
      tile_rows * row_bytes, stream, (const T*)p, (const unsigned char*)valid,
      (T*)prev, (T*)next, B, L, row_stride, (int)tile_rows);
}

}  // namespace

extern "C" {

// Launch on `stream`; returns cudaGetLastError() (0 on success).  p holds
// B rows of L levels at `row_stride` values apart (0: one row for all, or
// L) with unit level stride; valid (B, L) bool; prev and next (B, L) are
// written.
int bridge_neighbors_f32(const void* p, const void* valid, void* prev,
                         void* next, int64_t B, int L, int row_stride,
                         void* stream) {
  return launch<float>(p, valid, prev, next, B, L, row_stride, stream);
}

int bridge_neighbors_f64(const void* p, const void* valid, void* prev,
                         void* next, int64_t B, int L, int row_stride,
                         void* stream) {
  return launch<double>(p, valid, prev, next, B, L, row_stride, stream);
}

}  // extern "C"
