// Native host-side ingest runtime for xarray_parcel_tpu_torch.
//
// The device path starts at the copy to the GPU; everything in front of it
// (validating the reference's data invariants, repacking float64 xarray
// buffers to float32 feed arrays, moving the vertical dim to the trailing
// axis, compacting leading NaNs) is host-side, bandwidth-bound work.  The
// reference leaves this to xarray/dask workers (its `valid_data` and
// `shift_out_nans`); here it is a small multithreaded C++ library bound via
// ctypes (see __init__.py), with a NumPy form of each function for when it
// is not built.  The code is the JAX package's ingest.cc.
//
// All functions operate on C-contiguous buffers; `n_cols` columns of `L`
// levels with the level axis fastest (trailing).

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// Run fn(col_begin, col_end) over [0, n) split across hardware threads.
template <typename F>
void parallel_for(int64_t n, F fn) {
  unsigned hw = std::thread::hardware_concurrency();
  int64_t n_threads = hw ? static_cast<int64_t>(hw) : 1;
  if (n_threads > n) n_threads = n > 0 ? n : 1;
  if (n_threads <= 1) {
    fn(0, n);
    return;
  }
  std::vector<std::thread> threads;
  threads.reserve(n_threads);
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int64_t t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    threads.emplace_back([=] { fn(lo, hi); });
  }
  for (auto& th : threads) th.join();
}

template <typename T>
void validate_columns_impl(const T* p, int64_t n_cols, int64_t L,
                           uint8_t* ok) {
  parallel_for(n_cols, [=](int64_t lo, int64_t hi) {
    for (int64_t c = lo; c < hi; ++c) {
      const T* col = p + c * L;
      uint8_t good = 1;
      bool seen_nan = std::isnan(col[0]);  // leading NaN: nothing may follow
      for (int64_t k = 1; k < L; ++k) {
        T a = col[k - 1], b = col[k];
        if (std::isnan(b)) {
          seen_nan = true;
          continue;
        }
        // Valid columns are strictly decreasing with NaN padding only at
        // the top (a non-NaN after a NaN is malformed).
        if (seen_nan || (!std::isnan(a) && b >= a)) {
          good = 0;
          break;
        }
      }
      ok[c] = good;
    }
  });
}

}  // namespace

extern "C" {

// Per-column validation of the reference's input invariant (pressure
// strictly decreasing along the level axis, NaN padding allowed at the top).
// `ok` receives 1/0 per column.
void xpt_validate_columns_f32(const float* p, int64_t n_cols, int64_t L,
                              uint8_t* ok) {
  validate_columns_impl(p, n_cols, L, ok);
}
void xpt_validate_columns_f64(const double* p, int64_t n_cols, int64_t L,
                              uint8_t* ok) {
  validate_columns_impl(p, n_cols, L, ok);
}

// Parallel float64 -> float32 conversion (xarray buffers are commonly f64;
// the device feed is f32).
void xpt_repack_f64_to_f32(const double* src, float* dst, int64_t n) {
  parallel_for(n, [=](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) dst[i] = static_cast<float>(src[i]);
  });
}

// Transpose a level-leading buffer (L, n_cols) to level-trailing
// (n_cols, L) — the vert-dim-to-last move of the xarray ingest boundary —
// with optional f64 input.
void xpt_levels_to_last_f32(const float* src, float* dst, int64_t L,
                            int64_t n_cols) {
  parallel_for(n_cols, [=](int64_t lo, int64_t hi) {
    for (int64_t c = lo; c < hi; ++c)
      for (int64_t k = 0; k < L; ++k) dst[c * L + k] = src[k * n_cols + c];
  });
}
void xpt_levels_to_last_f64_to_f32(const double* src, float* dst, int64_t L,
                                   int64_t n_cols) {
  parallel_for(n_cols, [=](int64_t lo, int64_t hi) {
    for (int64_t c = lo; c < hi; ++c)
      for (int64_t k = 0; k < L; ++k)
        dst[c * L + k] = static_cast<float>(src[k * n_cols + c]);
  });
}

// In-place left-compaction of leading NaNs in `key`, applied to n_fields
// stacked field buffers of shape (n_cols, L) sharing the key's NaN pattern.
// Host-side equivalent of ops.compact_left (device) and the reference's
// shift_out_nans (reference: modules/parcel_functions.py:1699-1720).
void xpt_compact_left_f32(const float* key, float** fields, int64_t n_fields,
                          int64_t n_cols, int64_t L) {
  parallel_for(n_cols, [=](int64_t lo, int64_t hi) {
    for (int64_t c = lo; c < hi; ++c) {
      const float* kcol = key + c * L;
      int64_t lead = 0;
      while (lead < L && std::isnan(kcol[lead])) ++lead;
      if (lead == 0 || lead == L) continue;
      for (int64_t f = 0; f < n_fields; ++f) {
        float* col = fields[f] + c * L;
        std::memmove(col, col + lead, (L - lead) * sizeof(float));
        for (int64_t k = L - lead; k < L; ++k) col[k] = NAN;
      }
    }
  });
}

}  // extern "C"
