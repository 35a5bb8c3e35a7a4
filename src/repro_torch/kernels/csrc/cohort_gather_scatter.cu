// Cohort row gather / scatter over the device-resident cohort cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `cohort_gather_scatter` of
// src/repro/kernels/cohort_gather.py (`_gather_kernel`, `_scatter_kernel`).
// For a cache (S, D) of any element type, slots (K,) int64, unique, in
// [0, S), and rows (K, D) of the cache's type, all contiguous:
//
//   gather   rows[k]        = cache[slots[k]]
//   scatter  cache[slots[k]] = rows[k]      (in place; the other rows stay)
//
// Both are pure copies, so the kernel treats a row as D * itemsize bytes and
// one source serves the f32 residual, the f32 and int32 data shards and bf16.
// Slots are unique by contract, so the scatter has no write conflicts and
// needs no atomics. A slot outside [0, S) traps (the launch then fails and
// the context reports it at the next synchronisation) instead of reading or
// writing outside the cache.
//
// What bounds it: memory bytes. It reads K rows and writes K rows
// (2 * K * D * itemsize bytes) and computes nothing. At the resident
// driver's sizes (K = 16 rows of 42 to 800 elements) one call moves a few
// KB to 100 KB, far below what one launch costs: there the launch bounds it.
//
// Design: grid (chunks of a row, K); each block reads its row's slot once,
// checks it, and copies its chunk with the widest vector type W in
// {16, 8, 4, 2, 1} bytes that divides the row's byte length and both base
// pointers (the launcher picks W; 16-byte copies when rows allow them).
// Neighbouring threads copy neighbouring vectors.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int64_t kChunk = static_cast<int64_t>(kThreads) * kUnroll;

// Row k of the (K, row) block <-> row slots[k] of the (S, row) cache: the
// gather copies cache -> block, the scatter block -> cache.
template <typename T, bool kScatter>
__global__ void __launch_bounds__(kThreads)
copy_rows(const T* __restrict__ src_base, T* __restrict__ dst_base,
          const int64_t* __restrict__ slots, int64_t n_vec,
          int64_t n_cache_rows) {
  const int64_t k = blockIdx.y;
  const int64_t slot = slots[k];
  if (slot < 0 || slot >= n_cache_rows) __trap();
  const T* src = src_base + (kScatter ? k : slot) * n_vec;
  T* dst = dst_base + (kScatter ? slot : k) * n_vec;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * kChunk;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const int64_t i = begin + u * kThreads + threadIdx.x;
    if (i < n_vec) dst[i] = src[i];
  }
}

// The widest vector width (bytes) dividing the row bytes and both pointers.
int vector_width(const void* a, const void* b, int64_t row_bytes) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b) |
                         static_cast<uintptr_t>(row_bytes);
  for (int w = 16; w > 1; w >>= 1) {
    if ((bits & static_cast<uintptr_t>(w - 1)) == 0) return w;
  }
  return 1;
}

template <typename T>
int launch(bool scatter, void* cache, const int64_t* slots, void* rows,
           int64_t k, int64_t row_bytes, int64_t n_cache_rows,
           cudaStream_t stream) {
  const int64_t n_vec = row_bytes / static_cast<int64_t>(sizeof(T));
  const dim3 grid(static_cast<unsigned>((n_vec + kChunk - 1) / kChunk),
                  static_cast<unsigned>(k));
  if (scatter) {
    copy_rows<T, true><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(rows), static_cast<T*>(cache), slots, n_vec,
        n_cache_rows);
  } else {
    copy_rows<T, false><<<grid, kThreads, 0, stream>>>(
        static_cast<const T*>(cache), static_cast<T*>(rows), slots, n_vec,
        n_cache_rows);
  }
  return static_cast<int>(cudaGetLastError());
}

int dispatch(bool scatter, void* cache, const int64_t* slots, void* rows,
             int64_t k, int64_t row_bytes, int64_t n_cache_rows,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vector_width(cache, rows, row_bytes)) {
    case 16:
      return launch<uint4>(scatter, cache, slots, rows, k, row_bytes,
                          n_cache_rows, s);
    case 8:
      return launch<uint2>(scatter, cache, slots, rows, k, row_bytes,
                          n_cache_rows, s);
    case 4:
      return launch<uint32_t>(scatter, cache, slots, rows, k, row_bytes,
                              n_cache_rows, s);
    case 2:
      return launch<uint16_t>(scatter, cache, slots, rows, k, row_bytes,
                              n_cache_rows, s);
    default:
      return launch<uint8_t>(scatter, cache, slots, rows, k, row_bytes,
                             n_cache_rows, s);
  }
}

}  // namespace

extern "C" {

// The vector width in bytes a launch on these pointers would copy with.
int cohort_gather_scatter_width(const void* cache, const void* rows,
                                int64_t row_bytes) {
  return vector_width(cache, rows, row_bytes);
}

// rows (k, row_bytes) <- cache[slots]; returns cudaGetLastError() as an int.
int cohort_gather_launch(const void* cache, const int64_t* slots, void* rows,
                         int64_t k, int64_t row_bytes, int64_t n_cache_rows,
                         void* stream) {
  return dispatch(false, const_cast<void*>(cache), slots, rows, k, row_bytes,
                  n_cache_rows, stream);
}

// cache[slots] <- rows (k, row_bytes), in place; returns cudaGetLastError().
int cohort_scatter_launch(void* cache, const int64_t* slots, const void* rows,
                          int64_t k, int64_t row_bytes, int64_t n_cache_rows,
                          void* stream) {
  return dispatch(true, cache, slots, const_cast<void*>(rows), k, row_bytes,
                  n_cache_rows, stream);
}

const char* cohort_gather_scatter_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
