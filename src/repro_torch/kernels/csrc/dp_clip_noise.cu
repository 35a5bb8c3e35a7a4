// Row-batched DP clip + noise for Hopper (sm_90a): the Eq.-7a step of
// DP-PASGD, applied to every client's flat gradient at once.
//
// Replaces the Pallas TPU kernel `dp_clip_noise` of
// src/repro/kernels/dp_clip_noise.py (`_sqnorm_kernel`,
// `_scale_noise_kernel`, `_scale_kernel`). That kernel works on one flat
// (N,) gradient; this one takes R rows, because the port keeps the client
// axis as an explicit batch dimension. For g (R, N) f32, contiguous:
//
//   norm[r] = ||g[r]||_2
//   y[r]    = g[r] * min(1, C / max(norm[r], 1e-12)) + sigma[r] * noise[r]
//
// and with noise == NULL the clip-only variant, which streams no noise.
// Rows of noise may be strided (row r starts at noise + r * noise_stride),
// so a (C, tau, N) noise block feeds step t without a copy.
//
// What bounds it: memory bytes. At best 12 B per element (read g, read
// noise, write y); as written 16 B, because kernel 1 reads g once more.
// At the main path's size (R = 16 clients, N = 210 logreg parameters) one
// call moves ~54 KB, ~16 ns at 3.35 TB/s: there the kernel is bound by its
// two launches, not by memory.
//
// Design: two launches, no atomics, no host sync.
//   kernel 1  grid (B, R): block (b, r) writes the sum of squares of chunk b
//             of row r (coalesced loads, warp shuffles, then shared memory).
//   kernel 2  grid (B, R): every block reduces its row's B partials in one
//             fixed order (so the norm is deterministic), derives the
//             scale, and streams y over its chunk; block (0, r) writes
//             norm[r].
// B = ceil(N / kChunk), so B = 1 when N is small.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kChunk = 8192;  // elements of one row per block

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, off);
  }
  return v;
}

// Sum over the block in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ float block_sum(float v) {
  __shared__ float warp_part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  v = (threadIdx.x < kWarps) ? warp_part[threadIdx.x] : 0.0f;
  if (warp == 0) v = warp_sum(v);
  return v;
}

__device__ __forceinline__ int64_t chunk_end(int64_t begin, int64_t n) {
  return (begin + kChunk < n) ? begin + kChunk : n;
}

__global__ void __launch_bounds__(kThreads)
sqnorm_partials(const float* __restrict__ g, int64_t n, int nb,
                float* __restrict__ partial) {
  const int64_t row = blockIdx.y;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t end = chunk_end(begin, n);
  const float* g_row = g + row * n;
  float acc = 0.0f;
#pragma unroll 4
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    const float x = g_row[i];
    acc = fmaf(x, x, acc);
  }
  acc = block_sum(acc);
  if (threadIdx.x == 0) partial[row * nb + blockIdx.x] = acc;
}

template <bool kNoise>
__global__ void __launch_bounds__(kThreads)
scale_noise(const float* __restrict__ g, const float* __restrict__ noise,
            const float* __restrict__ sigma, float clip_norm,
            int64_t noise_stride, const float* __restrict__ partial,
            int64_t n, int nb, float* __restrict__ y,
            float* __restrict__ norm) {
  __shared__ float s_scale;
  const int64_t row = blockIdx.y;
  float ss = 0.0f;
  for (int i = threadIdx.x; i < nb; i += kThreads) ss += partial[row * nb + i];
  ss = block_sum(ss);
  if (threadIdx.x == 0) {
    const float nrm = sqrtf(ss);
    s_scale = fminf(1.0f, clip_norm / fmaxf(nrm, 1e-12f));
    if (blockIdx.x == 0) norm[row] = nrm;
  }
  __syncthreads();
  const float scale = s_scale;
  const float sg = kNoise ? sigma[row] : 0.0f;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t end = chunk_end(begin, n);
  const int64_t base = row * n;
#pragma unroll 4
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    float v = g[base + i] * scale;
    if (kNoise) v = fmaf(sg, noise[row * noise_stride + i], v);
    y[base + i] = v;
  }
}

}  // namespace

extern "C" {

// Partial sums per row: the wrapper sizes the (R, B) scratch buffer by it.
int64_t dp_clip_noise_partials(int64_t n) { return (n + kChunk - 1) / kChunk; }

// Launches both kernels on `stream`; returns cudaGetLastError() as an int.
// `noise` and `sigma` may be NULL (clip only). `partial` is (rows, B) f32.
int dp_clip_noise_launch(const float* g, const float* noise,
                         int64_t noise_stride, const float* sigma,
                         float clip_norm, float* partial, float* y,
                         float* norm, int64_t rows, int64_t n, void* stream) {
  const int nb = static_cast<int>(dp_clip_noise_partials(n));
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sqnorm_partials<<<grid, kThreads, 0, s>>>(g, n, nb, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (noise != nullptr) {
    scale_noise<true><<<grid, kThreads, 0, s>>>(g, noise, sigma, clip_norm,
                                                 noise_stride, partial, n, nb,
                                                 y, norm);
  } else {
    scale_noise<false><<<grid, kThreads, 0, s>>>(g, nullptr, nullptr,
                                                  clip_norm, 0, partial, n,
                                                  nb, y, norm);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dp_clip_noise_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
