// Row-batched QSGD quantize -> dequantize for Hopper (sm_90a): the wire
// round trip of the aggregation pipeline's qsgd compressor, applied to
// every client's flat error-fed update at once.
//
// Replaces the Pallas TPU kernel `quantize_decompress` of
// src/repro/kernels/quantize_decompress.py (`_absmax_kernel`,
// `_quant_kernel`). That kernel works on one flat (N,) update under
// jax.vmap; this one takes R rows, because the port keeps the client axis
// as an explicit batch dimension. For x, u (R, N) f32, contiguous:
//
//   scale[r] = max(max|x[r]|, 1e-30) * inv_levels,  inv_levels = f32(1/levels)
//   y[r]     = sign(x[r]) * floor(|x[r]| / scale[r] + u[r]) * scale[r]
//
// with levels = 2^bits - 1. The scale is the max times the f32 reciprocal
// of the level count, because that is what the JAX package computes under
// jit (XLA rewrites its division by the constant level count into that
// multiply); |x| / scale is a true divide. Every rounding is pinned with
// __fdiv_rn / __fadd_rn / __fmul_rn, so nvcc cannot contract the add and
// the multiplies into an FMA, and the kernel equals its plain PyTorch
// version (kernels/ref.py) bit for bit: a max has no order to differ in.
//
// What bounds it: memory bytes. At best 12 B per element (read x, read u,
// write y); as written 16 B, because kernel 1 reads x once more. At the
// main path's size (R = 16 clients, N = 210 logreg parameters) one call
// moves ~40 KB, ~12 ns at 3.35 TB/s: there the kernel is bound by its two
// launches, not by memory.
//
// Design: two launches, no atomics, no host sync.
//   kernel 1  grid (B, R): block (b, r) writes max|x| over chunk b of row r.
//   kernel 2  grid (B, R): every block reduces its row's B partials (max is
//             exact, so every block gets the same value), forms the scale
//             and streams y over its chunk; block (0, r) writes scale[r].
// B = ceil(N / kChunk), so B = 1 when N is small.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int64_t kChunk = 8192;  // elements of one row per block

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// Max over the block; the result is valid in thread 0.
__device__ __forceinline__ float block_max(float v) {
  __shared__ float warp_part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_max(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  v = (threadIdx.x < kWarps) ? warp_part[threadIdx.x] : 0.0f;
  if (warp == 0) v = warp_max(v);
  return v;
}

__device__ __forceinline__ int64_t chunk_end(int64_t begin, int64_t n) {
  return (begin + kChunk < n) ? begin + kChunk : n;
}

__global__ void __launch_bounds__(kThreads)
absmax_partials(const float* __restrict__ x, int64_t n, int nb,
                float* __restrict__ partial) {
  const int64_t row = blockIdx.y;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t end = chunk_end(begin, n);
  const float* x_row = x + row * n;
  float m = 0.0f;
#pragma unroll 4
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    m = fmaxf(m, fabsf(x_row[i]));
  }
  m = block_max(m);
  if (threadIdx.x == 0) partial[row * nb + blockIdx.x] = m;
}

__global__ void __launch_bounds__(kThreads)
quantize(const float* __restrict__ x, const float* __restrict__ u,
         float inv_levels, const float* __restrict__ partial, int64_t n,
         int nb, float* __restrict__ y, float* __restrict__ scale_out) {
  __shared__ float s_scale;
  const int64_t row = blockIdx.y;
  float m = 0.0f;
  for (int i = threadIdx.x; i < nb; i += kThreads) {
    m = fmaxf(m, partial[row * nb + i]);
  }
  m = block_max(m);
  if (threadIdx.x == 0) {
    s_scale = __fmul_rn(fmaxf(m, 1e-30f), inv_levels);
    if (blockIdx.x == 0) scale_out[row] = s_scale;
  }
  __syncthreads();
  const float scale = s_scale;
  const int64_t begin = static_cast<int64_t>(blockIdx.x) * kChunk;
  const int64_t end = chunk_end(begin, n);
  const int64_t base = row * n;
#pragma unroll 4
  for (int64_t i = begin + threadIdx.x; i < end; i += kThreads) {
    const float v = x[base + i];
    const float level = floorf(__fadd_rn(__fdiv_rn(fabsf(v), scale),
                                         u[base + i]));
    // torch.sign: +1, -1, or +0 (also for -0)
    const float sign = static_cast<float>((v > 0.0f) - (v < 0.0f));
    y[base + i] = __fmul_rn(__fmul_rn(sign, level), scale);
  }
}

}  // namespace

extern "C" {

// Partials per row: the wrapper sizes the (R, B) scratch buffer by it.
int64_t quantize_decompress_partials(int64_t n) {
  return (n + kChunk - 1) / kChunk;
}

// Launches both kernels on `stream`; returns cudaGetLastError() as an int.
// `partial` is (rows, B) f32 scratch; `y` is (rows, n), `scale` (rows,).
int quantize_decompress_launch(const float* x, const float* u,
                               float inv_levels, float* partial, float* y,
                               float* scale, int64_t rows, int64_t n,
                               void* stream) {
  const int nb = static_cast<int>(quantize_decompress_partials(n));
  const dim3 grid(static_cast<unsigned>(nb), static_cast<unsigned>(rows));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  absmax_partials<<<grid, kThreads, 0, s>>>(x, n, nb, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  quantize<<<grid, kThreads, 0, s>>>(x, u, inv_levels, partial, n, nb, y,
                                     scale);
  return static_cast<int>(cudaGetLastError());
}

const char* quantize_decompress_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
