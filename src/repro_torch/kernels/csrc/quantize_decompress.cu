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
// What bounds it: memory bytes, 12 B per element (read x, read u, write
// y). At the main path's size (R = 16 clients, N = 210 logreg parameters)
// one call moves ~40 KB, ~12 ns at 3.35 TB/s: there a call is bound by
// its one launch and the host's call.
//
// Design (csrc/row_reduce.cuh): one launch a call for rows of up to
// 262,144 elements, x read from HBM once: one CTA per row with the row in
// registers (row_cta, N <= 4,096), or one thread-block cluster per row
// with the row in shared memory and the partial maxima exchanged through
// distributed shared memory (row_cluster). Longer rows take two passes
// (row_stream). No atomics, no host sync.

#include "row_reduce.cuh"

namespace {

struct quantize {
  static constexpr float kInit = 0.0f;
  __device__ static float acc(float a, float v) { return fmaxf(a, fabsf(v)); }
  __device__ static float combine(float a, float b) { return fmaxf(a, b); }
  // scale = max(max|x|, 1e-30) * f32(1 / levels), also the row's aux
  __device__ static float scale(float absmax, float inv_levels, float* aux) {
    const float s = __fmul_rn(fmaxf(absmax, 1e-30f), inv_levels);
    *aux = s;
    return s;
  }
  template <bool>
  __device__ static float elem(float x, float u, float, float scale) {
    const float level = floorf(__fadd_rn(__fdiv_rn(fabsf(x), scale), u));
    // torch.sign: +1, -1, or +0 (also for -0)
    const float sign = static_cast<float>((x > 0.0f) - (x < 0.0f));
    return __fmul_rn(__fmul_rn(sign, level), scale);
  }
};

}  // namespace

extern "C" {

// One call, its arguments packed as rowred::Args {variant (0 row_cta,
// 1 row_cluster, 2 row_stream), x, u, u's row stride (n), sigma (NULL),
// inv_levels (double), y, scale, partial (row_stream scratch), rows, n,
// geometry g0 / g1, stream}. Returns the CUDA error as an int.
int quantize_decompress_launch(const void* packed) {
  return rowred::launch<quantize, true>(rowred::unpack(packed));
}

const char* quantize_decompress_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
