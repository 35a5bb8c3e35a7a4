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
// What bounds it: memory bytes, 12 B per element (read g, read noise,
// write y). At the main path's size (R = 16 clients, N = 210 logreg
// parameters) one call moves ~40 KB, ~12 ns at 3.35 TB/s: there a call is
// bound by its one launch and the host's call.
//
// Design (csrc/row_reduce.cuh): one launch a call for rows of up to
// 262,144 elements, g read from HBM once: one CTA per row with the row in
// registers (row_cta, N <= 4,096), or one thread-block cluster per row
// with the row in shared memory and the partial sums of squares exchanged
// through distributed shared memory (row_cluster). Longer rows take two
// passes (row_stream). No atomics, no host sync; the sum of squares is
// taken in one fixed order, so the norm is deterministic.

#include "row_reduce.cuh"

namespace {

struct clip_noise {
  static constexpr float kInit = 0.0f;
  __device__ static float acc(float a, float v) { return fmaf(v, v, a); }
  __device__ static float combine(float a, float b) { return a + b; }
  // scale = min(1, C / max(norm, 1e-12)); the row's norm goes to aux
  __device__ static float scale(float sum_sq, float clip_norm, float* aux) {
    const float norm = sqrtf(sum_sq);
    *aux = norm;
    return fminf(1.0f, clip_norm / fmaxf(norm, 1e-12f));
  }
  template <bool kNoise>
  __device__ static float elem(float g, float noise, float sigma,
                               float scale) {
    const float v = g * scale;
    return kNoise ? fmaf(sigma, noise, v) : v;
  }
};

}  // namespace

extern "C" {

// One call, its arguments packed as rowred::Args {variant (0 row_cta,
// 1 row_cluster, 2 row_stream), g, noise (or NULL: clip only),
// noise_stride, sigma, clip_norm (double), y, norm, partial (row_stream
// scratch), rows, n, geometry g0 / g1, stream}. Returns the CUDA error as
// an int.
int dp_clip_noise_launch(const void* packed) {
  const rowred::Args a = rowred::unpack(packed);
  return a.z != nullptr ? rowred::launch<clip_noise, true>(a)
                        : rowred::launch<clip_noise, false>(a);
}

const char* dp_clip_noise_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
