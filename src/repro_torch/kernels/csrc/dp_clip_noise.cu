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

// -- the split form -----------------------------------------------------------
//
// Under a model axis a client's gradient is split over ranks, and its norm
// is the square root of a sum over them, so the call splits into its two
// phases with an all-reduce between them (core/clipping.py):
//
//   row_sumsq         s[r] = sum_j x[r, j]^2     (x rows of stride x_stride)
//   clip_noise_apply  y[r] = x[r] * min(1, C / max(norm[r], 1e-12))
//                            + sigma[r] * noise[r]        (or clip only)
//
// Both walk 8,192-element chunks over a grid of up to 4 blocks a SM, the
// passes of row_stream without its on-chip fast paths: a simple form, its
// order fixed (a chunk's strided walk, warp and block trees, then a row's
// partials in chunk order). row_sumsq writes its partials straight into s
// when a row is one chunk (one launch), else into a scratch that a second
// launch sums a row at a time. What bounds both: memory bytes, 4 B an
// element for row_sumsq and 12 B (8 B clip only) for clip_noise_apply.

using rowred::kThreads;

// one partial per chunk: chunk c covers row c / g1, elements
// [(c % g1) g0, + g0); row r starts at x + r * z_stride
__global__ void __launch_bounds__(kThreads, rowred::kStreamBlocksPerSm)
    sumsq_partials(rowred::Rows a) {
  const int64_t total = a.rows * a.g1;
  for (int64_t c = blockIdx.x; c < total; c += gridDim.x) {
    const int64_t row = c / a.g1, b = (c % a.g1) * a.g0;
    const int64_t len = a.n - b < a.g0 ? a.n - b : a.g0;
    const float v = rowred::block_reduce<clip_noise>(
        rowred::reduce_global<clip_noise>(a.x + row * a.z_stride + b, len));
    if (threadIdx.x == 0) a.partial[c] = v;
    __syncthreads();                 // block_reduce's shared array again
  }
}

// a row's g1 partials summed in one order: one block a row
__global__ void __launch_bounds__(kThreads) sumsq_rows(rowred::Rows a) {
  const int64_t row = blockIdx.x;
  float acc = 0.0f;
  for (int64_t i = threadIdx.x; i < a.g1; i += kThreads) {
    acc += a.partial[row * a.g1 + i];
  }
  acc = rowred::block_reduce<clip_noise>(acc);
  if (threadIdx.x == 0) a.aux[row] = acc;
}

// y from x (contiguous), the row norms in aux and the noise rows
template <bool kNoise>
__global__ void __launch_bounds__(kThreads, rowred::kStreamBlocksPerSm)
    apply_rows(rowred::Rows a) {
  const int64_t total = a.rows * a.g1;
  for (int64_t c = blockIdx.x; c < total; c += gridDim.x) {
    const int64_t row = c / a.g1, b = (c % a.g1) * a.g0;
    const int64_t len = a.n - b < a.g0 ? a.n - b : a.g0;
    const float scale = fminf(1.0f, a.param / fmaxf(a.aux[row], 1e-12f));
    const float sg = (kNoise && a.sigma) ? __ldg(a.sigma + row) : 0.0f;
    const float* x = a.x + row * a.n + b;
    const int px = rowred::phase(x);
    rowred::write_slice<clip_noise, kNoise, false>(
        x - px, px, kNoise ? a.z + row * a.z_stride + b : nullptr,
        a.y + row * a.n + b, len, sg, scale);
  }
}

// the grid of a chunked pass: as many chunks a block as fill 4 blocks a SM
inline unsigned chunk_grid(int64_t chunks) {
  const int64_t fill =
      static_cast<int64_t>(rowred::sm_count()) * rowred::kStreamBlocksPerSm;
  const int64_t each = (chunks + fill - 1) / fill;
  return static_cast<unsigned>((chunks + each - 1) / each);
}

inline rowred::Rows rows_of(const rowred::Args& a) {
  return {a.x, a.z, a.z_stride, a.sigma, static_cast<float>(a.param),
          a.y, a.aux, a.partial, a.rows, a.n, a.g0, a.g1};
}

}  // namespace

extern "C" {

// row_sumsq: Args {-, x, -, x row stride (in z_stride), -, -, -, s (aux),
// partial ((rows, g1) scratch, or s itself when g1 == 1), rows, n, g0
// elements a chunk, g1 chunks a row, stream}. Returns the CUDA error.
int row_sumsq_launch(const void* packed) {
  const rowred::Args a = rowred::unpack(packed);
  const rowred::Rows r = rows_of(a);
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  sumsq_partials<<<chunk_grid(a.rows * a.g1), kThreads, 0, st>>>(r);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.g1 == 1) return static_cast<int>(e);
  sumsq_rows<<<static_cast<unsigned>(a.rows), kThreads, 0, st>>>(r);
  return static_cast<int>(cudaGetLastError());
}

// clip_noise_apply: Args {-, x, noise (or NULL: clip only), noise row
// stride, sigma, clip norm, y, norm (aux, read), -, rows, n, g0, g1,
// stream}. Returns the CUDA error.
int clip_noise_apply_launch(const void* packed) {
  const rowred::Args a = rowred::unpack(packed);
  const rowred::Rows r = rows_of(a);
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  const unsigned grid = chunk_grid(a.rows * a.g1);
  if (a.z != nullptr) {
    apply_rows<true><<<grid, kThreads, 0, st>>>(r);
  } else {
    apply_rows<false><<<grid, kThreads, 0, st>>>(r);
  }
  return static_cast<int>(cudaGetLastError());
}

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
