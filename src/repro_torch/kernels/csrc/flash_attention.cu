// Causal (optionally sliding-window) flash attention for Hopper (sm_90a):
// the prefill attention of every `attn` / `shared_attn` layer.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (`_flash_kernel`). For q, k, v
// (B, H, S, hd) contiguous, f32 or bf16, one head count (GQA expanded by
// the caller), and every query row q:
//
//   s[k]  = (q_row * 1/sqrt(hd)) . k_row        for k <= q and, with a
//           window W > 0, k > q - W; else -1e30
//   out   = sum_k exp(s[k] - m) v_row / max(sum_k exp(s[k] - m), 1e-30)
//
// with the online softmax of the Pallas kernel (running max m, running
// denominator l, accumulator rescaled by exp(m_old - m_new)), all in f32,
// the output rounded once to the inputs' dtype. As in the Pallas kernel,
// key tiles past the diagonal and before the window are never read: a q
// tile visits keys [max(q0 - W + 1, 0), q_last] only, so the 29 sliding
// window layers of gemma3 cost O(S * W), not O(S^2). Any S >= 1: the
// ragged tail of the last q and k tiles is masked (the TPU kernel asserts
// S % block == 0 instead).
//
// What bounds it: operations. At gemma3's prefill (B 2, H 8, S 2048,
// hd 256) one full layer is 2 * 2 * B*H*S*S/2*hd ~ 34 GFLOP against 67 MB
// of q, k, v and output, ~500 FLOP per byte. This first version runs them
// on the f32 CUDA cores (67 TFLOP/s peak) whatever the inputs' type, while
// the bound of bf16 inputs is the bf16 tensor cores' 989 TFLOP/s: it runs
// far from that bound, and tensor-core products (`mma` / `wgmma`) are
// later work.
//
// Design: one block of 128 threads per (b*h, 32-row q tile). The q tile
// (pre-scaled, f32) stays in shared memory; each 32-key tile of k
// (transposed, so the score loop reads consecutive addresses) and v is
// staged through shared memory in f32. Thread t owns rows 4*(t/16)..+3 in
// both products: in the scores it holds a 4 x 2 tile (columns t%16 and
// t%16 + 16), in P.V a 4 x NC tile of the accumulator (columns t%16 + 16 j),
// so the rescale by exp(m_old - m_new) happens in registers. The 16
// threads of a row group (one half-warp) reduce the row max and sum with
// shuffles. Shared memory at hd 256 is ~104 KB (dynamic, above the 48 KB
// default), two blocks per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 32;        // query rows per block
constexpr int kBK = 32;        // keys per staged tile
constexpr int kThreads = 128;  // 8 row groups of 16 threads
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

__device__ __forceinline__ float group_max(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// NC: accumulator columns per thread, ceil(hd / 16) rounded up to 2, 4, 8
// or 16.
template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int s_len, int hd,
          int window, float scale) {
  extern __shared__ float smem[];
  const int qs = hd + 1;                   // padded row stride of the q tile
  const int ks = kBK + 1;                  // padded row stride of k^T and p
  float* sq = smem;                        // [kBQ][hd + 1]
  float* skt = sq + kBQ * qs;              // [hd][kBK + 1]
  float* sv = skt + hd * ks;               // [kBK][hd]
  float* sp = sv + kBK * hd;               // [kBQ][kBK + 1]

  const int64_t base = static_cast<int64_t>(blockIdx.x) * s_len * hd;
  const int q0 = blockIdx.y * kBQ;
  const int tid = threadIdx.x;
  const int rg = tid >> 4;                 // row group: rows 4 rg .. 4 rg + 3
  const int cl = tid & 15;

  for (int i = tid; i < kBQ * hd; i += kThreads) {
    const int r = i / hd, d = i - r * hd;
    const int qp = q0 + r;
    sq[r * qs + d] = qp < s_len ? to_f32(q[base + int64_t(qp) * hd + d]) *
                                      scale
                                : 0.0f;
  }

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.0f;
  }

  const int q_last = min(q0 + kBQ, s_len) - 1;
  const int k_first = window > 0 ? max(q0 - window + 1, 0) : 0;
  for (int t = k_first / kBK; t <= q_last / kBK; ++t) {
    const int k0 = t * kBK;
    __syncthreads();                       // the last tile's readers are done
    for (int i = tid; i < kBK * hd; i += kThreads) {
      const int kk = i / hd, d = i - kk * hd;
      const int kp = k0 + kk;
      const bool in = kp < s_len;
      const int64_t off = base + int64_t(kp) * hd + d;
      skt[d * ks + kk] = in ? to_f32(k[off]) : 0.0f;
      sv[kk * hd + d] = in ? to_f32(v[off]) : 0.0f;
    }
    __syncthreads();

    float sc[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) sc[i][0] = sc[i][1] = 0.0f;
    for (int d = 0; d < hd; ++d) {
      const float k_a = skt[d * ks + cl];
      const float k_b = skt[d * ks + cl + 16];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qv = sq[(rg * 4 + i) * qs + d];
        sc[i][0] = fmaf(qv, k_a, sc[i][0]);
        sc[i][1] = fmaf(qv, k_b, sc[i][1]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kp = k0 + cl + 16 * j;
        const bool ok = kp <= qp && (window <= 0 || kp > qp - window);
        if (!ok) sc[i][j] = kNegInf;
      }
      const float m_new = fmaxf(m[i], group_max(fmaxf(sc[i][0], sc[i][1])));
      const float alpha = expf(m[i] - m_new);
      const float p0 = expf(sc[i][0] - m_new);
      const float p1 = expf(sc[i][1] - m_new);
      l[i] = l[i] * alpha + group_sum(p0 + p1);
      m[i] = m_new;
      sp[(rg * 4 + i) * ks + cl] = p0;
      sp[(rg * 4 + i) * ks + cl + 16] = p1;
#pragma unroll
      for (int j = 0; j < NC; ++j) acc[i][j] *= alpha;
    }
    __syncwarp();                          // a row group is one half-warp

    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(rg * 4 + i) * ks + kk];
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const int d = cl + 16 * j;
        const float vv = d < hd ? sv[kk * hd + d] : 0.0f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + rg * 4 + i;
    if (qp >= s_len) continue;
    const float inv = 1.0f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int d = cl + 16 * j;
      if (d < hd) store(&o[base + int64_t(qp) * hd + d], acc[i][j] * inv);
    }
  }
}

size_t smem_bytes(int hd) {
  return sizeof(float) *
         (size_t(kBQ) * (hd + 1) + size_t(hd) * (kBK + 1) +
          size_t(kBK) * hd + size_t(kBQ) * (kBK + 1));
}

template <typename T, int NC>
int launch(const void* q, const void* k, const void* v, void* o, int64_t bh,
           int64_t s, int64_t hd, int64_t window, cudaStream_t stream) {
  const size_t bytes = smem_bytes(static_cast<int>(hd));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<T, NC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((s + kBQ - 1) / kBQ));
  flash_fwd<T, NC><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<int>(s),
      static_cast<int>(hd), static_cast<int>(window),
      1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* o,
              int64_t bh, int64_t s, int64_t hd, int64_t window,
              cudaStream_t stream) {
  if (hd <= 32) return launch<T, 2>(q, k, v, o, bh, s, hd, window, stream);
  if (hd <= 64) return launch<T, 4>(q, k, v, o, bh, s, hd, window, stream);
  if (hd <= 128) return launch<T, 8>(q, k, v, o, bh, s, hd, window, stream);
  return launch<T, 16>(q, k, v, o, bh, s, hd, window, stream);
}

}  // namespace

extern "C" {

// q, k, v, o (bh, s, hd) contiguous; dtype 0 = f32, 1 = bf16; window 0 =
// full causal. Launches one kernel on `stream` and returns
// cudaGetLastError() as an int (cudaErrorInvalidValue for bad arguments).
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int64_t bh, int64_t s, int64_t hd,
                           int64_t window, int dtype, void* stream) {
  if (bh < 1 || s < 1 || hd < 1 || hd > 256 || window < 0 ||
      (s + kBQ - 1) / kBQ > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_hd<float>(q, k, v, o, bh, s, hd, window, st);
  if (dtype == 1) {
    return launch_hd<__nv_bfloat16>(q, k, v, o, bh, s, hd, window, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
