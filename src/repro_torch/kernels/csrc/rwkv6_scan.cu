// RWKV6 WKV recurrence for Hopper (sm_90a): the time-mix of every `rwkv6`
// layer, at prefill (the whole prompt) and at every decoded token (S = 1,
// starting from the cached state).
//
// Replaces the Pallas TPU kernel `rwkv6_scan` of
// src/repro/kernels/rwkv6_scan.py (`_wkv6_kernel`). For r, k, v
// (B, H, S, hd) in f32 or bf16, w (B, H, S, hd) f32, u (H, hd) f32 and the
// initial state s0 (B, H, hd, hd) f32 (or zeros), per (b, h) and token t:
//
//   kv[i][j] = k_t[i] v_t[j]
//   y_t[j]   = sum_i r_t[i] (S[i][j] + u[i] kv[i][j])
//   S[i][j] <- S[i][j] w_t[i] + kv[i][j]
//
// in f32; y is rounded once to r's dtype, the final state stays f32.
//
// What bounds it: operations, then the sequence dependence. Each token
// does 7 hd^2 FLOP per head (the k v outer product, the bonus term and the
// sum for y, the decay and add for S) against 12 hd bytes (bf16 r, k, v and
// y, f32 w): ~37 FLOP per byte at hd 64, above the f32 CUDA cores' ridge
// of ~20 (67 TFLOP/s over 3.35 TB/s). Every token waits for the last, and
// B * H blocks (64 at rwkv6's B 2, H 32) fill fewer than half of the 132
// SMs; at decode (S = 1) the state read and write, 2 hd^2 f32 per head,
// are most of the bytes.
//
// Design: one block per (b, h), one thread per state column j, which keeps
// its column S[:, j] (hd <= 64 f32 values) in registers. r, k, w and v of
// 32 tokens at a time are staged in shared memory with coalesced loads, so
// the global-memory latency is paid once per chunk, not once per token;
// the inner loop over i reads r_t[i], k_t[i], w_t[i] and u[i] as
// shared-memory broadcasts. The state is read from s0 and
// written to the final state column-wise (coalesced across threads).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// HD: the register array's size, hd rounded up to 32 or 64; the block has
// hd threads.
template <typename T, int HD>
__global__ void __launch_bounds__(HD)
wkv6_fwd(const T* __restrict__ r, const T* __restrict__ k,
         const T* __restrict__ v, const float* __restrict__ w,
         const float* __restrict__ u, const float* __restrict__ s0,
         T* __restrict__ y, float* __restrict__ s_out, int s_len, int heads,
         int hd) {
  constexpr int kT = 32;                   // tokens staged at once (32 KB)
  __shared__ float sr[kT][HD], sk[kT][HD], sw[kT][HD], sv[kT][HD];
  __shared__ float su[HD];
  const int64_t bh = blockIdx.x;
  const int h = static_cast<int>(bh % heads);
  const int j = threadIdx.x;
  const int64_t base = bh * s_len * hd;
  const int64_t sbase = bh * hd * hd;

  float st[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    st[i] = (i < hd && s0 != nullptr) ? s0[sbase + int64_t(i) * hd + j]
                                      : 0.0f;
  }
  su[j] = u[h * hd + j];

  for (int t0 = 0; t0 < s_len; t0 += kT) {
    const int n = min(kT, s_len - t0);
    __syncthreads();                       // the last chunk's readers are done
    for (int tt = 0; tt < n; ++tt) {
      const int64_t off = base + int64_t(t0 + tt) * hd + j;
      sr[tt][j] = to_f32(r[off]);
      sk[tt][j] = to_f32(k[off]);
      sv[tt][j] = to_f32(v[off]);
      sw[tt][j] = w[off];
    }
    __syncthreads();
    for (int tt = 0; tt < n; ++tt) {
      const float vj = sv[tt][j];
      float yj = 0.0f;
#pragma unroll
      for (int i = 0; i < HD; ++i) {
        if (i < hd) {
          const float kv = sk[tt][i] * vj;
          yj += (st[i] + su[i] * kv) * sr[tt][i];
          st[i] = st[i] * sw[tt][i] + kv;
        }
      }
      store(&y[base + int64_t(t0 + tt) * hd + j], yj);
    }
  }
#pragma unroll
  for (int i = 0; i < HD; ++i) {
    if (i < hd) s_out[sbase + int64_t(i) * hd + j] = st[i];
  }
}

template <typename T, int HD>
int launch(const void* r, const void* k, const void* v, const float* w,
           const float* u, const float* s0, void* y, float* s_out,
           int64_t bh, int64_t s, int64_t heads, int64_t hd,
           cudaStream_t stream) {
  wkv6_fwd<T, HD><<<static_cast<unsigned>(bh), static_cast<unsigned>(hd), 0,
                    stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k),
      static_cast<const T*>(v), w, u, s0, static_cast<T*>(y), s_out,
      static_cast<int>(s), static_cast<int>(heads), static_cast<int>(hd));
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_hd(const void* r, const void* k, const void* v, const float* w,
              const float* u, const float* s0, void* y, float* s_out,
              int64_t bh, int64_t s, int64_t heads, int64_t hd,
              cudaStream_t stream) {
  if (hd <= 32) {
    return launch<T, 32>(r, k, v, w, u, s0, y, s_out, bh, s, heads, hd,
                         stream);
  }
  return launch<T, 64>(r, k, v, w, u, s0, y, s_out, bh, s, heads, hd,
                       stream);
}

}  // namespace

extern "C" {

// r, k, v, y (bh, s, hd) in `dtype` (0 = f32, 1 = bf16); w (bh, s, hd),
// u (heads, hd), s0 and s_out (bh, hd, hd) f32, all contiguous; s0 may be
// NULL (zero state). Launches one kernel on `stream` and returns
// cudaGetLastError() as an int.
int rwkv6_scan_launch(const void* r, const void* k, const void* v,
                      const float* w, const float* u, const float* s0,
                      void* y, float* s_out, int64_t bh, int64_t s,
                      int64_t heads, int64_t hd, int dtype, void* stream) {
  if (bh < 1 || s < 1 || heads < 1 || hd < 1 || hd > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_hd<float>(r, k, v, w, u, s0, y, s_out, bh, s, heads, hd,
                            st);
  }
  if (dtype == 1) {
    return launch_hd<__nv_bfloat16>(r, k, v, w, u, s0, y, s_out, bh, s,
                                    heads, hd, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
