// Mamba2 SSD chunk scan for Hopper (sm_90a): the prefill of every `mamba2`
// layer (zamba2's 81).
//
// Replaces the Pallas TPU kernel `mamba2_ssd` of
// src/repro/kernels/mamba2_ssd.py (`_ssd_kernel`). For x (B, S, H, P) in
// f32 or bf16 (the model's layout, read in place), dt (B, S, H) f32 (after
// softplus), a (H,) f32 and b, c (B, S, N) in x's dtype, shared by every
// head, per (b, h) from a zero state and per chunk of Q tokens:
//
//   L      = cumsum(dt * a)                                      (Q,)
//   M[t,s] = (c_t . b_s) exp(L_t - L_s) dt_s        for s <= t
//   y_t    = sum_s M[t,s] x_s + exp(L_t) (state c_t)
//   state <- exp(L_Q) state + sum_s exp(L_Q - L_s) dt_s x_s b_s^T
//
// in f32; y is rounded once to x's dtype (B, S, H, P), the final state
// (B, H, P, N) stays f32. S must be a multiple of Q.
//
// What bounds it: operations. Per chunk and head the three products take
// Q^2 N / 2 + Q^2 P / 2 + 2 Q P N multiply-adds (~1.6 M at Q 128, P = N
// 64) against ~Q (P + 2 N) input values: ~100 FLOP per byte in bf16, far
// above the f32 CUDA cores' ridge.
//
// Design: the TPU kernel's sequential chunk axis becomes a loop inside the
// block: one block of 256 threads per (b, h) walks the chunks in order and
// keeps the (P, N) state in shared memory, so the state never goes to
// device memory between chunks. Per chunk it stages x (Q, P), b and c
// (Q, N, rows padded by one float so column walks hit distinct banks), dt,
// L = cumsum(dt * a) (one thread, in order), exp(L) and
// w_s = exp(L_Q - L_s) dt_s in shared memory, then builds M (lower
// triangle only), y, and the new state, each output element owned by one
// thread whose neighbours read neighbouring or broadcast addresses. b and
// c are read straight from their (B, S, N) rows for every head: the
// broadcast over heads that the TPU wrapper materialises is never built.
// At Q 128, P = N = 64 the tiles take ~180 KB of dynamic shared memory
// (one block per SM).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

size_t smem_floats(int64_t q, int64_t p, int64_t n) {
  return size_t(q * p + 2 * q * (n + 1) + q * q + p * (n + 1) + 4 * q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_fwd(const T* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ a, const T* __restrict__ b,
        const T* __restrict__ c, T* __restrict__ y,
        float* __restrict__ s_fin, int s_len, int heads, int p_dim,
        int n_dim, int q_len) {
  extern __shared__ float smem[];
  const int np = n_dim + 1;
  float* sx = smem;                        // [Q][P]
  float* sb = sx + q_len * p_dim;          // [Q][N + 1]
  float* sc = sb + q_len * np;             // [Q][N + 1]
  float* sm = sc + q_len * np;             // [Q][Q]  (lower triangle)
  float* sst = sm + q_len * q_len;         // [P][N + 1]  the carried state
  float* sdt = sst + p_dim * np;           // [Q]
  float* sl = sdt + q_len;                 // [Q]  L
  float* sel = sl + q_len;                 // [Q]  exp(L)
  float* sw = sel + q_len;                 // [Q]  exp(L_Q - L_s) dt_s

  const int bi = blockIdx.x / heads;
  const int h = blockIdx.x - bi * heads;
  const int tid = threadIdx.x;
  const float ah = a[h];

  for (int i = tid; i < p_dim * n_dim; i += kThreads) {
    sst[(i / n_dim) * np + i % n_dim] = 0.0f;
  }

  for (int c0 = 0; c0 < s_len; c0 += q_len) {
    const int64_t row0 = int64_t(bi) * s_len + c0;    // first token's row
    __syncthreads();                       // the last chunk's readers are done
    for (int i = tid; i < q_len * p_dim; i += kThreads) {
      const int t = i / p_dim, p = i - t * p_dim;
      sx[i] = to_f32(x[((row0 + t) * heads + h) * p_dim + p]);
    }
    for (int i = tid; i < q_len * n_dim; i += kThreads) {
      const int t = i / n_dim, n = i - t * n_dim;
      sb[t * np + n] = to_f32(b[(row0 + t) * n_dim + n]);
      sc[t * np + n] = to_f32(c[(row0 + t) * n_dim + n]);
    }
    for (int t = tid; t < q_len; t += kThreads) {
      sdt[t] = dt[(row0 + t) * heads + h];
    }
    __syncthreads();
    if (tid == 0) {
      float acc = 0.0f;
      for (int t = 0; t < q_len; ++t) {
        acc += sdt[t] * ah;
        sl[t] = acc;
      }
    }
    __syncthreads();
    const float l_last = sl[q_len - 1];
    for (int t = tid; t < q_len; t += kThreads) {
      sel[t] = expf(sl[t]);
      sw[t] = expf(l_last - sl[t]) * sdt[t];
    }
    for (int i = tid; i < q_len * q_len; i += kThreads) {
      const int t = i / q_len, s = i - t * q_len;
      if (s > t) continue;
      float g = 0.0f;
      for (int n = 0; n < n_dim; ++n) g = fmaf(sc[t * np + n], sb[s * np + n], g);
      sm[i] = g * expf(sl[t] - sl[s]) * sdt[s];
    }
    __syncthreads();

    for (int i = tid; i < q_len * p_dim; i += kThreads) {
      const int t = i / p_dim, p = i - t * p_dim;
      float acc = 0.0f;
      for (int s = 0; s <= t; ++s) {
        acc = fmaf(sm[t * q_len + s], sx[s * p_dim + p], acc);
      }
      float inter = 0.0f;
      for (int n = 0; n < n_dim; ++n) {
        inter = fmaf(sc[t * np + n], sst[p * np + n], inter);
      }
      acc += sel[t] * inter;
      store(&y[((row0 + t) * heads + h) * p_dim + p], acc);
    }
    __syncthreads();                       // every read of the old state done

    const float e_last = expf(l_last);
    for (int i = tid; i < p_dim * n_dim; i += kThreads) {
      const int p = i / n_dim, n = i - p * n_dim;
      float acc = 0.0f;
      for (int s = 0; s < q_len; ++s) {
        acc = fmaf(sw[s] * sx[s * p_dim + p], sb[s * np + n], acc);
      }
      sst[p * np + n] = e_last * sst[p * np + n] + acc;
    }
  }
  __syncthreads();
  float* out = s_fin + int64_t(blockIdx.x) * p_dim * n_dim;
  for (int i = tid; i < p_dim * n_dim; i += kThreads) {
    out[i] = sst[(i / n_dim) * np + i % n_dim];
  }
}

template <typename T>
int launch(const void* x, const float* dt, const float* a, const void* b,
           const void* c, void* y, float* s_fin, int64_t batch, int64_t s,
           int64_t heads, int64_t p, int64_t n, int64_t q,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(q, p, n);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_fwd<T><<<static_cast<unsigned>(batch * heads), kThreads, bytes,
               stream>>>(
      static_cast<const T*>(x), dt, a, static_cast<const T*>(b),
      static_cast<const T*>(c), static_cast<T*>(y), s_fin,
      static_cast<int>(s), static_cast<int>(heads), static_cast<int>(p),
      static_cast<int>(n), static_cast<int>(q));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory one block needs for chunk q, head dim p and state size n;
// the wrapper refuses shapes above the card's 227 KB.
int64_t mamba2_ssd_smem_bytes(int64_t q, int64_t p, int64_t n) {
  return static_cast<int64_t>(sizeof(float) * smem_floats(q, p, n));
}

// x, y (batch, s, heads, p) and b, c (batch, s, n) in `dtype` (0 = f32,
// 1 = bf16); dt (batch, s, heads), a (heads,) and s_fin (batch, heads, p,
// n) f32; all contiguous; s a multiple of the chunk q. Launches one kernel
// on `stream` and returns cudaGetLastError() as an int.
int mamba2_ssd_launch(const void* x, const float* dt, const float* a,
                      const void* b, const void* c, void* y, float* s_fin,
                      int64_t batch, int64_t s, int64_t heads, int64_t p,
                      int64_t n, int64_t q, int dtype, void* stream) {
  if (batch < 1 || s < 1 || heads < 1 || p < 1 || n < 1 || q < 1 ||
      s % q != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(x, dt, a, b, c, y, s_fin, batch, s, heads, p, n, q,
                         st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(x, dt, a, b, c, y, s_fin, batch, s, heads,
                                 p, n, q, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* mamba2_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
