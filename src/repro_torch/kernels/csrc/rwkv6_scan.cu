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
// in f32; y is rounded once to r's dtype, the final state stays f32. Any
// S >= 1 and hd <= 64.
//
// What bounds it: bytes. Each token reads r, k, v (bf16) and w (f32) and
// writes y, 12 hd bytes a head, against 7 hd^2 multiply-adds a head done
// one token at a time; taken as the chunked products below (~4 hd^2 + Q hd
// a token on the tensor cores) the work sits far under the bf16 ridge, so
// the least time is the bytes' (chip_smoke.py's `_rwkv_bound`: 0.00783 ms
// at rwkv6-1.6b's prefill, (2, 32, 512, 64) bf16). What kept the recurrent
// form far from it is the sequence dependence: one block per (b, h), 64
// blocks on 132 SMs, each walking 512 tokens with a ~3,000-cycle step.
// The library holds two instances; the wrapper picks one by S, hd and dtype
// (`_variant` in kernels/rwkv6_scan.py):
//
// * `tc` (bf16, hd 16 / 32 / 48 / 64, S >= 16; instance 1 of
//   rwkv6_scan_launch): the chunk-parallel WKV of the JAX model's
//   `wkv6_chunked` (src/repro/models/rwkv.py), three kernels on the
//   caller's stream with no host sync between them. With chunks of Q = 64
//   tokens and l = log2 w clamped at -64 (w = 0 gives no -inf - -inf),
//   L_t = sum_{tau <= t} l_tau per channel, L_Q the chunk's total:
//     1. wkv_chunk_state, a block per (b, h, chunk): the chunk's own state
//        dS = (k * 2^(L_Q - L))^T V and its decay L_Q, into scratch
//        (B, H, nc, hd, hd) and (B, H, nc, hd) f32 that the wrapper
//        allocates;
//     2. wkv_state_pass, a thread per state element: S_prev(c) for every
//        chunk, S <- 2^(L_Q) S + dS from s0 or zero, an f32 recurrence of nc
//        steps written over dS; the last S is the final state;
//     3. wkv_chunk_out, a block per (b, h, chunk):
//        y_t = sum_{s < t} A[t,s] v_s + (r_t . u k_t) v_t
//              + (r_t * 2^(L_{t-1})) S_prev,
//        A[t,s] = sum_i r_t[i] k_s[i] 2^(L_{t-1}[i] - L_s[i]).
//   At (2, 32, 512, 64) that is 512 blocks where the recurrence had 64.
//   The decay sits inside the sum over channels, so unlike the SSD it
//   cannot scale an accumulator after the product: A is built per
//   16-token sub-chunk. For t's sub-chunk after s's, with e the last token
//   of s's, the decay is folded into the operands, r~_t = r_t *
//   2^(L_{t-1} - L_e) and k~_s = k_s * 2^(L_e - L_s), both <= 1, and A's
//   three off-diagonal column blocks are m64n16k16 `wgmma`s. The four
//   16 x 16 diagonal blocks (and the bonus u on their diagonal) are
//   computed per element on the CUDA cores, every exponent <= 0, while
//   the state's product runs on the tensor cores. Nothing is factored
//   against the chunk start: under a strong decay (-ln w ~ 4.5) L falls by
//   ~290 over a chunk, past the ~88 an f32 exponent spans. Then y =
//   (A_hi + A_lo) V + (r 2^L)(S_prev) and dS are m64n64k16 `wgmma`s, V
//   read as an MN-major B.
//   Precision: r, k and v are bf16 values, so their products are exact.
//   Every f32 operand enters as bf16 hi + lo with lo * lo dropped (r~,
//   k~, A, r 2^L and S_prev, k 2^(L_Q - L)); sums accumulate in f32 and
//   the state stays f32. The depths come from an emulation of this
//   arithmetic on the CPU (tests/test_torch_kernels.py,
//   `_wkv_tc_emulation`; `python tests/test_torch_kernels.py` prints the
//   shares): against the plain version at the card's tolerance y uses up
//   to 0.48 of its (the floor its one bf16 rounding sets) and the state up
//   to 0.27, in the tests' decay, the model's and a strong one, and with
//   w = 0 and w = 1 mixed in. l is log2f, not __log2f: at the model's
//   w ~ 0.9975 the fast log's absolute error is ~1e-4 of l and compounds
//   over the chunk into the state's gate.
//   Copies: v by 16-byte cp.async into a 128-byte-swizzled tile; r, k and
//   w by 16-byte loads, widened to f32 in shared memory (the fragments and
//   the decay read them per element), so r, k, v and w must be 16-byte
//   aligned (the wrapper raises otherwise). A ragged last chunk is padded
//   with k = v = r = 0 and l = 0, and its rows past S are not stored.
//   Shared memory: ~92 KB a block in stage 3 (two blocks a SM), ~46 KB in
//   stage 1. Stage 3 issues every global load of its chunk before using
//   any, and runs the diagonal blocks while the state's and the
//   off-diagonal products are in flight.
//
// * `wkv6_fwd` (SIMT: f32, the decode step S < 16, hd not a multiple of
//   16; instance 0): one block per (b, h), one thread per state column j,
//   which keeps its column S[:, j] (hd <= 64 f32 values) in registers. r,
//   k, w and v of 32 tokens at a time are staged in shared memory with
//   coalesced loads; the inner loop over i reads r_t[i], k_t[i], w_t[i]
//   and u[i] as shared-memory broadcasts. The state is read from s0 and
//   written to the final state column-wise (coalesced across threads).
//   f32 stays here: TF32 on the tensor cores fails the f32 gates.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ------------------------------ SIMT instance ------------------------------

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


// --------------------------- tensor-core instance ---------------------------

constexpr int kQ = 64;                    // tokens per chunk
constexpr int kWg = 128;                  // threads of one warpgroup
constexpr int kLs = 72;                   // row stride (floats) of f32 tiles
constexpr float kLog2Floor = -64.0f;      // log2 w clamp (w = 0)
constexpr uint32_t kTile = 64 * 128;      // 64 rows of 128 bytes (bf16)
constexpr uint32_t kSubTile = 16 * 128;   // 16 rows of 128 bytes (bf16)
constexpr int kF32Tile = kQ * kLs;        // floats of a (64, kLs) tile
constexpr int kLcFloats = (kQ + 1) * kLs; // rows 0..64 of the cumsum

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit_wait_all() {
  asm volatile("cp.async.commit_group;" ::: "memory");
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// 2^x on the MUFU (relative error ~2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// (v0, v1) -> bf16 pairs hi = bf16(v), lo = bf16(v - hi)
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  hi = hopper::pack_bf16(h);
  lo = hopper::pack_bf16(__floats2bfloat162_rn(v0 - hf.x, v1 - hf.y));
}
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (hopper::smem_u32(p) & 1023u)) & 1023u);
}

// v rows [0, n) of a chunk (row-major, D columns) into a 64 x 64 bf16 tile
// in the 128-byte swizzle by 16-byte cp.async (read as an MN-major B); the
// rows past n and the columns past D are zeroed (0 * garbage could be NaN)
template <int D>
__device__ void load_v_tile(uint8_t* tile, const __nv_bfloat16* src, int n,
                            int tid) {
  const uint32_t t32 = hopper::smem_u32(tile);
  for (int p = tid; p < kQ * 8; p += kWg) {
    const int t = p >> 3, j = (p & 7) * 8;
    const uint32_t o = hopper::sw128_offset(t, j, kTile);
    if (t < n && j < D) {
      cp_async16(t32 + o, src + t * D + j);
    } else {
      *reinterpret_cast<uint4*>(tile + o) = make_uint4(0, 0, 0, 0);
    }
  }
}

// The chunk's global loads are issued all at once, into registers, before
// any is used: at 8 warps a SM one load at a time would wait out an L2 or
// HBM round trip per loop step. Piece p of a (64, D) chunk: row p / per,
// columns from (p % per) * width.

// 8 bf16 of piece p (16 bytes), zeros past row n
template <int D>
__device__ __forceinline__ uint4 ld_bf16x8(const __nv_bfloat16* src, int n,
                                           int p) {
  constexpr int kPer = D / 8;
  const int t = p / kPer, i = (p - t * kPer) * 8;
  return t < n ? *reinterpret_cast<const uint4*>(src + t * D + i)
               : make_uint4(0, 0, 0, 0);
}
// ... widened into the f32 (64, kLs) tile
template <int D>
__device__ __forceinline__ void st_f32x8(float* dst, int p, uint4 raw) {
  constexpr int kPer = D / 8;
  const int t = p / kPer, i = (p - t * kPer) * 8;
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 a = __bfloat1622float2(h[0]), b = __bfloat1622float2(h[1]);
  const float2 c = __bfloat1622float2(h[2]), d = __bfloat1622float2(h[3]);
  float* o = dst + t * kLs + i;
  *reinterpret_cast<float4*>(o) = make_float4(a.x, a.y, b.x, b.y);
  *reinterpret_cast<float4*>(o + 4) = make_float4(c.x, c.y, d.x, d.y);
}
// 4 w of piece p, 1 past row n (log2 1 = 0: the padded chunk's decay)
template <int D>
__device__ __forceinline__ float4 ld_w4(const float* w, int n, int p) {
  constexpr int kPer = D / 4;
  const int t = p / kPer, i = (p - t * kPer) * 4;
  return t < n ? *reinterpret_cast<const float4*>(w + t * D + i)
               : make_float4(1.f, 1.f, 1.f, 1.f);
}
// ... as log2 w clamped at kLog2Floor into row t + 1 of lc (row 0 = 0 is
// written by the caller); the scan below turns rows 1..64 into L_t, so row
// t holds L_{t-1}
template <int D>
__device__ __forceinline__ void st_log4(float* lc, int p, float4 x) {
  constexpr int kPer = D / 4;
  const int t = p / kPer, i = (p - t * kPer) * 4;
  *reinterpret_cast<float4*>(lc + (t + 1) * kLs + i) = make_float4(
      fmaxf(log2f(x.x), kLog2Floor), fmaxf(log2f(x.y), kLog2Floor),
      fmaxf(log2f(x.z), kLog2Floor), fmaxf(log2f(x.w), kLog2Floor));
}

// inclusive prefix sum over the 64 tokens, one thread per channel, in token
// order (after st_log4 and a barrier)
template <int D>
__device__ void scan_log_decay(float* lc, int tid) {
  if (tid < D) {
    float v[kQ];
#pragma unroll
    for (int t = 0; t < kQ; ++t) v[t] = lc[(t + 1) * kLs + tid];
    float acc = 0.0f;
#pragma unroll
    for (int t = 0; t < kQ; ++t) {
      acc += v[t];
      lc[(t + 1) * kLs + tid] = acc;
    }
  }
}

// Stage 1: dS = (k * 2^(L_Q - L))^T V of chunk c of head bh, and L_Q.
// Shared memory: [v tile][k f32][lc f32].
template <int D>
__global__ void __launch_bounds__(kWg)
wkv_chunk_state(const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                const float* __restrict__ w, float* __restrict__ states,
                float* __restrict__ decay, int s_len, int nc) {
  using hopper::reg_fence;
  extern __shared__ uint8_t smem_st[];
  uint8_t* base = align1024(smem_st);
  float* sk = reinterpret_cast<float*>(base + kTile);
  float* lc = sk + kF32Tile;
  const int64_t bh = blockIdx.x / nc;
  const int c = static_cast<int>(blockIdx.x - bh * nc);
  const int n = min(kQ, s_len - c * kQ);
  const int64_t row0 = (bh * s_len + int64_t(c) * kQ) * D;
  const int tid = threadIdx.x;

  load_v_tile<D>(base, v + row0, n, tid);
  {
    constexpr int kIk = D / 16, kIw = D / 8;   // pieces a thread loads
    uint4 kr[kIk];
    float4 wr[kIw];
#pragma unroll
    for (int it = 0; it < kIk; ++it) {
      kr[it] = ld_bf16x8<D>(k + row0, n, tid + it * kWg);
    }
#pragma unroll
    for (int it = 0; it < kIw; ++it) {
      wr[it] = ld_w4<D>(w + row0, n, tid + it * kWg);
    }
#pragma unroll
    for (int it = 0; it < kIk; ++it) st_f32x8<D>(sk, tid + it * kWg, kr[it]);
#pragma unroll
    for (int it = 0; it < kIw; ++it) st_log4<D>(lc, tid + it * kWg, wr[it]);
    if (tid < D) lc[tid] = 0.0f;
  }
  __syncthreads();
  scan_log_decay<D>(lc, tid);
  cp_async_commit_wait_all();
  hopper::fence_proxy_async();             // smem writes -> wgmma reads
  __syncthreads();

  // rows i (channels) of warp's 16, k16 steps over tokens s
  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  float acc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    acc[x] = 0.0f;
    reg_fence(acc[x]);
  }
  uint32_t a_hi[4][4], a_lo[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      const int i = r0 + 8 * (hh & 1);
      const int s = 16 * j + 8 * (hh >> 1) + c0;
      float v0 = 0.0f, v1 = 0.0f;
      if (i < D) {
        const float lq = lc[kQ * kLs + i];
        v0 = sk[s * kLs + i] * ex2(lq - lc[(s + 1) * kLs + i]);
        v1 = sk[(s + 1) * kLs + i] * ex2(lq - lc[(s + 2) * kLs + i]);
      }
      split2(v0, v1, a_hi[j][hh], a_lo[j][hh]);
    }
  }
  const uint32_t tv = hopper::smem_u32(base);
  hopper::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t dv = hopper::desc_sw128(tv + j * kSubTile, kTile);
    hopper::wgmma_rs(acc, a_hi[j], dv);
    hopper::wgmma_rs(acc, a_lo[j], dv);
  }
  hopper::wgmma_commit_wait();
#pragma unroll
  for (int x = 0; x < 32; ++x) reg_fence(acc[x]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      reg_fence(a_hi[j][hh]);
      reg_fence(a_lo[j][hh]);
    }
  }

  float* out = states + (bh * nc + c) * D * D;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int i = r0 + 8 * rr;
#pragma unroll
    for (int ib = 0; ib < 8; ++ib) {
      const int j = 8 * ib + c0;
      if (i < D && j < D) {
        *reinterpret_cast<float2*>(out + i * D + j) =
            make_float2(acc[4 * ib + 2 * rr], acc[4 * ib + 2 * rr + 1]);
      }
    }
  }
  if (tid < D) decay[(bh * nc + c) * D + tid] = lc[kQ * kLs + tid];
}

// Stage 2: one thread per state element (bh, i, j): S_prev of every chunk
// over its dS, and the final state
__global__ void __launch_bounds__(256)
wkv_state_pass(float* __restrict__ states, const float* __restrict__ decay,
               const float* __restrict__ s0, float* __restrict__ s_out,
               int64_t total, int nc, int d) {
  const int64_t idx = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  const int64_t dd = int64_t(d) * d;
  const int64_t bh = idx / dd;
  const int64_t e = idx - bh * dd;
  float* sp = states + bh * nc * dd + e;
  const float* gp = decay + bh * nc * d + e / d;
  float st = s0 != nullptr ? s0[idx] : 0.0f;
  float next = sp[0];
  for (int c = 0; c < nc; ++c) {
    const float ds = next;
    if (c + 1 < nc) next = sp[(c + 1) * dd];   // ahead of the store
    const float g = exp2f(gp[int64_t(c) * d]);
    sp[c * dd] = st;
    st = st * g + ds;
  }
  s_out[idx] = st;
}

// Stage 3: y of chunk c of head bh. Shared memory: [v tile][S_prev hi][S_prev
// lo][k~ tiles: 3 column blocks x (hi, lo), 16 rows each][r f32][k f32][lc
// f32][u]
template <int D>
__global__ void __launch_bounds__(kWg)
wkv_chunk_out(const __nv_bfloat16* __restrict__ r,
              const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v,
              const float* __restrict__ w, const float* __restrict__ u,
              const float* __restrict__ states, __nv_bfloat16* __restrict__ y,
              int s_len, int heads, int nc) {
  using hopper::reg_fence;
  using hopper::sw128_offset;
  constexpr int kSteps = D / 16;           // k16 steps over the channels
  extern __shared__ uint8_t smem_out[];
  uint8_t* base = align1024(smem_out);
  constexpr uint32_t off_shi = kTile, off_slo = 2 * kTile;
  constexpr uint32_t off_kt = 3 * kTile;
  constexpr uint32_t off_f32 = off_kt + 6 * kSubTile;
  float* sr = reinterpret_cast<float*>(base + off_f32);
  float* sk = sr + kF32Tile;
  float* lc = sk + kF32Tile;
  float* su = lc + kLcFloats;
  const int64_t bh = blockIdx.x / nc;
  const int c = static_cast<int>(blockIdx.x - bh * nc);
  const int n = min(kQ, s_len - c * kQ);
  const int64_t row0 = (bh * s_len + int64_t(c) * kQ) * D;
  const int tid = threadIdx.x;

  load_v_tile<D>(base, v + row0, n, tid);
  {
    constexpr int kIr = D / 16, kIw = D / 8;   // pieces a thread loads
    constexpr int kIs = 64 * 32 / kWg;         // S_prev column pairs
    uint4 rr[kIr], kr[kIr];
    float4 wr[kIw];
    float2 sv[kIs];
    const float* sp = states + (bh * nc + c) * D * D;
#pragma unroll
    for (int it = 0; it < kIr; ++it) {
      rr[it] = ld_bf16x8<D>(r + row0, n, tid + it * kWg);
      kr[it] = ld_bf16x8<D>(k + row0, n, tid + it * kWg);
    }
#pragma unroll
    for (int it = 0; it < kIw; ++it) {
      wr[it] = ld_w4<D>(w + row0, n, tid + it * kWg);
    }
#pragma unroll
    for (int it = 0; it < kIs; ++it) {
      const int p = tid + it * kWg, i = p >> 5, j = (p & 31) * 2;
      sv[it] = (i < D && j < D)
                   ? *reinterpret_cast<const float2*>(sp + i * D + j)
                   : make_float2(0.f, 0.f);
    }
    const float uv = tid < D ? u[(bh % heads) * D + tid] : 0.0f;
#pragma unroll
    for (int it = 0; it < kIr; ++it) {
      st_f32x8<D>(sr, tid + it * kWg, rr[it]);
      st_f32x8<D>(sk, tid + it * kWg, kr[it]);
    }
#pragma unroll
    for (int it = 0; it < kIw; ++it) st_log4<D>(lc, tid + it * kWg, wr[it]);
    if (tid < D) {
      lc[tid] = 0.0f;
      su[tid] = uv;
    }
    // S_prev (rows i, columns j) as hi + lo, MN-major B tiles
#pragma unroll
    for (int it = 0; it < kIs; ++it) {
      const int p = tid + it * kWg, i = p >> 5, j = (p & 31) * 2;
      uint32_t hi, lo;
      split2(sv[it].x, sv[it].y, hi, lo);
      const uint32_t o = sw128_offset(i, j, kTile);
      *reinterpret_cast<uint32_t*>(base + off_shi + o) = hi;
      *reinterpret_cast<uint32_t*>(base + off_slo + o) = lo;
    }
  }
  __syncthreads();
  scan_log_decay<D>(lc, tid);
  __syncthreads();
  // k~ of column block b (tokens s of sub-chunk b, e its last token):
  // k_s 2^(L_e - L_s), as K-major B tiles of 16 rows (hi, lo)
  for (int p = tid; p < 3 * 16 * 32; p += kWg) {
    const int b = p >> 9, sl = (p >> 5) & 15, i = (p & 31) * 2;
    const int s = 16 * b + sl;
    float v0 = 0.0f, v1 = 0.0f;
    if (i < D) {
      const float* le = lc + (16 * b + 16) * kLs + i;
      const float* ls = lc + (s + 1) * kLs + i;
      v0 = sk[s * kLs + i] * ex2(le[0] - ls[0]);
      v1 = sk[s * kLs + i + 1] * ex2(le[1] - ls[1]);
    }
    uint32_t hi, lo;
    split2(v0, v1, hi, lo);
    const uint32_t o = off_kt + 2 * b * kSubTile +
                       sw128_offset(sl, i, kSubTile);
    *reinterpret_cast<uint32_t*>(base + o) = hi;
    *reinterpret_cast<uint32_t*>(base + o + kSubTile) = lo;
  }
  cp_async_commit_wait_all();
  hopper::fence_proxy_async();             // smem writes -> wgmma reads
  __syncthreads();

  const int lane = tid & 31, warp = tid >> 5;
  const int r0 = 16 * warp + (lane >> 2), c0 = 2 * (lane & 3);
  const uint32_t sbase = hopper::smem_u32(base);
  float yacc[32];
#pragma unroll
  for (int x = 0; x < 32; ++x) {
    yacc[x] = 0.0f;
    reg_fence(yacc[x]);
  }

  // y = (r 2^(L_{t-1})) S_prev: hi hi + hi lo + lo hi
  uint32_t a_hi[kSteps][4], a_lo[kSteps][4];
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      const int t = r0 + 8 * (hh & 1);
      const int i = 16 * j + 8 * (hh >> 1) + c0;
      const float2 rv = *reinterpret_cast<const float2*>(sr + t * kLs + i);
      const float2 lv = *reinterpret_cast<const float2*>(lc + t * kLs + i);
      split2(rv.x * ex2(lv.x), rv.y * ex2(lv.y), a_hi[j][hh], a_lo[j][hh]);
    }
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
    const uint64_t dh = hopper::desc_sw128(sbase + off_shi + j * kSubTile,
                                           kTile);
    const uint64_t dl = hopper::desc_sw128(sbase + off_slo + j * kSubTile,
                                           kTile);
    hopper::wgmma_rs(yacc, a_hi[j], dh);
    hopper::wgmma_rs(yacc, a_hi[j], dl);
    hopper::wgmma_rs(yacc, a_lo[j], dh);
  }
  wgmma_commit();

  // A's off-diagonal column blocks b = 0..2, issued behind it: r~ (rows of
  // sub-chunks after b; zero in the warps of sub-chunks <= b) times k~ of
  // block b, each from fragments of its own that stay live until the wait
  float a16[3][8];
  uint32_t f_hi[3][kSteps][4], f_lo[3][kSteps][4];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      a16[b][x] = 0.0f;
      reg_fence(a16[b][x]);
    }
    const bool live = warp > b;
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
#pragma unroll
      for (int hh = 0; hh < 4; ++hh) {
        const int t = r0 + 8 * (hh & 1);
        const int i = 16 * j + 8 * (hh >> 1) + c0;
        float v0 = 0.0f, v1 = 0.0f;
        if (live) {
          const float2 rv = *reinterpret_cast<const float2*>(sr + t * kLs + i);
          const float2 lv = *reinterpret_cast<const float2*>(lc + t * kLs + i);
          const float2 le =
              *reinterpret_cast<const float2*>(lc + (16 * b + 16) * kLs + i);
          v0 = rv.x * ex2(lv.x - le.x);
          v1 = rv.y * ex2(lv.y - le.y);
        }
        split2(v0, v1, f_hi[b][j][hh], f_lo[b][j][hh]);
      }
    }
    hopper::wgmma_fence();
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const uint32_t kt = sbase + off_kt + 2 * b * kSubTile + j * 32;
      const uint64_t dh = hopper::desc_sw128(kt, kSubTile);
      const uint64_t dl = hopper::desc_sw128(kt + kSubTile, kSubTile);
      hopper::wgmma_rs_n16(a16[b], f_hi[b][j], dh);
      hopper::wgmma_rs_n16(a16[b], f_hi[b][j], dl);
      hopper::wgmma_rs_n16(a16[b], f_lo[b][j], dh);
    }
    wgmma_commit();
  }

  // meanwhile on the CUDA cores: this warp's diagonal 16 x 16 block of A,
  // in the n16 accumulator layout: dg[4 q + 2 rr + e] is row r0 + 8 rr,
  // column (of the sub-chunk) 8 q + c0 + e; s < t decayed, s == t the bonus
  float dg[8];
  int mode[8];                             // 0: zero, 1: s < t, 2: s == t
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int t = r0 + 8 * ((x >> 1) & 1);
    const int s = 16 * warp + 8 * (x >> 2) + c0 + (x & 1);
    dg[x] = 0.0f;
    mode[x] = s < t ? 1 : (s == t ? 2 : 0);
  }
#pragma unroll 2
  for (int i = 0; i < D; i += 2) {         // channel pairs, float2 reads
    const float2 ui = *reinterpret_cast<const float2*>(su + i);
    float2 rt[2], lt[2], ks[4], ls[4];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      rt[rr] = *reinterpret_cast<const float2*>(sr + (r0 + 8 * rr) * kLs + i);
      lt[rr] = *reinterpret_cast<const float2*>(lc + (r0 + 8 * rr) * kLs + i);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int s = 16 * warp + 8 * (q >> 1) + c0 + (q & 1);
      ks[q] = *reinterpret_cast<const float2*>(sk + s * kLs + i);
      ls[q] = *reinterpret_cast<const float2*>(lc + (s + 1) * kLs + i);
    }
#pragma unroll
    for (int x = 0; x < 8; ++x) {
      const int rr = (x >> 1) & 1, q = 2 * (x >> 2) + (x & 1);
      const float f0 = mode[x] == 1 ? ex2(lt[rr].x - ls[q].x)
                                    : (mode[x] == 2 ? ui.x : 0.0f);
      const float f1 = mode[x] == 1 ? ex2(lt[rr].y - ls[q].y)
                                    : (mode[x] == 2 ? ui.y : 0.0f);
      dg[x] = fmaf(rt[rr].x * ks[q].x, f0, dg[x]);
      dg[x] = fmaf(rt[rr].y * ks[q].y, f1, dg[x]);
    }
  }
  wgmma_wait();
#pragma unroll
  for (int x = 0; x < 32; ++x) reg_fence(yacc[x]);
#pragma unroll
  for (int j = 0; j < kSteps; ++j) {
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      reg_fence(a_hi[j][hh]);
      reg_fence(a_lo[j][hh]);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        reg_fence(f_hi[b][j][hh]);
        reg_fence(f_lo[b][j][hh]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < 3; ++b) {
#pragma unroll
    for (int x = 0; x < 8; ++x) reg_fence(a16[b][x]);
  }

  // y += (A_hi + A_lo) V; token step j is 16 rows (2048 bytes) of V. The A
  // fragment of step j, register hh: row r0 + 8 (hh % 2), columns 16 j +
  // 8 (hh / 2) + c0 + {0, 1}: block j's n16 accumulator at 4 (hh / 2) +
  // 2 (hh % 2)
  uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      const int x = 4 * (hh >> 1) + 2 * (hh & 1);
      float v0 = 0.0f, v1 = 0.0f;
      if (j < 3 && j < warp) {
        v0 = a16[j < 3 ? j : 0][x];
        v1 = a16[j < 3 ? j : 0][x + 1];
      } else if (j == warp) {
        v0 = dg[x];
        v1 = dg[x + 1];
      }
      split2(v0, v1, p_hi[j][hh], p_lo[j][hh]);
    }
  }
  hopper::wgmma_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint64_t dv = hopper::desc_sw128(sbase + j * kSubTile, kTile);
    hopper::wgmma_rs(yacc, p_hi[j], dv);
    hopper::wgmma_rs(yacc, p_lo[j], dv);
  }
  hopper::wgmma_commit_wait();
#pragma unroll
  for (int x = 0; x < 32; ++x) reg_fence(yacc[x]);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int hh = 0; hh < 4; ++hh) {
      reg_fence(p_hi[j][hh]);
      reg_fence(p_lo[j][hh]);
    }
  }

  // y rounded once to bf16; rows past S and columns past D not written
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int t = r0 + 8 * rr;
    if (t < n) {
      __nv_bfloat16* out = y + row0 + int64_t(t) * D;
#pragma unroll
      for (int ib = 0; ib < 8; ++ib) {
        const int j = 8 * ib + c0;
        if (j < D) {
          *reinterpret_cast<__nv_bfloat162*>(out + j) = __floats2bfloat162_rn(
              yacc[4 * ib + 2 * rr], yacc[4 * ib + 2 * rr + 1]);
        }
      }
    }
  }
}

constexpr int kMaxDevices = 64;
constexpr size_t kStateSmem = 1024 + kTile + 4 * (kF32Tile + kLcFloats);
constexpr size_t kOutSmem =
    1024 + 3 * kTile + 6 * kSubTile + 4 * (2 * kF32Tile + kLcFloats + 64);

template <int D>
int launch_tc(const __nv_bfloat16* r, const __nv_bfloat16* k,
              const __nv_bfloat16* v, const float* w, const float* u,
              const float* s0, __nv_bfloat16* y, float* s_out, float* states,
              float* decay, int64_t bh, int64_t s, int64_t heads,
              cudaStream_t stream) {
  // the shared-memory limits are raised once per device (a driver call
  // each, host time on every call otherwise)
  static bool raised[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= kMaxDevices || !raised[dev]) {
    err = cudaFuncSetAttribute(wkv_chunk_state<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kStateSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(wkv_chunk_out<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kOutSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) raised[dev] = true;
  }
  const int nc = static_cast<int>((s + kQ - 1) / kQ);
  const unsigned blocks = static_cast<unsigned>(bh * nc);
  wkv_chunk_state<D><<<blocks, kWg, kStateSmem, stream>>>(
      k, v, w, states, decay, static_cast<int>(s), nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = bh * D * D;
  wkv_state_pass<<<static_cast<unsigned>((total + 255) / 256), 256, 0,
                   stream>>>(states, decay, s0, s_out, total, nc, D);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  wkv_chunk_out<D><<<blocks, kWg, kOutSmem, stream>>>(
      r, k, v, w, u, states, y, static_cast<int>(s),
      static_cast<int>(heads), nc);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// One call, its arguments packed as seventeen int64 (ctypes turns one bytes
// object into a pointer faster than it converts seventeen typed arguments):
// {instance (0: wkv6_fwd, 1: tc), dtype (0 = f32, 1 = bf16), r, k, v, w,
// u, s0, y, s_out, states, decay, bh, s, heads, hd, stream}. r, k, v, y
// (bh, s, hd) in `dtype`; w (bh, s, hd), u (heads, hd), s0 and s_out (bh,
// hd, hd) f32, all contiguous; s0 may be 0 (zero state). The tc instance
// (bf16, hd 16 / 32 / 48 / 64, r, k, v and w 16-byte aligned) also takes
// the scratch `states` (bh, nc, hd, hd) and `decay` (bh, nc, hd) f32, nc =
// ceil(s / 64), and launches three kernels; wkv6_fwd launches one. Returns
// cudaGetLastError() as an int (cudaErrorInvalidValue for bad arguments).
int rwkv6_scan_launch(const int64_t* a) {
  const int64_t inst = a[0], dtype = a[1], bh = a[12], s = a[13],
                heads = a[14], hd = a[15];
  const void* r = reinterpret_cast<const void*>(a[2]);
  const void* k = reinterpret_cast<const void*>(a[3]);
  const void* v = reinterpret_cast<const void*>(a[4]);
  const float* w = reinterpret_cast<const float*>(a[5]);
  const float* u = reinterpret_cast<const float*>(a[6]);
  const float* s0 = reinterpret_cast<const float*>(a[7]);
  void* y = reinterpret_cast<void*>(a[8]);
  float* s_out = reinterpret_cast<float*>(a[9]);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(a[16]);
  if (bh < 1 || s < 1 || heads < 1 || hd < 1 || hd > 64) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (inst == 0) {
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
  float* states = reinterpret_cast<float*>(a[10]);
  float* decay = reinterpret_cast<float*>(a[11]);
  if (inst != 1 || dtype != 1 || hd % 16 != 0 || states == nullptr ||
      decay == nullptr ||
      (a[2] | a[3] | a[4] | a[5]) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* rb = static_cast<const __nv_bfloat16*>(r);
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* yb = static_cast<__nv_bfloat16*>(y);
  switch (hd) {
#define WKV_TC_CASE(D)                                                        \
  case D:                                                                    \
    return launch_tc<D>(rb, kb, vb, w, u, s0, yb, s_out, states, decay, bh,  \
                        s, heads, st);
    WKV_TC_CASE(16) WKV_TC_CASE(32) WKV_TC_CASE(48) WKV_TC_CASE(64)
#undef WKV_TC_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* rwkv6_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
