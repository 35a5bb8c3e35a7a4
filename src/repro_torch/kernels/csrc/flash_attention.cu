// Causal (optionally sliding-window) flash attention for Hopper (sm_90a):
// the prefill attention of every `attn` / `shared_attn` layer.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (`_flash_kernel`). For q, k, v
// (B, H, S, hd) contiguous, f32 or bf16, one head count (GQA expanded by
// the caller), and every query row q:
//
//   s[k]  = (q_row . k_row) * 1/sqrt(hd)        for k <= q and, with a
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
// S % block == 0 instead). A fully masked first tile leaves m = -1e30 and
// p = 1 in the sums, which the next real score erases through
// alpha = exp(-1e30 - m) = 0, as in the Pallas kernel.
//
// What bounds it: operations. At gemma3's prefill (B 2, H 8, S 2048,
// hd 256) one full layer is 2 * 2 * B*H*S*S/2*hd ~ 34 GFLOP against 67 MB
// of q, k, v and output, ~500 FLOP per byte, far above the H100's ~295
// bf16 FLOP per byte of HBM. For bf16 inputs the bound is the bf16 tensor
// cores' 989 TFLOP/s, for f32 inputs the CUDA cores' 67 TFLOP/s (the
// tensor cores have no f32 product, and TF32 would round the inputs to 10
// bits). So the library holds two instances, and the wrapper picks one by
// shape and dtype (`_variant` in kernels/flash_attention.py):
//
// * `flash_tc` (bf16, hd a multiple of 16, entry flash_attention_tc_launch):
//   one warpgroup of 128 threads per (b*h, 64-row q tile), grid
//   (B*H, q tiles) with the q tiles walked longest-first. Both products
//   run as `wgmma` m64n64k16 with f32 accumulators. The q tile and a
//   2-stage ring of 64-key k and v tiles are brought into shared memory
//   by TMA (3-D tensor maps (hd, S, B*H), so a ragged S tail meets a real
//   edge of the map and is zero-filled, 128-byte swizzle, hd in boxes of
//   64 columns), completion reported to one mbarrier per stage; thread 0
//   issues tile t + 1 while the warpgroup computes on tile t. S = Q K^T
//   reads both operands from shared memory (K's natural (keys, hd) rows
//   are K-major for B); 1/sqrt(hd) * log2(e) multiplies the f32 scores
//   (folding it into a bf16 copy of q would round every score once more at
//   hd 112 or 48, where the scale is no power of two), and exp2f takes
//   the place of exp. The mask is applied only on the diagonal and
//   window-edge tiles; the row max and sum are reduced across the 4
//   threads that share a row with shuffles. O += P V takes P from
//   registers (the S fragment converted in place) and V from shared memory
//   as an MN-major B (the transpose bit of 16-bit types).
//
//   P keeps f32 precision: the Pallas kernel multiplies an f32 p by v, and
//   rounding P once to bf16 moves an output whose terms cancel by ~2^-9 of
//   their size, beyond the card's bf16 check (1e-5 of the largest output
//   plus 8e-3 relative, against the plain version in f32). So P is split
//   into P_hi = bf16(P) and P_lo = bf16(P - P_hi) and both go through
//   `wgmma` into the same accumulator: 1.5x the tensor-core work of one
//   bf16 P, and ~2^-17 relative error per term.
//
//   At hd 256 the O accumulator takes 128 registers a thread and the tiles
//   160 KB, so one block per SM (`__launch_bounds__(128, 1)`); smaller hd
//   fit several.
//
// * `flash_fwd` (f32 at any hd, bf16 at hd not a multiple of 16; entry
//   flash_attention_simt_launch): the SIMT kernel on the CUDA cores. One
//   block of 128 threads per (b*h, 32-row q tile). The q tile (pre-scaled,
//   f32) stays in shared memory; each 32-key tile of k (transposed, so the
//   score loop reads consecutive addresses) and v is staged through shared
//   memory in f32. Thread t owns rows 4*(t/16)..+3 in both products: in
//   the scores it holds a 4 x 2 tile (columns t%16 and t%16 + 16), in P.V
//   a 4 x NC tile of the accumulator (columns t%16 + 16 j), so the rescale
//   by exp(m_old - m_new) happens in registers. The 16 threads of a row
//   group (one half-warp) reduce the row max and sum with shuffles.
//   Shared memory at hd 256 is ~104 KB, two blocks per SM.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "hopper_wgmma.cuh"

namespace {

using hopper::pack_bf16;
using hopper::reg_fence;
using hopper::smem_u32;
using hopper::wgmma_commit_wait;
using hopper::wgmma_fence;
using hopper::wgmma_rs;
using hopper::wgmma_ss;

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

// ------------------------- tensor-core instance ----------------------------

constexpr int kTile = 64;                 // q rows per block = keys per tile
constexpr int kBox = 64;                  // hd columns per TMA box (128 B)
constexpr int kBoxBytes = kTile * kBox * 2;
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Tc {
  static constexpr int kBoxes = (HD + kBox - 1) / kBox;
  static constexpr int kSteps = HD / 16;       // k16 steps of Q K^T
  static constexpr int kTileBytes = kBoxes * kBoxBytes;
  // q, k stages 0-1, v stages 0-1, three mbarriers (q, full[0], full[1]),
  // and 1 KB to align the base to the 128-byte swizzle's 1024-byte atom
  static constexpr int kSmem = 5 * kTileBytes + 64 + 1024;
};

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(1)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes)
               : "memory");
}

// waits for the phase `parity` of `bar` to complete; a wait longer than
// 4 s (a lost TMA transfer) traps instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  uint64_t start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    uint64_t now;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (start == 0) {
      start = now;
    } else if (now - start > 4000000000ull) {
      __trap();
    }
  }
}

// one 64 x 64 box of a (hd, S, B*H) map at (col, row, bh) into `dst`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(row),
      "r"(bh)
      : "memory");
}

// wgmma descriptor of one of this kernel's 64 x 64 swizzled boxes
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return hopper::desc_sw128(addr, kBoxBytes);
}

// keys [row, row + 64) of k and v into ring stage `stage`, reported to the
// stage's barrier `full`
template <int HD>
__device__ __forceinline__ void load_kv(const CUtensorMap* kmap,
                                        const CUtensorMap* vmap, uint32_t sk,
                                        uint32_t sv, uint32_t full, int stage,
                                        int row, int bh) {
  mbar_expect_tx(full, 2 * Tc<HD>::kTileBytes);
#pragma unroll
  for (int c = 0; c < Tc<HD>::kBoxes; ++c) {
    const uint32_t off = stage * Tc<HD>::kTileBytes + c * kBoxBytes;
    tma_load(sk + off, kmap, full, c * kBox, row, bh);
    tma_load(sv + off, vmap, full, c * kBox, row, bh);
  }
}

template <int HD>
__global__ void __launch_bounds__(128, 1)
flash_tc(const __grid_constant__ CUtensorMap qmap,
         const __grid_constant__ CUtensorMap kmap,
         const __grid_constant__ CUtensorMap vmap,
         __nv_bfloat16* __restrict__ o, int s_len, int window,
         float scale_log2) {
  using C = Tc<HD>;
  extern __shared__ uint8_t smem_tc[];
  const uint32_t base = (smem_u32(smem_tc) + 1023u) & ~1023u;
  const uint32_t sq = base;                          // q tile
  const uint32_t sk = base + C::kTileBytes;          // k stages 0, 1
  const uint32_t sv = base + 3 * C::kTileBytes;      // v stages 0, 1
  const uint32_t bar = base + 5 * C::kTileBytes;     // q, full[0], full[1]

  const int bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTile;   // longest first
  const int tid = threadIdx.x;
  const int q_last = min(q0 + kTile, s_len) - 1;
  const int t_first = (window > 0 ? max(q0 - window + 1, 0) : 0) / kTile;
  const int n_tiles = q_last / kTile - t_first + 1;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(bar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    mbar_expect_tx(bar, C::kTileBytes);
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
      tma_load(sq + c * kBoxBytes, &qmap, bar, c * kBox, q0, bh);
    }
    load_kv<HD>(&kmap, &vmap, sk, sv, bar + 8, 0, t_first * kTile, bh);
  }
  __syncthreads();

  // the wgmma accumulator layout: thread (warp w, lane) holds rows
  // r0 = 16 w + lane / 4 and r0 + 8, and in each 8-column block i the
  // columns 8 i + 2 (lane % 4) + {0, 1}: d[4 i + e] is row r0 + 8 (e / 2),
  // column 8 i + 2 (lane % 4) + e % 2
  const int lane = tid & 31;
  const int r0 = 16 * (tid >> 5) + (lane >> 2);
  const int c0 = 2 * (lane & 3);

  float acc[C::kBoxes][32];
#pragma unroll
  for (int c = 0; c < C::kBoxes; ++c) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.0f;
  }
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  mbar_wait(bar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int stage = t & 1;
    // every thread is past tile t - 1, whose stage tile t + 1 reuses
    if (t > 0) __syncthreads();
    if (tid == 0 && t + 1 < n_tiles) {
      load_kv<HD>(&kmap, &vmap, sk, sv, bar + 8 + 8 * (stage ^ 1), stage ^ 1,
                  (t_first + t + 1) * kTile, bh);
    }
    mbar_wait(bar + 8 + 8 * stage, (t >> 1) & 1);

    // S = Q K^T: k16 steps walk 32 bytes along a swizzled 128-byte row
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(s[i]);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < C::kSteps; ++j) {
      const uint32_t off = (j / 4) * kBoxBytes + (j % 4) * 32;
      wgmma_ss(s, desc_sw128(sq + off),
               desc_sw128(sk + stage * C::kTileBytes + off), 1);
    }
    wgmma_commit_wait();
#pragma unroll
    for (int i = 0; i < 32; ++i) reg_fence(s[i]);

    // scale to log2 units, mask the diagonal and window-edge tiles only
    const int k0 = (t_first + t) * kTile;
    const bool edge = k0 + kTile - 1 > q0 ||
                      (window > 0 && k0 <= q0 + kTile - 1 - window);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = s[i] * scale_log2;
      if (edge) {
        const int key = k0 + 8 * (i / 4) + c0 + (i & 1);
        const int row = q0 + r0 + 8 * ((i / 2) & 1);
        if (key > row || (window > 0 && key <= row - window)) x = kNegInf;
      }
      s[i] = x;
      mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], x);
    }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }

    // P = exp2(S - m) as the A fragments of the four k16 steps of P V:
    // step j, register h holds S[8 j + 2 h], S[8 j + 2 h + 1] (row
    // r0 + 8 (h % 2)); split into P_hi + P_lo, both bf16
    uint32_t p_hi[4][4], p_lo[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const float mr = m[h & 1];
        const float p0 = exp2f(s[8 * j + 2 * h] - mr);
        const float p1 = exp2f(s[8 * j + 2 * h + 1] - mr);
        sum[h & 1] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        p_hi[j][h] = pack_bf16(hi);
        p_lo[j][h] = pack_bf16(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l[r] = l[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        acc[c][i] *= alpha[(i / 2) & 1];
        reg_fence(acc[c][i]);
      }
    }

    // O += P_hi V + P_lo V; key step j is 16 rows (2048 bytes) of v
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint64_t dv = desc_sw128(sv + stage * C::kTileBytes +
                                       c * kBoxBytes + j * 16 * 128);
        wgmma_rs(acc[c], p_hi[j], dv);
        wgmma_rs(acc[c], p_lo[j], dv);
      }
    }
    wgmma_commit_wait();
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
#pragma unroll
      for (int i = 0; i < 32; ++i) reg_fence(acc[c][i]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        reg_fence(p_hi[j][h]);
        reg_fence(p_lo[j][h]);
      }
    }
  }

  // out = O / l, rounded once; rows >= S and columns >= hd not written
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + 8 * r;
    if (row >= s_len) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    __nv_bfloat16* out = o + (static_cast<int64_t>(bh) * s_len + row) * HD;
#pragma unroll
    for (int c = 0; c < C::kBoxes; ++c) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (c * kBox + 8 * i < HD) {
          *reinterpret_cast<__nv_bfloat162*>(out + c * kBox + 8 * i + c0) =
              __floats2bfloat162_rn(acc[c][4 * i + 2 * r] * inv,
                                    acc[c][4 * i + 2 * r + 1] * inv);
        }
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime has loaded, so the
// library needs no -lcuda; nullptr when the driver does not have it
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// the (hd, S, B*H) bf16 map of one of q, k, v in 64 x 64 boxes, 128-byte
// swizzle, zero fill out of bounds; -> CUresult
int encode_map(EncodeTiled encode, CUtensorMap* map, const void* ptr,
               int64_t bh, int64_t s, int64_t hd) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(s),
                              static_cast<cuuint64_t>(bh)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd * 2),
                                 static_cast<cuuint64_t>(s * hd * 2)};
  const cuuint32_t box[3] = {kBox, kTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return static_cast<int>(encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

template <int HD>
int launch_tc(const CUtensorMap& qm, const CUtensorMap& km,
              const CUtensorMap& vm, void* o, int64_t bh, int64_t s,
              int64_t window, cudaStream_t stream) {
  constexpr int bytes = Tc<HD>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      flash_tc<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(bh),
                  static_cast<unsigned>((s + kTile - 1) / kTile));
  flash_tc<HD><<<grid, 128, bytes, stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), static_cast<int>(s),
      static_cast<int>(window),
      1.0f / sqrtf(static_cast<float>(HD)) * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, k, v, o (bh, s, hd) contiguous; dtype 0 = f32, 1 = bf16; window 0 =
// full causal. Launches the SIMT kernel on `stream` and returns
// cudaGetLastError() as an int (cudaErrorInvalidValue for bad arguments).
int flash_attention_simt_launch(const void* q, const void* k, const void* v,
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

// q, k, v, o (bh, s, hd) contiguous bf16, hd a multiple of 16 up to 256,
// q, k, v 16-byte aligned; window 0 = full causal. Encodes the three
// tensor maps, launches the tensor-core kernel on `stream` and returns
// cudaGetLastError() as an int, cudaErrorInvalidValue for bad arguments,
// or a negative code for a failed tensor-map encode (-1: the driver has
// no cuTensorMapEncodeTiled; -1000 - CUresult otherwise).
int flash_attention_tc_launch(const void* q, const void* k, const void* v,
                              void* o, int64_t bh, int64_t s, int64_t hd,
                              int64_t window, void* stream) {
  if (bh < 1 || bh > 0x7fffffff || s < 1 || hd < 16 || hd > 256 ||
      hd % 16 != 0 || window < 0 || (s + kTile - 1) / kTile > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    if (reinterpret_cast<uintptr_t>(ptrs[i]) % 16 != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return -1;
  CUtensorMap maps[3];
  for (int i = 0; i < 3; ++i) {
    const int res = encode_map(encode, &maps[i], ptrs[i], bh, s, hd);
    if (res != 0) return -1000 - res;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd / 16) {
#define FLASH_TC_CASE(n) \
  case n:                \
    return launch_tc<16 * n>(maps[0], maps[1], maps[2], o, bh, s, window, st);
    FLASH_TC_CASE(1) FLASH_TC_CASE(2) FLASH_TC_CASE(3) FLASH_TC_CASE(4)
    FLASH_TC_CASE(5) FLASH_TC_CASE(6) FLASH_TC_CASE(7) FLASH_TC_CASE(8)
    FLASH_TC_CASE(9) FLASH_TC_CASE(10) FLASH_TC_CASE(11) FLASH_TC_CASE(12)
    FLASH_TC_CASE(13) FLASH_TC_CASE(14) FLASH_TC_CASE(15) FLASH_TC_CASE(16)
#undef FLASH_TC_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* flash_attention_error_string(int err) {
  static char buf[96];
  if (err == -1) return "the CUDA driver has no cuTensorMapEncodeTiled";
  if (err < 0) {
    snprintf(buf, sizeof(buf), "cuTensorMapEncodeTiled failed (CUresult %d)",
             -1000 - err);
    return buf;
  }
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
