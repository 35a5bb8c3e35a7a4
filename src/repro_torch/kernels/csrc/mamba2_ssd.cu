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
// What bounds it: operations. Per chunk and head the products take
// Q^2 N / 2 + Q^2 P / 2 + 2 Q P N multiply-adds (~1.6 M at Q 128, P = N
// 64) against ~Q (P + 2 N) input values: ~100 FLOP per byte in bf16, far
// above the f32 CUDA cores' ridge; in bf16 every product can run on the
// tensor cores. The library holds two instances, and the wrapper picks one
// by shape and dtype (`_variant` in kernels/mamba2_ssd.py):
//
// * `ssd_tc` (bf16, Q 64 or 128, P and N multiples of 16 up to 128;
//   instance 1 of mamba2_ssd_launch). The chunk is flash attention with a
//   decay mask in place of the softmax, as four `wgmma` m64n64k16 products
//   with f32 accumulators (helpers in hopper_wgmma.cuh), per 64-row tile
//   of the chunk:
//     y     = exp(L_t) (C S^T)                 C, S_hi, S_lo from smem
//     G     = C B^T                            one 64 x 64 block at a time
//     M     = G * exp(L_t - L_s) dt_s [s <= t] on the accumulator fragment
//     y    += M_hi x + M_lo x                  M from registers, x MN-major
//   and per chunk the state update
//     S    <- exp(L_Q) S + sum_k (w x)_k^T B   (w x) from registers
//   with w_s = exp(L_Q - L_s) dt_s.
//   Precision: C, B and x are bf16 values, so their products are exact.
//   The f32 operands enter split into bf16 terms, hi = bf16(v), lo =
//   bf16(v - hi), ...: M and S as hi + lo (~2^-17 relative), w x as
//   three terms (exact to f32's 24 bits). The depths come from an
//   emulation of this arithmetic on the CPU against the plain version
//   (tests/test_torch_kernels.py, `_ssd_tc_emulation`): at the card's
//   tolerance (state at f32's, y at bf16's) w x in two terms used up to
//   17% of the state's tolerance over 16 chunks, three terms 0.2%; M and
//   S in two terms leave y at the floor that its one bf16 rounding sets.
//   The f32 state lives in shared memory as those three bf16 tiles, which
//   reconstruct it exactly: the update reloads it (hi + lo + lo2), scales
//   it by exp(L_Q) in the accumulator, adds the product and writes the
//   split back; the next chunk's C S^T reads S_hi and S_lo as a K-major B.
//   The decay is one exp2 per element of M on the MUFU, with dt folded in:
//   M = G 2^(L_t log2(e) - q_s), q_s = L_s log2(e) - log2(dt_s) kept per
//   token. It is not the factored exp(L_t) exp(-L_s): within one 64-row
//   tile of a chunk L can fall by more than the 88 an f32 exponent spans
//   (zamba2's A reaches -16 per unit of dt), and a factored product would
//   then overflow to inf * 0.
//   Latency: a chunk is a chain of dependent product groups on one
//   warpgroup, so dt for chunk c + 1 is read into a register during chunk
//   c, and the first G of each row tile goes in one group with C S^T.
//   Parallelism: two (b, h) chains per block (two warpgroups, heads h and
//   h + 1 of one batch row) share the b and c tiles when B * H exceeds the
//   SM count, so zamba2's 224 chains at batch 2 run as 112 blocks in one
//   wave; at B * H up to the SM count each chain has a block of its own.
//   All threads of the block bring chunk c + 1's b, c and x tiles into a
//   second stage with 16-byte cp.async (128-byte swizzle, written by hand)
//   while chunk c computes; shapes whose two stages do not fit in 227 KB
//   run one stage. L = cumsum(dt a) is a warp scan per warpgroup. Shared
//   memory at Q 128, P = N = 64: 181 KB for two chains and two stages.
//   P or N below 64 occupy a zero-padded 64-column box; their products run
//   at n64 on the zeros.
//
// * `ssd_fwd` (f32 at any shape, bf16 where the tiles do not fit;
//   instance 0 of mamba2_ssd_launch): the SIMT kernel on the f32 CUDA
//   cores. One block of 256 threads per (b, h) walks the chunks in order
//   and keeps the (P, N) state in shared memory. Per chunk it stages x
//   (Q, P), b and c (Q, N, rows padded by one float so column walks hit
//   distinct banks), dt, L = cumsum(dt * a) (a block scan of warp scans),
//   exp(L) and w in shared memory, then builds M (lower triangle only, one
//   expf per element), y, and the new state, each output element owned by
//   one thread. At Q 128, P = N = 64 the tiles take ~180 KB (one block per SM).
//
// b and c are read straight from their (B, S, N) rows by every head: the
// broadcast over heads that the TPU wrapper materialises is never built.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSmem = 232448;          // bytes a block may use on Hopper
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// inclusive prefix sum over the 32 lanes of a warp
__device__ __forceinline__ float warp_scan(float v, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float n = __shfl_up_sync(0xffffffffu, v, off);
    if (lane >= off) v += n;
  }
  return v;
}

// ------------------------------ SIMT instance ------------------------------

size_t smem_floats(int64_t q, int64_t p, int64_t n) {
  return size_t(q * p + 2 * q * (n + 1) + q * q + p * (n + 1) + 4 * q + 8);
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
  float* sscan = sw + q_len;               // [8]  warp totals of the scan

  const int bi = blockIdx.x / heads;
  const int h = blockIdx.x - bi * heads;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
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
    // L = cumsum(dt * a): a block scan of warp scans, kThreads tokens at a
    // time, each tile carried into the next
    float carry = 0.0f;
    for (int t0 = 0; t0 < q_len; t0 += kThreads) {
      const int t = t0 + tid;
      float d = 0.0f;
      if (t < q_len) {
        d = dt[(row0 + t) * heads + h];
        sdt[t] = d;
      }
      const float v = warp_scan(d * ah, lane);
      if (lane == 31) sscan[warp] = v;
      __syncthreads();
      float prefix = carry, tile = 0.0f;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        if (w < warp) prefix += sscan[w];
        tile += sscan[w];
      }
      if (t < q_len) sl[t] = prefix + v;
      carry += tile;
      __syncthreads();                     // sscan is rewritten next tile
    }
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
int launch_simt(const void* x, const float* dt, const float* a, const void* b,
                const void* c, void* y, float* s_fin, int64_t batch,
                int64_t s, int64_t heads, int64_t p, int64_t n, int64_t q,
                cudaStream_t stream) {
  const size_t bytes = sizeof(float) * smem_floats(q, p, n);
  if (bytes > static_cast<size_t>(kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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

// --------------------------- tensor-core instance ---------------------------

constexpr int kWg = 128;                  // threads of one warpgroup

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// 2^x on the MUFU (relative error ~2^-22; results below 2^-126 flush to 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
// the 128 threads of warpgroup `wg` (named barriers 1 and 2)
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "r"(kWg) : "memory");
}
__device__ __forceinline__ float bf_at(const uint8_t* p) {
  return __bfloat162float(*reinterpret_cast<const __nv_bfloat16*>(p));
}
// v -> three bf16 pairs whose sum is v exactly (hi, lo, lo2)
__device__ __forceinline__ void split3(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo, uint32_t& lo2) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(h);
  const float r0 = v0 - hf.x, r1 = v1 - hf.y;
  const __nv_bfloat162 l = __floats2bfloat162_rn(r0, r1);
  const float2 lf = __bfloat1622float2(l);
  hi = hopper::pack_bf16(h);
  lo = hopper::pack_bf16(l);
  lo2 = hopper::pack_bf16(__floats2bfloat162_rn(r0 - lf.x, r1 - lf.y));
}

// bytes of shared memory of one block: `stages` of the b and c tiles and of
// `hb` x tiles, `hb` states as three bf16 tiles, `hb` sets of the per-token
// arrays, and 1 KB to align the base to the swizzle's 1024-byte atom
size_t tc_smem(int64_t q, int64_t pb, int64_t nb, int64_t hb,
               int64_t stages) {
  const int64_t box_q = q * 128, box_p = 64 * pb * 128;
  return size_t(stages * (2 * nb * box_q + hb * pb * box_q) +
                hb * (3 * nb * box_p + (4 * q + 8) * 4) + 1024);
}

// Q tokens per chunk, PB / NB 64-column boxes of P / N; hb (b, h) chains
// per block, one warpgroup each; stages 1 or 2.
template <int Q, int PB, int NB>
__global__ void __launch_bounds__(2 * kWg, 1)
ssd_tc(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
       const float* __restrict__ a, const __nv_bfloat16* __restrict__ b,
       const __nv_bfloat16* __restrict__ c, __nv_bfloat16* __restrict__ y,
       float* __restrict__ s_fin, int s_len, int heads, int p_dim, int n_dim,
       int hb, int stages) {
  using hopper::desc_sw128;
  using hopper::reg_fence;
  using hopper::sw128_offset;
  constexpr int kRowTiles = Q / 64;
  constexpr int kSteps = Q / 16;                // k16 steps over the tokens
  constexpr uint32_t kBoxQ = Q * 128;           // a box of Q rows
  constexpr uint32_t kBoxP = PB * 64 * 128;     // a box of the padded P rows
  constexpr uint32_t kTileBC = NB * kBoxQ;      // b or c: (Q, N)
  constexpr uint32_t kTileX = PB * kBoxQ;       // x: (Q, P)
  constexpr uint32_t kTileS = NB * kBoxP;       // one term of S: (P, N)

  extern __shared__ uint8_t smem_tc[];
  uint8_t* base = smem_tc + ((1024u - (hopper::smem_u32(smem_tc) & 1023u)) &
                             1023u);
  const uint32_t sbase = hopper::smem_u32(base);
  // layout: b, c tiles [stage][2], then x tiles [stage][chain], the state
  // tiles [chain][hi, lo, lo2], the per-token arrays [chain]
  const uint32_t off_x = stages * 2 * kTileBC;
  const uint32_t off_s = off_x + stages * hb * kTileX;
  const uint32_t off_small = off_s + hb * 3 * kTileS;
  const uint32_t total = off_small + hb * (4 * Q + 8) * 4;

  const int n_groups = (heads + hb - 1) / hb;
  const int bi = blockIdx.x / n_groups;
  const int h0 = (blockIdx.x - bi * n_groups) * hb;
  const int tid = threadIdx.x;
  const int nthreads = hb * kWg;
  const int wg = tid / kWg;
  const int wt = tid - wg * kWg;
  const int h = h0 + wg;
  const bool active = h < heads;
  const int lane = tid & 31;
  const int r0 = 16 * (wt >> 5) + (lane >> 2);  // accumulator rows r0, r0 + 8
  const int c0 = 2 * (lane & 3);                // and columns 8 i + c0 + {0,1}

  // zero everything once: the columns past P or N of every tile stay zero
  for (uint32_t i = tid * 16; i < total; i += nthreads * 16) {
    *reinterpret_cast<uint4*>(base + i) = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // chunk `ch`'s b, c and x tiles into stage `st`, 16 bytes per cp.async.
  // A thread copies one 16-byte column piece of every step-th row; its
  // column and first row are fixed for the whole chain (no division per
  // copy), and threads past step * pieces-per-row sit out.
  const int per_n = n_dim >> 3, per_p = p_dim >> 3;
  const int bc_step = nthreads / per_n, x_step = nthreads / per_p;
  const int bc_col = (tid % per_n) * 8, x_col = (tid % per_p) * 8;
  const bool bc_on = tid < bc_step * per_n, x_on = tid < x_step * per_p;
  auto load_chunk = [&](int ch, int st) {
    const int64_t row0 = int64_t(bi) * s_len + int64_t(ch) * Q;
    const uint32_t tb = sbase + st * 2 * kTileBC;
    if (bc_on) {
      for (int r = tid / per_n; r < Q; r += bc_step) {
        const uint32_t o = sw128_offset(r, bc_col, kBoxQ);
        const int64_t g = (row0 + r) * n_dim + bc_col;
        cp_async16(tb + o, b + g);
        cp_async16(tb + kTileBC + o, c + g);
      }
    }
    if (x_on) {
      // rows of the hb chains' x tiles, chain-major
      for (int rr = tid / per_p; rr < hb * Q; rr += x_step) {
        const int hh = rr / Q, r = rr - hh * Q;
        if (h0 + hh >= heads) break;
        cp_async16(sbase + off_x + (st * hb + hh) * kTileX +
                       sw128_offset(r, x_col, kBoxQ),
                   x + ((row0 + r) * heads + h0 + hh) * p_dim + x_col);
      }
    }
    cp_async_commit();
  };

  float* small = reinterpret_cast<float*>(base + off_small) + wg * (4 * Q + 8);
  float* sl2 = small;                  // [Q] L in log2 units
  float* sq = small + Q;               // [Q] L_s log2(e) - log2(dt_s)
  float* sw = small + 2 * Q;           // [Q] exp(L_Q - L_s) dt_s
  float* sel = small + 3 * Q;          // [Q] exp(L_t)
  float* sscan = small + 4 * Q;        // [Q / 32] warp totals
  const uint32_t s_tile = sbase + off_s + wg * 3 * kTileS;
  uint8_t* s_gen = base + off_s + wg * 3 * kTileS;
  const float ah = active ? a[h] : 0.0f;
  const int n_steps = n_dim >> 4;      // k16 steps over N
  const int n_chunks = s_len / Q;

  // dt of chunk ch + 1 is read into a register while chunk ch computes,
  // so its global-memory latency is off the chain
  const bool loads_dt = active && wt < Q;
  const float* dt_h = dt + int64_t(bi) * s_len * heads + h;
  float dt_next = loads_dt ? dt_h[int64_t(wt) * heads] : 0.0f;
  load_chunk(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int st = stages == 2 ? (ch & 1) : 0;
    if (stages == 2 && ch + 1 < n_chunks) {
      load_chunk(ch + 1, st ^ 1);      // stage st ^ 1 was freed last chunk
      cp_async_wait<1>();
    } else {
      if (stages == 1 && ch > 0) load_chunk(ch, 0);
      cp_async_wait<0>();
    }
    hopper::fence_proxy_async();       // cp.async data -> wgmma reads
    const int64_t row0 = int64_t(bi) * s_len + int64_t(ch) * Q;
    const float dtv = dt_next;
    if (loads_dt && ch + 1 < n_chunks) {
      dt_next = dt_h[(int64_t(ch + 1) * Q + wt) * heads];
    }
    __syncthreads();

    if (active) {
      // L = cumsum(dt a) by warp scans; L_Q sums the warp totals in the
      // order the last token's prefix does, so L_Q == L[Q - 1] exactly
      const float v = warp_scan(dtv * ah, lane);
      if (lane == 31 && wt < Q) sscan[wt >> 5] = v;
      wg_sync(wg);
      float prefix = 0.0f, l_last = 0.0f;
#pragma unroll
      for (int w = 0; w < Q / 32; ++w) {
        const float tw = sscan[w];
        if (w < (wt >> 5)) prefix += tw;
        if (w < Q / 32 - 1) l_last += tw;
      }
      if (wt < Q) {
        const float l = prefix + v;
        sl2[wt] = l * kLog2e;
        sq[wt] = l * kLog2e - log2f(dtv);    // M's column term, log2 units
        sw[wt] = expf(l_last + sscan[Q / 32 - 1] - l) * dtv;
        sel[wt] = expf(l);
      }
      l_last += sscan[Q / 32 - 1];
      const float e_last = expf(l_last);
      wg_sync(wg);

      const uint32_t tb = sbase + st * 2 * kTileBC;
      const uint32_t tc = tb + kTileBC;
      const uint32_t tx = sbase + off_x + (st * hb + wg) * kTileX;
      const uint8_t* tx_gen = base + off_x + (st * hb + wg) * kTileX;

#pragma unroll
      for (int rt = 0; rt < kRowTiles; ++rt) {
        float yacc[PB][32];
#pragma unroll
        for (int pb = 0; pb < PB; ++pb) {
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            yacc[pb][i] = 0.0f;
            reg_fence(yacc[pb][i]);
          }
        }
        const int t_lo = rt * 64 + r0;
        const float l2_t[2] = {sl2[t_lo], sl2[t_lo + 8]};
#pragma unroll
        for (int sb = 0; sb <= rt; ++sb) {
          // G = C B^T for tokens t of this row tile, s of column block sb;
          // with the first block, y = C S_hi^T + C S_lo^T in the same group
          float g[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            g[i] = 0.0f;
            reg_fence(g[i]);
          }
          hopper::wgmma_fence();
          if (sb == 0 && ch > 0) {
#pragma unroll
            for (int pb = 0; pb < PB; ++pb) {
#pragma unroll
              for (int term = 0; term < 2; ++term) {
                for (int j = 0; j < n_steps; ++j) {
                  const uint32_t k = (j >> 2) * kBoxQ + (j & 3) * 32;
                  const uint32_t ks = (j >> 2) * kBoxP + (j & 3) * 32;
                  hopper::wgmma_ss(
                      yacc[pb], desc_sw128(tc + k + rt * 64 * 128, kBoxQ),
                      desc_sw128(s_tile + term * kTileS + ks + pb * 64 * 128,
                                 kBoxP),
                      1);
                }
              }
            }
          }
          for (int j = 0; j < n_steps; ++j) {
            const uint32_t k = (j >> 2) * kBoxQ + (j & 3) * 32;
            hopper::wgmma_ss(g, desc_sw128(tc + k + rt * 64 * 128, kBoxQ),
                             desc_sw128(tb + k + sb * 64 * 128, kBoxQ), 1);
          }
          hopper::wgmma_commit_wait();
#pragma unroll
          for (int i = 0; i < 32; ++i) reg_fence(g[i]);
          if (sb == 0 && ch > 0) {
            // y = exp(L_t) (C S^T), before M x adds to it
            const float e0 = sel[t_lo], e1 = sel[t_lo + 8];
#pragma unroll
            for (int pb = 0; pb < PB; ++pb) {
#pragma unroll
              for (int i = 0; i < 32; ++i) {
                reg_fence(yacc[pb][i]);
                yacc[pb][i] *= ((i >> 1) & 1) ? e1 : e0;
              }
            }
          }

          // M = G exp2(L_t log2(e) - sq_s) = G exp(L_t - L_s) dt_s, masked
          // to s <= t on the diagonal block, split into M_hi + M_lo as the A
          // fragments of the four k16 steps of M x
          uint32_t m_hi[4][4], m_lo[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int hh = 0; hh < 4; ++hh) {
              const int row = hh & 1;
              const int t = t_lo + 8 * row;
              const int s = sb * 64 + 16 * j + 8 * (hh >> 1) + c0;
              const float2 q2 = *reinterpret_cast<const float2*>(sq + s);
              float m0 = g[8 * j + 2 * hh] * ex2(l2_t[row] - q2.x);
              float m1 = g[8 * j + 2 * hh + 1] * ex2(l2_t[row] - q2.y);
              if (sb == rt) {
                m0 = s <= t ? m0 : 0.0f;
                m1 = s + 1 <= t ? m1 : 0.0f;
              }
              const __nv_bfloat162 hi = __floats2bfloat162_rn(m0, m1);
              const float2 hf = __bfloat1622float2(hi);
              m_hi[j][hh] = hopper::pack_bf16(hi);
              m_lo[j][hh] = hopper::pack_bf16(
                  __floats2bfloat162_rn(m0 - hf.x, m1 - hf.y));
            }
          }
#pragma unroll
          for (int pb = 0; pb < PB; ++pb) {
#pragma unroll
            for (int i = 0; i < 32; ++i) reg_fence(yacc[pb][i]);
          }
          hopper::wgmma_fence();
          // y += M_hi x + M_lo x; token step j is 16 rows (2048 bytes) of x
#pragma unroll
          for (int pb = 0; pb < PB; ++pb) {
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const uint64_t dx = desc_sw128(
                  tx + pb * kBoxQ + (sb * 64 + 16 * j) * 128, kBoxQ);
              hopper::wgmma_rs(yacc[pb], m_hi[j], dx);
              hopper::wgmma_rs(yacc[pb], m_lo[j], dx);
            }
          }
          hopper::wgmma_commit_wait();
#pragma unroll
          for (int pb = 0; pb < PB; ++pb) {
#pragma unroll
            for (int i = 0; i < 32; ++i) reg_fence(yacc[pb][i]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int hh = 0; hh < 4; ++hh) {
              reg_fence(m_hi[j][hh]);
              reg_fence(m_lo[j][hh]);
            }
          }
        }

        // y rounded once to bf16; columns past P not written
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = t_lo + 8 * r;
          __nv_bfloat16* out = y + ((row0 + t) * heads + h) * p_dim;
#pragma unroll
          for (int pb = 0; pb < PB; ++pb) {
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const int p = pb * 64 + 8 * i + c0;
              if (p < p_dim) {
                *reinterpret_cast<__nv_bfloat162*>(out + p) =
                    __floats2bfloat162_rn(yacc[pb][4 * i + 2 * r],
                                          yacc[pb][4 * i + 2 * r + 1]);
              }
            }
          }
        }
      }

      // S <- exp(L_Q) S + (w x)^T B, per 64-row box of P and 64-column box
      // of N; (w x)^T as three bf16 terms in registers (rows p, tokens s)
#pragma unroll
      for (int pm = 0; pm < PB; ++pm) {
        uint32_t aw[3][kSteps][4];
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
#pragma unroll
          for (int hh = 0; hh < 4; ++hh) {
            const int p = pm * 64 + r0 + 8 * (hh & 1);
            const int s = 16 * j + 8 * (hh >> 1) + c0;
            const float v0 = sw[s] * bf_at(tx_gen + sw128_offset(s, p, kBoxQ));
            const float v1 =
                sw[s + 1] * bf_at(tx_gen + sw128_offset(s + 1, p, kBoxQ));
            split3(v0, v1, aw[0][j][hh], aw[1][j][hh], aw[2][j][hh]);
          }
        }
#pragma unroll
        for (int nb = 0; nb < NB; ++nb) {
          float acc[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) {
            const int p = pm * 64 + r0 + 8 * ((i >> 1) & 1);
            const int n = nb * 64 + 8 * (i >> 2) + c0 + (i & 1);
            const uint32_t o = sw128_offset(p, n, kBoxP);
            acc[i] = e_last * ((bf_at(s_gen + o) + bf_at(s_gen + kTileS + o)) +
                               bf_at(s_gen + 2 * kTileS + o));
            reg_fence(acc[i]);
          }
          hopper::wgmma_fence();
#pragma unroll
          for (int j = 0; j < kSteps; ++j) {
            const uint64_t db =
                desc_sw128(tb + nb * kBoxQ + 16 * j * 128, kBoxQ);
            hopper::wgmma_rs(acc, aw[0][j], db);
            hopper::wgmma_rs(acc, aw[1][j], db);
            hopper::wgmma_rs(acc, aw[2][j], db);
          }
          hopper::wgmma_commit_wait();
#pragma unroll
          for (int i = 0; i < 32; ++i) reg_fence(acc[i]);
#pragma unroll
          for (int i = 0; i < 32; i += 2) {
            const int p = pm * 64 + r0 + 8 * ((i >> 1) & 1);
            const int n = nb * 64 + 8 * (i >> 2) + c0;
            const uint32_t o = sw128_offset(p, n, kBoxP);
            uint32_t hi, lo, lo2;
            split3(acc[i], acc[i + 1], hi, lo, lo2);
            *reinterpret_cast<uint32_t*>(s_gen + o) = hi;
            *reinterpret_cast<uint32_t*>(s_gen + kTileS + o) = lo;
            *reinterpret_cast<uint32_t*>(s_gen + 2 * kTileS + o) = lo2;
          }
        }
#pragma unroll
        for (int j = 0; j < kSteps; ++j) {
#pragma unroll
          for (int hh = 0; hh < 4; ++hh) {
            reg_fence(aw[0][j][hh]);
            reg_fence(aw[1][j][hh]);
            reg_fence(aw[2][j][hh]);
          }
        }
      }
    }
    hopper::fence_proxy_async();       // state writes -> next chunk's wgmma
    __syncthreads();                   // stage st and the state are free
  }

  if (active) {
    float* out = s_fin + (int64_t(bi) * heads + h) * p_dim * n_dim;
    for (int i = wt; i < p_dim * n_dim; i += kWg) {
      const int p = i / n_dim, n = i - p * n_dim;
      const uint32_t o = sw128_offset(p, n, kBoxP);
      out[i] = (bf_at(s_gen + o) + bf_at(s_gen + kTileS + o)) +
               bf_at(s_gen + 2 * kTileS + o);
    }
  }
}

// (hb, stages, bytes) for the tensor-core instance at this shape: two
// chains per block when there are more chains than SMs, two stages when
// they fit; -> 0 or cudaErrorInvalidValue when nothing fits
int tc_plan(int64_t batch, int64_t heads, int64_t p, int64_t n, int64_t q,
            int* hb, int* stages, size_t* bytes) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return static_cast<int>(cudaGetLastError());
  }
  const int64_t pb = (p + 63) / 64, nb = (n + 63) / 64;
  const int pref = (batch * heads > sms && heads > 1) ? 2 : 1;
  const int tries[4][2] = {{pref, 2}, {pref, 1}, {1, 2}, {1, 1}};
  for (const auto& t : tries) {
    const size_t need = tc_smem(q, pb, nb, t[0], t[1]);
    if (need <= static_cast<size_t>(kMaxSmem)) {
      *hb = t[0];
      *stages = t[1];
      *bytes = need;
      return 0;
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int Q, int PB, int NB>
int launch_tc(const void* x, const float* dt, const float* a, const void* b,
              const void* c, void* y, float* s_fin, int64_t batch, int64_t s,
              int64_t heads, int64_t p, int64_t n, int hb, int stages,
              size_t bytes, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_tc<Q, PB, NB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t blocks = batch * ((heads + hb - 1) / hb);
  ssd_tc<Q, PB, NB><<<static_cast<unsigned>(blocks), hb * kWg, bytes,
                      stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, a,
      static_cast<const __nv_bfloat16*>(b),
      static_cast<const __nv_bfloat16*>(c), static_cast<__nv_bfloat16*>(y),
      s_fin, static_cast<int>(s), static_cast<int>(heads),
      static_cast<int>(p), static_cast<int>(n), hb, stages);
  return static_cast<int>(cudaGetLastError());
}

// x, y (batch, s, heads, p) and b, c (batch, s, n) in `dtype` (0 = f32,
// 1 = bf16); dt (batch, s, heads), a (heads,) and s_fin (batch, heads, p,
// n) f32; all contiguous; s a multiple of the chunk q.
int simt_entry(const void* x, const float* dt, const float* a, const void* b,
               const void* c, void* y, float* s_fin, int64_t batch,
               int64_t s, int64_t heads, int64_t p, int64_t n, int64_t q,
               int64_t dtype, cudaStream_t st) {
  if (batch < 1 || s < 1 || heads < 1 || p < 1 || n < 1 || q < 1 ||
      s % q != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (dtype == 0) {
    return launch_simt<float>(x, dt, a, b, c, y, s_fin, batch, s, heads, p,
                              n, q, st);
  }
  if (dtype == 1) {
    return launch_simt<__nv_bfloat16>(x, dt, a, b, c, y, s_fin, batch, s,
                                      heads, p, n, q, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// As simt_entry for bf16 x, b, c, y with q 64 or 128 and p, n multiples of
// 16 up to 128, x, b and c 16-byte aligned.
int tc_entry(const void* x, const float* dt, const float* a, const void* b,
             const void* c, void* y, float* s_fin, int64_t batch, int64_t s,
             int64_t heads, int64_t p, int64_t n, int64_t q, int64_t dtype,
             cudaStream_t st) {
  if (dtype != 1 || batch < 1 || s < 1 || heads < 1 ||
      (q != 64 && q != 128) || s % q != 0 || p < 16 || p > 128 ||
      p % 16 != 0 || n < 16 || n > 128 || n % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(b) |
       reinterpret_cast<uintptr_t>(c)) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int hb = 0, stages = 0;
  size_t bytes = 0;
  const int err = tc_plan(batch, heads, p, n, q, &hb, &stages, &bytes);
  if (err != 0) return err;
  const int key = (q == 128 ? 4 : 0) + (p > 64 ? 2 : 0) + (n > 64 ? 1 : 0);
  switch (key) {
#define SSD_TC_CASE(k, Q, PB, NB)                                             \
  case k:                                                                    \
    return launch_tc<Q, PB, NB>(x, dt, a, b, c, y, s_fin, batch, s, heads, p, \
                                n, hb, stages, bytes, st);
    SSD_TC_CASE(0, 64, 1, 1) SSD_TC_CASE(1, 64, 1, 2)
    SSD_TC_CASE(2, 64, 2, 1) SSD_TC_CASE(3, 64, 2, 2)
    SSD_TC_CASE(4, 128, 1, 1) SSD_TC_CASE(5, 128, 1, 2)
    SSD_TC_CASE(6, 128, 2, 1) SSD_TC_CASE(7, 128, 2, 2)
#undef SSD_TC_CASE
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// One launch, its arguments packed as sixteen int64 (ctypes turns one bytes
// object into a pointer faster than it converts sixteen typed arguments):
// {instance (0: ssd_fwd, 1: ssd_tc), dtype, x, dt, a, b, c, y, s_fin,
// batch, s, heads, p, n, q, stream}, as simt_entry and tc_entry take them.
// Returns cudaGetLastError() as an int (cudaErrorInvalidValue for bad
// arguments or a shape whose tiles exceed the card's shared memory).
int mamba2_ssd_launch(const int64_t* v) {
  const auto entry = v[0] == 1 ? tc_entry : v[0] == 0 ? simt_entry : nullptr;
  if (entry == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return entry(reinterpret_cast<const void*>(v[2]),
               reinterpret_cast<const float*>(v[3]),
               reinterpret_cast<const float*>(v[4]),
               reinterpret_cast<const void*>(v[5]),
               reinterpret_cast<const void*>(v[6]),
               reinterpret_cast<void*>(v[7]), reinterpret_cast<float*>(v[8]),
               v[9], v[10], v[11], v[12], v[13], v[14], v[1],
               reinterpret_cast<cudaStream_t>(v[15]));
}

const char* mamba2_ssd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
