// Row-batched "reduce a row, form its scale, stream the row" kernels for
// Hopper (sm_90a), shared by dp_clip_noise.cu (sum of squares -> clip and
// noise) and quantize_decompress.cu (max |x| -> QSGD round trip).
//
// An operation `Op` supplies the reduction (`kInit`, `acc`, `combine`),
// the row's scale from its reduction (`scale`, which also yields the
// per-row value the wrapper returns) and the element-wise output (`elem`).
// Both reductions ignore an element of value 0, which pads partial vectors.
//
// Three instances, picked by the wrapper from the row length alone
// (kernels/row_reduce.py: variant):
//   row_cta      n <= 4,096: one CTA per row, one launch. The row (and the
//                second operand) goes into registers once, 16 elements a
//                thread at t + 256 k; the CTA reduces, forms the scale and
//                writes y. 4-byte loads: rows start at any 4-byte offset.
//   row_cluster  4,096 < n <= 262,144: one thread-block cluster per row, of
//                2-16 CTAs, one launch. Each CTA copies its slice of x into
//                shared memory (16-byte cp.async where x is 16-byte aligned,
//                4-byte loads for a misaligned head and tail), reduces it,
//                and leaves its partial in shared memory; after a cluster
//                barrier every CTA reads all partials through distributed
//                shared memory in rank order, so all derive the same scale
//                bit for bit; each then writes y from its on-chip copy,
//                streaming the second operand: x is read from HBM once.
//   row_stream   n > 262,144: the row does not fit on chip, so two passes
//                over a grid of up to 4 blocks a SM, each block with as
//                many 8,192-element chunks as the others (b, b + G, ...).
//                Pass 1 writes one partial per chunk; pass 2 walks the
//                same chunks backward (the grid starts where pass 1 ended),
//                reduces a row's partials in one fixed order and streams y.
//
// The reduction order is fixed for every instance, so a call is
// deterministic: per-thread accumulators over a strided walk, a warp
// shuffle tree, then the warps (a tree; row_stream's pass 1: in order),
// then the partials (row_cluster: in rank order; row_stream: a block's
// strided walk and tree). tests/test_torch_kernels.py emulates the
// row_cta / row_cluster order.
//
// Vector paths: 16-byte loads and stores where every operand of a slice
// has the same phase (address / 4 mod 4); otherwise 4-byte accesses.
//
// The build hashes this header with every kernel source (kernels/_build.py),
// so an edit here rebuilds the kernels that include it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace rowred {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCtaPer = 16;               // row_cta: elements a thread holds
constexpr int kSliceMax = 16384;          // row_cluster: elements a CTA holds
// row_cluster's shared memory: a slice of up to 16,384 floats shifted by
// its phase (< 4), 64 KiB + 16 B: three CTAs share an SM, so one CTA's
// copy-in overlaps another's write-out
constexpr int kClusterSmem = (kSliceMax + 4) * 4;
constexpr int kStreamBlocksPerSm = 4;
// 16-byte loads in flight a thread, chosen by timing 2-16 on an H100:
constexpr int kClusterBatch = 8;          // row_cluster's write-out
constexpr int kStreamBatch = 4;           // row_stream's write-out (pass 2)
constexpr int kReduceBatch = 8;           // row_stream's pass 1
constexpr int kGroup = 32;                // pass 1: chunks between barriers

enum Variant : int64_t { kRowCta = 0, kRowCluster = 1, kRowStream = 2 };

// The C entry's one argument, as the wrapper packs it (struct "<5qd8q").
struct Args {
  int64_t variant;
  const float* x;         // (rows, n) contiguous
  const float* z;         // second operand, rows of stride z_stride, or null
  int64_t z_stride;
  const float* sigma;     // (rows,) factor of z, or null
  double param;           // clip norm / f32(1 / levels)
  float* y;               // (rows, n)
  float* aux;             // (rows,): the norm / the scale
  float* partial;         // row_stream: (rows, chunks a row) scratch
  int64_t rows, n;
  int64_t g0, g1;         // row_cluster: CTAs a cluster, elements a CTA;
                          // row_stream: elements a chunk, chunks a row
  void* stream;
};
static_assert(sizeof(Args) == 14 * 8, "Args must match the packed struct");

// What the kernels take (by value).
struct Rows {
  const float* x;
  const float* z;
  int64_t z_stride;
  const float* sigma;
  float param;
  float* y;
  float* aux;
  float* partial;
  int64_t rows, n, g0, g1;
};

// -- reductions -------------------------------------------------------------

template <class Op>
__device__ __forceinline__ float warp_reduce(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = Op::combine(v, __shfl_down_sync(0xffffffffu, v, off));
  }
  return v;
}

// The block's reduction in a fixed order, valid in thread 0: each warp's
// tree, then warp 0's tree over the 8 warp values (lanes 8-31 at kInit).
// Callers that reduce again put a __syncthreads() in between.
template <class Op>
__device__ __forceinline__ float block_reduce(float v) {
  __shared__ float warp_part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_reduce<Op>(v);
  if (lane == 0) warp_part[warp] = v;
  __syncthreads();
  v = (threadIdx.x < kWarps) ? warp_part[threadIdx.x] : Op::kInit;
  if (warp == 0) v = warp_reduce<Op>(v);
  return v;
}

// -- alignment --------------------------------------------------------------

// a float pointer's phase: its 4-byte word within a 16-byte line
__device__ __forceinline__ int phase(const void* p) {
  return static_cast<int>((reinterpret_cast<uintptr_t>(p) >> 2) & 3);
}

// The positions [ph, ph + len) of a slice, counted from the 16-byte line
// it starts in: whole float4s q in [q0, q1), and scalars in
// [ph, head_end) and [tail_start, end).
struct Span {
  int64_t ph, end, q0, q1, head_end, tail_start;
};

__device__ __forceinline__ Span span_of(int ph, int64_t len) {
  Span s;
  s.ph = ph;
  s.end = ph + len;
  s.q0 = ph ? 1 : 0;
  s.q1 = s.end / 4 > s.q0 ? s.end / 4 : s.q0;
  s.head_end = 4 * s.q0 < s.end ? 4 * s.q0 : s.end;
  s.tail_start = 4 * s.q1 > s.head_end ? 4 * s.q1 : s.head_end;
  return s;
}

// z's 16 bytes at p; with kHint evict-first (nothing reads z again)
template <bool kHint>
__device__ __forceinline__ float4 ld_z4(const float* p) {
  if (kHint) return __ldcs(reinterpret_cast<const float4*>(p));
  return *reinterpret_cast<const float4*>(p);
}

// -- the write-out ----------------------------------------------------------

// y[j] = Op::elem(x[j], z[j]) over a slice of `len` elements, x's element j
// at xa[j + px] (xa 16-byte aligned: the slice's copy in shared memory, or
// x in global memory less its phase). y and z are global.
template <class Op, bool kZ, bool kXShared>
__device__ __forceinline__ void write_slice(const float* xa, int px,
                                            const float* __restrict__ z,
                                            float* __restrict__ y,
                                            int64_t len, float sg,
                                            float scale) {
  const int py = phase(y);
  const int pz = kZ ? phase(z) : py;
  float* __restrict__ ya = y - py;
  const float* __restrict__ za = kZ ? z - pz : nullptr;
  const Span s = span_of(py, len);
  const int t = threadIdx.x;
  // row_cluster streams z and y evict-first (nothing reads them again);
  // row_stream measured faster with plain accesses
  constexpr int kBatch = kXShared ? kClusterBatch : kStreamBatch;
  constexpr bool kHint = kXShared;
  auto one = [&](int64_t p) {
    const int64_t j = p - py;
    ya[p] = Op::template elem<kZ>(xa[j + px], kZ ? za[j + pz] : 0.0f, sg,
                                  scale);
  };
  for (int64_t p = s.ph + t; p < s.head_end; p += kThreads) one(p);
  for (int64_t p = s.tail_start + t; p < s.end; p += kThreads) one(p);
  if (px != py || pz != py) {
    for (int64_t q = s.q0 + t; q < s.q1; q += kThreads) {
#pragma unroll
      for (int i = 0; i < 4; ++i) one(4 * q + i);
    }
    return;
  }
  for (int64_t q = s.q0 + t; q < s.q1; q += kBatch * kThreads) {
    float4 xv[kBatch], zv[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int64_t qq = q + k * kThreads;
      zv[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (qq < s.q1) {
        xv[k] = *reinterpret_cast<const float4*>(xa + 4 * qq);
        if (kZ) zv[k] = ld_z4<kHint>(za + 4 * qq);
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int64_t qq = q + k * kThreads;
      if (qq < s.q1) {
        float4 o;
        o.x = Op::template elem<kZ>(xv[k].x, zv[k].x, sg, scale);
        o.y = Op::template elem<kZ>(xv[k].y, zv[k].y, sg, scale);
        o.z = Op::template elem<kZ>(xv[k].z, zv[k].z, sg, scale);
        o.w = Op::template elem<kZ>(xv[k].w, zv[k].w, sg, scale);
        if (kHint) {
          __stcs(reinterpret_cast<float4*>(ya + 4 * qq), o);
        } else {
          *reinterpret_cast<float4*>(ya + 4 * qq) = o;
        }
      }
    }
  }
}

// -- row_cta -----------------------------------------------------------------

template <class Op, bool kZ>
__global__ void __launch_bounds__(kThreads) row_cta(Rows a) {
  __shared__ float s_scale;
  const int64_t row = blockIdx.x;
  const int n = static_cast<int>(a.n);
  const float* __restrict__ x = a.x + row * a.n;
  const float* __restrict__ z = kZ ? a.z + row * a.z_stride : nullptr;
  const int t = threadIdx.x;
  const float sg = (kZ && a.sigma) ? __ldg(a.sigma + row) : 0.0f;
  float xv[kCtaPer], zv[kCtaPer];
#pragma unroll
  for (int k = 0; k < kCtaPer; ++k) {
    const int i = t + k * kThreads;
    xv[k] = i < n ? __ldg(x + i) : 0.0f;
    zv[k] = (kZ && i < n) ? __ldg(z + i) : 0.0f;
  }
  float acc = Op::kInit;
#pragma unroll
  for (int k = 0; k < kCtaPer; ++k) acc = Op::acc(acc, xv[k]);
  acc = block_reduce<Op>(acc);
  if (t == 0) {
    float aux;
    s_scale = Op::scale(acc, a.param, &aux);
    a.aux[row] = aux;
  }
  __syncthreads();
  const float scale = s_scale;
  float* __restrict__ y = a.y + row * a.n;
#pragma unroll
  for (int k = 0; k < kCtaPer; ++k) {
    const int i = t + k * kThreads;
    if (i < n) y[i] = Op::template elem<kZ>(xv[k], zv[k], sg, scale);
  }
}

// -- row_cluster -------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory");  // release
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");  // acquire
}

// a float in CTA `rank`'s shared memory, at the address of `local` in ours
__device__ __forceinline__ float ld_cluster(const float* local,
                                            uint32_t rank) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(smem_addr(local)), "r"(rank));
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n"
               : "=f"(v) : "r"(remote) : "memory");
  return v;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(smem)), "l"(gmem) : "memory");
}

// grid: rows x g0 CTAs in clusters of g0; dynamic shared memory
// (g1 + 4) floats
template <class Op, bool kZ>
__global__ void __launch_bounds__(kThreads, 3) row_cluster(Rows a) {
  extern __shared__ __align__(16) float s_row[];
  __shared__ float s_part, s_scale;
  const int64_t ctas = a.g0, per = a.g1;
  const uint32_t rank = cluster_rank();
  const int64_t row = blockIdx.x / ctas;
  const int64_t b = rank * per;
  const int64_t rest = a.n - b;
  const int64_t len = rest < per ? (rest > 0 ? rest : 0) : per;
  const float* x = a.x + row * a.n + b;
  const int t = threadIdx.x;
  const float sg = (kZ && a.sigma) ? __ldg(a.sigma + row) : 0.0f;
  // copy-in: position p of the slice's 16-byte lines to s_row[p]
  const int px = phase(x);
  const float* xa = x - px;
  const Span s = span_of(px, len);
  for (int64_t q = s.q0 + t; q < s.q1; q += kThreads) {
    cp_async16(s_row + 4 * q, xa + 4 * q);
  }
  for (int64_t p = s.ph + t; p < s.head_end; p += kThreads) s_row[p] = xa[p];
  for (int64_t p = s.tail_start + t; p < s.end; p += kThreads) {
    s_row[p] = xa[p];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  float acc = Op::kInit;
  for (int64_t j = t; j < len; j += kThreads) {
    acc = Op::acc(acc, s_row[j + px]);
  }
  acc = block_reduce<Op>(acc);
  if (t == 0) s_part = acc;
  cluster_arrive();                  // every partial is written ...
  cluster_wait();                    // ... and visible cluster-wide
  if (t == 0) {
    float total = Op::kInit;
    for (int64_t r = 0; r < ctas; ++r) {
      total = Op::combine(total,
                          ld_cluster(&s_part, static_cast<uint32_t>(r)));
    }
    float aux;
    s_scale = Op::scale(total, a.param, &aux);
    if (rank == 0) a.aux[row] = aux;
  }
  cluster_arrive();                  // this CTA reads no more partials
  __syncthreads();
  write_slice<Op, kZ, true>(s_row, px,
                            kZ ? a.z + row * a.z_stride + b : nullptr,
                            a.y + row * a.n + b, len, sg, s_scale);
  cluster_wait();                    // no CTA leaves while its partial may
                                     // still be read
}

// -- row_stream --------------------------------------------------------------

// x's chunk [0, len) reduced by this thread: scalars, then float4s
template <class Op>
__device__ __forceinline__ float reduce_global(const float* x, int64_t len) {
  const int px = phase(x);
  const float* __restrict__ xa = x - px;
  const Span s = span_of(px, len);
  const int t = threadIdx.x;
  float acc = Op::kInit;
  for (int64_t p = s.ph + t; p < s.head_end; p += kThreads) {
    acc = Op::acc(acc, xa[p]);
  }
  for (int64_t p = s.tail_start + t; p < s.end; p += kThreads) {
    acc = Op::acc(acc, xa[p]);
  }
  for (int64_t q = s.q0 + t; q < s.q1; q += kReduceBatch * kThreads) {
    float4 v[kReduceBatch];
#pragma unroll
    for (int k = 0; k < kReduceBatch; ++k) {
      const int64_t qq = q + k * kThreads;
      v[k] = qq < s.q1 ? __ldg(reinterpret_cast<const float4*>(xa + 4 * qq))
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
#pragma unroll
    for (int k = 0; k < kReduceBatch; ++k) {
      acc = Op::acc(acc, v[k].x);
      acc = Op::acc(acc, v[k].y);
      acc = Op::acc(acc, v[k].z);
      acc = Op::acc(acc, v[k].w);
    }
  }
  return acc;
}

// Pass 1: one partial per chunk; block b takes chunks b, b + G, b + 2 G,
// ... (G blocks), so the grid reads neighbouring chunks together. A warp's
// share of a chunk is reduced by its shuffle tree and parked in shared
// memory, so warps stream on without a block barrier; every kGroup chunks
// the 8 warp values of each chunk are combined in warp order into its
// partial.
template <class Op>
__global__ void __launch_bounds__(kThreads, kStreamBlocksPerSm)
    stream_partials(Rows a) {
  __shared__ float warp_part[kGroup][kWarps];
  const int64_t total = a.rows * a.g1, stride = gridDim.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int64_t g = blockIdx.x; g < total; g += kGroup * stride) {
    for (int k = 0; k < kGroup && g + k * stride < total; ++k) {
      const int64_t c = g + k * stride;
      const int64_t row = c / a.g1, b = (c % a.g1) * a.g0;
      const int64_t len = a.n - b < a.g0 ? a.n - b : a.g0;
      const float v =
          warp_reduce<Op>(reduce_global<Op>(a.x + row * a.n + b, len));
      if (lane == 0) warp_part[k][warp] = v;
    }
    __syncthreads();
    const int64_t c = g + threadIdx.x * stride;
    if (threadIdx.x < kGroup && c < total) {
      float v = Op::kInit;
      for (int w = 0; w < kWarps; ++w) {
        v = Op::combine(v, warp_part[threadIdx.x][w]);
      }
      a.partial[c] = v;
    }
    __syncthreads();                 // warp_part is written again
  }
}

// Pass 2: the same chunks as pass 1, in reverse, so the grid starts on the
// chunks pass 1 read last (still in L2). A chunk's row scale comes from
// the row's partials in one fixed order: every block derives the same.
template <class Op, bool kZ>
__global__ void __launch_bounds__(kThreads, kStreamBlocksPerSm)
    stream_apply(Rows a) {
  __shared__ float s_scale;
  const int64_t total = a.rows * a.g1, stride = gridDim.x;
  int64_t cur = -1;
  float scale = 0.0f, sg = 0.0f, aux = 0.0f;
  if (blockIdx.x >= total) return;
  for (int64_t c = blockIdx.x + (total - 1 - blockIdx.x) / stride * stride;
       c >= 0; c -= stride) {
    const int64_t row = c / a.g1, cb = c % a.g1, b = cb * a.g0;
    if (row != cur) {
      const float* part = a.partial + row * a.g1;
      float acc = Op::kInit;
      for (int64_t i = threadIdx.x; i < a.g1; i += kThreads) {
        acc = Op::combine(acc, part[i]);
      }
      acc = block_reduce<Op>(acc);
      if (threadIdx.x == 0) s_scale = Op::scale(acc, a.param, &aux);
      __syncthreads();
      scale = s_scale;
      sg = (kZ && a.sigma) ? __ldg(a.sigma + row) : 0.0f;
      cur = row;
    }
    if (cb == 0 && threadIdx.x == 0) a.aux[row] = aux;
    const int64_t len = a.n - b < a.g0 ? a.n - b : a.g0;
    const float* x = a.x + row * a.n + b;
    const int px = phase(x);
    write_slice<Op, kZ, false>(x - px, px,
                               kZ ? a.z + row * a.z_stride + b : nullptr,
                               a.y + row * a.n + b, len, sg, scale);
  }
}

// -- the launch --------------------------------------------------------------

inline int sm_count() {
  static int cached[64];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 64 && cached[dev]) return cached[dev];
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cached[dev] = sms;
  return sms;
}

// Launches the instance `a.variant` names on a.stream; returns the CUDA
// error as an int (0: launched). A refused launch, a cluster the card
// cannot place among them, is returned, never rerouted.
template <class Op, bool kZ>
int launch(const Args& a) {
  const Rows r = {a.x, a.z, a.z_stride, a.sigma, static_cast<float>(a.param),
                  a.y, a.aux, a.partial, a.rows, a.n, a.g0, a.g1};
  cudaStream_t st = static_cast<cudaStream_t>(a.stream);
  if (a.variant == kRowCta) {
    row_cta<Op, kZ><<<static_cast<unsigned>(a.rows), kThreads, 0, st>>>(r);
    return static_cast<int>(cudaGetLastError());
  }
  if (a.variant == kRowCluster) {
    auto kernel = row_cluster<Op, kZ>;
    static uint64_t configured;      // a bit per device
    int dev = 0;
    cudaGetDevice(&dev);
    const uint64_t bit = 1ull << (dev & 63);
    if (!(configured & bit)) {
      cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kClusterSmem);
      if (e == cudaSuccess) {
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      }
      if (e != cudaSuccess) return static_cast<int>(e);
      configured |= bit;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(a.rows * a.g0));
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = static_cast<size_t>(a.g1 + 4) * sizeof(float);
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = static_cast<unsigned>(a.g0);
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, r);
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(e != cudaSuccess ? e : last);
  }
  if (a.variant == kRowStream) {
    // as many chunks a block as fill 4 blocks a SM, and no block with
    // fewer than the others but the last: no block idles while its
    // neighbours stream their extra chunk
    const int64_t chunks = a.rows * a.g1;
    const int64_t fill = static_cast<int64_t>(sm_count()) * kStreamBlocksPerSm;
    const int64_t each = (chunks + fill - 1) / fill;
    const unsigned grid = static_cast<unsigned>((chunks + each - 1) / each);
    stream_partials<Op><<<grid, kThreads, 0, st>>>(r);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    stream_apply<Op, kZ><<<grid, kThreads, 0, st>>>(r);
    return static_cast<int>(cudaGetLastError());
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the packed argument, copied out of the caller's buffer (any alignment)
inline Args unpack(const void* packed) {
  Args a;
  memcpy(&a, packed, sizeof a);
  return a;
}

}  // namespace rowred
