// Hopper (sm_90a) warpgroup matrix-multiply helpers shared by the port's
// tensor-core kernels (flash_attention.cu, mamba2_ssd.cu, rwkv6_scan.cu).
//
// Operands in shared memory are tiles of 128-byte rows (64 bf16 columns)
// in the 128-byte swizzle: inside each 1024-byte atom of 8 rows, the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8). Tiles start on a
// 1024-byte boundary. A K-major operand advances 32 bytes per k16 step
// along its rows; an MN-major B operand (`wgmma_rs`, transpose bit set)
// advances 16 rows (2048 bytes) per k16 step. Every product is
// m64n64k16 with f32 accumulators: 32 registers a thread, where thread
// (warp w, lane) holds rows r0 = 16 w + lane / 4 and r0 + 8 and, in each
// 8-column block i, columns 8 i + 2 (lane % 4) + {0, 1}: d[4 i + e] is
// row r0 + 8 (e / 2), column 8 i + 2 (lane % 4) + e % 2. That layout is
// also the register A fragment of the next product: k16 step j, register
// h holds d[8 j + 2 h], d[8 j + 2 h + 1] (row r0 + 8 (h % 2), columns
// 16 j + 8 (h / 2) + 2 (lane % 4) + {0, 1}).
//
// The build hashes this header with every kernel source (kernels/_build.py),
// so an edit here rebuilds the kernels that include it.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma descriptor of a 128-byte-swizzled operand: start address, leading
// byte offset `lbo` (the next 64-column box along N of an MN-major
// operand; unused at N = 64), stride byte offset 1024 (the next 8 rows),
// layout B128; offsets in 16-byte units.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// the byte offset of element (row, col) of a tile of 64-column boxes, each
// `box_bytes` long (rows x 128 bytes), in the 128-byte swizzle
__device__ __forceinline__ uint32_t sw128_offset(int row, int col,
                                                 uint32_t box_bytes) {
  return (col >> 6) * box_bytes + row * 128 +
         ((((col & 63) >> 3) ^ (row & 7)) << 4) + (col & 7) * 2;
}

#define HOPPER_WG_D32                                                       \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define HOPPER_WG_OUT32(d)                                                 \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),  \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),         \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),     \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),     \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),     \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),     \
      "+f"(d[31])

// d (64 x 64, f32) (+)= A (64 x 16, K-major in shared memory) B (16 x 64,
// K-major in shared memory); `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t a,
                                         uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_WG_D32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_WG_OUT32(d)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16 bf16, registers) B (16 x 64, MN-major in
// shared memory)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " HOPPER_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d (64 x 16, f32) += A (64 x 16 bf16, registers) B (16 x 16, K-major in
// shared memory: 16 rows of N, K along each row). d[4 i + e] is row
// r0 + 8 (e / 2), column 8 i + 2 (lane % 4) + e % 2, i in {0, 1}: the first
// two 8-column blocks of the m64n64 layout above.
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, "
      "0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit_wait() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// keeps the compiler from touching registers that wgmma reads or writes
// asynchronously across the fence / wait
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}

// orders this thread's generic-proxy writes to shared memory (plain stores,
// cp.async) before later reads of the same memory by wgmma (async proxy)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

}  // namespace hopper
