"""Rates of the FMA pipe on an NVIDIA GPU, as the design of the port's
``counter_rng`` kernel reads them: 32 x 32 -> 64-bit integer multiplies
(``IMAD.WIDE.U32``, Philox's), f32 multiply-add pairs rounded apart
(``FMUL`` + ``FADD``, the normal transform's), 32-bit multiplies
(``IMAD``), and the wide multiply mixed with 1 or 3 f32 pairs in one loop:
where the two share the pipe, the mixed loop takes the sum of their times
alone.

    python3 benchmarks/fma_pipe_probe_torch.py

Builds a small CUDA program with nvcc in a temporary directory, runs it on
the current card (8 independent chains a thread, 8 CTAs of 256 threads a
SM) and prints the card, then each kernel's ms and instructions a clock a
SM at the card's SM clock.
"""
from __future__ import annotations

import subprocess
import sys
import tempfile
from pathlib import Path

SOURCE = r"""
#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>
#define CH 8
__global__ void wide(uint32_t* out, int iters) {
  uint32_t a[CH];
  for (int j = 0; j < CH; ++j) a[j] = threadIdx.x * 7 + j + blockIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      a[j] = __umulhi(a[j], 0xD2511F53u) ^ (a[j] * 0xD2511F53u) ^ i;
    }
  }
  uint32_t s = 0;
  for (int j = 0; j < CH; ++j) s ^= a[j];
  if (s == 0x12345u) out[0] = s;
}
__global__ void lo(uint32_t* out, int iters) {
  uint32_t a[CH];
  for (int j = 0; j < CH; ++j) a[j] = threadIdx.x * 7 + j + blockIdx.x;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CH; ++j) a[j] = (a[j] * 0xD2511F53u) ^ i;
  }
  uint32_t s = 0;
  for (int j = 0; j < CH; ++j) s ^= a[j];
  if (s == 0x12345u) out[0] = s;
}
__global__ void fp(uint32_t* out, int iters) {
  float x[CH];
  for (int j = 0; j < CH; ++j) x[j] = threadIdx.x * 1e-3f + j;
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      x[j] = __fadd_rn(__fmul_rn(x[j], 0.999f), 1e-3f);
    }
  }
  float s = 0;
  for (int j = 0; j < CH; ++j) s += x[j];
  if (s == 0.12345f) out[0] = 1;
}
template <int R>
__global__ void mix(uint32_t* out, int iters) {
  uint32_t a[CH];
  float x[CH];
  for (int j = 0; j < CH; ++j) {
    a[j] = threadIdx.x * 7 + j + blockIdx.x;
    x[j] = threadIdx.x * 1e-3f + j;
  }
  for (int i = 0; i < iters; ++i) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      a[j] = __umulhi(a[j], 0xD2511F53u) ^ (a[j] * 0xD2511F53u) ^ i;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        x[j] = __fadd_rn(__fmul_rn(x[j], 0.999f), 1e-3f);
      }
    }
  }
  uint32_t s = 0;
  float t = 0;
  for (int j = 0; j < CH; ++j) { s ^= a[j]; t += x[j]; }
  if (s == 0x12345u || t == 0.5f) out[0] = s;
}
template <typename K> float time_ms(K k, uint32_t* out, int blocks, int iters) {
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  k<<<blocks, 256>>>(out, iters);
  cudaEventRecord(a);
  k<<<blocks, 256>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  return ms;
}
int main() {
  int sms, khz;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  uint32_t* out;
  cudaMalloc(&out, 4);
  const int iters = 4096, blocks = sms * 8;
  const double per = double(blocks) * 256 * iters * CH;    // chain steps
  struct { const char* name; float ms; double instr; } rows[] = {
      {"IMAD.WIDE (+ LOP3)", time_ms(wide, out, blocks, iters), 1},
      {"IMAD (+ LOP3)", time_ms(lo, out, blocks, iters), 1},
      {"FMUL + FADD", time_ms(fp, out, blocks, iters), 2},
      {"IMAD.WIDE + 1 f32 pair", time_ms(mix<1>, out, blocks, iters), 1},
      {"IMAD.WIDE + 3 f32 pairs", time_ms(mix<3>, out, blocks, iters), 1}};
  for (auto& r : rows) {
    printf("%-24s %8.4f ms  %6.1f a clock a SM (of the named multiply or "
           "f32 op; %d SMs at %d MHz)\n", r.name, r.ms,
           per * r.instr / (r.ms * 1e-3 * khz * 1e3) / sms, sms, khz / 1000);
  }
  printf("sum of IMAD.WIDE and 1 / 3 f32 pairs alone: %.4f / %.4f ms\n",
         rows[0].ms + rows[2].ms / 2, rows[0].ms + 3 * rows[2].ms / 2);
  return 0;
}
"""


def main() -> int:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        print("fma_pipe_probe: no CUDA toolkit", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = Path(tmp) / "probe.cu", Path(tmp) / "probe"
        src.write_text(SOURCE)
        subprocess.run([str(Path(CUDA_HOME) / "bin" / "nvcc"), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-O3", "-o",
                        str(exe), str(src)], check=True)
        return subprocess.run([str(exe)], check=True).returncode


if __name__ == "__main__":
    sys.exit(main())
