"""Throughput of the tensor-core instruction the Gram·V kernels K1 and K3
use, ``mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32``, on one GPU:
the yardstick for their r = 256 times (csrc/gram_mma.cuh).

    python3 tools/mma_sync_rate.py

Each warp runs 20,000 iterations of ``chains`` independent MMAs (1024
multiply-adds each); the grid puts 4 to 32 warps on each SM. Prints one
line per occupancy, in TFLOP/s, beside the card's name and power limit.
Needs nvcc and a card; builds into build/ (ignored by git).
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <int C>
__global__ void loop(float* out, int iters) {
  float d[C][4] = {};
  const uint32_t a[4] = {0x3f800000u, 0x3f800000u, 0x3f000000u, 0x3f000000u};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c) mma(d[c], a, 0x3a800000u, 0x3a000000u);
  float s = 0.f;
  for (int c = 0; c < C; ++c) for (int e = 0; e < 4; ++e) s += d[c][e];
  if (s == 1234.5f) out[0] = s;
}
template <int C>
static double tflops(int threads, int blocks, int iters) {
  float* out;
  cudaMalloc(&out, 4);
  loop<C><<<blocks, threads>>>(out, 10);
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  cudaEventRecord(e0);
  loop<C><<<blocks, threads>>>(out, iters);
  cudaEventRecord(e1);
  cudaEventSynchronize(e1);
  float ms;
  cudaEventElapsedTime(&ms, e0, e1);
  cudaFree(out);
  return 2.0 * 1024 * C * (double)iters * (threads / 32) * blocks / (ms * 1e-3) / 1e12;
}
extern "C" double mma_tflops(int chains, int threads, int blocks, int iters) {
  switch (chains) {
    case 1: return tflops<1>(threads, blocks, iters);
    case 2: return tflops<2>(threads, blocks, iters);
    case 4: return tflops<4>(threads, blocks, iters);
    default: return tflops<8>(threads, blocks, iters);
  }
}
"""


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("mma_sync_rate: no CUDA device")
    root = Path(__file__).resolve().parent.parent
    sys.path.insert(0, str(root))
    from gaussianprocessfundamentals_tpu_torch.ops import cuda_build

    build = root / "build"
    build.mkdir(exist_ok=True)
    src, lib = build / "mma_sync_rate.cu", build / "libmma_sync_rate.so"
    src.write_text(SOURCE)
    subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(lib)).mma_tflops
    fn.argtypes = [ctypes.c_int] * 4
    fn.restype = ctypes.c_double
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    for warps in (4, 8, 16, 32):
        per_block = min(warps, 8)
        rates = [fn(c, 32 * per_block, sms * warps // per_block, 20_000)
                 for c in (1, 2, 4, 8)]
        print(f"[mma.sync tf32] {warps} warps/SM: " + "  ".join(
            f"{c} chains/warp {t:.1f} TFLOP/s" for c, t in zip((1, 2, 4, 8), rates)))


if __name__ == "__main__":
    main()
