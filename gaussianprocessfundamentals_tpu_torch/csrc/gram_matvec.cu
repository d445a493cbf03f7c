// Fused Gram-matrix product  out = K(x1, x2) @ V  for sm_90a, with the
// K tiles built in registers and never written to device memory.
//
// Replaces the TPU kernel `fused_gram_matvec_cross`
// (gaussianprocessfundamentals_tpu/ops/pallas_gram.py:252, tile body
// `_mv_kernel` :222). What it computes is the same; how is not: the TPU
// version walked a sequential grid of 512x512 VMEM tiles and accumulated
// into the output block across grid steps. Here blocks run in parallel, so
// one block owns a strip of output rows and a tile of V's columns and loops
// over all of x2 itself: no atomics, no cross-block reduction, and the
// result does not depend on scheduling.
//
//   K(a, b) = var * exp(-d2 / (2 l^2))                        (SE, any d <= 8)
//   K(a, b) = var * (1 + f) * exp(-f),         f = sqrt(3) |a - b| / l   (Matern-3/2, d = 1)
//   K(a, b) = var * (1 + f + f^2/3) * exp(-f), f = sqrt(5) |a - b| / l   (Matern-5/2, d = 1)
//
// Distances are DIRECT per-dimension differences at every d. The TPU used
// the norm expansion |a|^2 - 2ab + |b|^2 at d > 1 only because it had a
// matrix unit; the expansion loses digits that CG needs, and at the small d
// of GP regression the direct form costs a few FMAs per pair.
//
// What bounds it on an H100:
//   * r = 1 (the y-solve): the expf rate. Each (i, j) pair costs one expf
//     (an ex2 on the special-function unit plus range-reduction FMAs) and
//     one FMA; n1*n2 = 1e10 pairs at n = 100k.
//   * r >= 64 (a posterior chunk): f32 FMA throughput, 2*n1*n2*r flops, with
//     one expf per pair per column tile of V on top.
// TF32 tensor cores are not used: they keep about three decimal digits,
// which CG cannot afford. A 3xTF32 or wgmma version is later work.
//
// Design: a block of 128 threads owns TM*128 rows of x1 (thread t owns rows
// t, t+128, ...) and RT columns of V. It loops over x2 in tiles of BN = 128
// rows, staging the x2 tile and the [BN, RT] slab of V in shared memory;
// every thread reads the same x2 row and V row at once (a shared-memory
// broadcast). Each thread builds its TM kernel values for row j in
// registers and does TM*RT FMAs. Sums over one x2 tile go into a per-tile
// partial that is added to the running total afterwards, so each f32 chain
// is at most BN + n2/BN adds long. Ragged edges are masked: x2 and V rows
// past n2 are staged as zero (a zero V row adds exactly nothing), V columns
// past r are zero, and rows past n1 are not stored.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared and no
// --use_fast_math (which would swap expf and division for approximations).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BN = 128;

constexpr int KIND_SE = 0;
constexpr int KIND_MAT32 = 1;
constexpr int KIND_MAT52 = 2;

// a is -1/(2 l^2) for SE and sqrt(3)/l or sqrt(5)/l for Matern.
template <int KIND>
__device__ __forceinline__ float kernel_value(float d2, float dist, float a,
                                              float var) {
  if (KIND == KIND_SE) {
    return var * expf(a * d2);
  } else {
    const float f = a * dist;
    float poly = 1.0f + f;
    if (KIND == KIND_MAT52) poly += f * f * (1.0f / 3.0f);
    return var * poly * expf(-f);
  }
}

template <int KIND, int D, int RT, int TM>
__global__ void __launch_bounds__(THREADS)
gram_matvec_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                   const float* __restrict__ V, float* __restrict__ out,
                   int n1, int n2, int r, float a, float var) {
  __shared__ float xs[BN * D];
  __shared__ float vs[BN * RT];

  const int tid = threadIdx.x;
  const int64_t row0 = (int64_t)blockIdx.x * (THREADS * TM);
  const int c0 = blockIdx.y * RT;

  float xr[TM][D];
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int64_t i = row0 + tid + m * THREADS;
#pragma unroll
    for (int k = 0; k < D; ++k) xr[m][k] = (i < n1) ? x1[i * D + k] : 0.0f;
  }

  float acc[TM][RT];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int c = 0; c < RT; ++c) acc[m][c] = 0.0f;

  for (int j0 = 0; j0 < n2; j0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int e = tid; e < BN * D; e += THREADS) {
      const int j = j0 + e / D;
      xs[e] = (j < n2) ? x2[(int64_t)j0 * D + e] : 0.0f;
    }
    for (int e = tid; e < BN * RT; e += THREADS) {
      const int j = j0 + e / RT;
      const int c = c0 + e % RT;
      vs[e] = (j < n2 && c < r) ? V[(int64_t)j * r + c] : 0.0f;
    }
    __syncthreads();

    float part[TM][RT];
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int c = 0; c < RT; ++c) part[m][c] = 0.0f;

#pragma unroll 2
    for (int jj = 0; jj < BN; ++jj) {
      float kv[TM];
#pragma unroll
      for (int m = 0; m < TM; ++m) {
        float d2 = 0.0f;
        float dist = 0.0f;
#pragma unroll
        for (int k = 0; k < D; ++k) {
          const float diff = xr[m][k] - xs[jj * D + k];
          d2 = fmaf(diff, diff, d2);
          if (D == 1) dist = fabsf(diff);
        }
        kv[m] = kernel_value<KIND>(d2, dist, a, var);
      }
#pragma unroll
      for (int c = 0; c < RT; ++c) {
        const float v = vs[jj * RT + c];
#pragma unroll
        for (int m = 0; m < TM; ++m) part[m][c] = fmaf(kv[m], v, part[m][c]);
      }
    }
#pragma unroll
    for (int m = 0; m < TM; ++m)
#pragma unroll
      for (int c = 0; c < RT; ++c) acc[m][c] += part[m][c];
  }

#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const int64_t i = row0 + tid + m * THREADS;
    if (i >= n1) continue;
#pragma unroll
    for (int c = 0; c < RT; ++c) {
      if (c0 + c < r) out[i * r + c0 + c] = acc[m][c];
    }
  }
}

template <int KIND, int D, int RT, int TM>
cudaError_t launch(const float* x1, const float* x2, const float* V,
                   float* out, int n1, int n2, int r, float a, float var,
                   cudaStream_t stream) {
  const int rows = THREADS * TM;
  dim3 grid((n1 + rows - 1) / rows, (r + RT - 1) / RT);
  gram_matvec_kernel<KIND, D, RT, TM>
      <<<grid, THREADS, 0, stream>>>(x1, x2, V, out, n1, n2, r, a, var);
  return cudaGetLastError();
}

// Column tile of V by r: r = 1 (y-solve), r <= 4, r <= 16 (training
// probes), wider (posterior chunks, tiled by 32 columns).
template <int KIND, int D>
cudaError_t dispatch_rt(const float* x1, const float* x2, const float* V,
                        float* out, int n1, int n2, int r, float a, float var,
                        cudaStream_t stream) {
  if (r == 1) return launch<KIND, D, 1, 2>(x1, x2, V, out, n1, n2, r, a, var, stream);
  if (r <= 4) return launch<KIND, D, 4, 2>(x1, x2, V, out, n1, n2, r, a, var, stream);
  if (r <= 16) return launch<KIND, D, 16, 4>(x1, x2, V, out, n1, n2, r, a, var, stream);
  return launch<KIND, D, 32, 2>(x1, x2, V, out, n1, n2, r, a, var, stream);
}

}  // namespace

// x1 [n1, d], x2 [n2, d], V [n2, r], out [n1, r]: contiguous row-major f32
// on the device. d is the padded width: 1, 4 or 8 for SE (pad columns are
// zero in both x1 and x2), 1 for Matern. Returns a cudaError_t; the launch
// is asynchronous on `stream`.
extern "C" int gpf_gram_matvec(const void* x1, const void* x2, const void* V,
                               void* out, int n1, int n2, int d, int r,
                               int kind, float a, float var, void* stream) {
  const float* px1 = static_cast<const float*>(x1);
  const float* px2 = static_cast<const float*>(x2);
  const float* pV = static_cast<const float*>(V);
  float* po = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n1 < 0 || n2 < 0 || r < 0) return (int)cudaErrorInvalidValue;
  if (n1 == 0 || r == 0) return (int)cudaSuccess;
  if (kind == KIND_SE) {
    if (d == 1) return (int)dispatch_rt<KIND_SE, 1>(px1, px2, pV, po, n1, n2, r, a, var, s);
    if (d == 4) return (int)dispatch_rt<KIND_SE, 4>(px1, px2, pV, po, n1, n2, r, a, var, s);
    if (d == 8) return (int)dispatch_rt<KIND_SE, 8>(px1, px2, pV, po, n1, n2, r, a, var, s);
    return (int)cudaErrorInvalidValue;
  }
  if (d != 1) return (int)cudaErrorInvalidValue;
  if (kind == KIND_MAT32) return (int)dispatch_rt<KIND_MAT32, 1>(px1, px2, pV, po, n1, n2, r, a, var, s);
  if (kind == KIND_MAT52) return (int)dispatch_rt<KIND_MAT52, 1>(px1, px2, pV, po, n1, n2, r, a, var, s);
  return (int)cudaErrorInvalidValue;
}
