// Fused low-rank-cotangent gradient for sm_90a: the two scalars
//
//   g_k  = sum_ij (U W^T)_ij * k(x1_i, x2_j)
//   g_dk = sum_ij (U W^T)_ij * dk(x1_i, x2_j)/dl
//
// of the unit-variance kernel k, in one pass over the (i, j) pairs, with
// neither K nor the cotangent U W^T ever in device memory. The wrapper
// turns them into (dL/dl, dL/dvar) = (var * g_dk, g_k).
//
// Replaces the TPU kernel `fused_lowrank_vjp_cross`
// (gaussianprocessfundamentals_tpu/ops/pallas_gram.py:398, tile body
// `_lrvjp_kernel` :348). What it computes is the same; how is not: the TPU
// version walked a sequential grid and carried one (8, 128) accumulator
// per row block across the column steps. Here every [BM, BN] tile of pairs
// is its own block, all in parallel, and each block writes its two partial
// sums to its own slot of a [grid_i * grid_j, 2] buffer, which the wrapper
// sums on the device in float64. No atomics, so the result does not depend
// on scheduling; no float32 chain is longer than a thread's 64 pairs plus
// the 5 + 8 adds of the block reduction (the TPU lesson,
// pallas_gram.py:371-377, was to keep chains near a tile plus n/BN adds).
//
//   k = exp(-d2 / (2 l^2)),              dk/dl = k * d2 / l^3            (SE, d <= 8)
//   k = (1 + f) e^-f,                     dk/dl = f^2 e^-f / l            (Matern-3/2, d = 1)
//   k = (1 + f + f^2/3) e^-f,             dk/dl = f^2 (1 + f) e^-f / (3l) (Matern-5/2, d = 1)
//   with f = sqrt(3 or 5) |x1 - x2| / l
//
// Distances are direct per-dimension differences at every d, as in K1
// (csrc/gram_matvec.cu), never the TPU's |a|^2 - 2ab + |b|^2 expansion.
//
// What bounds it on an H100: the cotangent tile is a rank-r product,
// 2*n1*n2*r float32 operations (r = 2s + m + 1 = 273 on the main path:
// 5.5e12 at n = 100k), against one expf and a dozen operations per pair in
// the epilogue. So float32 FMA throughput bounds it at wide r, and the
// expf rate at r of a few. Tensor cores are not used (TF32 keeps about
// three decimal digits); a 3xTF32 or wgmma cotangent tile is later work.
//
// Design: 256 threads own a 128 x 128 tile; thread (tx, ty) of a 16 x 16
// grid computes an 8 x 8 register tile of the cotangent, rows
// {4ty..4ty+3, 64+4ty..64+4ty+3} and the same pattern of columns in tx, so
// each k step reads two float4s of U and two of W from shared memory with
// no bank conflicts. U and W are staged through shared memory in chunks of
// BK = 16 of their r columns, transposed; rows past n and columns past r
// are staged as zero, so any r >= 1 works and a zero row contributes
// exactly nothing. Then each thread forms the kernel value and its
// derivative for its 64 pairs from the x tiles in shared memory, sums
// cot*k and cot*dk, and the block reduces the two sums with warp shuffles
// (xor butterfly, a fixed order) and then one thread over the 8 warps.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared and no
// --use_fast_math (which would swap expf and division for approximations).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 16;
constexpr int TM = 8;
constexpr int TN = 8;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256
constexpr int PAD = 4;  // keeps each staged row 16-byte aligned
static_assert(BM == BN, "the wrapper sizes the partial buffer by one tile edge");
static_assert(TM == 8 && TN == 8, "the float4 row/column pattern assumes 8 x 8");

constexpr int KIND_SE = 0;
constexpr int KIND_MAT32 = 1;
constexpr int KIND_MAT52 = 2;

// a is -1/(2 l^2) for SE and sqrt(3)/l or sqrt(5)/l for Matern; b is 1/l^3
// for SE and 1/l for Matern.
template <int KIND>
__device__ __forceinline__ void weights(float d2, float dist, float a, float b,
                                        float& k, float& dk) {
  if (KIND == KIND_SE) {
    k = expf(a * d2);
    dk = k * d2 * b;
  } else {
    const float f = a * dist;
    const float e = expf(-f);
    if (KIND == KIND_MAT32) {
      k = (1.0f + f) * e;
      dk = f * f * e * b;
    } else {
      k = (1.0f + f + f * f * (1.0f / 3.0f)) * e;
      dk = f * f * (1.0f + f) * e * (b * (1.0f / 3.0f));
    }
  }
}

// Row (or column) of the tile that register m of thread t owns.
__device__ __forceinline__ int owned(int t, int m) {
  return (m < 4) ? 4 * t + m : 64 + 4 * t + (m - 4);
}

template <int KIND, int D>
__global__ void __launch_bounds__(THREADS)
lowrank_vjp_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                   const float* __restrict__ U, const float* __restrict__ W,
                   float* __restrict__ partial, int n1, int n2, int r,
                   float a, float b) {
  __shared__ __align__(16) float us[BK][BM + PAD];
  __shared__ __align__(16) float ws[BK][BN + PAD];
  __shared__ float xs1[BM * D];
  __shared__ float xs2[BN * D];
  __shared__ float red[2][THREADS / 32];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t i0 = (int64_t)blockIdx.y * BM;
  const int64_t j0 = (int64_t)blockIdx.x * BN;

  for (int e = tid; e < BM * D; e += THREADS) {
    xs1[e] = (i0 + e / D < n1) ? x1[i0 * D + e] : 0.0f;
  }
  for (int e = tid; e < BN * D; e += THREADS) {
    xs2[e] = (j0 + e / D < n2) ? x2[j0 * D + e] : 0.0f;
  }

  float cot[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) cot[m][n] = 0.0f;

  for (int k0 = 0; k0 < r; k0 += BK) {
    __syncthreads();  // the previous chunk's readers are done
    // consecutive threads read consecutive columns of one row of U (W)
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int row = e / BK;
      const int kk = e % BK;
      const int c = k0 + kk;
      const int64_t i = i0 + row;
      us[kk][row] = (i < n1 && c < r) ? U[i * r + c] : 0.0f;
    }
    for (int e = tid; e < BN * BK; e += THREADS) {
      const int col = e / BK;
      const int kk = e % BK;
      const int c = k0 + kk;
      const int64_t j = j0 + col;
      ws[kk][col] = (j < n2 && c < r) ? W[j * r + c] : 0.0f;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&us[kk][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&us[kk][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&ws[kk][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&ws[kk][64 + 4 * tx]);
      const float av[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int m = 0; m < TM; ++m)
#pragma unroll
        for (int n = 0; n < TN; ++n) cot[m][n] = fmaf(av[m], bv[n], cot[m][n]);
    }
  }

  // epilogue: the kernel value and its derivative for the 64 owned pairs
  float sk = 0.0f;
  float sdk = 0.0f;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const float* xa = &xs1[owned(ty, m) * D];
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      const float* xb = &xs2[owned(tx, n) * D];
      float d2 = 0.0f;
      float dist = 0.0f;
#pragma unroll
      for (int q = 0; q < D; ++q) {
        const float diff = xa[q] - xb[q];
        d2 = fmaf(diff, diff, d2);
        if (D == 1) dist = fabsf(diff);
      }
      float k, dk;
      weights<KIND>(d2, dist, a, b, k, dk);
      sk = fmaf(cot[m][n], k, sk);
      sdk = fmaf(cot[m][n], dk, sdk);
    }
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sk += __shfl_xor_sync(0xffffffffu, sk, off);
    sdk += __shfl_xor_sync(0xffffffffu, sdk, off);
  }
  const int warp = tid / 32;
  if (tid % 32 == 0) {
    red[0][warp] = sdk;
    red[1][warp] = sk;
  }
  __syncthreads();
  if (tid == 0) {
    float g_dk = 0.0f;
    float g_k = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) {
      g_dk += red[0][w];
      g_k += red[1][w];
    }
    const int64_t slot = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
    partial[2 * slot] = g_dk;
    partial[2 * slot + 1] = g_k;
  }
}

template <int KIND, int D>
cudaError_t launch(const float* x1, const float* x2, const float* U,
                   const float* W, float* partial, int n1, int n2, int r,
                   float a, float b, cudaStream_t stream) {
  dim3 grid((n2 + BN - 1) / BN, (n1 + BM - 1) / BM);
  lowrank_vjp_kernel<KIND, D>
      <<<grid, THREADS, 0, stream>>>(x1, x2, U, W, partial, n1, n2, r, a, b);
  return cudaGetLastError();
}

}  // namespace

// The tile edge: the partial buffer holds 2 floats for each of
// ceil(n1 / tile) * ceil(n2 / tile) tiles.
extern "C" int gpf_lowrank_vjp_tile() { return BM; }

// x1 [n1, d], x2 [n2, d], U [n1, r], W [n2, r]: contiguous row-major f32 on
// the device; partial [ceil(n1/BM) * ceil(n2/BN), 2] receives (g_dk, g_k)
// per tile, row-block major. d is the padded width: 1, 4 or 8 for SE (pad
// columns are zero in both x1 and x2), 1 for Matern. Returns a
// cudaError_t; the launch is asynchronous on `stream`.
extern "C" int gpf_lowrank_vjp(const void* x1, const void* x2, const void* U,
                               const void* W, void* partial, int n1, int n2,
                               int d, int r, int kind, float a, float b,
                               void* stream) {
  const float* px1 = static_cast<const float*>(x1);
  const float* px2 = static_cast<const float*>(x2);
  const float* pU = static_cast<const float*>(U);
  const float* pW = static_cast<const float*>(W);
  float* pp = static_cast<float*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n1 <= 0 || n2 <= 0 || r <= 0) return (int)cudaErrorInvalidValue;
  if ((n1 + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  if (kind == KIND_SE) {
    if (d == 1) return (int)launch<KIND_SE, 1>(px1, px2, pU, pW, pp, n1, n2, r, a, b, s);
    if (d == 4) return (int)launch<KIND_SE, 4>(px1, px2, pU, pW, pp, n1, n2, r, a, b, s);
    if (d == 8) return (int)launch<KIND_SE, 8>(px1, px2, pU, pW, pp, n1, n2, r, a, b, s);
    return (int)cudaErrorInvalidValue;
  }
  if (d != 1) return (int)cudaErrorInvalidValue;
  if (kind == KIND_MAT32) return (int)launch<KIND_MAT32, 1>(px1, px2, pU, pW, pp, n1, n2, r, a, b, s);
  if (kind == KIND_MAT52) return (int)launch<KIND_MAT52, 1>(px1, px2, pU, pW, pp, n1, n2, r, a, b, s);
  return (int)cudaErrorInvalidValue;
}
