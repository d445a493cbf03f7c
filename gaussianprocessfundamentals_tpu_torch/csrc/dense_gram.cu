// Materialised Gram matrices for sm_90a: the squared-exponential (K5) and
// Matern-3/2 / -5/2 (K6) covariance of x1 [n, d] against x2 [m, d], written
// once to an [n, m] row-major float32 matrix, with `diag_add` added where
// the global row index equals the column index (when diag_add > 0):
//
//   K(a, b) = var * exp(-|a - b|^2 / (2 l^2))                (SE, d <= 8)
//   K(a, b) = var * (1 + f) * exp(-f),         f = sqrt(3) |a - b| / l   (Matern-3/2, d = 1)
//   K(a, b) = var * (1 + f + f^2/3) * exp(-f), f = sqrt(5) |a - b| / l   (Matern-5/2, d = 1)
//
// Replaces the TPU kernels `se_gram` and `matern_gram`
// (gaussianprocessfundamentals_tpu/ops/pallas_gram.py:67 and :142, tile
// bodies `_se_tile_kernel` :46 and `_matern_tile_kernel` :117), which fused
// the dense route's K + (noise + jitter) I into one pass over [512, 512]
// VMEM tiles. The diagonal keeps their semantics: global row == column, on
// a non-square build too. Distances differ on purpose: the TPU expanded
// |a|^2 - 2ab + |b|^2 on its matrix unit at d > 1, whose cancellation
// (pallas_gram.py:31-37) this kernel avoids with direct per-dimension
// differences at every d, as the port's K1 does.
//
// What bounds it on an H100: the write. The kernel reads O((n + m) d)
// floats and writes 4 n m bytes; it performs no product. At n = m = 16,384
// that is 1.07 GB, 0.32 ms at 3.35 TB/s, against one expf per entry
// (2.7e8 calls, 0.064 ms on the special-function units).
//
// Design, for the stores: a block of 256 threads (64 x 4) owns a tile of
// BM = 32 rows by BN = 256 columns. It stages the tile's x1 rows and x2
// columns in shared memory; each thread keeps its 4 consecutive x2 columns
// in registers and walks 8 rows of the tile (rows ty, ty + 4, ...). For each
// row it builds 4 entries and writes them as one 16-byte float4 store, so a
// warp writes 512 contiguous bytes of one row and the block's two warps of
// a row cover 1 KB. Every thread of a warp reads the same x1 row from
// shared memory (a broadcast). When m is not a multiple of 4 the rows are
// not 16-byte aligned, and the kernel stores the 4 floats one by one; the
// ragged edges (rows past n, columns past m) are masked.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared and no
// --use_fast_math (which would swap expf for an approximation).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 64;   // threads along the columns, 4 columns each
constexpr int TY = 4;    // threads along the rows
constexpr int BN = TX * 4;
constexpr int BM = 32;

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

template <int KIND, int D>
__global__ void __launch_bounds__(TX * TY)
dense_gram_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                  float* __restrict__ out, int n, int m, float a, float var,
                  float diag_add, int aligned) {
  __shared__ float s1[BM * D];
  __shared__ float s2[BN * D];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int64_t row0 = (int64_t)blockIdx.y * BM;
  const int64_t col0 = (int64_t)blockIdx.x * BN;

  for (int e = tid; e < BM * D; e += TX * TY) {
    const int64_t i = row0 + e / D;
    s1[e] = (i < n) ? x1[row0 * D + e] : 0.0f;
  }
  for (int e = tid; e < BN * D; e += TX * TY) {
    const int64_t j = col0 + e / D;
    s2[e] = (j < m) ? x2[col0 * D + e] : 0.0f;
  }
  __syncthreads();

  const int64_t j0 = col0 + 4 * tx;
  if (j0 >= m) return;
  float xc[4][D];
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int k = 0; k < D; ++k) xc[c][k] = s2[(4 * tx + c) * D + k];
  const bool add_diag = diag_add > 0.0f;

#pragma unroll 2
  for (int r = ty; r < BM; r += TY) {
    const int64_t i = row0 + r;
    if (i >= n) break;
    float v[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      float d2 = 0.0f;
#pragma unroll
      for (int k = 0; k < D; ++k) {
        const float diff = s1[r * D + k] - xc[c][k];
        d2 = fmaf(diff, diff, d2);
      }
      const float dist = (D == 1) ? fabsf(s1[r] - xc[c][0]) : sqrtf(d2);
      v[c] = kernel_value<KIND>(d2, dist, a, var);
      if (add_diag && i == j0 + c) v[c] += diag_add;
    }
    float* dst = out + i * (int64_t)m + j0;
    if (aligned && j0 + 3 < m) {
      *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (j0 + c < m) dst[c] = v[c];
    }
  }
}

template <int KIND, int D>
cudaError_t launch(const float* x1, const float* x2, float* out, int n, int m,
                   float a, float var, float diag_add, cudaStream_t stream) {
  dim3 grid((m + BN - 1) / BN, (n + BM - 1) / BM);
  dim3 block(TX, TY);
  const int aligned = (m % 4 == 0) &&
                      (reinterpret_cast<uintptr_t>(out) % 16 == 0);
  dense_gram_kernel<KIND, D><<<grid, block, 0, stream>>>(
      x1, x2, out, n, m, a, var, diag_add, aligned);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_se(const float* x1, const float* x2, float* out, int n,
                      int m, float a, float var, float diag_add,
                      cudaStream_t s) {
  return launch<KIND_SE, D>(x1, x2, out, n, m, a, var, diag_add, s);
}

}  // namespace

// x1 [n, d], x2 [m, d], out [n, m]: contiguous row-major float32 on the
// device; d in 1..8 for SE (kind 0), d = 1 for Matern (kind 1: 3/2, kind 2:
// 5/2). Returns a cudaError_t; the launch is asynchronous on `stream`.
extern "C" int gpf_dense_gram(const void* x1, const void* x2, void* out, int n,
                              int m, int d, int kind, float a, float var,
                              float diag_add, void* stream) {
  const float* p1 = static_cast<const float*>(x1);
  const float* p2 = static_cast<const float*>(x2);
  float* po = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || m < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || m == 0) return (int)cudaSuccess;
  if (kind == KIND_SE) {
    switch (d) {
      case 1: return (int)launch_se<1>(p1, p2, po, n, m, a, var, diag_add, s);
      case 2: return (int)launch_se<2>(p1, p2, po, n, m, a, var, diag_add, s);
      case 3: return (int)launch_se<3>(p1, p2, po, n, m, a, var, diag_add, s);
      case 4: return (int)launch_se<4>(p1, p2, po, n, m, a, var, diag_add, s);
      case 5: return (int)launch_se<5>(p1, p2, po, n, m, a, var, diag_add, s);
      case 6: return (int)launch_se<6>(p1, p2, po, n, m, a, var, diag_add, s);
      case 7: return (int)launch_se<7>(p1, p2, po, n, m, a, var, diag_add, s);
      case 8: return (int)launch_se<8>(p1, p2, po, n, m, a, var, diag_add, s);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (d != 1) return (int)cudaErrorInvalidValue;
  if (kind == KIND_MAT32)
    return (int)launch<KIND_MAT32, 1>(p1, p2, po, n, m, a, var, diag_add, s);
  if (kind == KIND_MAT52)
    return (int)launch<KIND_MAT52, 1>(p1, p2, po, n, m, a, var, diag_add, s);
  return (int)cudaErrorInvalidValue;
}
