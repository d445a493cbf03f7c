// Fused low-rank-cotangent gradient for one composite kernel expression,
// for sm_90a: the P packed-parameter derivatives
//
//   g_q = sum_ij (U W^T)_ij * dK(x1_i, x2_j)/dpv_q,   q = 0 .. P-1
//
// in one pass over the (i, j) pairs, with neither K nor the cotangent U W^T
// ever in device memory. (K4)
//
// This file is a template: it is not compiled alone. The generator
// (ops/expr_codegen.py) emits `struct Expr` for one expression -- its
// packed parameters and, per pair, its value and the analytic derivative
// with respect to every packed parameter, combined through Sum and Product
// by the product rule -- and compiles it followed by this file into one
// library per expression, cached by a hash of the whole source.
//
// Replaces the TPU kernel `expr_lowrank_vjp_cross`
// (gaussianprocessfundamentals_tpu/ops/pallas_expr.py:481, tile body
// `_expr_vjp_kernel` :446), which took jax.grad of the tile body and
// carried one (8, 128) accumulator row per row block across a sequential
// grid. The layout here is K2's (csrc/lowrank_vjp.cu): every [BM, BN] tile
// of pairs is its own block, all in parallel, and each block writes its P
// partial sums to its own slot of a [grid_i * grid_j, P] buffer, which the
// wrapper sums on the device in float64. No atomics; no float32 chain is
// longer than a thread's 64 pairs plus the 5 + 8 adds of the block
// reduction.
//
// What bounds it on an H100: the cotangent tile is a rank-r product,
// 2*n1*n2*r float32 operations (r = 2s + m + 1 = 273 on the main path:
// 5.5e12 at n = 100k), against one evaluation of the expression and its P
// derivatives per pair in the epilogue (the Mauna Loa composite: 3 expf,
// 1 sinf, 1 cosf and ~60 FMA-pipe operations). So float32 FMA throughput
// bounds it at wide r. Tensor cores are not used (TF32 keeps about three
// decimal digits); a 3xTF32 or wgmma cotangent tile is later work.
//
// Design: K2's. 256 threads own a 128 x 128 tile; thread (tx, ty) of a
// 16 x 16 grid computes an 8 x 8 register tile of the cotangent, rows
// {4ty..4ty+3, 64+4ty..64+4ty+3} and the same pattern of columns in tx,
// from U and W staged through shared memory in chunks of BK = 16 of their
// r columns, transposed; rows past n and columns past r are staged as zero,
// so a padded pair has a zero cotangent and adds exactly nothing. Then each
// thread accumulates cot * dK/dpv_q for its 64 pairs into P registers, and
// the block reduces each of the P sums with warp shuffles (xor butterfly, a
// fixed order) and then one thread per parameter over the 8 warps.

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
constexpr int D = Expr::D;
constexpr int P = Expr::P;
static_assert(BM == BN, "the wrapper sizes the partial buffer by one tile edge");
static_assert(TM == 8 && TN == 8, "the float4 row/column pattern assumes 8 x 8");
static_assert(P <= THREADS, "one thread per parameter in the final reduction");

// Row (or column) of the tile that register m of thread t owns.
__device__ __forceinline__ int owned(int t, int m) {
  return (m < 4) ? 4 * t + m : 64 + 4 * t + (m - 4);
}

__global__ void __launch_bounds__(THREADS)
expr_vjp_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                const float* __restrict__ U, const float* __restrict__ W,
                const float* __restrict__ pv, float* __restrict__ partial,
                int n1, int n2, int r) {
  __shared__ __align__(16) float us[BK][BM + PAD];
  __shared__ __align__(16) float ws[BK][BN + PAD];
  __shared__ float xs1[BM * D];
  __shared__ float xs2[BN * D];
  __shared__ float red[P][THREADS / 32];

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);
  const int64_t i0 = (int64_t)blockIdx.y * BM;
  const int64_t j0 = (int64_t)blockIdx.x * BN;

  for (int q = tid; q < BM * D; q += THREADS) {
    xs1[q] = (i0 + q / D < n1) ? x1[i0 * D + q] : 0.0f;
  }
  for (int q = tid; q < BN * D; q += THREADS) {
    xs2[q] = (j0 + q / D < n2) ? x2[j0 * D + q] : 0.0f;
  }

  float cot[TM][TN];
#pragma unroll
  for (int m = 0; m < TM; ++m)
#pragma unroll
    for (int n = 0; n < TN; ++n) cot[m][n] = 0.0f;

  for (int k0 = 0; k0 < r; k0 += BK) {
    __syncthreads();  // the previous chunk's readers are done
    // consecutive threads read consecutive columns of one row of U (W)
    for (int q = tid; q < BM * BK; q += THREADS) {
      const int row = q / BK;
      const int kk = q % BK;
      const int c = k0 + kk;
      const int64_t i = i0 + row;
      us[kk][row] = (i < n1 && c < r) ? U[i * r + c] : 0.0f;
    }
    for (int q = tid; q < BN * BK; q += THREADS) {
      const int col = q / BK;
      const int kk = q % BK;
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

  // epilogue: the expression's derivatives for the 64 owned pairs
  Expr e;
  e.init(pv);
  float g[P];
#pragma unroll
  for (int q = 0; q < P; ++q) g[q] = 0.0f;
#pragma unroll
  for (int m = 0; m < TM; ++m) {
    const float* xa = &xs1[owned(ty, m) * D];
#pragma unroll
    for (int n = 0; n < TN; ++n) {
      e.grad(xa, &xs2[owned(tx, n) * D], cot[m][n], g);
    }
  }

  const int warp = tid / 32;
#pragma unroll
  for (int q = 0; q < P; ++q) {
    float v = g[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (tid % 32 == 0) red[q][warp] = v;
  }
  __syncthreads();
  if (tid < P) {
    float total = 0.0f;
    for (int w = 0; w < THREADS / 32; ++w) total += red[tid][w];
    const int64_t slot = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
    partial[slot * P + tid] = total;
  }
}

}  // namespace

// The tile edge: the partial buffer holds P floats for each of
// ceil(n1 / tile) * ceil(n2 / tile) tiles.
extern "C" int gpf_expr_vjp_tile() { return BM; }

// x1 [n1, D], x2 [n2, D], U [n1, r], W [n2, r], pv [P]: contiguous
// row-major f32 on the device; partial [ceil(n1/BM) * ceil(n2/BN), P]
// receives the per-tile sums, row-block major. Returns a cudaError_t; the
// launch is asynchronous on `stream`.
extern "C" int gpf_expr_vjp(const void* x1, const void* x2, const void* U,
                            const void* W, const void* pv, void* partial,
                            int n1, int n2, int r, void* stream) {
  if (n1 <= 0 || n2 <= 0 || r <= 0) return (int)cudaErrorInvalidValue;
  if ((n1 + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((n2 + BN - 1) / BN, (n1 + BM - 1) / BM);
  expr_vjp_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x1), static_cast<const float*>(x2),
      static_cast<const float*>(U), static_cast<const float*>(W),
      static_cast<const float*>(pv), static_cast<float*>(partial), n1, n2, r);
  return (int)cudaGetLastError();
}
