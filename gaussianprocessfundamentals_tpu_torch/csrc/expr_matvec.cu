// Fused Gram-matrix product  out = K(x1, x2) @ V  for one composite kernel
// expression (a Sum/Product tree of SE, PER, LIN, MAT32, MAT52, RQ and
// CONST leaves), for sm_90a, with the K tiles built in registers and never
// written to device memory. (K3)
//
// This file is a template: it is not compiled alone. The generator
// (ops/expr_codegen.py) emits `struct Expr` for one expression -- the
// packed parameters, the per-leaf constants and the unrolled value of one
// (x1 row, x2 row) pair -- and compiles it followed by this file into one
// library per expression, cached by a hash of the whole source.
//
// Replaces the TPU kernel `expr_gram_matvec_cross`
// (gaussianprocessfundamentals_tpu/ops/pallas_expr.py:394, tile body
// `_expr_mv_kernel` :373), which interpreted the AST at trace time inside
// a sequential grid of 512x512 VMEM tiles. The layout here is K1's
// (csrc/gram_matvec.cu): one block owns a strip of output rows and a tile of
// V's columns and loops over all of x2 itself -- no atomics, no cross-block
// reduction. The packed parameter vector is read from device memory once
// per thread (the TPU kernel read it from SMEM): no host read per call.
//
// What bounds it on an H100: each (i, j) pair evaluates the expression once
// per column tile of V -- the Mauna Loa composite costs 3 expf and 1 sinf
// (special-function unit) and ~40 FMA-pipe operations -- and then does RT
// FMAs. At r = 1 and 9 the transcendentals bound it; at r = 256 the
// 2*n1*n2*r product's FMAs and the expression's recomputation per column
// tile share the bound. IEEE expf/sinf/logf (no --use_fast_math): PER's
// argument pi*man/p reaches ~3e4 at the period's lower bound, where
// __sinf loses every digit.
//
// Design: a block of 128 threads owns 128 rows of x1 (one per thread) and
// RT columns of V -- one row per thread, so even r = 1 at n = 100k fills
// the card with 782 blocks. It loops over x2 in tiles of BN = 128
// rows staged in shared memory, with the [BN, RT] slab of V; every thread
// reads the same x2 row and V row at once (a shared-memory broadcast).
// Sums over one x2 tile go into a per-tile partial added to the running
// total afterwards, so each f32 chain is at most BN + n2/BN adds long.
// Ragged edges: x2 and V rows past n2 are staged as zero (a zero V row adds
// nothing: the expression is finite at x = 0), V columns past r are zero,
// and rows past n1 are not stored.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int BN = 128;
constexpr int D = Expr::D;

template <int RT>
__global__ void __launch_bounds__(THREADS)
expr_matvec_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                   const float* __restrict__ V, const float* __restrict__ pv,
                   float* __restrict__ out, int n1, int n2, int r) {
  __shared__ float xs[BN * D];
  __shared__ float vs[BN * RT];

  const int tid = threadIdx.x;
  const int64_t i = (int64_t)blockIdx.x * THREADS + tid;
  const int c0 = blockIdx.y * RT;

  Expr e;
  e.init(pv);

  float xr[D];
#pragma unroll
  for (int k = 0; k < D; ++k) xr[k] = (i < n1) ? x1[i * D + k] : 0.0f;

  float acc[RT];
#pragma unroll
  for (int c = 0; c < RT; ++c) acc[c] = 0.0f;

  for (int j0 = 0; j0 < n2; j0 += BN) {
    __syncthreads();  // the previous tile's readers are done
    for (int q = tid; q < BN * D; q += THREADS) {
      const int j = j0 + q / D;
      xs[q] = (j < n2) ? x2[(int64_t)j0 * D + q] : 0.0f;
    }
    for (int q = tid; q < BN * RT; q += THREADS) {
      const int j = j0 + q / RT;
      const int c = c0 + q % RT;
      vs[q] = (j < n2 && c < r) ? V[(int64_t)j * r + c] : 0.0f;
    }
    __syncthreads();

    float part[RT];
#pragma unroll
    for (int c = 0; c < RT; ++c) part[c] = 0.0f;
    for (int jj = 0; jj < BN; ++jj) {
      const float kv = e.value(xr, &xs[jj * D]);
#pragma unroll
      for (int c = 0; c < RT; ++c) part[c] = fmaf(kv, vs[jj * RT + c], part[c]);
    }
#pragma unroll
    for (int c = 0; c < RT; ++c) acc[c] += part[c];
  }

  if (i >= n1) return;
#pragma unroll
  for (int c = 0; c < RT; ++c) {
    if (c0 + c < r) out[i * r + c0 + c] = acc[c];
  }
}

template <int RT>
cudaError_t launch(const float* x1, const float* x2, const float* V,
                   const float* pv, float* out, int n1, int n2, int r,
                   cudaStream_t stream) {
  dim3 grid((n1 + THREADS - 1) / THREADS, (r + RT - 1) / RT);
  expr_matvec_kernel<RT>
      <<<grid, THREADS, 0, stream>>>(x1, x2, V, pv, out, n1, n2, r);
  return cudaGetLastError();
}

}  // namespace

// x1 [n1, D], x2 [n2, D], V [n2, r], pv [Expr::P], out [n1, r]: contiguous
// row-major f32 on the device. Returns a cudaError_t; the launch is
// asynchronous on `stream`. Column tile of V by r: the y-solve (r = 1),
// the training probes (r <= 16), posterior chunks (wider, tiled by 64
// columns so each pair's expression is evaluated r/64 times).
extern "C" int gpf_expr_matvec(const void* x1, const void* x2, const void* V,
                               const void* pv, void* out, int n1, int n2,
                               int r, void* stream) {
  const float* px1 = static_cast<const float*>(x1);
  const float* px2 = static_cast<const float*>(x2);
  const float* pV = static_cast<const float*>(V);
  const float* ppv = static_cast<const float*>(pv);
  float* po = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n1 < 0 || n2 < 0 || r < 0) return (int)cudaErrorInvalidValue;
  if (n1 == 0 || r == 0) return (int)cudaSuccess;
  if (r == 1) return (int)launch<1>(px1, px2, pV, ppv, po, n1, n2, r, s);
  if (r <= 4) return (int)launch<4>(px1, px2, pV, ppv, po, n1, n2, r, s);
  if (r <= 16) return (int)launch<16>(px1, px2, pV, ppv, po, n1, n2, r, s);
  if (r <= 32) return (int)launch<32>(px1, px2, pV, ppv, po, n1, n2, r, s);
  return (int)launch<64>(px1, px2, pV, ppv, po, n1, n2, r, s);
}
