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
// by the product rule -- and compiles it followed by this file, with
// csrc/lowrank_mma.cuh inlined in place of its #include, into one library
// per expression, cached by a hash of the whole source.
//
// Replaces the TPU kernel `expr_lowrank_vjp_cross`
// (gaussianprocessfundamentals_tpu/ops/pallas_expr.py:481, tile body
// `_expr_vjp_kernel` :446), which took jax.grad of the tile body and
// carried one (8, 128) accumulator row per row block across a sequential
// grid. The tile loop is K2's (csrc/lowrank_mma.cuh): every [128, 128]
// tile of pairs is its own block, all in parallel; the cotangent tile is
// made on the tensor cores in 3xTF32; and each block writes its P sums to
// its own slot of a [grid_i * grid_j, P] buffer, which the wrapper sums on
// the device in float64. No atomics; the sums within a tile are float64.
//
// What bounds it on an H100: the 3xTF32 rank-r product (3 * 2 * n1 * n2 * r
// tensor-core operations, 5.46e12 * 3 at n = 100k, r = 273) and one
// evaluation of the expression and its P derivatives per pair in the
// epilogue (the Mauna Loa composite: 3 expf, 1 sinf, 1 cosf, PER's phase
// reduced in float64, and ~60 FMA-pipe operations). The epilogue walks a
// lane's fragments in a loop (ROLLED): the generated derivative code runs
// to a few hundred instructions a pair, too long to unroll 64 times.
// IEEE expf/sinf/cosf (no --use_fast_math): PER's argument reaches ~3e4
// at the period's lower bound, where __sinf loses every digit.

#include "lowrank_mma.cuh"

namespace {

// what one pair adds: cot * dK/dpv_q for every packed parameter
struct ExprGrad {
  static constexpr int D = Expr::D;
  static constexpr int P = Expr::P;
  static constexpr bool ROLLED = true;
  const float* pv;
  Expr e;
  __device__ __forceinline__ void setup() { e.init(pv); }
  __device__ __forceinline__ void operator()(const float* xa, const float* xb,
                                             float cot, double (&s)[P]) const {
    float g[P] = {};
    e.grad(xa, xb, cot, g);  // g_q = cot * dK/dpv_q, rounded once
#pragma unroll
    for (int q = 0; q < P; ++q) s[q] += g[q];
  }
};

}  // namespace

// The tile edge: the partial buffer holds P floats for each of
// ceil(n1 / tile) * ceil(n2 / tile) tiles.
extern "C" int gpf_expr_vjp_tile() { return lowrank_mma::TILE; }

// x1 [n1, D], x2 [n2, D], U [n1, r], W [n2, r], pv [P]: contiguous
// row-major f32 on the device; partial [ceil(n1/tile) * ceil(n2/tile), P]
// receives the per-tile sums, row-tile major. Returns a cudaError_t; the
// launch is asynchronous on `stream`.
extern "C" int gpf_expr_vjp(const void* x1, const void* x2, const void* U,
                            const void* W, const void* pv, void* partial,
                            int n1, int n2, int r, void* stream) {
  ExprGrad pair{};
  pair.pv = static_cast<const float*>(pv);
  return (int)lowrank_mma::launch(
      pair, static_cast<const float*>(x1), static_cast<const float*>(x2),
      static_cast<const float*>(U), static_cast<const float*>(W),
      static_cast<float*>(partial), n1, n2, r,
      static_cast<cudaStream_t>(stream));
}
