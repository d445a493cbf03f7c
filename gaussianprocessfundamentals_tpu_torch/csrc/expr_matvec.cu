// Fused Gram-matrix product  out = K(x1, x2) @ V  for one composite kernel
// expression (a Sum/Product tree of SE, PER, LIN, MAT32, MAT52, RQ and
// CONST leaves), for sm_90a, with the K tiles built in the tensor-core
// operand registers and never written to shared or device memory. (K3)
//
// This file is a template: it is not compiled alone. The generator
// (ops/expr_codegen.py) emits `struct Expr` for one expression -- the
// packed parameters, the per-leaf constants and the unrolled value of one
// (x1 row, x2 row) pair -- and compiles it followed by this file, with
// csrc/gram_mma.cuh inlined in place of its #include, into one library per
// expression, cached by a hash of the whole source.
//
// Replaces the TPU kernel `expr_gram_matvec_cross`
// (gaussianprocessfundamentals_tpu/ops/pallas_expr.py:394, tile body
// `_expr_mv_kernel` :373), which interpreted the AST at trace time inside
// a sequential grid of 512x512 VMEM tiles. The tile loop is K1's
// (csrc/gram_mma.cuh): one block owns a strip of output rows and all of
// V's columns and loops over all of x2 itself -- no atomics, no
// cross-block reduction; each pair's expression is evaluated once per
// launch at any r <= 256 (r <= 128 where the 256-column tile spills, see
// below), and the product runs on the tensor cores in
// 3xTF32, which keeps float32's digits (torch's float32 matmul precision
// stays "highest"). The packed parameter vector is read from device memory
// once per thread (the TPU kernel read it from SMEM): no host read per call.
//
// What bounds it on an H100: the Mauna Loa composite costs 3 expf and 1
// sinf (special-function unit), a float64 phase and ~40 FMA-pipe
// operations per pair; at r = 1 and 9 that evaluation bounds it, at
// r = 256 the 3xTF32 product and its shared-memory operand reads join it.
// IEEE expf/sinf/logf (no --use_fast_math): PER's argument pi*man/p
// reaches ~3e4 at the period's lower bound, where __sinf loses every
// digit.

#include "gram_mma.cuh"

// 256-column tiles, unless ops/cuda_expr.py found that they spill
// registers for this expression and defined 128
#ifndef EXPR_MAX_COLS
#define EXPR_MAX_COLS 256
#endif

namespace {

// the generated expression's value of an (x1 row, x2 row) pair
struct ExprPair {
  static constexpr int D = Expr::D;
  static constexpr int MAX_COLS = EXPR_MAX_COLS;
  const float* pv;
  Expr e;
  __device__ __forceinline__ void setup() { e.init(pv); }
  __device__ __forceinline__ float operator()(const float* xa,
                                              const float* xb) const {
    return e.value(xa, xb);
  }
};

}  // namespace

// x1 [n1, D], x2 [n2, D], V [n2, r], pv [Expr::P], out [n1, r]: contiguous
// row-major f32 on the device. Returns a cudaError_t; the launch is
// asynchronous on `stream`.
extern "C" int gpf_expr_matvec(const void* x1, const void* x2, const void* V,
                               const void* pv, void* out, int n1, int n2,
                               int r, void* stream) {
  ExprPair pair{};
  pair.pv = static_cast<const float*>(pv);
  return (int)gram_mma::launch(pair, static_cast<const float*>(x1),
                               static_cast<const float*>(x2),
                               static_cast<const float*>(V),
                               static_cast<float*>(out), n1, n2, r,
                               static_cast<cudaStream_t>(stream));
}
