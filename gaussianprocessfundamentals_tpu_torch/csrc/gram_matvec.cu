// Fused Gram-matrix product  out = K(x1, x2) @ V  for sm_90a, with the
// K tiles built in the tensor-core operand registers and never written to
// shared or device memory. (K1)
//
// Replaces the TPU kernel `fused_gram_matvec_cross`
// (gaussianprocessfundamentals_tpu/ops/pallas_gram.py:252, tile body
// `_mv_kernel` :222). What it computes is the same; how is not: the TPU
// version walked a sequential grid of 512x512 VMEM tiles and accumulated
// into the output block across grid steps. Here blocks run in parallel, so
// one block owns a strip of output rows and all of V's columns and loops
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
// The tile loop, the bound and the design are csrc/gram_mma.cuh's, shared
// with K3: each pair is evaluated once per launch at r <= 128 (twice at
// r <= 256: two column tiles, see the header's "Registers"), and the
// product runs on the tensor cores in 3xTF32 (each operand split into TF32
// hi and lo halves, three MMAs per product), which keeps float32's digits;
// a single TF32 pass would keep about three, which CG cannot afford. The
// tensor cores are used only inside this kernel: torch's float32 matmul
// precision stays "highest".

#include "gram_mma.cuh"

namespace {

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

// one leaf's value of an (x1 row, x2 row) pair, for gram_mma's tile loop;
// 128 columns per column tile (csrc/gram_mma.cuh, "Registers")
template <int KIND, int D_>
struct LeafPair {
  static constexpr int D = D_;
  static constexpr int MAX_COLS = 128;
  float a, var;
  __device__ __forceinline__ void setup() {}
  __device__ __forceinline__ float operator()(const float* xa,
                                              const float* xb) const {
    float d2 = 0.0f;
    float dist = 0.0f;
#pragma unroll
    for (int k = 0; k < D; ++k) {
      const float diff = xa[k] - xb[k];
      d2 = fmaf(diff, diff, d2);
      if (D == 1) dist = fabsf(diff);
    }
    return kernel_value<KIND>(d2, dist, a, var);
  }
};

template <int KIND, int D>
cudaError_t run(const float* x1, const float* x2, const float* V, float* out,
                int n1, int n2, int r, float a, float var, cudaStream_t s) {
  return gram_mma::launch(LeafPair<KIND, D>{a, var}, x1, x2, V, out, n1, n2,
                          r, s);
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
  if (kind == KIND_SE) {
    if (d == 1) return (int)run<KIND_SE, 1>(px1, px2, pV, po, n1, n2, r, a, var, s);
    if (d == 4) return (int)run<KIND_SE, 4>(px1, px2, pV, po, n1, n2, r, a, var, s);
    if (d == 8) return (int)run<KIND_SE, 8>(px1, px2, pV, po, n1, n2, r, a, var, s);
    return (int)cudaErrorInvalidValue;
  }
  if (d != 1) return (int)cudaErrorInvalidValue;
  if (kind == KIND_MAT32) return (int)run<KIND_MAT32, 1>(px1, px2, pV, po, n1, n2, r, a, var, s);
  if (kind == KIND_MAT52) return (int)run<KIND_MAT52, 1>(px1, px2, pV, po, n1, n2, r, a, var, s);
  return (int)cudaErrorInvalidValue;
}
