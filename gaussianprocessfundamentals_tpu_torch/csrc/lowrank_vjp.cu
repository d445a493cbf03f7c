// Fused low-rank-cotangent gradient for sm_90a: the two scalars
//
//   g_k  = sum_ij (U W^T)_ij * k(x1_i, x2_j)
//   g_dk = sum_ij (U W^T)_ij * dk(x1_i, x2_j)/dl
//
// of the unit-variance kernel k, in one pass over the (i, j) pairs, with
// neither K nor the cotangent U W^T ever in device memory. The wrapper
// turns them into (dL/dl, dL/dvar) = (var * g_dk, g_k). (K2)
//
// Replaces the TPU kernel `fused_lowrank_vjp_cross`
// (gaussianprocessfundamentals_tpu/ops/pallas_gram.py:398, tile body
// `_lrvjp_kernel` :348). What it computes is the same; how is not: the TPU
// version walked a sequential grid and carried one (8, 128) accumulator
// per row block across the column steps. Here every [128, 128] tile of
// pairs is its own block, all in parallel, and each block writes its two
// sums to its own slot of a [grid_i * grid_j, 2] buffer, which the wrapper
// sums on the device in float64. No atomics, so the result does not depend
// on scheduling; the sums within a tile are float64 (the TPU lesson,
// pallas_gram.py:371-377, was to keep float32 chains near a tile plus
// n/BN adds).
//
//   k = exp(-d2 / (2 l^2)),              dk/dl = k * d2 / l^3            (SE, any d)
//   k = (1 + f) e^-f,                     dk/dl = f^2 e^-f / l            (Matern-3/2, d = 1)
//   k = (1 + f + f^2/3) e^-f,             dk/dl = f^2 (1 + f) e^-f / (3l) (Matern-5/2, d = 1)
//   with f = sqrt(3 or 5) |x1 - x2| / l
//
// Distances are direct per-dimension differences at every d, as in K1
// (csrc/gram_matvec.cu), never the TPU's |a|^2 - 2ab + |b|^2 expansion.
//
// The tile loop is csrc/lowrank_mma.cuh, shared with K4: the cotangent
// tile U W^T on the tensor cores in 3xTF32 (mma.sync), consumed in the
// accumulator registers by the epilogue below, which is this file's only
// code: one expf and about a dozen operations per pair, unrolled over a
// lane's 64 pairs at d = 1, looped over its fragments at d = 4 and 8, and
// at d > 8 (SE) evaluated from squared distances the header sums over
// chunks of dimensions at the run-time width d (WideSe).
// The header's note says what bounds it and how it is laid out.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared and no
// --use_fast_math (which would swap expf and division for approximations).

#include "lowrank_mma.cuh"

namespace {

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

// what one pair adds: (cot * dk, cot * k), the partial slot's order
template <int KIND, int D_>
struct LeafPair {
  static constexpr int D = D_;
  static constexpr int P = 2;
  static constexpr bool ROLLED = D > 1;
  float a, b;
  __device__ __forceinline__ void setup() {}
  __device__ __forceinline__ void operator()(const float* xa, const float* xb,
                                             float cot, double (&s)[2]) const {
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
    s[0] += static_cast<double>(cot) * dk;  // the product is exact in double
    s[1] += static_cast<double>(cot) * k;
  }
};

// SE at a run-time width d > 8: the header sums the squared distances
// (lowrank_mma::wide_epilogue) in the order LeafPair does
struct WideSe {
  static constexpr int D = 0;
  static constexpr int P = 2;
  static constexpr bool ROLLED = false;
  float a, b;
  int d;
  __device__ __forceinline__ void setup() {}
  __device__ __forceinline__ void from_d2(float d2, float cot,
                                          double (&s)[2]) const {
    float k, dk;
    weights<KIND_SE>(d2, 0.0f, a, b, k, dk);
    s[0] += static_cast<double>(cot) * dk;
    s[1] += static_cast<double>(cot) * k;
  }
};

template <class Pair>
int launch_pair(const Pair& pair, const void* x1, const void* x2,
                const void* U, const void* W, void* partial, int n1, int n2,
                int r, void* stream) {
  return (int)lowrank_mma::launch(
      pair, static_cast<const float*>(x1), static_cast<const float*>(x2),
      static_cast<const float*>(U), static_cast<const float*>(W),
      static_cast<float*>(partial), n1, n2, r,
      static_cast<cudaStream_t>(stream));
}

template <int KIND, int D>
int launch(const void* x1, const void* x2, const void* U, const void* W,
           void* partial, int n1, int n2, int r, float a, float b,
           void* stream) {
  return launch_pair(LeafPair<KIND, D>{a, b}, x1, x2, U, W, partial, n1, n2,
                     r, stream);
}

}  // namespace

// The tile edge: the partial buffer holds 2 floats for each of
// ceil(n1 / tile) * ceil(n2 / tile) tiles.
extern "C" int gpf_lowrank_vjp_tile() { return lowrank_mma::TILE; }

// x1 [n1, d], x2 [n2, d], U [n1, r], W [n2, r]: contiguous row-major f32 on
// the device; partial [ceil(n1/tile) * ceil(n2/tile), 2] receives
// (g_dk, g_k) per tile, row-tile major. d is, for SE, the padded width 1,
// 4 or 8 (pad columns are zero in both x1 and x2) or any width above 8;
// 1 for Matern. Returns a cudaError_t; the launch is asynchronous on
// `stream`.
extern "C" int gpf_lowrank_vjp(const void* x1, const void* x2, const void* U,
                               const void* W, void* partial, int n1, int n2,
                               int d, int r, int kind, float a, float b,
                               void* stream) {
  if (kind == KIND_SE) {
    if (d == 1) return launch<KIND_SE, 1>(x1, x2, U, W, partial, n1, n2, r, a, b, stream);
    if (d == 4) return launch<KIND_SE, 4>(x1, x2, U, W, partial, n1, n2, r, a, b, stream);
    if (d == 8) return launch<KIND_SE, 8>(x1, x2, U, W, partial, n1, n2, r, a, b, stream);
    if (d > 8) return launch_pair(WideSe{a, b, d}, x1, x2, U, W, partial, n1, n2, r, stream);
    return (int)cudaErrorInvalidValue;
  }
  if (d != 1) return (int)cudaErrorInvalidValue;
  if (kind == KIND_MAT32) return launch<KIND_MAT32, 1>(x1, x2, U, W, partial, n1, n2, r, a, b, stream);
  if (kind == KIND_MAT52) return launch<KIND_MAT52, 1>(x1, x2, U, W, partial, n1, n2, r, a, b, stream);
  return (int)cudaErrorInvalidValue;
}
