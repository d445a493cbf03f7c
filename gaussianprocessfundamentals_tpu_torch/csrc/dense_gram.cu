// Materialised Gram matrices for sm_90a: the squared-exponential (K5) and
// Matern-3/2 / -5/2 (K6) covariance of x1 [n, d] against x2 [m, d], at any
// d, written once to an [n, m] row-major float32 matrix, with `diag_add`
// added where the global row index equals the column index (when
// diag_add > 0):
//
//   K(a, b) = var * exp(-r^2 / (2 l^2))                           (SE)
//   K(a, b) = var * (1 + f) * exp(-f),          f = sqrt(3) r / |l|   (Matern-3/2)
//   K(a, b) = var * (1 + f + f^2/3) * exp(-f),  f = sqrt(5) r / |l|   (Matern-5/2)
//
// with r = |a - b| the Euclidean distance, its square summed with fmaf from
// direct per-dimension differences (at d = 1 the Matern takes |a - b|
// itself).
//
// Replaces the TPU kernels `se_gram` and `matern_gram`
// (gaussianprocessfundamentals_tpu/ops/pallas_gram.py:67 and :142, tile
// bodies `_se_tile_kernel` :46 and `_matern_tile_kernel` :117), which fused
// the dense route's K + (noise + jitter) I into one pass over [512, 512]
// VMEM tiles. The diagonal keeps their semantics: global row == column, on
// a non-square build too, added only when diag_add > 0 (their
// `pl.when(diag > 0.0)`). So do the hyperparameters: like their `scal`
// operand in SMEM, (l, var, diag_add) may come as a 3-float device buffer
// that every thread reads, so that a Gram whose hyperparameters and shift
// live on the device needs no read on the host; where `scal` is null they
// come as values. Distances differ on purpose: the TPU expanded
// |a|^2 - 2ab + |b|^2 on its matrix unit at d > 1, whose cancellation
// (pallas_gram.py:31-37) this kernel avoids, as the port's K1 does.
//
// What bounds it on an H100: the write. The kernel reads O((n + m) d)
// floats and writes 4 n m bytes. At n = m = 16,384 that is 1.07 GB, 0.32 ms
// at 3.35 TB/s, against one expf per entry (2.7e8 calls, 0.064 ms on the
// special-function units) and 3 n m d float32 operations (0.012 ms at
// d = 1; at d = 20 a 6,250^2 build's 0.035 ms comes near its 0.047 ms of
// writes).
//
// Design, for the stores:
//   * 16-byte stores at every m. The matrix is written as its flat n*m
//     array; its base is 16-byte aligned (the wrapper allocates it, the
//     entry point checks), so the aligned float4 chunks of row i start at
//     the columns j = 4q - o, o = (i*m) % 4. A chunk that straddles two
//     rows is written by both rows' threads, each storing its own (at most
//     3) entries one by one; every other chunk is one float4 store.
//   * Plain stores. Streaming ones (__stcs, evict-first) made the builds
//     up to 17% faster (12% at 6,250^2), but the Cholesky that reads a
//     square Gram right after its build 0.2-0.6% slower at 6,511^2,
//     16,384^2 and 50,000^2, more time than the build saved there (in
//     turns on an H100; tools/dense_gram_times.py; PERF.md, section 5).
//   * A block of 256 threads (64 x 4) owns bm rows (32, or 16 where 32
//     would give fewer than 8 blocks an SM, as for a segment's cross Gram)
//     and, in each row, the BN = 256 columns col0 - o .. col0 + BN - 1 - o.
//     Thread (tx, ty) walks the rows ty, ty + 4, ...: all have the same
//     i % 4 and so the same o, and the thread owns the columns
//     col0 + 4 tx - o .. + 3 in each of them. A warp (one ty) writes 512
//     contiguous bytes of a row. Blocks are numbered column tile first
//     (a 1-D grid: any n), so the blocks in flight write whole rows.
//   * x1's rows and x2's columns col0 - 4 .. col0 + BN + 3 are staged in
//     shared memory, x2 dimension-major: a thread reads its 4 columns of a
//     dimension as two aligned 16-byte loads and picks them by o, which is
//     uniform in a warp.
//   * d = 1 .. 8 are compile-time widths: x is staged in one piece, each
//     thread keeps its 4 columns in registers and evaluates and stores
//     row after row. Any other d takes one run-time-width instantiation
//     that stages 32 dimensions at a time, as K2's WideSe
//     (csrc/lowrank_mma.cuh) does, and sums each thread's (rows x 4)
//     squared distances in registers over the chunks before it evaluates
//     and stores; at d = 12-20 it runs at 30-40% of the write bound.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared and no
// --use_fast_math (which would swap expf for an approximation).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TX = 64;          // threads along the columns, 4 columns each
constexpr int TY = 4;           // threads along the rows
constexpr int BN = TX * 4;      // columns a block owns in each row
constexpr int BM = 32;          // rows a block owns, at most
constexpr int RPT = BM / TY;    // rows a thread walks, at most
constexpr int XW = BN + 8;      // staged x2 columns: col0 - 4 .. col0 + BN + 3
constexpr int CHUNK = 32;       // dimensions staged at a time at run-time d
constexpr int MIN_BLOCKS = 8 * 132;  // 8 blocks on each of an H100's SMs

constexpr int KIND_SE = 0;
constexpr int KIND_MAT32 = 1;
constexpr int KIND_MAT52 = 2;

// q is the squared distance for SE and the distance for Matern; a is
// -1/(2 l^2) for SE and sqrt(3)/|l| or sqrt(5)/|l| for Matern.
template <int KIND>
__device__ __forceinline__ float kernel_value(float q, float a, float var) {
  if (KIND == KIND_SE) return var * expf(a * q);
  const float f = a * q;
  float poly = 1.0f + f;
  if (KIND == KIND_MAT52) poly += f * f * (1.0f / 3.0f);
  return var * poly * expf(-f);
}

// The 4 staged columns 4 tx + 4 - o .. 4 tx + 7 - o of one dimension, from
// the aligned float4s lo (4 tx .. 4 tx + 3) and hi (4 tx + 4 .. 4 tx + 7).
__device__ __forceinline__ void pick(float4 lo, float4 hi, int o,
                                     float (&xc)[4]) {
  switch (o) {
    case 0: xc[0] = hi.x; xc[1] = hi.y; xc[2] = hi.z; xc[3] = hi.w; break;
    case 1: xc[0] = lo.w; xc[1] = hi.x; xc[2] = hi.y; xc[3] = hi.z; break;
    case 2: xc[0] = lo.z; xc[1] = lo.w; xc[2] = hi.x; xc[3] = hi.y; break;
    default: xc[0] = lo.y; xc[1] = lo.z; xc[2] = lo.w; xc[3] = hi.x; break;
  }
}

// Evaluates row i's 4 entries j0 .. j0 + 3 from their q (kernel_value)
// and stores those below m: one float4 where all 4 are in the row.
template <int KIND>
__device__ __forceinline__ void store_row(float* __restrict__ out, int64_t i,
                                          int64_t j0, int m,
                                          const float (&q)[4], float a,
                                          float var, float diag_add) {
  const int64_t dc = i - j0;  // the diagonal's place among the 4, if any
  const bool diag = diag_add > 0.0f && dc >= 0 && dc < 4;
  float v[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    v[c] = kernel_value<KIND>(q[c], a, var);
    if (diag && c == (int)dc) v[c] += diag_add;
  }
  const int64_t at = i * m + j0;  // a multiple of 4
  if (j0 >= 0 && j0 + 4 <= m) {
    *reinterpret_cast<float4*>(out + at) =
        make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (j0 + c >= 0 && j0 + c < m) out[at + c] = v[c];
  }
}

// D > 0: the width d at compile time. D = 0: d at run time, staged CHUNK
// dimensions at a time, zero-padded to a multiple of 4 (which adds
// nothing to a squared distance) so that x1 is read 4 dimensions at a
// time.
template <int KIND, int D>
__global__ void __launch_bounds__(TX * TY, D > 0 ? 4 : 3)
dense_gram_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                  float* __restrict__ out, int n, int m, int d, int bm,
                  int col_tiles, const float* __restrict__ scal, float ls,
                  float var, float diag_add) {
  constexpr int CH = D > 0 ? D : CHUNK;
  __shared__ __align__(16) float s1[BM * CH];  // [row][dimension]
  __shared__ __align__(16) float s2[CH * XW];  // [dimension][column]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int64_t row0 = (int64_t)(blockIdx.x / col_tiles) * bm;
  const int64_t col0 = (int64_t)(blockIdx.x % col_tiles) * BN;
  const int rpt = bm / TY;
  // row0 % 4 == 0, so every row of this thread has i % 4 == ty
  const int o = ((ty & 3) * (m & 3)) & 3;
  const int64_t j0 = col0 + 4 * tx - o;
  if (scal) {
    ls = __ldg(scal);
    var = __ldg(scal + 1);
    diag_add = __ldg(scal + 2);
  }
  const float a = KIND == KIND_SE ? -0.5f / (ls * ls)
                  : (KIND == KIND_MAT32 ? 1.7320508075688772f
                                        : 2.2360679774997896f) / fabsf(ls);

  if constexpr (D > 0) {
    for (int e = tid; e < bm * D; e += TX * TY)
      s1[e] = row0 + e / D < n ? x1[row0 * D + e] : 0.0f;
    for (int e = tid; e < XW * D; e += TX * TY) {
      const int c = e / D, k = e - c * D;
      const int64_t j = col0 - 4 + c;
      s2[k * XW + c] = (j >= 0 && j < m) ? x2[j * D + k] : 0.0f;
    }
    __syncthreads();
    if (j0 >= m) return;
    float xc[4][D];
#pragma unroll
    for (int k = 0; k < D; ++k) {
      float t[4];
      pick(*reinterpret_cast<const float4*>(&s2[k * XW + 4 * tx]),
           *reinterpret_cast<const float4*>(&s2[k * XW + 4 * tx + 4]), o, t);
#pragma unroll
      for (int c = 0; c < 4; ++c) xc[c][k] = t[c];
    }
#pragma unroll 4
    for (int rr = 0; rr < rpt; ++rr) {
      const int r = ty + TY * rr;
      if (row0 + r >= n) break;
      float q[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        if (D == 1 && KIND != KIND_SE) {
          q[c] = fabsf(s1[r] - xc[c][0]);  // the distance itself, exactly
        } else {
          float d2 = 0.0f;
#pragma unroll
          for (int k = 0; k < D; ++k) {
            const float diff = s1[r * D + k] - xc[c][k];
            d2 = fmaf(diff, diff, d2);
          }
          q[c] = KIND == KIND_SE ? d2 : sqrtf(d2);
        }
      }
      store_row<KIND>(out, row0 + r, j0, m, q, a, var, diag_add);
    }
  } else {
    float acc[RPT][4];
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[rr][c] = 0.0f;
    for (int k0 = 0; k0 < d; k0 += CHUNK) {
      const int w = min(CHUNK, d - k0);
      const int w4 = (w + 3) & ~3;
      if (k0 > 0) __syncthreads();
      for (int e = tid; e < bm * w4; e += TX * TY) {
        const int r = e / w4, k = e - r * w4;
        const int64_t i = row0 + r;
        s1[r * CHUNK + k] = (i < n && k < w) ? x1[i * d + k0 + k] : 0.0f;
      }
      for (int e = tid; e < XW * w4; e += TX * TY) {
        const int k = e / XW, c = e - k * XW;
        const int64_t j = col0 - 4 + c;
        s2[e] = (j >= 0 && j < m && k < w) ? x2[j * d + k0 + k] : 0.0f;
      }
      __syncthreads();
      for (int k = 0; k < w4; k += 4) {
        float xc[4][4];  // [dimension k + kk][column]
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          pick(*reinterpret_cast<const float4*>(&s2[(k + kk) * XW + 4 * tx]),
               *reinterpret_cast<const float4*>(
                   &s2[(k + kk) * XW + 4 * tx + 4]),
               o, xc[kk]);
#pragma unroll
        for (int rr = 0; rr < RPT; ++rr) {
          if (rr < rpt) {
            const float4 xr = *reinterpret_cast<const float4*>(
                &s1[(ty + TY * rr) * CHUNK + k]);
            const float xk[4] = {xr.x, xr.y, xr.z, xr.w};
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const float diff = xk[kk] - xc[kk][c];
                acc[rr][c] = fmaf(diff, diff, acc[rr][c]);
              }
          }
        }
      }
    }
    if (j0 >= m) return;
#pragma unroll
    for (int rr = 0; rr < RPT; ++rr) {
      const int64_t i = row0 + ty + TY * rr;
      if (rr >= rpt || i >= n) break;
      float q[4];
#pragma unroll
      for (int c = 0; c < 4; ++c)
        q[c] = KIND == KIND_SE ? acc[rr][c] : sqrtf(acc[rr][c]);
      store_row<KIND>(out, i, j0, m, q, a, var, diag_add);
    }
  }
}

struct Args {
  const float* x1;
  const float* x2;
  float* out;
  int n, m, d;
  const float* scal;
  float ls, var, diag_add;
  cudaStream_t stream;
};

template <int KIND, int D>
cudaError_t launch(const Args& g) {
  const int col_tiles = (int)(((int64_t)g.m + 3 + BN - 1) / BN);
  const int bm =
      ((int64_t)g.n + BM - 1) / BM * col_tiles < MIN_BLOCKS ? BM / 2 : BM;
  const int64_t blocks = ((int64_t)g.n + bm - 1) / bm * col_tiles;
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  dense_gram_kernel<KIND, D><<<(unsigned)blocks, dim3(TX, TY), 0, g.stream>>>(
      g.x1, g.x2, g.out, g.n, g.m, g.d, bm, col_tiles, g.scal, g.ls, g.var,
      g.diag_add);
  return cudaGetLastError();
}

template <int KIND>
cudaError_t dispatch(const Args& g) {
  switch (g.d) {
    case 1: return launch<KIND, 1>(g);
    case 2: return launch<KIND, 2>(g);
    case 3: return launch<KIND, 3>(g);
    case 4: return launch<KIND, 4>(g);
    case 5: return launch<KIND, 5>(g);
    case 6: return launch<KIND, 6>(g);
    case 7: return launch<KIND, 7>(g);
    case 8: return launch<KIND, 8>(g);
    default: return launch<KIND, 0>(g);
  }
}

}  // namespace

// x1 [n, d], x2 [m, d], out [n, m]: contiguous row-major float32 on the
// device, out 16-byte aligned; any d >= 0; kind 0 SE, 1 Matern-3/2, 2
// Matern-5/2. `scal`: a device pointer to (l, var, diag_add) as 3 floats,
// or null to take ls, var and diag_add as given. Returns a cudaError_t; the
// launch is asynchronous on `stream`.
extern "C" int gpf_dense_gram(const void* x1, const void* x2, void* out, int n,
                              int m, int d, int kind, const void* scal,
                              float ls, float var, float diag_add,
                              void* stream) {
  if (n < 0 || m < 0 || d < 0) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  if (n == 0 || m == 0) return (int)cudaSuccess;
  const Args g{static_cast<const float*>(x1), static_cast<const float*>(x2),
               static_cast<float*>(out), n, m, d,
               static_cast<const float*>(scal), ls, var, diag_add,
               static_cast<cudaStream_t>(stream)};
  switch (kind) {
    case KIND_SE: return (int)dispatch<KIND_SE>(g);
    case KIND_MAT32: return (int)dispatch<KIND_MAT32>(g);
    case KIND_MAT52: return (int)dispatch<KIND_MAT52>(g);
    default: return (int)cudaErrorInvalidValue;
  }
}
