// The tile loop of the low-rank-VJP kernels K2 (csrc/lowrank_vjp.cu) and K4
// (csrc/expr_vjp.cu) for sm_90a: per-tile sums
//
//   s_q = sum_ij (U W^T)_ij * f_q(x1_i, x2_j),   q = 0 .. P-1
//
// over one pass of the (i, j) pairs, with the cotangent tile U W^T made on
// the tensor cores in 3xTF32 and consumed in the accumulator registers:
// neither K nor U W^T reaches device memory. The two kernels differ only
// in what a pair adds to the sums, the `Pair` functor this template takes:
//
//   struct Pair {
//     static constexpr int D;           // x row width (0: runtime, below)
//     static constexpr int P;           // sums per pair
//     static constexpr bool ROLLED;     // epilogue loop: see "Epilogue"
//     __device__ void setup();          // once per thread
//     __device__ void operator()(const float* xa, const float* xb, float cot,
//                                double (&s)[P]) const;  // s_q += cot * f_q
//   };
//
// A pair of a kernel that depends on x only through the squared distance
// may instead take its width at run time: D = 0, a member `int d`, and
//     __device__ void from_d2(float d2, float cot, double (&s)[P]) const;
// in place of operator() (K2's SE at d > 8; see wide_epilogue).
//
// What bounds it on an H100. The cotangent tile is a rank-r product:
// 2 * n1 * n2 * r multiply-adds (5.46e12 at n = 100k, r = 2s + m + 1 = 273),
// 3x that in 3xTF32: 33 ms at the 495 TFLOP/s of dense TF32, ~51 ms at the
// ~320 TFLOP/s mma.sync reaches on one H100 (tools/mma_sync_rate.py). The
// epilogue adds one evaluation of the pair per (i, j): K2's SE one expf
// (2.4 ms per 1e10 pairs on the special-function unit), the Mauna Loa K4
// 4 special-function calls, a float64 phase and 7 derivatives (~250
// instructions a pair, ~75 ms of instructions at 1e10 pairs). The bytes (U and
// W once, 0.22 GB) are far below either. K2 runs at about 2.5x the
// mma.sync bound of its product (PERF.md, section 6); what holds the rest
// (the next chunks' copies and split in the loop, the fragment reads from
// shared memory, the partials' adds, 8 warps an SM) is not separated.
//
// Design:
//   * A block of 8 warps owns one [128, 128] tile of pairs: rows i0 ..
//     i0 + 127 of x1 and U, rows j0 .. j0 + 127 of x2 and W. Warp w owns
//     the 32 x 64 warp tile at rows 32 (w % 4), columns 64 (w / 4): 2 x 8
//     m16n8 fragments, 64 float32 accumulators per lane, which are the
//     cotangent tile itself -- no per-tile partials over x2, since the
//     reduction axis is r.
//   * mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 with A = U's rows
//     (row-major [n1, r] is the `row` operand) and B = W's rows (row-major
//     [n2, r] is the `col` operand): cot_ij = sum_k U_ik W_jk needs no
//     transpose.
//   * U's and W's chunks of BK = 16 of their r columns (2 k-steps) arrive
//     by cp.async, two copies of 4 columns each per thread: one 16-byte
//     copy where r % 4 == 0 and U, W are 16-byte aligned, else (a ragged
//     r: its rows are not 16-byte aligned) four 4-byte ones, which are
//     slower (PERF.md, section 5), so the NLL
//     makes its factors at a width that is a multiple of 4
//     (models/iterative.py, cotangent_factor); rows past n and columns
//     past r zero-filled. U and W are read as they are. Each chunk is split once per block into TF32
//     hi/lo halves in fragment order (gram_mma.cuh's split: cvt.rna as its
//     two integer operations): per m16 tile, k-step and lane a float4 of
//     A's hi and one of its lo; per n8 tile, k-step and lane one float4
//     {hi(b0), hi(b1), lo(b0), lo(b1)}, so every operand read is one
//     conflict-free 16-byte load, 12 per 48 MMAs. Raw chunks and fragments
//     are double-buffered: one barrier per chunk; iteration `it`
//     multiplies chunk it and, between the MMAs of its first k-step,
//     splits chunk it + 1 and starts the copies of chunk it + 2.
//   * 3xTF32, never one pass: per k-step and fragment u_lo w_hi, then
//     u_hi w_lo, then u_hi w_hi (gram_mma::mma3). A product is represented
//     to ~3 * 2^-22; the dropped u_lo w_lo term is below 2^-22 of it. The
//     three MMAs go into a partial that starts at zero, which one IEEE
//     float32 add puts into the accumulator: the tensor core's own
//     accumulation truncates, and with all 105 MMAs of r = 273 in one
//     accumulator a streamed fit step's variance gradient (card test
//     test_streamed_fit_step_runs_k2_once) came out at 5.81 against the
//     materialised 5.63. Per k-step it spans 3 MMAs, and the totals take
//     35 rounded adds where the SIMT tile this replaces ran a 273-long FMA
//     chain. A chunk's second k-step runs only where it holds a column
//     below r.
//   * Epilogue: on the C-fragment layout, lane (g, t) owns rows g and
//     g + 8 and columns 2t and 2t + 1 of each fragment; its x1 and x2 rows
//     come from shared memory (staged with the first chunk). Each lane
//     sums cot * f_q over its 64 pairs in float64 (one double add a sum
//     and pair), then a fixed-order xor shuffle and one thread per q over
//     the 8 warps, also in float64, and stores the tile's sums as float32:
//     no atomics. The wrapper sums the per-tile slots in float64. ROLLED =
//     false (K2 at d = 1, a dozen operations a pair): the pairs are
//     unrolled over the accumulator registers. ROLLED = true (K2 at d > 1,
//     whose unrolled x rows would not fit in registers, and K4's
//     generated expressions, a few hundred instructions a pair): each lane
//     parks its fragments in shared memory (the fragment buffers, free by
//     then) and walks them in a loop of 4 pairs, which keeps the code
//     small and frees the accumulator registers for the evaluation. The
//     pair's constants (setup) are made after the loop. D = 0 (K2's SE
//     at d > 8): the squared distances are summed over chunks of 32
//     dimensions staged in the raw buffers, then evaluated in place.
//   * Registers and occupancy: one block an SM, up to 255 registers a
//     thread. Two blocks an SM (one's epilogue beside the other's MMAs)
//     need <= 128 registers, and every warp shape tried in development
//     spilled there with the k-step partials. chip_smoke.py prints every
//     instantiation's registers and fails on a spill.
//   * mma.sync, not wgmma: a throwaway wgmma probe (m64n128k8 per
//     warpgroup, both operands from shared memory in the no-swizzle
//     K-major layout, the same split and partials) held every check but
//     ran K2 slower than this loop on one H100 (ROADMAP.md, section 2).
//   * Order of the tiles: blocks walk the [n1 / 128, n2 / 128] grid of
//     tiles in groups of 16 tile rows, down a group's rows first, so the
//     blocks resident at once read a few tiles of U and W, and W (109 MB at
//     n = 100k, r = 273) is read from device memory about n1 / 2048 times,
//     not once per tile row.
//   * Padded pairs: x rows past n are zero and U, W rows past n are zero,
//     so their cotangent is exactly zero and they add exactly nothing (the
//     pair's f_q is finite at x = 0).
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 and no
// --use_fast_math (which would swap expf and division for approximations).

#pragma once

#include <limits.h>

#include "gram_mma.cuh"

namespace lowrank_mma {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int TILE = 128;            // pair tile edge, rows of x1 and of x2
constexpr int BK = 16;               // r columns per chunk
constexpr int KS = BK / 8;           // k-steps per chunk
constexpr int STAGES = 2;            // raw chunks in shared memory
constexpr int WM = 32;               // warp tile rows
constexpr int WN = 64;               // warp tile columns
constexpr int MT = WM / 16;          // m16 fragments per warp tile
constexpr int NT = WN / 8;           // n8 fragments per warp tile
constexpr int WARPS_M = TILE / WM;   // warps down the tile's rows
static_assert(WARPS_M * (TILE / WN) == WARPS, "warp tiles cover the tile");
constexpr int COPIES = TILE * BK / 4 / THREADS;  // 4-column copies per operand
constexpr int RS = BK + 4;           // raw row stride: conflict-free split reads
constexpr int RAW = TILE * RS;       // floats per raw operand buffer
constexpr int A_ENTRIES = KS * (TILE / 16) * 32;  // float4s of A hi (or lo)
constexpr int B_ENTRIES = KS * (TILE / 8) * 32;   // float4s of B
constexpr int FRAG = 2 * A_ENTRIES + B_ENTRIES;   // float4s per fragment stage
constexpr int GROUP = 16;            // tile rows per group of the tile order
static_assert(WARPS * MT * NT * 32 == 2 * FRAG, "the epilogue parks its "
              "fragments in the two fragment stages");
static_assert(A_ENTRIES % THREADS == 0 && B_ENTRIES % THREADS == 0, "split");

template <class Pair>
constexpr size_t smem_bytes() {
  return sizeof(float) * (STAGES * 2 * RAW + 2 * 4 * FRAG + 2 * TILE * Pair::D) +
         sizeof(double) * Pair::P * WARPS;
}

// This thread's COPIES copies of 4 columns of one operand's chunk: rows
// row + k * THREADS / 4 of the operand (row = r0 + threadIdx.x / 4),
// columns 4 (threadIdx.x % 4) .. + 3 of the chunk. VEC (r % 4 == 0 and U,
// W 16-byte aligned): each is one 16-byte copy; otherwise (a ragged r,
// whose rows are not 16-byte aligned) four 4-byte ones. A template
// parameter, not a flag: a run-time choice in the loop made K2 slower
// (PERF.md, section 5).
template <bool VEC>
struct Copies {
  int row;
  __device__ __forceinline__ explicit Copies(int64_t r0)
      : row(static_cast<int>(r0) + threadIdx.x / 4) {}
  // copy k of chunk c0 of M [n, r] into raw [TILE][RS], rows past n and
  // columns past r (every column of a chunk past the last) zero-filled
  __device__ __forceinline__ void copy(float* raw, const float* M, int n,
                                       int r, int c0, int k) const {
    const int dr = k * (THREADS / 4), col = 4 * (threadIdx.x % 4);
    float* dst = raw + (threadIdx.x / 4 + dr) * RS + col;
    if constexpr (VEC) {
      const bool ok = row + dr < n && c0 + col < r;
      gram_mma::cp_async16(dst, ok ? M + (int64_t)(row + dr) * r + c0 + col : M,
                           ok);
    } else {
      const float* src = M + (int64_t)(row + dr) * r + c0 + col;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool ok = row + dr < n && c0 + col + e < r;
        gram_mma::cp_async4(dst + e, ok ? src + e : M, ok);
      }
    }
  }
  __device__ __forceinline__ void stage(float* raw, const float* M, int n,
                                        int r, int c0) const {
#pragma unroll
    for (int k = 0; k < COPIES; ++k) copy(raw, M, n, r, c0, k);
  }
};
static_assert(COPIES * THREADS * 4 == TILE * BK, "whole 4-column copies");

// This thread's share of one chunk, split into hi/lo TF32 fragments:
// A entry q = (ks, m16 tile, lane (g, t)) holds U rows g, g + 8 and
// columns t, t + 4 of the tile's k-step ks as {a0, a1, a2, a3} (hi at q,
// lo at A_ENTRIES + q); B entry q = (ks, n8 tile, lane) holds W row g at
// columns t and t + 4 as {hi(b0), hi(b1), lo(b0), lo(b1)}. Entry k of
// SPLIT_A (SPLIT_B) per thread is q = threadIdx.x + k * THREADS: warp w's
// lanes take the m16 (n8) tile w + WARPS * k, wrapped into the next k-step,
// so every address is a per-thread base plus a constant.
constexpr int SPLIT_A = A_ENTRIES / THREADS;
constexpr int SPLIT_B = B_ENTRIES / THREADS;
static_assert((TILE / 16) % WARPS == 0 && (TILE / 8) % WARPS == 0, "split");

__device__ __forceinline__ void split_a(const float* ru, float4* f, int k) {
  constexpr int PER_KS = TILE / 16 / WARPS;  // entries per k-step
  const int q = threadIdx.x + k * THREADS;
  const int l = threadIdx.x % 32, w = threadIdx.x / 32;
  const float* src = ru + (16 * (w + WARPS * (k % PER_KS)) + l / 4) * RS +
                     8 * (k / PER_KS) + l % 4;
  uint32_t h[4], lo[4];
  gram_mma::split_tf32(src[0], h[0], lo[0]);
  gram_mma::split_tf32(src[8 * RS], h[1], lo[1]);
  gram_mma::split_tf32(src[4], h[2], lo[2]);
  gram_mma::split_tf32(src[8 * RS + 4], h[3], lo[3]);
  f[q] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]),
                     __uint_as_float(h[2]), __uint_as_float(h[3]));
  f[A_ENTRIES + q] = make_float4(__uint_as_float(lo[0]), __uint_as_float(lo[1]),
                                 __uint_as_float(lo[2]), __uint_as_float(lo[3]));
}

__device__ __forceinline__ void split_b(const float* rw, float4* f, int k) {
  constexpr int PER_KS = TILE / 8 / WARPS;
  const int q = threadIdx.x + k * THREADS;
  const int l = threadIdx.x % 32, w = threadIdx.x / 32;
  const float* src = rw + (8 * (w + WARPS * (k % PER_KS)) + l / 4) * RS +
                     8 * (k / PER_KS) + l % 4;
  uint32_t h0, l0, h1, l1;
  gram_mma::split_tf32(src[0], h0, l0);
  gram_mma::split_tf32(src[4], h1, l1);
  f[2 * A_ENTRIES + q] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                                     __uint_as_float(l0), __uint_as_float(l1));
}

__device__ __forceinline__ void split_chunk(const float* ru, const float* rw,
                                            float4* f) {
#pragma unroll
  for (int k = 0; k < SPLIT_A; ++k) split_a(ru, f, k);
#pragma unroll
  for (int k = 0; k < SPLIT_B; ++k) split_b(rw, f, k);
}

// cp.async.wait_group: at most N of this thread's copy groups in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// This block's tile (ti, tj): groups of GROUP tile rows, down a group's
// rows first.
__device__ __forceinline__ void tile_of(int n1, int n2, int& ti, int& tj) {
  const int tiles_i = (n1 + TILE - 1) / TILE, tiles_j = (n2 + TILE - 1) / TILE;
  const int grp = blockIdx.x / (GROUP * tiles_j);
  const int first = grp * GROUP;
  const int rows = min(GROUP, tiles_i - first);
  const int local = blockIdx.x - grp * GROUP * tiles_j;
  ti = first + local % rows;
  tj = local / rows;
}

// The four pairs of fragment (mt, nt) lane (g, t) owns, added to s.
template <class Pair>
__device__ __forceinline__ void fragment_pairs(const Pair& p, const float* xs1,
                                               const float* xs2, int wm, int wn,
                                               int mt, int nt, float c0, float c1,
                                               float c2, float c3,
                                               double (&s)[Pair::P]) {
  constexpr int D = Pair::D;
  const int lane = threadIdx.x % 32;
  const float* xa0 = xs1 + (WM * wm + 16 * mt + lane / 4) * D;
  const float* xa1 = xa0 + 8 * D;
  const float* xb0 = xs2 + (WN * wn + 8 * nt + 2 * (lane % 4)) * D;
  const float* xb1 = xb0 + D;
  p(xa0, xb0, c0, s);
  p(xa0, xb1, c1, s);
  p(xa1, xb0, c2, s);
  p(xa1, xb1, c3, s);
}

// The epilogue at a runtime width (Pair::D == 0, the pair's member d: K2's
// SE at d > 8). The squared distances of the lane's 64 pairs are summed in
// registers over chunks of DC dimensions, each chunk's x1 and x2 rows
// staged in the raw buffers (free by then) at a stride of DC + 1 floats
// (conflict-free reads), in the order the fixed-width pairs sum them;
// then each pair is evaluated from its squared distance and its
// cotangent, still in the accumulator registers.
constexpr int DC = 32;          // dimensions per chunk
constexpr int XSW = DC + 1;     // row stride of a staged chunk
static_assert(2 * TILE * XSW <= STAGES * 2 * RAW, "chunks fit the raw buffers");

template <class Pair>
__device__ __forceinline__ void wide_epilogue(
    const Pair& p, float* raw, const float* __restrict__ x1,
    const float* __restrict__ x2, int n1, int n2, int64_t i0, int64_t j0,
    int wm, int wn, const float (&acc)[MT][NT][4], double (&s)[Pair::P]) {
  const int tid = threadIdx.x, lane = tid % 32;
  float d2[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) d2[mt][nt][e] = 0.0f;
  float* xs1 = raw;
  float* xs2 = raw + TILE * XSW;
  cp_async_wait<0>();  // the loop's last copies (of spent chunks) are done
#pragma unroll 1
  for (int c0 = 0; c0 < p.d; c0 += DC) {
    __syncthreads();  // every warp is done with the buffers
    for (int q = tid; q < TILE * DC; q += THREADS) {
      const int row = q / DC, col = c0 + q % DC;
      const bool in = col < p.d;
      xs1[row * XSW + q % DC] =
          in && i0 + row < n1 ? x1[(i0 + row) * p.d + col] : 0.0f;
      xs2[row * XSW + q % DC] =
          in && j0 + row < n2 ? x2[(j0 + row) * p.d + col] : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < DC; ++k) {
      float a[MT][2], b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* ra = xs1 + (WM * wm + 16 * mt + lane / 4) * XSW + k;
        a[mt][0] = ra[0];
        a[mt][1] = ra[8 * XSW];
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float* rb = xs2 + (WN * wn + 8 * nt + 2 * (lane % 4)) * XSW + k;
        b[nt][0] = rb[0];
        b[nt][1] = rb[XSW];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float diff = a[mt][e / 2] - b[nt][e % 2];
            d2[mt][nt][e] = fmaf(diff, diff, d2[mt][nt][e]);
          }
    }
  }
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) p.from_d2(d2[mt][nt][e], acc[mt][nt][e], s);
}

template <class Pair, bool VEC>
__global__ void __launch_bounds__(THREADS, 1)
lowrank_mma_kernel(Pair pair, const float* __restrict__ x1,
                   const float* __restrict__ x2, const float* __restrict__ U,
                   const float* __restrict__ W, float* __restrict__ partial,
                   int n1, int n2, int r) {
  constexpr int D = Pair::D;
  constexpr int P = Pair::P;
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);    // [STAGES][U, W][TILE][RS]
  float4* frag = smem4 + STAGES * RAW / 2;         // [2 stages][FRAG]
  float* xs1 = reinterpret_cast<float*>(frag + 2 * FRAG);  // [TILE][D]
  float* xs2 = xs1 + TILE * D;                     // [TILE][D]
  double* red = reinterpret_cast<double*>(xs2 + TILE * D);  // [P][WARPS]

  int ti, tj;
  tile_of(n1, n2, ti, tj);
  const int64_t i0 = (int64_t)ti * TILE, j0 = (int64_t)tj * TILE;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;

  // Chunk c's raw U and W are in raw stage c % STAGES, its fragments in
  // fragment stage c % 2; each chunk's copies are one cp.async group.
  const int chunks = (r + BK - 1) / BK;
  const Copies<VEC> cu(i0), cw(j0);
  if constexpr (D > 0) {
    for (int q = tid; q < TILE * D; q += THREADS) {
      const bool ok1 = i0 + q / D < n1, ok2 = j0 + q / D < n2;
      gram_mma::cp_async4(xs1 + q, ok1 ? x1 + i0 * D + q : x1, ok1);
      gram_mma::cp_async4(xs2 + q, ok2 ? x2 + j0 * D + q : x2, ok2);
    }
  }
#pragma unroll
  for (int c = 0; c < STAGES; ++c) {
    cu.stage(raw + c * 2 * RAW, U, n1, r, c * BK);
    cw.stage(raw + c * 2 * RAW + RAW, W, n2, r, c * BK);
    gram_mma::cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();
  __syncthreads();
  split_chunk(raw, raw + RAW, frag);
  static_assert(SPLIT_A <= NT && SPLIT_B <= NT && COPIES <= NT,
                "the next chunks' split and copies ride on k-step 0's n-tiles");
#pragma unroll 1
  for (int it = 0; it < chunks; ++it) {
    cp_async_wait<STAGES - 2>();
    // chunk it + 1 has landed and chunk it's fragments are written; every
    // warp is done with chunk it - 1 (its fragments and raw buffers)
    __syncthreads();
    // Between the MMAs of k-step 0: the split of chunk it + 1 and the
    // copies of chunk it + STAGES into chunk it's raw stage,
    // unconditionally (no branch in the MMA stream): past the last chunk
    // the split fills a fragment buffer that nothing reads, and the copies
    // zero-fill a raw buffer that is spent.
    float* rs = raw + (it % STAGES) * 2 * RAW;
    const float* rn = raw + ((it + 1) % STAGES) * 2 * RAW;
    float4* fn = frag + ((it + 1) % 2) * FRAG;
    const int c2 = (it + STAGES) * BK;
    const float4* fa = frag + (it % 2) * FRAG;
    const float4* fb = fa + 2 * A_ENTRIES;
    const bool second = r - it * BK > 8;  // the chunk's k-step 1 holds a column
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks > 0 && !second) break;
      uint32_t ahi[MT][4], alo[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int q = (ks * (TILE / 16) + MT * wm + mt) * 32 + lane;
        const float4 h = fa[q], l = fa[A_ENTRIES + q];
        ahi[mt][0] = __float_as_uint(h.x);
        ahi[mt][1] = __float_as_uint(h.y);
        ahi[mt][2] = __float_as_uint(h.z);
        ahi[mt][3] = __float_as_uint(h.w);
        alo[mt][0] = __float_as_uint(l.x);
        alo[mt][1] = __float_as_uint(l.y);
        alo[mt][2] = __float_as_uint(l.z);
        alo[mt][3] = __float_as_uint(l.w);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float4 b = fb[(ks * (TILE / 8) + NT * wn + nt) * 32 + lane];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          float part[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          gram_mma::mma3(part, ahi[mt], alo[mt], b);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[e];
        }
        if (ks == 0) {
          if (nt < SPLIT_A) split_a(rn, fn, nt);
          if (nt < SPLIT_B) split_b(rn + RAW, fn, nt);
          if (nt < COPIES) {
            cu.copy(rs, U, n1, r, c2, nt);
            cw.copy(rs + RAW, W, n2, r, c2, nt);
          }
        }
      }
    }
    gram_mma::cp_async_commit();
  }

  // the pair's constants are made here, not before the loop: nothing but
  // the accumulators and the copy addresses lives across it
  Pair p = pair;
  p.setup();
  double s[P];
#pragma unroll
  for (int q = 0; q < P; ++q) s[q] = 0.0;
  if constexpr (D == 0) {
    wide_epilogue(p, raw, x1, x2, n1, n2, i0, j0, wm, wn, acc, s);
  } else if constexpr (!Pair::ROLLED) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        fragment_pairs(p, xs1, xs2, wm, wn, mt, nt, acc[mt][nt][0],
                       acc[mt][nt][1], acc[mt][nt][2], acc[mt][nt][3], s);
  } else {
    __syncthreads();  // every warp is done with the fragment buffers
    float4* park = frag + warp * MT * NT * 32;
#pragma unroll
    for (int f = 0; f < MT * NT; ++f)
      park[f * 32 + lane] = make_float4(acc[f / NT][f % NT][0], acc[f / NT][f % NT][1],
                                        acc[f / NT][f % NT][2], acc[f / NT][f % NT][3]);
    // each lane reads back only what it wrote: no barrier
#pragma unroll 1
    for (int f = 0; f < MT * NT; ++f) {
      const float4 c = park[f * 32 + lane];
      fragment_pairs(p, xs1, xs2, wm, wn, f / NT, f % NT, c.x, c.y, c.z, c.w, s);
    }
  }

#pragma unroll
  for (int q = 0; q < P; ++q) {
    double v = s[q];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
    if (lane == 0) red[q * WARPS + warp] = v;
  }
  __syncthreads();
  if (tid < P) {
    double total = 0.0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) total += red[tid * WARPS + w];
    tile_of(n1, n2, ti, tj);  // again: not held in registers across the loop
    partial[((int64_t)ti * ((n2 + TILE - 1) / TILE) + tj) * P + tid] =
        static_cast<float>(total);
  }
}

template <class Pair, bool VEC>
cudaError_t launch_as(const Pair& pair, const float* x1, const float* x2,
                      const float* U, const float* W, float* partial, int n1,
                      int n2, int r, unsigned blocks, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<Pair>();
  cudaError_t e = cudaFuncSetAttribute(lowrank_mma_kernel<Pair, VEC>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(bytes));
  if (e != cudaSuccess) return e;
  lowrank_mma_kernel<Pair, VEC><<<blocks, THREADS, bytes, stream>>>(
      pair, x1, x2, U, W, partial, n1, n2, r);
  return cudaGetLastError();
}

// partial [ceil(n1 / TILE) * ceil(n2 / TILE), Pair::P] receives each
// tile's sums, row-tile major, from x1 [n1, D], x2 [n2, D] (D = pair.d
// when Pair::D is 0), U [n1, r], W [n2, r]: contiguous row-major f32 on
// the device. Asynchronous on `stream`; returns the launch's error.
template <class Pair>
cudaError_t launch(const Pair& pair, const float* x1, const float* x2,
                   const float* U, const float* W, float* partial, int n1,
                   int n2, int r, cudaStream_t stream) {
  static_assert(Pair::P <= THREADS, "one thread per sum in the final reduction");
  if (n1 <= 0 || n2 <= 0 || r <= 0) return cudaErrorInvalidValue;
  const int64_t blocks = (int64_t)((n1 + TILE - 1) / TILE) * ((n2 + TILE - 1) / TILE);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const bool vec16 = r % 4 == 0 && reinterpret_cast<uintptr_t>(U) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(W) % 16 == 0;
  return vec16 ? launch_as<Pair, true>(pair, x1, x2, U, W, partial, n1, n2, r,
                                       static_cast<unsigned>(blocks), stream)
               : launch_as<Pair, false>(pair, x1, x2, U, W, partial, n1, n2, r,
                                        static_cast<unsigned>(blocks), stream);
}

}  // namespace lowrank_mma
