// The tile loop of the Gram·V kernels K1 (csrc/gram_matvec.cu) and K3
// (csrc/expr_matvec.cu):  out = K(x1, x2) @ V  for sm_90a, with the pair
// values made in the tensor-core operand registers and the product run on
// the tensor cores in 3xTF32. The two kernels differ only in how a pair's
// value is formed, which is the `Pair` functor this template takes:
//
//   struct Pair {
//     static constexpr int D;         // x row width
//     static constexpr int MAX_COLS;  // 256, or 128: see "Registers" below
//     __device__ void setup();        // once per thread
//     __device__ float operator()(const float* xa, const float* xb) const;
//   };
//
// What bounds it on an H100. Each (i, j) pair costs its value (K1: one
// expf; the Mauna Loa K3: three expf, one sinf and a float64 phase), the
// 3xTF32 split of it, and 3 * 2 * r tensor-core operations. At r = 1 and 9
// the evaluation and the split bound it (the special-function unit alone
// would allow 2.4 ms per expf per 1e10 pairs). At r = 256 the product
// does: 3 * 2 * n1 * n2 * r operations are 31 ms at n = 100k at the 495
// TFLOP/s of dense TF32, but mma.sync reaches about 318 TFLOP/s on one
// H100 (48 ms; tools/mma_sync_rate.py), and every warp reads each B
// fragment from shared memory itself (one 16-byte load per lane per 3
// MMAs: per 32 rows of x2 an SM spends ~4,100 cycles of shared-memory
// bandwidth on them against ~5,100 of MMAs at that rate).
//
// Design:
//   * A block of 8 warps owns 128 rows of x1 and up to MAX_COLS columns of
//     V; wider r runs in column tiles (a grid dimension). Warp w owns rows
//     16w .. 16w + 15 and loops over all of x2 in tiles of BN rows.
//   * mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 with A = K tile
//     (16 x1 rows x 8 x2 rows, one k-step), B = V slab (8 x2 rows x 8
//     columns, one n-tile). Lane (g = lane / 4, t = lane % 4) owns A
//     elements (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4): it
//     evaluates exactly those four pairs from its two x1 rows (registers)
//     and the tile's x2 rows (shared memory), and splits each value into
//     TF32 hi/lo in registers. No K tile reaches shared or device memory.
//     Each pair is evaluated once per column tile: once per launch for
//     r <= MAX_COLS.
//   * V's slab [BN, 8 * NT] arrives by cp.async two tiles ahead (rows past
//     n2 zero-filled, columns past r zeroed once and never copied), and is
//     split once per block into hi/lo TF32 halves in B-fragment order: one
//     float4 {hi(b0), hi(b1), lo(b0), lo(b1)} per lane, n-tile and k-step,
//     so a warp reads its B operands with one conflict-free 16-byte load.
//     Fragments are double-buffered: one barrier per tile, and iteration
//     `it` splits tile it + 1 while it computes tile it.
//   * 3xTF32, never 1x: hi = cvt.rna.tf32.f32(a), lo = cvt.rna.tf32.f32(a
//     - hi), written as the two integer operations cvt.rna performs on a
//     finite value (ptxas adds an infinity test to the instruction, two
//     more operations per operand). Per k-step and n-tile the partial
//     takes k_lo v_hi and k_hi v_lo, then k_hi v_hi: the small terms
//     first. The dropped k_lo v_lo term is below 2^-22 of each product.
//     mma.sync, not wgmma: wgmma would read B straight from shared memory
//     for all four warps of a warpgroup at once (a quarter of the shared-
//     memory traffic, no 16-byte loads) and run asynchronously beside the
//     pair evaluation; its 64 x N accumulator leaves no registers for the
//     per-tile partials below at N = 256.
//   * Two schedules. Narrow r (NT <= 8 n-tiles): per k-step the lane makes
//     its four pairs and runs them against every n-tile at once, a partial
//     per n-tile over a tile of BN = 64 rows (8 k-steps; the k-step loop is
//     not unrolled, which keeps the large K3 expressions in the
//     instruction cache). Wide r (NT >= 16): the tile is BN = 16 rows (2
//     k-steps); the lane holds the tile's A fragments and runs the n-tiles
//     in groups of 4, four independent MMA chains, while it makes the next
//     tile's pairs and splits the next slab between the groups' MMAs.
//   * Short chains. Each partial starts at zero per tile: 3 MMAs per
//     k-step (24 at narrow r, 6 at wide r), each adding 8 exact products,
//     then one IEEE float32 add into the running total. A total is thus
//     n2 / BN + 3 * BN / 8 steps long at most: 1,587 at n2 = 100k and
//     narrow r, 6,256 at wide r, against 12,500 for one MMA accumulator
//     over all of x2; the tensor core's own accumulation (which truncates)
//     never runs longer than one tile.
//   * Registers. At 256 columns a lane carries 128 float32 totals, both
//     tiles' A fragments (32) and a group's partials and B fragments:
//     __launch_bounds__(256, 1) lets it use 255. Long expressions (the
//     Mauna Loa composite, PER, Matern-5/2) fit there; for cheap pairs
//     ptxas schedules so far ahead that the 256-column tile spills. Those
//     take MAX_COLS = 128 and evaluate each pair twice at 128 < r <= 256:
//     K1 always (its SE at d = 1 spilled in every 256-column variant
//     tried, and two 128-column tiles ran faster than the spilling one on
//     one H100), K3 where ptxas reports a spill (ops/cuda_expr.py rebuilds
//     it). `-Xptxas -v` is printed per instantiation by chip_smoke.py,
//     which fails on a spill.
//   * Ragged edges: r is padded to a multiple of 8 with zero columns; x2
//     rows past n2 carry zero x2 and V rows (the pair value is finite at
//     x = 0, and its product with a zero V row is zero); x1 rows past n1
//     are computed on zero rows and not stored.
//
// Built with nvcc -gencode arch=compute_90a,code=sm_90a -O3 and no
// --use_fast_math (which would swap expf and division for approximations).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace gram_mma {

constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int ROWS = 16 * WARPS;  // x1 rows per block

template <int NT>
struct Tile {
  static constexpr bool NARROW = NT <= 8;  // the schedule (above)
  static constexpr int KS = NARROW ? 8 : 2;  // k-steps per tile
  static constexpr int G = NT < 4 ? NT : 4;  // n-tiles per group (wide)
  static constexpr int BN = 8 * KS;          // x2 rows per tile
  static constexpr int RP = 8 * NT;          // padded columns
  static constexpr int RS = RP + 8;          // raw row stride: conflict-free split reads
  static constexpr int RAW = BN * RS;        // floats per raw V buffer
  static constexpr int FRAG = 4 * KS * NT * 32;  // floats per fragment buffer
  static constexpr int SPLITS = KS * NT * 32 / THREADS;  // fragments per thread
  template <int D>
  static constexpr size_t bytes() {
    return sizeof(float) * (2 * RAW + 2 * FRAG + 3 * BN * D);
  }
};

// cvt.rna.tf32.f32 of a finite x: half a TF32 ulp added to the magnitude
// bits, then the 13 low bits cleared (round to nearest, ties away from
// zero)
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// x = hi + lo to ~22 bits, each a TF32 value in a .b32 register
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));  // exact difference
}

// d += A (16x8, row) * B (8x8, col), float32 accumulate
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += k v in 3xTF32, the two small terms first; b = {hi(b0), hi(b1),
// lo(b0), lo(b1)}
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], float4 b) {
  mma_tf32(d, alo, __float_as_uint(b.x), __float_as_uint(b.y));
  mma_tf32(d, ahi, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, ahi, __float_as_uint(b.x), __float_as_uint(b.y));
}

// Pair e of the four lane (g, t) owns in one k-step -- (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4) of the A tile -- from its x1 rows xa0 (g) and
// xa1 (g + 8) and the k-step's x2 row t at xb, split into hi/lo.
template <class Pair>
__device__ __forceinline__ void pair_at(const Pair& p, const float* xa0,
                                        const float* xa1, const float* xb,
                                        int e, uint32_t& hi, uint32_t& lo) {
  split_tf32(p(e % 2 ? xa1 : xa0, e / 2 ? xb + 4 * Pair::D : xb), hi, lo);
}

template <class Pair>
__device__ __forceinline__ void pairs(const Pair& p, const float* xa0,
                                      const float* xa1, const float* xb,
                                      uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) pair_at(p, xa0, xa1, xb, e, hi[e], lo[e]);
}

// cp.async of 4 or 16 bytes; with pred false the destination is zero-filled
// and nothing is read
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(pred ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Stage x2 rows j0 .. j0 + BN - 1 and the matching slab of V's columns
// c0 .. c0 + cw - 1 into shared memory, rows past n2 zero-filled. Columns
// cw .. RP - 1 of both raw buffers are zeroed once (zero_pad) and never
// copied. `vec16`: cw == RP, r % 4 == 0 and V 16-byte aligned, so rows
// go in whole float4 chunks.
template <int NT, int D>
__device__ __forceinline__ void stage(float* raw, float* xs,
                                      const float* __restrict__ x2,
                                      const float* __restrict__ V, int j0,
                                      int c0, int cw, int n2, int r,
                                      bool vec16) {
  using T = Tile<NT>;
  const int tid = threadIdx.x;
  if (vec16) {
    constexpr int CH = T::RP / 4, TOTAL = T::BN * CH;
#pragma unroll
    for (int k = 0; k < (TOTAL + THREADS - 1) / THREADS; ++k) {
      const int q = tid + k * THREADS;
      if (TOTAL % THREADS != 0 && q >= TOTAL) break;
      const int row = q / CH, cc = 4 * (q % CH);
      const bool ok = j0 + row < n2;
      cp_async16(raw + row * T::RS + cc,
                 ok ? V + (int64_t)(j0 + row) * r + c0 + cc : V, ok);
    }
  } else {
    for (int q = tid; q < T::BN * cw; q += THREADS) {
      const int row = q / cw, cc = q - row * cw;
      const bool ok = j0 + row < n2;
      cp_async4(raw + row * T::RS + cc,
                ok ? V + (int64_t)(j0 + row) * r + c0 + cc : V, ok);
    }
  }
  for (int q = tid; q < T::BN * D; q += THREADS) {
    const bool ok = j0 + q / D < n2;
    cp_async4(xs + q, ok ? x2 + (int64_t)j0 * D + q : x2, ok);
  }
  cp_async_commit();
}

template <int NT>
__device__ __forceinline__ void zero_pad(float* raw, int cw) {
  using T = Tile<NT>;
  for (int q = threadIdx.x; q < 2 * T::RAW; q += THREADS)
    if (q % T::RS >= cw) raw[q] = 0.0f;
}

// Fragment k of this thread's share of one raw V slab, split into hi/lo
// halves in B-fragment order: entry q = (ks, nt, lane) holds lane (g, t)'s
// b0 = V[8 ks + t][8 nt + g] and b1 = V[8 ks + t + 4][8 nt + g] as
// {hi(b0), hi(b1), lo(b0), lo(b1)}.
template <int NT>
__device__ __forceinline__ void split_entry(const float* rb, float4* fb, int k) {
  using T = Tile<NT>;
  const int q = threadIdx.x + k * THREADS;
  const int l = q % 32, nt = (q / 32) % NT, ks = q / (32 * NT);
  const float* src = rb + (8 * ks + l % 4) * T::RS + 8 * nt + l / 4;
  uint32_t h0, l0, h1, l1;
  split_tf32(src[0], h0, l0);
  split_tf32(src[4 * T::RS], h1, l1);
  fb[q] = make_float4(__uint_as_float(h0), __uint_as_float(h1),
                      __uint_as_float(l0), __uint_as_float(l1));
}

template <int NT>
__device__ __forceinline__ void split_slab(const float* rb, float4* fb) {
  static_assert(Tile<NT>::SPLITS * THREADS == Tile<NT>::KS * NT * 32, "split");
#pragma unroll
  for (int k = 0; k < Tile<NT>::SPLITS; ++k) split_entry<NT>(rb, fb, k);
}

template <class Pair, int NT>
__global__ void __launch_bounds__(THREADS, NT <= 4 ? 2 : 1)
gram_mma_kernel(Pair pair, const float* __restrict__ x1,
                const float* __restrict__ x2, const float* __restrict__ V,
                float* __restrict__ out, int n1, int n2, int r, bool full16) {
  using T = Tile<NT>;
  constexpr int D = Pair::D;
  constexpr int KS = T::KS;
  constexpr int BN = T::BN;
  extern __shared__ float4 smem4[];
  float* raw = reinterpret_cast<float*>(smem4);           // [2][BN][RS]
  float4* frag = smem4 + (2 * T::RAW) / 4;                // [2][KS][NT][32]
  float* xs = raw + 2 * T::RAW + 2 * T::FRAG;             // [3][BN * D]

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int t = lane % 4;
  const int64_t i0 = (int64_t)blockIdx.x * ROWS + (tid / 32) * 16 + lane / 4;
  const int64_t i1 = i0 + 8;
  const int c0 = blockIdx.y * T::RP;
  const int cw = min(T::RP, r - c0);
  const bool vec16 = full16 && cw == T::RP;

  Pair p = pair;
  p.setup();

  float xa0[D], xa1[D];
#pragma unroll
  for (int k = 0; k < D; ++k) {
    xa0[k] = i0 < n1 ? x1[i0 * D + k] : 0.0f;
    xa1[k] = i1 < n1 ? x1[i1 * D + k] : 0.0f;
  }

  float acc[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.0f;

  // Tile j's V slab is in raw buffer j % 2, its fragments in frag buffer
  // j % 2 and its x2 rows in xs buffer j % 3. Iteration `it` loads tile
  // it + 2 and splits tile it + 1 while it computes tile it (at wide r it
  // also makes tile it + 1's pairs): one barrier per tile.
  uint32_t ahi[KS][4], alo[KS][4];  // wide r: this tile's A fragments
  const int tiles = (n2 + BN - 1) / BN;
  if (tiles > 0) {
    if (cw < T::RP) zero_pad<NT>(raw, cw);
    stage<NT, D>(raw, xs, x2, V, 0, c0, cw, n2, r, vec16);
    cp_async_wait_all();
    __syncthreads();
    split_slab<NT>(raw, frag);
    if constexpr (!T::NARROW) {
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
        pairs(p, xa0, xa1, xs + (8 * ks + t) * D, ahi[ks], alo[ks]);
    }
    if (tiles > 1)
      stage<NT, D>(raw + T::RAW, xs + BN * D, x2, V, BN, c0, cw, n2, r, vec16);
  }
  for (int it = 0; it < tiles; ++it) {
    cp_async_wait_all();
    // tile it + 1 has landed and tile it's fragments are written; every
    // warp is done with tile it - 1 (its fragments, raw buffer, x2 rows)
    __syncthreads();
    if (it + 2 < tiles)
      stage<NT, D>(raw + (it % 2) * T::RAW, xs + ((it + 2) % 3) * BN * D, x2,
                   V, (it + 2) * BN, c0, cw, n2, r, vec16);
    // Tile it + 1's split (and, at wide r, its pairs) run unconditionally,
    // without a branch in the MMA stream: after the last tile they fill a
    // fragment buffer and registers that nothing reads.
    const float* rn = raw + ((it + 1) % 2) * T::RAW;
    float4* fn = frag + ((it + 1) % 2) * (T::FRAG / 4);
    const float4* fb = frag + (it % 2) * (T::FRAG / 4);
    if constexpr (T::NARROW) {
      split_slab<NT>(rn, fn);
      const float* xt = xs + (it % 3) * BN * D + t * D;
      float part[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[nt][e] = 0.0f;
#pragma unroll 1
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t khi[4], klo[4];
        pairs(p, xa0, xa1, xt + 8 * ks * D, khi, klo);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          mma3(part[nt], khi, klo, fb[(ks * NT + nt) * 32 + lane]);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] += part[nt][e];
    } else {
      const float* xn = xs + ((it + 1) % 3) * BN * D + t * D;
      uint32_t nhi[KS][4], nlo[KS][4];  // tile it + 1's A fragments
      constexpr int GROUPS = NT / T::G, PAIRS = 4 * KS;
#pragma unroll
      for (int gi = 0; gi < GROUPS; ++gi) {
        // this group's share of the next tile's split and pairs
#pragma unroll
        for (int k = gi * T::SPLITS / GROUPS; k < (gi + 1) * T::SPLITS / GROUPS; ++k)
          split_entry<NT>(rn, fn, k);
#pragma unroll
        for (int q = gi * PAIRS / GROUPS; q < (gi + 1) * PAIRS / GROUPS; ++q)
          pair_at(p, xa0, xa1, xn + 8 * (q / 4) * D, q % 4, nhi[q / 4][q % 4],
                  nlo[q / 4][q % 4]);
        float part[T::G][4];
#pragma unroll
        for (int j = 0; j < T::G; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[j][e] = 0.0f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks)
#pragma unroll
          for (int j = 0; j < T::G; ++j)
            mma3(part[j], ahi[ks], alo[ks],
                 fb[(ks * NT + gi * T::G + j) * 32 + lane]);
#pragma unroll
        for (int j = 0; j < T::G; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[gi * T::G + j][e] += part[j][e];
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ahi[ks][e] = nhi[ks][e];
          alo[ks][e] = nlo[ks][e];
        }
    }
  }

  const int c = c0 + 2 * t;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int cn = c + 8 * nt;
    if (i0 < n1) {
      if (cn < r) out[i0 * r + cn] = acc[nt][0];
      if (cn + 1 < r) out[i0 * r + cn + 1] = acc[nt][1];
    }
    if (i1 < n1) {
      if (cn < r) out[i1 * r + cn] = acc[nt][2];
      if (cn + 1 < r) out[i1 * r + cn + 1] = acc[nt][3];
    }
  }
}

template <int NT, class Pair>
cudaError_t launch_nt(const Pair& pair, const float* x1, const float* x2,
                      const float* V, float* out, int n1, int n2, int r,
                      cudaStream_t stream) {
  constexpr size_t bytes = Tile<NT>::template bytes<Pair::D>();
  if (bytes > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        gram_mma_kernel<Pair, NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return e;
  }
  const bool full16 = r % 4 == 0 && reinterpret_cast<uintptr_t>(V) % 16 == 0;
  dim3 grid((n1 + ROWS - 1) / ROWS, (r + 8 * NT - 1) / (8 * NT));
  gram_mma_kernel<Pair, NT><<<grid, THREADS, bytes, stream>>>(
      pair, x1, x2, V, out, n1, n2, r, full16);
  return cudaGetLastError();
}

// out [n1, r] = K(x1, x2) [n1, n2] @ V [n2, r]: contiguous row-major f32 on
// the device, x rows of Pair::D floats. The n-tile count follows r (the
// y-solve, the fit's CG, probes, posterior chunks); r > Pair::MAX_COLS
// runs in column tiles of MAX_COLS. Asynchronous on `stream`; returns the
// launch's error.
template <class Pair>
cudaError_t launch(const Pair& pair, const float* x1, const float* x2,
                   const float* V, float* out, int n1, int n2, int r,
                   cudaStream_t stream) {
  static_assert(Pair::MAX_COLS == 128 || Pair::MAX_COLS == 256, "MAX_COLS");
  if (n1 < 0 || n2 < 0 || r < 0) return cudaErrorInvalidValue;
  if (n1 == 0 || r == 0) return cudaSuccess;
  if (r <= 8) return launch_nt<1>(pair, x1, x2, V, out, n1, n2, r, stream);
  if (r <= 16) return launch_nt<2>(pair, x1, x2, V, out, n1, n2, r, stream);
  if (r <= 32) return launch_nt<4>(pair, x1, x2, V, out, n1, n2, r, stream);
  if (r <= 64) return launch_nt<8>(pair, x1, x2, V, out, n1, n2, r, stream);
  if constexpr (Pair::MAX_COLS == 256) {
    if (r > 128) return launch_nt<32>(pair, x1, x2, V, out, n1, n2, r, stream);
  }
  return launch_nt<16>(pair, x1, x2, V, out, n1, n2, r, stream);
}

}  // namespace gram_mma
