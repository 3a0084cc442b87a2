// Fixed-order sums of the E-step statistics, shared by fused_fb.cu,
// split_fb.cu and duplex_fb.cu: acc (K, K) and eacc (K, F) are sums over
// every (t, b) of the batch, taken by many blocks, and the sums across
// blocks run in an order that depends on the shapes only, never on timing,
// so a call gives the same bits every time on one card.
//
// Two ways in:
//   * the kernels for K <= 64 keep a block's share in registers and write it
//     to a partial (one row of `part` a block); sum_partials_kernel then adds
//     the rows in block order;
//   * the kernels for K > 64 cannot hold a column of acc a thread (K floats
//     beside the rest), so they write the statistics' two operands a step
//     instead (the gated d_t n_t and w_t gamma_t), a window of time steps at
//     a time (WideStats), and outer_sum() forms sum_n X[n] (x) Y[n] over the
//     window's (t, b) rows as a tiled product on the tensor cores (3xTF32,
//     below): a chunk of rows a block, rows in order inside it, the chunks'
//     partials added in chunk order to what the windows before gave. The
//     windows and chunks follow from the shapes alone, and the scratch from
//     (B, K, F), not T.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <climits>

#include "fb_common.cuh"

namespace fbs {

constexpr int SUM_NT = 256;  // threads of sum_partials_kernel
constexpr int SUM_UNROLL = 16;  // loads a thread keeps in flight

// out[e] = part[0][e] + part[1][e] + ... + part[n-1][e], in that order, for
// e < len (0 when n = 0), added to out[e]'s own value first when `add`; part
// is (n, len) row-major. Of internal linkage, as the other kernels here
// that are not templates, so that two translation units of one library
// (fused_fb.cu and fused_fb_modes.cu) may both include this header.
static __global__ void __launch_bounds__(SUM_NT)
sum_partials_kernel(const float* __restrict__ part, int n, int len, bool add,
                    float* __restrict__ out) {
  const int e = blockIdx.x * SUM_NT + threadIdx.x;
  if (e >= len) return;
  const float* p = part + e;
  float v = add ? out[e] : 0.f;
  int i = 0;
  for (; i + SUM_UNROLL <= n; i += SUM_UNROLL) {
    float x[SUM_UNROLL];
#pragma unroll
    for (int u = 0; u < SUM_UNROLL; ++u) x[u] = p[(size_t)(i + u) * len];
#pragma unroll
    for (int u = 0; u < SUM_UNROLL; ++u) v += x[u];
  }
  for (; i < n; ++i) v += p[(size_t)i * len];
  out[e] = v;
}

inline cudaError_t sum_partials(const float* part, int n, int len, float* out, cudaStream_t st,
                                bool add = false) {
  if (len <= 0) return cudaSuccess;
  sum_partials_kernel<<<(len + SUM_NT - 1) / SUM_NT, SUM_NT, 0, st>>>(part, n, len, add, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The outer sums, on the tensor cores at 3xTF32.
//
// outer_sum() forms part[c] = X[chunk c]^T Y[chunk c] for row-major X (N, I)
// and Y (N, J): the large-K statistics acc = sum outer(a_{t-1}, dn_t) and
// eacc = sum outer(gw_t, f_t). The JAX kernels take the same sums on the
// matrix unit (pysvihmm_tpu/messages/pallas_fb.py:664 `outer_acc`, used at
// :678 in _bwd_kernel_fused; pallas_duplex.py:233-260 in _combine_kernel) at
// their "bf16x3" tier, three passes over hi / lo split operands
// (pallas_fb.py:241). Here the counterpart is 3xTF32: each float x splits
// into big = tf32(x) and small = tf32(x - big) (to nearest), and
// mma.sync.m16n8k8 adds small.big + big.small, then big.big, into float32
// accumulators, as CUTLASS's OpMultiplyAddFastF32 orders them. A tf32 part
// keeps 11 significant bits against bf16's 8.
//
// What bounds it on this card: at K = 256, B = 1024, T = 1000, F = 45 the
// sums read 3.33 GB and do 3 x 157.7 GFLOP of TF32 products, 0.99 ms of
// bytes and 0.96 ms at the 495 TFLOP/s TF32 peak, so both; but that peak is
// wgmma's, and wgmma takes TF32 operands K-major only, where these are
// M- and N-major (the contraction runs over the rows n of row-major X and
// Y). mma.sync takes them as loaded, at a lower peak, and each mma needs
// its operands' split, loads and sums issued beside it, so issue slots and
// the mma pipe set the pace together. The design:
//   * output tiles of 128 x 128 (J > 64; 8 warps of 64 x 32, 4 x 4 mma
//     tiles) or 128 x 64 (J <= 64, eacc; 8 warps of 32 x 32), one block an
//     SM, so each split of an operand feeds 2 to 4 mma a pass and K = 256
//     reads each row of acc's operands twice;
//   * a ring of OSTAGES stages of ON rows in shared memory filled by
//     cp.async (16 bytes where a row pitch and the base are 16-byte aligned,
//     4 bytes elsewhere: K = 65 or 129, F = 45), the loads of stage s + 3 in
//     flight while stage s is multiplied; rows as loaded, xs[n][i] and
//     ys[n][j], the row pitch 8 words past a multiple of 32, so that the
//     fragment reads (lane g = lane / 4, t = lane % 4: A xs[t][g], xs[t][g +
//     8], xs[t + 4][g], xs[t + 4][g + 8]; B ys[t][g], ys[t + 4][g]) are free
//     of bank conflicts;
//   * the split in four integer and float operations a value, not cvt;
//   * the tensor cores' float32 sums truncate, so each step of 8 rows (its
//     three passes) starts a fresh mma sum, which is then added into a
//     second set of registers by FADD, in step order: on operands of one
//     sign the truncation would otherwise bias the sums by a few 1e-7.
// A fixed order: the chunks follow from (N, I, J) alone (OUTER_BLOCKS is a
// constant, not the card's SM count), a block takes its rows in stage order,
// and sum_partials adds the chunks' partials in chunk order, so the sums are
// the same bits on every call and whatever produced the same operands.

constexpr int ON = 32;             // rows a stage
constexpr int OSTAGES = 4;         // stages in the ring
constexpr int OUTER_BLOCKS = 132;  // blocks a product aims at (one an SM on an H100; a
                                   // constant, so the chunks do not depend on the card)

// An output tile of WI x WJ warps, each a patch of MT x NTL mma tiles (16
// rows of i by 8 columns of j each).
template <int WI, int WJ, int MT, int NTL>
struct OuterTile {
  static constexpr int MI = 16 * MT, MJ = 8 * NTL;   // a warp's patch
  static constexpr int TI = MI * WI, TJ = MJ * WJ;   // the tile
  static constexpr int NT = 32 * WI * WJ;            // threads
  static constexpr int M = MT, N = NTL;
  static constexpr int PX = TI + 8, PY = TJ + 8;     // row pitches, 8 mod 32 words
  static constexpr int STAGE = ON * (PX + PY);       // floats a stage
  static constexpr int SMEM = OSTAGES * STAGE * 4;   // bytes of the ring
  static_assert(PX % 32 == 8 && PY % 32 == 8, "conflict-free fragment reads");
};
using WideTile = OuterTile<2, 4, 4, 4>;    // 128 x 128 (64 x 32 a warp), for J > 64
using NarrowTile = OuterTile<4, 2, 2, 4>;  // 128 x 64 (32 x 32 a warp), for J <= 64 (eacc)

// V floats (1 or 4) from src to shared dst, zeros where !valid (src is then
// not read).
template <int V>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 4 * V : 0;
  if constexpr (V == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

// 4 bytes from src to shared dst, of which the first `bytes` (0, 2 or 4)
// are read and the rest zero-filled; src 4-byte aligned.
__device__ __forceinline__ void cp_async_n(float* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// x to tf32, to nearest (ties away from zero) on the magnitude's bits: what
// cvt.rna.tf32.f32 gives for finite x, in two integer operations (ptxas
// expands that cvt into four on sm_90a, an add, a compare, a select and a
// mask).
__device__ __forceinline__ unsigned tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small to about 2^-22 relative, both tf32 (their bits as b32);
// x - big is exact in float32.
__device__ __forceinline__ void split_tf32(float x, unsigned& big, unsigned& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// c += a b on one m16n8k8 tile (A row-major 16 x 8, B column-major 8 x 8).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One operand's share of a stage: W columns of ON rows, V floats a copy, Q
// copies a row, the block's NT threads R rows at a time. A thread's copies
// sit at one column c0 of rows r0, r0 + R, ...: the row offsets in global
// and shared memory are a constant stride apart, so a copy costs a multiply
// and a compare beside the cp.async.
template <int NT, int W, int V, int P>
struct Slab {
  static constexpr int Q = W / V, R = NT / Q;
  static_assert(NT % Q == 0 && ON % R == 0, "whole rows a pass");
  int r0, c0;
  bool col_ok;

  __device__ Slab(int origin, int width) : r0(threadIdx.x / Q), c0((threadIdx.x % Q) * V) {
    col_ok = origin + c0 < width;
  }

  // The stage whose first row is src (at the tile's first column), `rows`
  // of its ON rows in the chunk, into dst (the slab in shared memory).
  __device__ __forceinline__ void copy(float* dst, const float* src, int ld, int rows) const {
#pragma unroll
    for (int k = 0; k < ON / R; ++k) {
      const int r = r0 + k * R;
      const bool ok = col_ok && r < rows;
      cp_async<V>(dst + r * P + c0, ok ? src + (long long)r * ld + c0 : src, ok);
    }
  }
};

// part[c][i][j] = sum over the rows n of chunk c, in order, of X[n][i] Y[n][j],
// for X (N, I) and Y (N, J) row-major; one tile of (i, j) a block. VX and VY
// are the floats a copy of X and Y moves (4: rows and bases 16-byte aligned).
template <class Tile, int VX, int VY>
__global__ void __launch_bounds__(Tile::NT, 1)
outer_partial_kernel(const float* __restrict__ X, const float* __restrict__ Y, long long N,
                     int I, int J, long long chunk, float* __restrict__ part) {
  constexpr int WI = Tile::TI / Tile::MI, MT = Tile::M, NTL = Tile::N;
  extern __shared__ __align__(16) float ring[];
  const int i0 = blockIdx.x * Tile::TI, j0 = blockIdx.y * Tile::TJ;
  const long long n0 = (long long)blockIdx.z * chunk;
  const int rows = static_cast<int>((n0 + chunk < N ? chunk : N - n0));  // the chunk's
  const int stages = (rows + ON - 1) / ON;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, t = lane % 4;
  const int ib = (warp % WI) * Tile::MI, jb = (warp / WI) * Tile::MJ;  // the warp's patch
  // a patch wholly outside (I, J) skips the products; a patch in part
  // outside multiplies the zeros the copies put there (a guard a tile costs
  // more, in registers, than the products it saves)
  const bool idle = I - i0 - ib <= 0 || J - j0 - jb <= 0;
  const Slab<Tile::NT, Tile::TI, VX, Tile::PX> xslab(i0, I);
  const Slab<Tile::NT, Tile::TJ, VY, Tile::PY> yslab(j0, J);
  const float* xc = X + n0 * I + i0;  // the chunk's first row, at the tile's columns
  const float* yc = Y + n0 * J + j0;
  auto load = [&](int s) {
    float* xs = ring + (s % OSTAGES) * Tile::STAGE;
    xslab.copy(xs, xc + (long long)s * ON * I, I, rows - s * ON);
    yslab.copy(xs + ON * Tile::PX, yc + (long long)s * ON * J, J, rows - s * ON);
  };

  float sum[MT][NTL][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[m][n][e] = 0.f;

#pragma unroll
  for (int s = 0; s < OSTAGES - 1; ++s) {
    if (s < stages) load(s);
    cp_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_wait<OSTAGES - 2>();  // stage s has landed (this thread's copies)
    __syncthreads();         // everyone's, and the slot of stage s - 1 is free
    if (s + OSTAGES - 1 < stages) load(s + OSTAGES - 1);
    cp_commit();
    if (idle) continue;
    const float* xs = ring + (s % OSTAGES) * Tile::STAGE + ib + g;
    const float* ys = ring + (s % OSTAGES) * Tile::STAGE + ON * Tile::PX + jb + g;
#pragma unroll
    for (int k = 0; k < ON / 8; ++k) {  // a step of 8 rows
      const int r0 = 8 * k + t, r1 = r0 + 4;
      unsigned ab[MT][4], as[MT][4], bb[NTL][2], bs[NTL][2];
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        split_tf32(xs[r0 * Tile::PX + 16 * m], ab[m][0], as[m][0]);
        split_tf32(xs[r0 * Tile::PX + 16 * m + 8], ab[m][1], as[m][1]);
        split_tf32(xs[r1 * Tile::PX + 16 * m], ab[m][2], as[m][2]);
        split_tf32(xs[r1 * Tile::PX + 16 * m + 8], ab[m][3], as[m][3]);
      }
#pragma unroll
      for (int n = 0; n < NTL; ++n) {
        split_tf32(ys[r0 * Tile::PY + 8 * n], bb[n][0], bs[n][0]);
        split_tf32(ys[r1 * Tile::PY + 8 * n], bb[n][1], bs[n][1]);
      }
      float c[MT][NTL][4];
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NTL; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) c[m][n][e] = 0.f;
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NTL; ++n) mma_tf32(c[m][n], as[m], bb[n]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NTL; ++n) mma_tf32(c[m][n], ab[m], bs[n]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NTL; ++n) mma_tf32(c[m][n], ab[m], bb[n]);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int n = 0; n < NTL; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sum[m][n][e] += c[m][n][e];
    }
  }

  // c[e] of tile (m, n): row g (e < 2) or g + 8, column 2t + e % 2
  float* pc = part + (size_t)blockIdx.z * I * J;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NTL; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + ib + 16 * m + g + (e < 2 ? 0 : 8);
        const int j = j0 + jb + 8 * n + 2 * t + e % 2;
        if (i < I && j < J) pc[(size_t)i * J + j] = sum[m][n][e];
      }
}

// How outer_sum cuts N rows: `chunks` blocks of `chunk` rows along N for each
// output tile (0 chunks for N = 0). chunks <= want, the most the scratch
// holds: want * chunk >= stages * ON >= N.
struct OuterPlan {
  long long chunk;
  int chunks;
};

// The tile that takes J columns: 128 x 64 up to 64 (eacc), else 128 x 128.
inline bool narrow_tile(int J) { return J <= NarrowTile::TJ; }

constexpr int OUTER_WAVE_I = 257;  // the fewest columns of X whose chunks fit one wave

// Chunks wanted along N: OUTER_BLOCKS blocks over the output tiles, at most
// one a stage of ON rows. Up to 256 columns of X the chunks are rounded up,
// which where the tiles do not divide 132 leaves a short second wave of
// blocks (one block an SM); from OUTER_WAVE_I (the XL tiers' acc and eacc)
// they are rounded down to fit one wave: at K = 512 the 16 tiles of acc
// then take 8 chunks, not 9 (144 blocks, a second wave of 12), which took
// the outer sums of one backward at B = 1024, T = 1000 from 18.35 to 10.89
// ms (11.73 in torch.matmul; at K = 1024 54.18 to 40.22) on an NVIDIA H100
// 80GB HBM3 at 700 W (chip_smoke.py phase 17, PERF.md). The widths up to
// 256 keep their chunks so that their sums keep their bits, not for speed:
// rounding down was level or faster at every width timed
// (scripts/time_outer.py), and one rule for all widths is left to a change
// that re-checks those widths' digests (ROADMAP).
inline long long outer_want(long long N, int I, int J) {
  const int ti = narrow_tile(J) ? NarrowTile::TI : WideTile::TI;
  const int tj = narrow_tile(J) ? NarrowTile::TJ : WideTile::TJ;
  const long long tiles = (long long)((I + ti - 1) / ti) * ((J + tj - 1) / tj);
  const long long stages = (N + ON - 1) / ON;
  long long want = I >= OUTER_WAVE_I ? std::max<long long>(1, OUTER_BLOCKS / tiles)
                                     : (OUTER_BLOCKS + tiles - 1) / tiles;
  if (want > stages) want = stages;
  return want > 65535 ? 65535 : want;
}

inline OuterPlan outer_plan(long long N, int I, int J) {
  if (N <= 0) return {0, 0};
  const long long want = outer_want(N, I, J);
  const long long chunk = ((N + ON - 1) / ON + want - 1) / want * ON;
  return {chunk, static_cast<int>((N + chunk - 1) / chunk)};
}

// Floats of scratch outer_sum needs for any N' <= N rows (want grows with N).
inline long long outer_scratch(long long N, int I, int J) {
  return N <= 0 ? 0 : outer_want(N, I, J) * I * J;
}

// Launches of outer_partial_kernel by this library since the count was last
// cleared: one a call of outer_sum with rows (the library exports it); and
// of the operand kernels below, build_feats_kernel [0], widen_kernel [1] and
// ll_tile_kernel, its 64-state tile [2] and its 128-state one [3], one a
// call of build_feats, widen or ll_tile with rows.
// Inline, so that the translation units of one library share one count, and
// hidden from the library's exports, so that each library keeps its own.
#define FBS_LIBRARY_LOCAL __attribute__((visibility("hidden")))
FBS_LIBRARY_LOCAL inline long long outer_launch_count = 0;
FBS_LIBRARY_LOCAL inline long long prep_launch_count[4] = {0, 0, 0, 0};
#undef FBS_LIBRARY_LOCAL

// The count, cleared when `clear` (each library exports this).
inline int outer_launches(bool clear) {
  const long long n = outer_launch_count;
  if (clear) outer_launch_count = 0;
  return static_cast<int>(n);
}

template <class Tile, int VX, int VY>
cudaError_t outer_launch(const float* X, const float* Y, long long N, int I, int J,
                         const OuterPlan& p, float* part, cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(outer_partial_kernel<Tile, VX, VY>);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       Tile::SMEM);
  if (e != cudaSuccess) return e;
  const dim3 grid((I + Tile::TI - 1) / Tile::TI, (J + Tile::TJ - 1) / Tile::TJ, p.chunks);
  outer_partial_kernel<Tile, VX, VY><<<grid, Tile::NT, Tile::SMEM, st>>>(X, Y, N, I, J,
                                                                          p.chunk, part);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++outer_launch_count;
  return e;
}

// 16-byte copies need every row start and the base on 16 bytes.
inline bool rows_of_16_bytes(const float* p, int cols) {
  return cols % 4 == 0 && reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// out (I, J) = sum_n X[n] (x) Y[n] over N rows, in the fixed order above,
// added to out's own value when `add`; part holds outer_scratch(N, I, J)
// floats. The copies' width does not change a bit of the result.
inline cudaError_t outer_sum(const float* X, const float* Y, long long N, int I, int J,
                             float* part, float* out, bool add, cudaStream_t st) {
  const OuterPlan p = outer_plan(N, I, J);
  if (p.chunks > 0) {
    const bool vx = rows_of_16_bytes(X, I);
    const cudaError_t e =
        narrow_tile(J)
            ? (vx ? outer_launch<NarrowTile, 4, 1>(X, Y, N, I, J, p, part, st)
                  : outer_launch<NarrowTile, 1, 1>(X, Y, N, I, J, p, part, st))
            : (vx && rows_of_16_bytes(Y, J) ? outer_launch<WideTile, 4, 4>(X, Y, N, I, J, p, part, st)
                                            : outer_launch<WideTile, 1, 1>(X, Y, N, I, J, p, part, st));
    if (e != cudaSuccess) return e;
  }
  return sum_partials(part, p.chunks, I * J, out, st, add);
}

constexpr long long WIDE_ROWS = 1 << 17;  // (t, b) rows a window of the large-K statistics
constexpr int PREP_NT = 256;              // threads of the operand kernels below

// out (rows, F) = the built features of the observation rows obs (rows, D)
// (fbc::feat_of: the same float32 bits as the chain kernels' rows and
// ell_features', each product one __fmul_rn). It replaces the TPU kernels'
// _build_feats (pysvihmm_tpu/messages/pallas_fb.py:287) where the large-K
// fused backward, the K <= 64 fused WF backward's window tier and the
// duplex combine need a window's rows in device memory for the outer sums.
//
// What bounds it on this card: bytes, 4 (D + F) a row against F - 1 - D
// multiplies (0.0045 ms on the SVI step's window of 71,680 rows at D = 8,
// F = 45; 0.134 ms on a window of 2^17 rows at D = 39, F = 820). The design:
// a block walks chunks of bf_rows(F) rows (about BF_ELEMS features, 16 KB of
// output) over a grid sized to the card; each chunk's observations are
// loaded once into shared memory, by cp.async a chunk ahead (two slots), and
// each feature's factors come from a table of F (i, j) entries the block
// makes once, so no element searches for its pair. A thread writes four
// consecutive features with one 16-byte store (the chunk's head before the
// first 16-byte boundary of out and its tail after the last whole vector a
// feature a thread): it reads the first one's entry and walks to the next
// three (bf_next), and its cursor (row and feature in the chunk, 32-bit)
// moves 4 PREP_NT features a step by an addition, with no division past
// the first. Only the chunk's base is 64-bit.
constexpr int BF_ELEMS = 4096;       // features a chunk of rows aims at
constexpr int BF_BLOCKS_PER_SM = 8;  // the build's grid: blocks an SM at most

// Rows a chunk at F features.
__host__ __device__ inline int bf_rows(int F) { return F >= BF_ELEMS ? 1 : BF_ELEMS / F; }

// Bytes of build_feats_kernel's dynamic shared memory at (D, F): the table
// and two slots of a chunk's observations.
inline int bf_smem(int D, int F) { return 4 * (F + 2 * bf_rows(F) * D); }

// The entry (ia, ja) of feature f + 1 from feature f's in ell_features'
// order (fbc::feat_src), moving to the next row's feature 0 past F - 1.
template <int KIND>
__device__ __forceinline__ void bf_next(int& f, int& r, int& ia, int& ja, int F, int D) {
  if (++f == F) {
    f = 0;
    ++r;
    ia = ja = -1;
  } else if (f <= D) {
    ia = f - 1;
    ja = -1;
  } else if (KIND == fbc::FEATS_NIG) {
    ia = ja = f - 1 - D;
  } else if (f == D + 1) {
    ia = ja = 0;
  } else if (++ja == D) {  // the next row of triu(y y^T)
    ja = ++ia;
  }
}

__device__ __forceinline__ float bf_value(const float* y, int ia, int ja) {
  return ia < 0 ? 1.f : fbc::feat_of(y[ia], ja < 0 ? 0.f : y[ja], ja >= 0);
}

template <int KIND>
__global__ void __launch_bounds__(PREP_NT)
build_feats_kernel(const float* __restrict__ obs, float* __restrict__ out, long long rows, int D,
                   int F) {
  extern __shared__ __align__(16) float bf_smem_[];
  const int R = bf_rows(F), tid = threadIdx.x;
  int* tab = reinterpret_cast<int*>(bf_smem_);  // F entries, (ia + 1) | (ja + 1) << 16
  float* ybuf = bf_smem_ + F;                   // two slots of R D observations
  for (int f = tid; f < F; f += PREP_NT) {
    int ia, ja;
    fbc::feat_src(KIND, D, f, ia, ja);
    tab[f] = (ia + 1) | ((ja + 1) << 16);
  }
  const long long chunks = (rows + R - 1) / R;
  const int sr = 4 * PREP_NT / F, sf = 4 * PREP_NT - sr * F;  // a step's rows and features
  auto ask = [&](long long c, int slot) {  // chunk c's observations into the slot
    if (c < chunks) {
      const long long r0 = c * R;
      const int nd = static_cast<int>(rows - r0 < R ? rows - r0 : R) * D;
      const float* y = obs + r0 * D;
      float* dst = ybuf + slot * R * D;
      for (int i = tid; i < nd; i += PREP_NT) cp_async<1>(dst + i, y + i, true);
    }
    cp_commit();
  };
  int slot = 0;
  ask(blockIdx.x, 0);
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x, slot ^= 1) {
    ask(c + gridDim.x, slot ^ 1);
    cp_wait<1>();     // this thread's copies of chunk c have landed
    __syncthreads();  // everyone's (and the table)
    const long long r0 = c * R;
    const int n = static_cast<int>(rows - r0 < R ? rows - r0 : R) * F;  // the chunk's features
    const float* ys = ybuf + slot * R * D;
    float* o = out + r0 * F;
    const int head =
        min(n, static_cast<int>((16 - (reinterpret_cast<unsigned long long>(o) & 15)) & 15) / 4);
    const int nv = (n - head) / 4, tail = head + 4 * nv;
    auto one = [&](int l) {  // feature l of the chunk alone
      const int r = l / F, f = l - r * F, e = tab[f];
      o[l] = bf_value(ys + r * D, (e & 0xffff) - 1, (e >> 16) - 1);
    };
    if (tid < head) one(tid);
    if (tid < n - tail) one(tail + tid);
    if (tid < nv) {
      int r = (head + 4 * tid) / F, f = head + 4 * tid - r * F;
      for (int v = tid; v < nv; v += PREP_NT) {
        int rr = r, ff = f;
        const int e = tab[ff];
        int ia = (e & 0xffff) - 1, ja = (e >> 16) - 1;
        float x[4];
        x[0] = bf_value(ys + rr * D, ia, ja);
#pragma unroll
        for (int q = 1; q < 4; ++q) {
          bf_next<KIND>(ff, rr, ia, ja, F, D);
          x[q] = bf_value(ys + rr * D, ia, ja);
        }
        *reinterpret_cast<float4*>(o + head + 4 * v) = make_float4(x[0], x[1], x[2], x[3]);
        f += sf;
        r += sr;
        if (f >= F) {
          f -= F;
          ++r;
        }
      }
    }
    __syncthreads();  // the slot read by every thread before its next copies
  }
  cp_wait<0>();
}

// out[e] = a16[e] widened to float32, e < n: exact, so every bit is the
// twin's (.to(torch.float32)). Bound by bytes (2 read and 4 written a value;
// 54 MB, 0.0162 ms at 3.35 TB/s, on the main path's window of 69 x 1024
// rows of 128). Each thread widens eight values at a time, one 16-byte load
// and two 16-byte stores (four 8-byte or eight 4-byte ones where out is
// offset otherwise from a16, which the launcher reads off the pointers:
// `ow` floats a store), over a grid sized to the card and strided across
// the vectors; the values before the first 16-byte boundary of a16 (the
// head: WideStats passes alpha16 + (ta - 1) B K, which is not on 16 bytes
// when B K is not a multiple of 8) and those after the last whole vector
// (the tail) take a thread each.
static __global__ void __launch_bounds__(PREP_NT)
widen_kernel(const __nv_bfloat16* __restrict__ a16, float* __restrict__ out, long long n,
             int head, int ow) {
  const long long nv = (n - head) / 8;  // whole vectors after the head
  const long long tail = head + 8 * nv;
  const long long id = (long long)blockIdx.x * PREP_NT + threadIdx.x;
  const long long stride = (long long)gridDim.x * PREP_NT;
  if (id < head) out[id] = __bfloat162float(a16[id]);
  if (id < n - tail) out[tail + id] = __bfloat162float(a16[tail + id]);
  const uint4* src = reinterpret_cast<const uint4*>(a16 + head);
  float* dst = out + head;
  for (long long v = id; v < nv; v += stride) {
    const uint4 u = __ldg(src + v);
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
    float x[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of its float32
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
    float* o = dst + 8 * v;
    if (ow == 4) {
      reinterpret_cast<float4*>(o)[0] = make_float4(x[0], x[1], x[2], x[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(x[4], x[5], x[6], x[7]);
    } else if (ow == 2) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        reinterpret_cast<float2*>(o)[i] = make_float2(x[2 * i], x[2 * i + 1]);
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = x[i];
    }
  }
}

constexpr int WIDEN_BLOCKS_PER_SM = 8;  // the widening's grid: blocks an SM at most (2,048 threads)

inline unsigned prep_blocks(long long n) { return static_cast<unsigned>((n + PREP_NT - 1) / PREP_NT); }

// The window's eacc operand built from the observations (kind FEATS_NIW or
// FEATS_NIG), rows (t, b) of obs (rows, D) into out (rows, F).
template <int KIND>
cudaError_t build_feats_launch(const float* obs, float* out, long long rows, int D, int F,
                               cudaStream_t st) {
  const void* fn = reinterpret_cast<const void*>(build_feats_kernel<KIND>);
  const int smem = bf_smem(D, F);
  cudaError_t e = cudaSuccess;
  if (smem > 48 * 1024)  // past the default a block may take (F above about 12,000)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long chunks = (rows + bf_rows(F) - 1) / bf_rows(F);
  const unsigned grid =
      static_cast<unsigned>(std::min<long long>(chunks, (long long)sms * BF_BLOCKS_PER_SM));
  build_feats_kernel<KIND><<<grid, PREP_NT, smem, st>>>(obs, out, rows, D, F);
  return cudaGetLastError();
}

inline cudaError_t build_feats(int kind, const float* obs, float* out, long long rows, int D,
                               int F, cudaStream_t st) {
  if (rows <= 0) return cudaSuccess;
  const cudaError_t e = kind == fbc::FEATS_NIW
                            ? build_feats_launch<fbc::FEATS_NIW>(obs, out, rows, D, F, st)
                            : build_feats_launch<fbc::FEATS_NIG>(obs, out, rows, D, F, st);
  if (e == cudaSuccess) ++prep_launch_count[0];
  return e;
}

inline cudaError_t widen(const __nv_bfloat16* a16, float* out, long long n, cudaStream_t st) {
  if (n <= 0) return cudaSuccess;
  const unsigned long long pa = reinterpret_cast<unsigned long long>(a16);
  const long long head = std::min<long long>(n, ((16 - pa % 16) % 16) / 2);
  const unsigned long long po = reinterpret_cast<unsigned long long>(out + head);
  const int ow = po % 16 == 0 ? 4 : po % 8 == 0 ? 2 : 1;
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long need = std::max<long long>(prep_blocks((n - head) / 8), 1);
  const unsigned grid =
      static_cast<unsigned>(std::min<long long>(need, (long long)sms * WIDEN_BLOCKS_PER_SM));
  widen_kernel<<<grid, PREP_NT, 0, st>>>(a16, out, n, static_cast<int>(head), ow);
  e = cudaGetLastError();
  if (e == cudaSuccess) ++prep_launch_count[1];
  return e;
}

// ---------------------------------------------------------------------------
// The likelihood tile of the fused and duplex pairs' WF instances: out (N,
// K) = X (N, F) . W (F, K), W row-major, X the feature rows of N (t, b)
// rows: the array's, or for a built kind (fbc::FEATS_NIW, FEATS_NIG) each feature
// built from the raw observation rows (N, D) where it is staged (fbc::
// feat_of: ell_features' float32 bits). It is the ll half of the TPU's
// fused kernels, where ll is one tile matmul of a block of steps
// (pysvihmm_tpu/messages/pallas_fb.py:516 _fwd_kernel_fused, :577
// _bwd_kernel_fused; their pallas_calls :958, :1060 are the chains'): the
// forward up to K = 64 sums the likelihoods of all T steps with it, above
// K = 64 those of each window of fbs::WideStats::window(T, B) steps, and its
// chain reads them as the split forward does (fbseq::seq_forward's ll mode,
// fbw::seqs_forward without FEATS); the backward above K = 64 sums those of
// each window of its statistics (fbs::WideStats), read by
// fbw::seqs_backward's LL chain. The duplex pair sums those of all T B rows
// once an E-step, and both its chain and its combine read them
// (duplex_fb.cu). The chains thus keep F products a state and step off
// their serial path.
//
// Each element is the chains' own sum (the fused K <= 64 WF backward's tiled
// tier sums ll_t the same way): over f = 0 .. 4 ceil(F / 4) - 1 (zero beyond F) in blocks of
// 64 features, each block's fmaf chain from zero in feature order, the
// blocks added in order; so lik_t is the fused kernels' own bits and every output theirs.
// Any schedule that keeps each element's order gives these bits; tensor
// cores (TF32 operands, another order of sums) would not.
//
// What bounds it on this card: 2 N K F flops in float32 FFMA against 4 (N F
// + F K + N K) bytes. At K = 256, F = 66 on a window of 2^17 rows, 4.4 GFLOP
// (0.066 ms at 67 TFLOP/s) against 168 MB (0.050 ms at 3.35 TB/s): the FMA
// pipe, with the output's 134 MB written beside it. At K = 64 over all T B
// = 1,024,000 rows, 532 MB (0.159 ms) against 8.6 GFLOP (0.129 ms): device
// memory.
//
// The design: a register-blocked SGEMM tile of BM rows by BN states (BN =
// 64 up to K = 64, else 128), 256 threads each computing 8 rows by 8 states
// (two groups of 4 states BN / 2 apart, so that a warp's float4 reads of W
// are free of bank conflicts), so that every float4 of X or of W read from
// shared memory feeds 32 FMAs; both the 64-feature block being summed
// (`part`) and the running total (`tot`) stay in registers (128 of them,
// one block an SM). Persistent blocks (one an SM) walk the tiles, the
// states' tiles of a row tile on neighbouring blocks; each block's (tile,
// chunk of BK features) items form one sequence, which a ring of ST slots
// in shared memory stages ST - 1 items ahead by cp.async (X transposed, its
// row pitch 4 words past BM, 4 bytes a copy, so that any 4-byte-aligned
// base and any F take the same path; W's chunk beside it). So the next
// tile's first chunks arrive while this tile's last ones and its stores
// run. The cursors over the items move by increments: a division a tile,
// none an item. A built kind's features are built where its chunk is
// staged, from the raw rows loaded by the block's threads (no cp.async: the
// products need the values). Measured on the H100 against other plans of
// this tile (rows and states a thread, stages, chunk, the loop's unrolling,
// totals in shared memory and two blocks an SM; PERF.md): BM = 256
// and 3 stages of 16 features, fully unrolled, at BN = 64; BM = 128 and 4
// stages of 32, a loop over groups of 4, at BN = 128.
template <int BN>
struct LtPlan {
  static constexpr int NT = 256;                // threads a block
  static constexpr int SX = BN / 8;             // threads across the states
  static constexpr int BM = 8 * (NT / SX);      // rows a tile
  static constexpr int XP = BM + 4;             // the pitch of X's transposed rows
  static constexpr int GS = BN / 2;             // states between a thread's two groups
  static constexpr int ST = BN == 64 ? 3 : 4;  // slots in the ring
  static constexpr int BK = BN == 64 ? 16 : 32; // features an item
  static constexpr bool K4 = BN != 64;          // an item's features as a loop over groups of 4
  static constexpr int XL = BM * BK / NT, WL = BK * BN / NT;  // copies a thread an item
  static constexpr int STAGE = BK * (XP + BN);  // floats a slot
  static constexpr int SMEM = 4 * ST * STAGE;   // bytes of the ring
};
constexpr int LT_BLK = 64;  // features a block of ll's sum (fbc::FMAX)

// The tile's states a block at K states.
__host__ __device__ constexpr int lt_bn(int K) { return K <= 64 ? 64 : 128; }

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <int KIND, int BN>
__global__ void __launch_bounds__(LtPlan<BN>::NT, 1)
ll_tile_kernel(const float* __restrict__ X, const float* __restrict__ W, float* __restrict__ out,
               long long N, int F, int K, int D, bool vec) {
  using P = LtPlan<BN>;
  constexpr int NT = P::NT, BM = P::BM, XP = P::XP, BK = P::BK, ST = P::ST;
  constexpr int XR = NT / BK, WR = NT / BN;  // rows (features) between a thread's X (W) copies
  constexpr bool BUILT = KIND != fbc::FEATS_ARRAY;
  extern __shared__ __align__(16) float lt_smem_[];
  const int tid = threadIdx.x, tx = tid % P::SX, ty = tid / P::SX;
  const int fend = 4 * ((F + 3) / 4);  // the chains' padded end
  const int chunks = (fend + BK - 1) / BK;
  const int col_tiles = (K + BN - 1) / BN;
  // 32-bit counters (the launcher refuses more tiles): 64-bit ones cost the
  // item loop its time
  const int tiles = static_cast<int>((N + BM - 1) / BM) * col_tiles;
  const int b0 = blockIdx.x, nb = gridDim.x;
  const int mine = tiles > b0 ? (tiles - 1 - b0) / nb + 1 : 0;
  const int items = mine * chunks;  // this block's (tile, chunk) pairs, in order
  // this thread's copies: X rows xrow + XR q (feature xf of each), W rows
  // wf + WR q (state wn of each)
  const int xrow = tid / BK, xf = tid % BK, wf = tid / BN, wn = tid % BN;
  const int in_w = BUILT ? D : F;  // floats of an input row

  // The fill cursor: the next item to stage, its tile's rows and states.
  int f_tile = b0, f_c = 0, f_slot = 0, x_rows = 0;
  const float* xt = nullptr;  // row r0 + xrow of the tile
  const float* wt = nullptr;  // W[wf][n0 + wn]
  bool w_ok = false;
  auto f_start = [&]() {
    const int rt = f_tile / col_tiles, n0 = (f_tile - rt * col_tiles) * BN;
    const long long left = N - (long long)rt * BM - xrow;
    xt = X + ((long long)rt * BM + xrow) * in_w;
    x_rows = static_cast<int>(left < BM ? left : BM);
    wt = W + (size_t)wf * K + n0 + wn;
    w_ok = n0 + wn < K;
  };
  auto fill = [&]() {
    float* xs = lt_smem_ + f_slot * P::STAGE;
    float* ws = xs + BK * XP;
    const int f0 = f_c * BK;
#pragma unroll
    for (int q = 0; q < P::WL; ++q) {
      const bool ok = f0 + wf + q * WR < F && w_ok;
      fbs::cp_async<1>(ws + (wf + q * WR) * BN + wn, ok ? wt + (size_t)(f0 + q * WR) * K : W,
                       ok);
    }
    const int f = f0 + xf;
    if constexpr (BUILT) {  // the features of this thread's rows, built where staged
      int ia = -1, ja = -1;
      if (f < F) fbc::feat_src(KIND, D, f, ia, ja);
#pragma unroll
      for (int q = 0; q < P::XL; ++q) {
        const float* y = xt + (size_t)q * XR * D;
        float v = 0.f;
        if (f < F && q * XR < x_rows)
          v = ia < 0 ? 1.f : fbc::feat_of(y[ia], ja < 0 ? 0.f : y[ja], ja >= 0);
        xs[xf * XP + xrow + q * XR] = v;
      }
    } else {
#pragma unroll
      for (int q = 0; q < P::XL; ++q) {
        const bool ok = f < F && q * XR < x_rows;
        fbs::cp_async<1>(xs + xf * XP + xrow + q * XR, ok ? xt + (size_t)q * XR * F + f : X, ok);
      }
    }
    if (++f_slot == ST) f_slot = 0;
    if (++f_c == chunks) {
      f_c = 0;
      f_tile += nb;
      f_start();
    }
  };

  f_start();
  for (int p = 0; p < ST - 1; ++p) {
    if (p < items) fill();
    fbs::cp_commit();
  }
  int c_tile = b0, c_c = 0, c_slot = 0;  // the compute cursor
  float part[8][8], tot[8][8];
  for (int i = 0; i < items; ++i) {
    fbs::cp_wait<ST - 2>();  // this thread's copies of item i have landed
    __syncthreads();         // everyone's (and a built kind's stores); item i - 1's slot is free
    if (i + ST - 1 < items) fill();
    fbs::cp_commit();
    const int f0 = c_c * BK, kk_end = min(BK, fend - f0);
    if (f0 % LT_BLK == 0) {
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[r][j] = 0.f;
    }
    const float* xp = lt_smem_ + c_slot * P::STAGE + ty * 8;
    const float* wp = lt_smem_ + c_slot * P::STAGE + BK * XP + tx * 4;
    auto step = [&](int kk) {  // feature f0 + kk of the 8 rows and 8 states
      const float4 xa = ld4(xp + kk * XP), xb = ld4(xp + kk * XP + 4);
      const float4 wa = ld4(wp + kk * BN), wb = ld4(wp + kk * BN + P::GS);
      const float x[8] = {xa.x, xa.y, xa.z, xa.w, xb.x, xb.y, xb.z, xb.w};
      const float w[8] = {wa.x, wa.y, wa.z, wa.w, wb.x, wb.y, wb.z, wb.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[r][j] = fmaf(x[r], w[j], part[r][j]);
    };
    if constexpr (P::K4) {  // kk_end is a multiple of 4
#pragma unroll 1
      for (int k4 = 0; k4 < kk_end; k4 += 4) {
#pragma unroll
        for (int d = 0; d < 4; ++d) step(k4 + d);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        if (kk % 4 == 0 && kk >= kk_end) break;
        step(kk);
      }
    }
    const bool last = c_c + 1 == chunks;
    if ((f0 + BK) % LT_BLK == 0 || last) {  // a block's end: into the total
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          tot[r][j] = f0 < LT_BLK ? part[r][j] : tot[r][j] + part[r][j];
    }
    if (last) {  // the tile's end: its rows out
      const int rt = c_tile / col_tiles, n0 = (c_tile - rt * col_tiles) * BN;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const long long row = (long long)rt * BM + ty * 8 + r;
        if (row >= N) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int n = n0 + P::GS * h + tx * 4;
          float* o = out + row * K + n;
          if (vec && n + 3 < K) {
            *reinterpret_cast<float4*>(o) =
                make_float4(tot[r][4 * h], tot[r][4 * h + 1], tot[r][4 * h + 2], tot[r][4 * h + 3]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (n + j < K) o[j] = tot[r][4 * h + j];
          }
        }
      }
      c_c = 0;
      c_tile += nb;
    } else {
      ++c_c;
    }
    if (++c_slot == ST) c_slot = 0;
  }
  fbs::cp_wait<0>();
}

template <int KIND, int BN>
cudaError_t ll_tile_launch(const float* X, const float* W, float* out, long long N, int F, int K,
                           int D, bool vec, cudaStream_t st) {
  using P = LtPlan<BN>;
  const void* fn = reinterpret_cast<const void*>(ll_tile_kernel<KIND, BN>);
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const long long tiles = (N + P::BM - 1) / P::BM * ((K + BN - 1) / BN);
  if (tiles > INT_MAX) return cudaErrorInvalidValue;
  const unsigned grid =
      static_cast<unsigned>(std::max<long long>(1, std::min<long long>(tiles, sms)));
  ll_tile_kernel<KIND, BN><<<grid, P::NT, P::SMEM, st>>>(X, W, out, N, F, K, D, vec);
  return cudaGetLastError();
}

template <int BN>
cudaError_t ll_tile_of(int kind, const float* X, const float* W, float* out, long long N, int F,
                       int K, int D, bool vec, cudaStream_t st) {
  switch (kind) {
    case fbc::FEATS_NIW: return ll_tile_launch<fbc::FEATS_NIW, BN>(X, W, out, N, F, K, D, vec, st);
    case fbc::FEATS_NIG: return ll_tile_launch<fbc::FEATS_NIG, BN>(X, W, out, N, F, K, D, vec, st);
    default: return ll_tile_launch<fbc::FEATS_ARRAY, BN>(X, W, out, N, F, K, D, vec, st);
  }
}

// The likelihood tile over N rows (none for N = 0) of src: the feature
// array (N, F), or the raw observation rows (N, D) of a built kind; one
// launch, counted.
inline cudaError_t ll_tile(const float* src, const float* W, float* out, long long N, int F,
                           int K, int kind, cudaStream_t st) {
  if (N <= 0) return cudaSuccess;
  const bool vec = K % 4 == 0 && reinterpret_cast<unsigned long long>(out) % 16 == 0;
  const int D = fbc::obs_dim(kind, F);
  const cudaError_t e = lt_bn(K) == 64 ? ll_tile_of<64>(kind, src, W, out, N, F, K, D, vec, st)
                                       : ll_tile_of<128>(kind, src, W, out, N, F, K, D, vec, st);
  if (e == cudaSuccess) ++prep_launch_count[lt_bn(K) == 64 ? 2 : 3];
  return e;
}

// The count of build_feats_kernel (which = 0), widen_kernel (1) or
// ll_tile_kernel's 64- (2) or 128-state tile (3), cleared when `clear` (the
// fused, duplex and split libraries export this; the fused and duplex ones
// launch the last two).
inline int prep_launches(int which, bool clear) {
  long long& c = prep_launch_count[which < 0 || which > 3 ? 0 : which];
  const long long n = c;
  if (clear) c = 0;
  return static_cast<int>(n);
}

// The large-K statistics, a window of time steps at a time. For the steps
// t0 <= t < t1 of a window the kernel (the backward or the duplex combine)
// writes dn_t (the gated d_t n_t, t >= 1) and, with emission statistics
// (F > 0), gw_t = w_t gamma_t, (t1 - t0, B, K) each, at the head of the
// scratch buffer; the window's outer products are then added to acc = sum
// over t >= 1 of outer(a_{t-1}, dn_t) and eacc = sum over t of outer(gw_t,
// f_t). The windows hold `steps` steps (WIDE_ROWS / B, at least 1), the last
// one first: the backward's order, and it carries b'_{t0-1} from a window to
// the next in `carry` (B, K). So the scratch takes 2 WIDE_ROWS K floats at
// most (2 B K where B > WIDE_ROWS) beside the carry and the partials,
// whatever T. Two operands may not lie in device memory as the sums read
// them, and are then made a window at a time into the scratch before its
// sums: alpha stored as bf16 (`abf`) is widened to float32 for acc, and
// with a built feature kind (fbc::FEATS_NIW, FEATS_NIG; `kind`) eacc's
// feature rows are built from the observations (build_feats), the rows the
// chain kernels build, so the sums see the array mode's operands bit for bit.
//
// With `lls` (the fused backward at F > FMAX: above K = 64, and up to it in
// the WF window tier) the scratch holds a window's likelihoods too (n K
// floats, `ll`), which the caller's `prep` sums from the window's feature
// rows (built first, for a built kind) before the launch (fbs::ll_tile),
// its chain then reading them; eacc's sums take the same rows.
//
// With `blocks` > 0 (the fused backward's WF window tier up to K = 64) acc
// stays in the chain, a row of partials a block (`part_a`, blocks rows of K
// K floats, which the kernel reads back and writes each window and the
// caller adds in block order after the last): then there is no dn, no acc
// sum and no widened alpha, and only eacc's sums run here.
struct WideStats {
  int T, B, K, F, steps, kind, blocks;
  bool abf;
  float* dn;
  float* gw;
  float* carry;
  float* part_a;
  float* part_e;
  float* xa;  // abf: the window's alpha rows, widened
  float* yf;  // built kind: the window's feature rows
  float* ll;  // lls: the window's likelihoods (else null)

  static int window(int T, int B) {
    const long long s = WIDE_ROWS / B;
    return s < 1 ? 1 : s > T ? T : static_cast<int>(s);
  }

  static long long floats(int T, int B, int K, int F, int kind = fbc::FEATS_ARRAY,
                          bool abf = false, int blocks = 0, bool lls = false) {
    const long long n = (long long)window(T, B) * B;
    const bool chain = blocks > 0;
    return (chain ? 0 : n * K) + (F > 0 ? n * K : 0) + (long long)B * K +
           (chain ? (long long)blocks * K * K : outer_scratch(n, K, K)) +
           (F > 0 ? outer_scratch(n, K, F) : 0) + (abf && !chain ? n * K : 0) +
           (F > 0 && kind != fbc::FEATS_ARRAY ? n * F : 0) + (lls ? n * K : 0);
  }

  WideStats(float* scratch, int T_, int B_, int K_, int F_, int kind_ = fbc::FEATS_ARRAY,
            bool abf_ = false, int blocks_ = 0, bool lls = false)
      : T(T_), B(B_), K(K_), F(F_), steps(window(T_, B_)), kind(kind_), blocks(blocks_),
        abf(abf_ && blocks_ == 0) {
    const long long n = (long long)steps * B;
    dn = blocks > 0 ? nullptr : scratch;
    gw = F > 0 ? scratch + (blocks > 0 ? 0 : n * K) : nullptr;
    carry = scratch + (blocks > 0 ? 0 : n * K) + (F > 0 ? n * K : 0);
    part_a = carry + (long long)B * K;
    part_e = part_a + (blocks > 0 ? (long long)blocks * K * K : outer_scratch(n, K, K));
    xa = part_e + (F > 0 ? outer_scratch(n, K, F) : 0);
    yf = xa + (abf ? n * K : 0);
    ll = lls ? yf + (F > 0 && kind != fbc::FEATS_ARRAY ? n * F : 0) : nullptr;
  }

  // For each window [t0, t1), the last first: its feature rows (built for a
  // built kind), prep(Y, rows) on them (the likelihoods, with lls), then
  // launch(t0, t1) writes its dn and gw, and its sums go into stats: acc
  // (K, K), then eacc (K, F) right after it when F > 0. alpha is float32
  // (alpha16 null) or bf16 (alpha null); src holds the feature array, or
  // for a built kind the raw observations (T, B, D).
  struct NoPrep {
    cudaError_t operator()(const float*, long long) const { return cudaSuccess; }
  };

  template <class Launch, class Prep = NoPrep>
  cudaError_t run(const float* alpha, const __nv_bfloat16* alpha16, const float* src,
                  float* stats, cudaStream_t st, Launch launch, Prep prep = {}) const {
    const size_t step_k = (size_t)B * K;
    const int D = fbc::obs_dim(kind, F);
    for (int t1 = T; t1 > 0; t1 -= steps) {
      const int t0 = t1 > steps ? t1 - steps : 0;
      const bool add = t1 < T;
      const long long nr = (long long)(t1 - t0) * B;
      const float* Y = F > 0 ? src + (size_t)t0 * B * D : nullptr;  // the window's rows
      cudaError_t e = cudaSuccess;
      if (F > 0 && kind != fbc::FEATS_ARRAY) {
        e = build_feats(kind, Y, yf, nr, D, F, st);
        Y = yf;
      }
      if (e == cudaSuccess) e = prep(Y, nr);
      if (e == cudaSuccess) e = launch(t0, t1);
      if (e != cudaSuccess) return e;
      if (blocks == 0) {
        const int ta = t0 > 0 ? t0 : 1;  // acc's rows: t >= 1
        const long long na = (long long)(t1 - ta) * B;
        const float* X = alpha != nullptr ? alpha + (ta - 1) * step_k : xa;
        if (alpha == nullptr) e = widen(alpha16 + (ta - 1) * step_k, xa, na * K, st);
        if (e == cudaSuccess)
          e = outer_sum(X, dn + (ta - t0) * step_k, na, K, K, part_a, stats, add, st);
      }
      if (e == cudaSuccess && F > 0)
        e = outer_sum(gw, Y, nr, K, F, part_e, stats + K * K, add, st);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
};

}  // namespace fbs
