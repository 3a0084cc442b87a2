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

// Chunks wanted along N: OUTER_BLOCKS blocks over the output tiles, at most
// one a stage of ON rows.
inline long long outer_want(long long N, int I, int J) {
  const int ti = narrow_tile(J) ? NarrowTile::TI : WideTile::TI;
  const int tj = narrow_tile(J) ? NarrowTile::TJ : WideTile::TJ;
  const long long tiles = (long long)((I + ti - 1) / ti) * ((J + tj - 1) / tj);
  const long long stages = (N + ON - 1) / ON;
  long long want = (OUTER_BLOCKS + tiles - 1) / tiles;
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
// of the operand kernels below, build_feats_kernel [0] and widen_kernel [1],
// one a call of build_feats or widen with rows. Inline, so that the
// translation units of one library share one count, and hidden from the
// library's exports, so that each library keeps its own.
#define FBS_LIBRARY_LOCAL __attribute__((visibility("hidden")))
FBS_LIBRARY_LOCAL inline long long outer_launch_count = 0;
FBS_LIBRARY_LOCAL inline long long prep_launch_count[2] = {0, 0};
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

// out (rows, F) = the built features of the observation rows obs (rows, D),
// one thread a feature (fbc::feat_at: the same float32 bits as the chain
// kernels' rows and ell_features').
template <int KIND>
__global__ void __launch_bounds__(PREP_NT)
build_feats_kernel(const float* __restrict__ obs, float* __restrict__ out, long long rows, int D,
                   int F) {
  const long long e = (long long)blockIdx.x * PREP_NT + threadIdx.x;
  if (e >= rows * F) return;
  const long long r = e / F;
  out[e] = fbc::feat_at<KIND>(obs + r * D, D, static_cast<int>(e - r * F));
}

// out[e] = a16[e] widened to float32, e < n.
static __global__ void __launch_bounds__(PREP_NT)
widen_kernel(const __nv_bfloat16* __restrict__ a16, float* __restrict__ out, long long n) {
  const long long e = (long long)blockIdx.x * PREP_NT + threadIdx.x;
  if (e < n) out[e] = __bfloat162float(a16[e]);
}

inline unsigned prep_blocks(long long n) { return static_cast<unsigned>((n + PREP_NT - 1) / PREP_NT); }

// The window's eacc operand built from the observations (kind FEATS_NIW or
// FEATS_NIG), rows (t, b) of obs (rows, D) into out (rows, F).
inline cudaError_t build_feats(int kind, const float* obs, float* out, long long rows, int D,
                               int F, cudaStream_t st) {
  if (rows <= 0) return cudaSuccess;
  if (kind == fbc::FEATS_NIW)
    build_feats_kernel<fbc::FEATS_NIW><<<prep_blocks(rows * F), PREP_NT, 0, st>>>(obs, out, rows,
                                                                                D, F);
  else
    build_feats_kernel<fbc::FEATS_NIG><<<prep_blocks(rows * F), PREP_NT, 0, st>>>(obs, out, rows,
                                                                                D, F);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++prep_launch_count[0];
  return e;
}

inline cudaError_t widen(const __nv_bfloat16* a16, float* out, long long n, cudaStream_t st) {
  if (n <= 0) return cudaSuccess;
  widen_kernel<<<prep_blocks(n), PREP_NT, 0, st>>>(a16, out, n);
  const cudaError_t e = cudaGetLastError();
  if (e == cudaSuccess) ++prep_launch_count[1];
  return e;
}

// The count of build_feats_kernel (which = 0) or widen_kernel (1), cleared
// when `clear` (the fused and duplex libraries export this).
inline int prep_launches(int which, bool clear) {
  long long& c = prep_launch_count[which != 0];
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
// With `blocks` > 0 (the fused backward up to K = 64 at F > FMAX) acc stays
// in the chain, a row of partials a block (`part_a`, blocks rows of K K
// floats, which the kernel reads back and writes each window and the caller
// adds in block order after the last): then there is no dn, no acc sum and
// no widened alpha, and only eacc's sums run here.
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

  static int window(int T, int B) {
    const long long s = WIDE_ROWS / B;
    return s < 1 ? 1 : s > T ? T : static_cast<int>(s);
  }

  static long long floats(int T, int B, int K, int F, int kind = fbc::FEATS_ARRAY,
                          bool abf = false, int blocks = 0) {
    const long long n = (long long)window(T, B) * B;
    const bool chain = blocks > 0;
    return (chain ? 0 : n * K) + (F > 0 ? n * K : 0) + (long long)B * K +
           (chain ? (long long)blocks * K * K : outer_scratch(n, K, K)) +
           (F > 0 ? outer_scratch(n, K, F) : 0) + (abf && !chain ? n * K : 0) +
           (F > 0 && kind != fbc::FEATS_ARRAY ? n * F : 0);
  }

  WideStats(float* scratch, int T_, int B_, int K_, int F_, int kind_ = fbc::FEATS_ARRAY,
            bool abf_ = false, int blocks_ = 0)
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
  }

  // For each window [t0, t1), the last first: launch(t0, t1) writes its dn
  // and gw, then its sums go into stats: acc (K, K), then eacc (K, F) right
  // after it when F > 0. alpha is float32 (alpha16 null) or bf16 (alpha
  // null); src holds the feature array, or for a built kind the raw
  // observations (T, B, D).
  template <class Launch>
  cudaError_t run(const float* alpha, const __nv_bfloat16* alpha16, const float* src,
                  float* stats, cudaStream_t st, Launch launch) const {
    const size_t step_k = (size_t)B * K;
    const int D = fbc::obs_dim(kind, F);
    for (int t1 = T; t1 > 0; t1 -= steps) {
      const int t0 = t1 > steps ? t1 - steps : 0;
      const bool add = t1 < T;
      cudaError_t e = launch(t0, t1);
      if (e != cudaSuccess) return e;
      if (blocks == 0) {
        const int ta = t0 > 0 ? t0 : 1;  // acc's rows: t >= 1
        const long long na = (long long)(t1 - ta) * B;
        const float* X = alpha != nullptr ? alpha + (ta - 1) * step_k : xa;
        if (alpha == nullptr) e = widen(alpha16 + (ta - 1) * step_k, xa, na * K, st);
        if (e == cudaSuccess)
          e = outer_sum(X, dn + (ta - t0) * step_k, na, K, K, part_a, stats, add, st);
      }
      if (e == cudaSuccess && F > 0) {
        const long long nr = (long long)(t1 - t0) * B;
        const float* Y = src + (size_t)t0 * B * D;
        if (kind != fbc::FEATS_ARRAY) {
          e = build_feats(kind, Y, yf, nr, D, F, st);
          Y = yf;
        }
        if (e == cudaSuccess) e = outer_sum(gw, Y, nr, K, F, part_e, stats + K * K, add, st);
      }
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
};

}  // namespace fbs
