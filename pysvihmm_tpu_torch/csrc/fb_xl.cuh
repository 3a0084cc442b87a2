// The XL tier of the fused and split forward-backward kernels (257 <= K <=
// 1024), shared by split_fb_xl.cu, fused_fb_xl.cu and the launchers of
// split_fb.cu and fused_fb.cu. The duplex pair and the probes stay at K <=
// fbw::KWIDE = 256.
//
// Why the large-K layout (fb_wide.cuh) does not carry over: it keeps A~ in
// shared memory with its first rows in registers, and at KP = 512 padded
// states A~ alone is 1 MB of float32 (4 MB at KP = 1024) against the 227 KB
// of shared memory a block may use. So here A~ stays in device memory,
// where at these sizes it stays resident in the card's 50 MB L2, and each
// step's matvec reads it from there:
//   * an instance is built for KP = 512 or 1024 padded states and S = 1, 2,
//     4 or 8 sequences a block, one thread a state (KP threads; those with
//     k >= K idle but in every barrier and shuffle), the fb_wide.cuh chains
//     (fbw::seqs_forward, fbw::seqs_backward) with the matrix column of
//     XlCol below in place of MatCol's registers and shared rows;
//   * thread k reads M[i][k] for i = 0 .. K-1 in order (M = A~ for the
//     forward; for the backward M = A~^T, a transposed copy the launcher
//     makes once a call with xl_transpose_kernel), a warp's 32 words one
//     coalesced 128-byte load, and feeds each word into S fmaf chains, one a
//     sequence; a_{t-1} (d_t) of the S sequences lies in shared memory and
//     is read as float4 broadcasts, as at K <= 256. A warp whose states all
//     lie at or past K skips the product (its u is zero, as the padding's).
//
// The large-K tier's contract holds: per sequence the matvec is one fmaf
// chain over i in order (the rows K .. KP-1 of the padding add fmaf(0, 0,
// u) = u, since every u here is a sum of non-negative products from +0, so
// the chain stops at K with the same bits), the per-step sums and maxima are
// each warp's butterfly, then the warps' partials in warp order. So alpha,
// s, sh, gamma and gamma0 are the same bits at every S, and the fused
// forward (fused_fb_xl.cu, on ll_tile_kernel's likelihoods a window at a
// time, its float32 state carried from window to window) is the split
// forward on the same likelihoods, bit for bit. acc and eacc leave the
// backward through fbs::WideStats, a window of WIDE_ROWS / B steps at a
// time, in an order fixed by (T, B, K, F) alone.
//
// Modes: gated and ungated, gamma emitted or not. The gamma pick (sel) and
// bf16-stored alpha have no XL instance; the launchers refuse them.
//
// What bounds it on this card: at K = 512, B = 1024, T = 1000 the forward's
// matvecs are 2 K^2 B T = 537 GFLOP, 8.0 ms at 67 TFLOP/s float32, and the
// backward's twice that. But each block reads all of A~ from L2 every step:
// at S = 8 that is 128 blocks x 1000 steps x 1 MB, about 134 GB a chain,
// which at the L2's few TB/s sets the pace, several times the FLOP bound.
// The design keeps that traffic to one read of A~ a block and step (one
// block an SM: the wrappers' S rule counts one block an SM at these tiers,
// since a second block on an SM would read A~ again) and lets every word
// feed S FMAs; the faster design keeps A~'s column slices in the
// distributed shared memory of a thread-block cluster (ROADMAP).

#pragma once

#include "fb_common.cuh"
#include "fb_wide.cuh"

namespace fbw {

constexpr int KXL = 1024;  // the largest K of the XL instances

// The padded state count of the XL instance that takes K (257..1024).
inline int xl_tier_of(int K) { return K <= 512 ? 512 : 1024; }

// Threads a block of the chain that takes K > 64 states: its padded states.
inline int chain_tier(int K) { return K <= KWIDE ? tier_of(K) : xl_tier_of(K); }

// The XL tiers: no matrix row in registers or shared memory.
template <int KP>
struct XlTier {
  static constexpr int NT = KP;
  static constexpr int NWARP = KP / 32;
  static constexpr int RR = 0;
  static constexpr int SR = 0;
};
template <>
struct Tier<512> : XlTier<512> {};
template <>
struct Tier<1024> : XlTier<1024> {};

// Column k of the matrix a chain reads, M (K, K) row-major in device memory
// (A~ for the forward; for the backward the launcher's transposed copy, so
// load's `transposed` is already applied and not read here). Thread k keeps
// a pointer to its column (an idle state's to column 0, whose products it
// then drops).
template <int KP>
struct XlCol {
  const float* m;
  int K;
  bool active, idle_warp;

  __device__ void load(const float* __restrict__ M, float*, int K_, bool, int k) {
    K = K_;
    active = k < K_;
    idle_warp = (k & ~31) >= K_;
    m = M + (active ? k : 0);
  }

  // u[s] = sum_i v[s * vstride + i] M[i][k] for NS vectors v in shared
  // memory (16-byte aligned, zero past K), i = 0 .. K-1 in order; each word
  // of M feeds NS chains.
  template <int NS>
  __device__ __forceinline__ void dots(float (&u)[NS], const float* v, int vstride, const float*,
                                       int) const {
#pragma unroll
    for (int s = 0; s < NS; ++s) u[s] = 0.f;
    if (idle_warp) return;
    const int K4 = K & ~3;
    int i = 0;
#pragma unroll 2
    for (; i < K4; i += 4) {
      const float* p = m + i * K;
      const float m0 = __ldg(p), m1 = __ldg(p + K), m2 = __ldg(p + 2 * K), m3 = __ldg(p + 3 * K);
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float4 x = ld4(v + s * vstride + i);
        u[s] = fmaf(x.x, m0, u[s]);
        u[s] = fmaf(x.y, m1, u[s]);
        u[s] = fmaf(x.z, m2, u[s]);
        u[s] = fmaf(x.w, m3, u[s]);
      }
    }
    for (; i < K; ++i) {
      const float mi = __ldg(m + i * K);
#pragma unroll
      for (int s = 0; s < NS; ++s) u[s] = fmaf(v[s * vstride + i], mi, u[s]);
    }
    if (!active) {
#pragma unroll
      for (int s = 0; s < NS; ++s) u[s] = 0.f;
    }
  }
};
template <>
struct MatCol<512> : XlCol<512> {};
template <>
struct MatCol<1024> : XlCol<1024> {};

// AT (K, K) = A^T for row-major A, by 32 x 32 tiles through shared memory
// (both sides' accesses coalesced): the backward's matrix, made once a call.
// Of internal linkage, as fb_stats.cuh's kernels that are not templates.
static __global__ void __launch_bounds__(256)
xl_transpose_kernel(const float* __restrict__ A, float* __restrict__ AT, int K) {
  __shared__ float tile[32][33];
  const int x0 = blockIdx.x * 32, y0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int i = y0 + r, j = x0 + threadIdx.x;
    if (i < K && j < K) tile[r][threadIdx.x] = A[i * K + j];
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int i = x0 + r, j = y0 + threadIdx.x;  // AT[i][j] = A[j][i]
    if (i < K && j < K) AT[i * K + j] = tile[threadIdx.x][r];
  }
}

inline cudaError_t xl_transpose(const float* A, float* AT, int K, cudaStream_t st) {
  const dim3 grid((K + 31) / 32, (K + 31) / 32);
  xl_transpose_kernel<<<grid, dim3(32, 8), 0, st>>>(A, AT, K);
  return cudaGetLastError();
}

// The XL instance of (which, S, K) of one library's pair: which = 0 forward,
// 1 backward, 2 gated backward, at KP = xl_tier_of(K); its dynamic shared
// memory in *smem; null for an S not built. Pair names the pair's kernels:
// Pair::template forward<KP, S>() and Pair::template backward<KP, S, GATED>().
template <class Pair, int KP, int S>
const void* xl_at(int which, int* smem) {
  *smem = chain_smem_bytes<KP, S>();
  if (which == 0) return Pair::template forward<KP, S>();
  return which == 1 ? Pair::template backward<KP, S, false>()
                    : Pair::template backward<KP, S, true>();
}

template <class Pair, int KP>
const void* xl_of(int which, int S, int* smem) {
  switch (S) {
    case 1: return xl_at<Pair, KP, 1>(which, smem);
    case 2: return xl_at<Pair, KP, 2>(which, smem);
    case 4: return xl_at<Pair, KP, 4>(which, smem);
    case 8: return xl_at<Pair, KP, 8>(which, smem);
    default: *smem = 0; return nullptr;
  }
}

template <class Pair>
const void* xl_pick(int which, int S, int K, int* smem) {
  return xl_tier_of(K) == 512 ? xl_of<Pair, 512>(which, S, smem)
                              : xl_of<Pair, 1024>(which, S, smem);
}

}  // namespace fbw
