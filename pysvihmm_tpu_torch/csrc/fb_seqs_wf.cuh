// The fused pair's backward up to K = 64 at any feature width F (the
// instances fused_fb_wide*.cu build for F > fbc::FMAX; fb_seqs.cuh holds the
// layout this follows, and its instances for F <= FMAX). The fused forward
// at F > FMAX, like the duplex pair there, reads the likelihoods that
// fbs::ll_tile sums first (fb_seqs.cuh's seq_forward in its ll mode).
//
// What changes with the width. fb_seqs.cuh keeps row k of eacc (the
// backward) in registers and pads F to one of four compiled widths, which
// does not scale past 64 features. Here F is a run-time loop bound over
// groups of four features (nf4 = ceil(F / 4)):
//   * W lies in dynamic shared memory, k-major, row k of W^T at k * wst with
//     wst = 4 (nws | 1): an odd number of 16-byte groups a row, so that the
//     float4 reads of 32 threads at 32 rows are free of bank conflicts. Its
//     first nws groups, that is: as many as fit beside the block's other
//     arrays within SMEM_CAP; the groups beyond, column k of W, are read from
//     device memory (L2) at each step, in the same order, so that the chain
//     and its bits do not depend on where a word lies.
//   * The feature rows of a step (S F floats a block) reach shared memory by
//     cp.async, several steps before they are read (WideRows below), as a
//     ring of slots [S][4 nf4] whose padding stays zero; a built kind
//     (fbc::FEATS_NIW, FEATS_NIG) copies the raw observation rows (S D
//     floats) instead and builds each feature in the step before it is read
//     (each product one __fmul_rn, ell_features' bits, as fbseq::ObsRows).
//   * ll_t is summed in blocks of 64 features (ll_from): the fmaf chain over
//     the first block, then each further block's own chain from zero, added
//     in order, over zero padding, so that a built kind's rows give the
//     array's bits and the sums are ll_tile's, the forward's lik_t.
//
// The backward has two tiers, chosen before launch from (S, F) alone
// (tiled_fits; the launchers count each):
//   * the tiled tier (seq_backward_tiled, up to about F = 310), the
//     counterpart of the TPU kernel's shape (pallas_fb.py:577
//     _bwd_kernel_fused: ll as one tile matmul, eacc a VMEM-resident sum
//     of (w gamma)^T feats a tile at a time). The serial chain keeps only
//     what is serial; both F-wide products are tile products on two more
//     warps that the chain does not wait for (four where a block has the SM
//     alone; beside two or four chain groups at S = 2: tiled_plan), in
//     float32 FFMA from shared memory, W held there too. A window of
//     rows / (S G) steps holds 16 (t, b) rows, or 8 where the rings of 16
//     do not fit beside W and eacc (tiled_plan). The tile warps
//     stage a window's feature rows in shared memory (cp.async, asked for a
//     window before they are needed; a built kind's raw rows, built there)
//     and compute its (rows x F) . (F x K) likelihood tile two windows ahead
//     of the chain, each element the forward's own sum (the fmaf chain over
//     each block of 64 features from zero, the blocks added in order), into
//     a ring of two slots. The chain reads ll_t from the ring, and writes
//     w_t gamma_t into the same place once it has read it; a window behind,
//     the tile warps add (w gamma)^T (K x rows) . feats (rows x F) to eacc,
//     held in shared memory across all of T, before they overwrite the slot
//     with the likelihoods two windows on. acc stays in the chain's
//     registers from T - 1 down to 0; one launch covers T; each chain group
//     writes a row of acc partials and each block one of eacc, which
//     fbs::sum_partials adds in order. The two roles meet at named barriers
//     only (bar.sync / bar.arrive): each chain group's own a step, the tile
//     warps' own, and for each ring slot "likelihoods ready" (tile to chain,
//     one a group, so that no group waits for another) and "w gamma ready"
//     (chains to tile). eacc's grouping then follows the block's S and
//     groups, as acc's follows S.
//   * the window tier (seq_backward_wf, wider F, where W and eacc (KMAX x F
//     each) no longer fit beside the rings, and past F = 440 not even
//     alone within SMEM_CAP): the chain computes ll_{t-1}
//     itself, W^T in shared memory as above; eacc leaves the chain: the
//     backward writes w_t gamma_t for a window of time steps a launch
//     (fbs::WideStats, with acc kept in the chain), and the eacc outer sums
//     (3xTF32, fb_stats.cuh) add
//     the windows in an order fixed by (T, B, K, F). acc stays in registers,
//     a column a thread, and a window ends by writing it to the block's row
//     of partials, which the next window reads back and goes on summing
//     into: the same fmaf chain as in one launch. The windows carry
//     b'_{t0-1} in `carry`, as the large-K backward's do.
// Everything else -- the matvec, the sums and maxima, the modes -- is
// fb_seqs.cuh's arithmetic, line for line, so gamma, gamma0 and acc are the
// same bits in both tiers. The instances run only at F > FMAX (nf4 > 16
// groups), so the loop that interleaves ll's chain with the matvec's 16
// groups needs no guard.

#pragma once

#include "fb_common.cuh"
#include "fb_seqs.cuh"
#include "fb_stats.cuh"

namespace fbwf {

using fbc::FULL;
using fbc::KMAX;
using fbc::NT;
using fbc::NWARP;
using fbc::SUM_FLOOR;
using fbseq::AST;
using fbseq::block_max;
using fbseq::block_sum;
using fbseq::fma4;
using fbseq::ld4;
using fbseq::ld4s;

// Groups of four features, and the row stride of W^T in shared memory for
// nws groups held there.
__host__ __device__ constexpr int groups(int F) { return (F + 3) / 4; }
__host__ __device__ constexpr int w_stride(int nws) { return 4 * (nws | 1); }

// The dynamic shared memory a WF block takes at most, in bytes: within the
// H100's 227 KB a block (opt-in) beside the backward's static arrays.
constexpr int SMEM_CAP = 220 * 1024;

// W^T's groups held in shared memory beside `fixed` bytes of the block's
// other arrays: all nf4 where they fit within SMEM_CAP, else as many as fit,
// but at least KMAX / 4 (the loops interleaved with the matvec read those
// from shared memory; a block that then exceeds the card's limit reports no
// resident block and is not launched).
__host__ __device__ inline int smem_groups(int F, int fixed) {
  const int nf4 = groups(F);
  const int m = (SMEM_CAP - fixed) / (16 * KMAX);  // the largest (nws | 1) that fits
  const int fit = (m & 1) ? m : m - 1;
  const int g = fit < nf4 ? fit : nf4;
  return g > KMAX / 4 ? g : KMAX / 4;
}

// The feature rows of a block's S sequences for the chain, in shared memory.
// Rows are named by their place q in the order the chain reads them (the
// backward's q is t1 - 1 - t); slot(q) holds row q as [S]
// [fpr] floats, zero beyond F and for missing sequences. A step's copies are
// one cp.async group, committed even when empty, so that every thread counts
// the same groups.
//   * The feature array (ARRAY): a ring of 4 slots that the copies fill
//     directly; in the step that reads row r the copies of row r + 2 are
//     asked for.
//   * A built kind: a ring of 3 slots of raw rows (S D floats) and 2 feature
//     slots; in the step that reads row r, row r + 1 is built from its raw
//     slot and the raw copies of row r + 3 are asked for.
// The chain waits for all but the latest group just before its barrier, so a
// row asked for in one step has landed before the barrier two steps on.
template <int S, int KIND>
struct WideRows {
  static constexpr bool BUILT = KIND != fbc::FEATS_ARRAY;
  static constexpr int NF = BUILT ? 2 : 4;  // feature slots
  static constexpr int NR = BUILT ? 3 : 0;  // raw slots

  float* feat;  // NF slots of S fpr floats
  float* raw;   // NR slots of S D floats (built kinds)
  int* tab;     // F sources, (ia + 1) | (ja + 1) << 16 (built kinds; fbc::feat_src)
  const float* src;  // the block's first row: src + b0 in_w
  size_t step;       // floats from one time step's rows to the next
  int F, D, fpr, in_w, ns, k, T;

  // Floats of shared memory at (S, F) for KIND: the slots and the table.
  __host__ __device__ static int floats(int F_) {
    const int fp = 4 * groups(F_);
    const int d = fbc::obs_dim(KIND, F_);
    return NF * S * fp + (BUILT ? NR * S * d + F_ : 0);
  }

  __device__ WideRows(float* mem, const float* src_, int B, int F_, int ns_, int T_)
      : F(F_), D(fbc::obs_dim(KIND, F_)), fpr(4 * groups(F_)), ns(ns_), k(threadIdx.x), T(T_) {
    in_w = BUILT ? D : F;
    feat = mem;
    raw = feat + NF * S * fpr;
    tab = reinterpret_cast<int*>(raw + NR * S * D);
    src = src_;
    step = (size_t)B * in_w;
  }

  // Zero the slots and fill the table; the caller syncs before any copy.
  __device__ void init() const {
    for (int i = k; i < NF * S * fpr + NR * S * D; i += NT) feat[i] = 0.f;
    if constexpr (BUILT) {
      for (int f = k; f < F; f += NT) {
        int ia, ja;
        fbc::feat_src(KIND, D, f, ia, ja);
        tab[f] = (ia + 1) | ((ja + 1) << 16);
      }
    }
  }

  __device__ __forceinline__ float* slot(int q) const { return feat + (q % NF) * S * fpr; }

  // The sequence of element e of a block's row of S F floats, without a
  // division (S <= 4).
  __device__ __forceinline__ int seq_of(int e) const {
    int s = 0;
#pragma unroll
    for (int j = 1; j < S; ++j) s += e >= j * F;
    return s;
  }

  // Ask for the rows of time step `row` (any int: outside 0 .. T-1 the slot
  // is zero-filled and nothing is read) into the slot of q; one group.
  __device__ __forceinline__ void ask(int q, int row) const {
    const bool in_t = row >= 0 && row < T;
    const float* r = src + (in_t ? (size_t)row * step : 0);
    if constexpr (BUILT) {
      float* dst = raw + (q % NR) * S * D;
      for (int e = k; e < S * D; e += NT) {
        const bool ok = in_t && e < ns * D;
        fbs::cp_async<1>(dst + e, ok ? r + e : src, ok);
      }
    } else {
      float* dst = slot(q);
      for (int e = k; e < S * F; e += NT) {
        const int s = seq_of(e);
        const bool ok = in_t && s < ns;
        fbs::cp_async<1>(dst + s * fpr + (e - s * F), ok ? r + e : src, ok);
      }
    }
    fbs::cp_commit();
  }

  // A built kind: the features of row q from its raw slot (landed and seen
  // by every thread: the caller's barrier since its copies were waited for).
  __device__ __forceinline__ void build(int q) const {
    if constexpr (BUILT) {
      const float* y = raw + (q % NR) * S * D;
      float* dst = slot(q);
      for (int e = k; e < S * F; e += NT) {
        const int s = seq_of(e), f = e - s * F;
        const int ia = (tab[f] & 0xffff) - 1, ja = (tab[f] >> 16) - 1;
        const float* ys = y + s * D;
        dst[s * fpr + f] = ia < 0 ? 1.f : fbc::feat_of(ys[ia], ja < 0 ? 0.f : ys[ja], ja >= 0);
      }
    }
  }

  // In the step that reads row r, after its barrier: the work for the steps
  // to come. row_of maps a place q to its time step.
  template <class RowOf>
  __device__ __forceinline__ void advance(int r, RowOf row_of) const {
    if constexpr (BUILT) {
      build(r + 1);
      ask(r + 3, row_of(r + 3));
    } else {
      ask(r + 2, row_of(r + 2));
    }
  }

  // Before the chain's first barrier: row 0 ready to read (and seen, after
  // the caller's sync; the backward reads it before its loop), and the
  // copies the step before r = 1 would have asked for in flight.
  template <class RowOf>
  __device__ void prime(RowOf row_of) const {
    if constexpr (BUILT) {
      for (int q = 0; q < 3; ++q) ask(q, row_of(q));
      fbs::cp_wait<0>();
      __syncthreads();
      build(0);
      build(1);
      __syncthreads();  // raw slots 0 and 1 are free
      ask(3, row_of(3));
    } else {
      for (int q = 0; q < 3; ++q) ask(q, row_of(q));
      fbs::cp_wait<0>();
      __syncthreads();
    }
  }
};

// ll[s] = sum over f4 in [f0, f1) of the four features of row s of the slot
// times W^T's row k (wk), each in order: the chain of fbseq's FEATS rows.
template <int S>
__device__ __forceinline__ void ll_groups(float (&ll)[S], const float* wk, const float* slot,
                                          int fpr, int f0, int f1) {
  for (int f4 = f0; f4 < f1; ++f4) {
    const float4 wv = ld4(wk + 4 * f4);
    float4 y[S];
    ld4s<S>(y, slot + 4 * f4, fpr);
    fma4<S>(ll, y, wv.x, wv.y, wv.z, wv.w);
  }
}

// Column k of W: its groups [nws, nf4) from device memory (wg = W + k, null
// for an idle state), zero beyond F, in the chain's order.
struct WTail {
  const float* __restrict__ wg;
  int K, F, nws, nf4;
  __device__ __forceinline__ float at(int f) const {
    return (wg != nullptr && f < F) ? __ldg(wg + (size_t)f * K) : 0.f;
  }
};

// acc[s] += the groups [f0, f1) of ll's chain: W^T's row k (wk) in shared
// memory below wc.nws, column k of W from device memory from there on, the
// same chain over the same words wherever they lie.
template <int S>
__device__ __forceinline__ void ll_span(float (&acc)[S], const float* wk, const WTail& wc,
                                        const float* slot, int fpr, int f0, int f1) {
  ll_groups<S>(acc, wk, slot, fpr, f0, min(f1, wc.nws));
#pragma unroll 4
  for (int f4 = max(f0, wc.nws); f4 < f1; ++f4) {
    const int f = 4 * f4;
    float4 y[S];
    ld4s<S>(y, slot + f, fpr);
    fma4<S>(acc, y, wc.at(f), wc.at(f + 1), wc.at(f + 2), wc.at(f + 3));
  }
}

// ll[s] over the groups from f0 (0 or BLK) on, in blocks of BLK groups (64
// features): the first block's chain runs in ll itself, each later one in a
// chain of its own from zero, added to ll in order. A float32 sum over F
// features then errs by about 64 + F / 64 roundings, not F.
constexpr int BLK = KMAX / 4;

template <int S>
__device__ __forceinline__ void ll_from(float (&ll)[S], const float* wk, const WTail& wc,
                                        const float* slot, int fpr, int f0) {
  if (f0 == 0) ll_span<S>(ll, wk, wc, slot, fpr, 0, BLK);
  for (int b = BLK; b < wc.nf4; b += BLK) {
    float part[S];
#pragma unroll
    for (int s = 0; s < S; ++s) part[s] = 0.f;
    ll_span<S>(part, wk, wc, slot, fpr, b, min(b + BLK, wc.nf4));
#pragma unroll
    for (int s = 0; s < S; ++s) ll[s] += part[s];
  }
}

// *p by a load the compiler may not repeat or move.
__device__ __forceinline__ float ld_once(const float* p) {
  return *reinterpret_cast<const volatile float*>(p);
}

// W (F, K) row-major into W_s as W^T rows of wst floats, its first nws
// groups, zero beyond (K, F); the global reads are coalesced (k fastest).
__device__ __forceinline__ void load_W(const float* __restrict__ W, float* W_s, int K, int F,
                                       int nws, int wst) {
  for (int idx = threadIdx.x; idx < 4 * nws * KMAX; idx += NT) {
    const int f = idx / KMAX, r = idx % KMAX;
    W_s[r * wst + f] = (r < K && f < F) ? W[f * K + r] : 0.f;
  }
}

// The bytes of the backward's dynamic shared memory beside W^T's rows, and
// W^T's groups there (smem_groups), at (S, F).
template <int S, int KIND>
__host__ __device__ inline int backward_fixed(int F) {
  return 4 * (KMAX * AST + 4 * S * KMAX + 2 * NWARP * S + WideRows<S, KIND>::floats(F));
}

// Dynamic shared memory, in bytes, of the backward at (S, F).
template <int S, int KIND>
__host__ __device__ inline int backward_smem(int F) {
  const int fixed = backward_fixed<S, KIND>(F);
  return fixed + 4 * KMAX * w_stride(smem_groups(F, fixed));
}

// fbseq::seq_stats_backward with FEATS at any F, over the window t = t1-1 ..
// t0 (b'_{T-1} = 1 / s_{T-1} when t1 = T, else the carry the window above
// left): the same recursion, with row k of A~ and W^T from shared memory and
// the rows through WideRows. acc (column k, summed over the block's
// sequences) starts from zero at t1 = T, else from the block's row of
// partials `part`, and is written back there; eacc leaves the chain: w_t
// gamma_t goes to gw (t1 - t0, B, K) from t0. The window above 0 leaves
// b'_{t0-1} in carry (B, K). gamma0, gamma and the modes (alpha16, sel) as
// seq_stats_backward's. Every thread of the block calls it.
template <int S, bool GATED, int KIND, bool MODES>
__device__ __forceinline__ void seq_backward_wf(
    const float* __restrict__ A, const float* __restrict__ W, const float* __restrict__ src,
    const float* __restrict__ alpha, const __nv_bfloat16* __restrict__ alpha16,
    const float* __restrict__ s_in, const float* __restrict__ sh_in,
    const float* __restrict__ w_in, const int* __restrict__ sel, float* __restrict__ gamma,
    float* __restrict__ gamma0, float* __restrict__ gw_out, float* __restrict__ carry,
    float* __restrict__ part, int T, int B, int K, int F, int t0, int t1, int blk,
    float* smem) {
  const int nf4 = groups(F), fpr = 4 * nf4;
  const int nws = smem_groups(F, backward_fixed<S, KIND>(F)), wst = w_stride(nws);
  float* A_s = smem;                      // A~[k][j] at k * AST + j
  float* W_s = A_s + KMAX * AST;          // W^T rows
  float* d_s = W_s + KMAX * wst;          // d_t in slot t & 1, [S][KMAX] each
  float* a_s = d_s + 2 * S * KMAX;        // a_{t-1} in slot t & 1
  float* red = a_s + 2 * S * KMAX;        // partial sums of g_t in slot t & 1, [NWARP][S]
  float* rmem = red + 2 * NWARP * S;      // WideRows' slots

  const int b0 = blk * S;
  const int ns = min(S, B - b0);
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;
  const float* wk = W_s + k * wst;
  const WTail wc{active ? W + k : nullptr, K, F, nws, nf4};
  const int in_w = fbc::obs_dim(KIND, F);  // F for the array
  const WideRows<S, KIND> rows(rmem, src + (size_t)b0 * in_w, B, F, ns, T);

  for (int idx = k; idx < KMAX * KMAX; idx += NT) {
    const int r = idx / KMAX, c = idx % KMAX;
    A_s[r * AST + c] = (r < K && c < K) ? A[r * K + c] : 0.f;
  }
  load_W(W, W_s, K, F, nws, wst);
  rows.init();

  float* pb = part + (size_t)blk * K * K;  // the block's row of partials
  float acc[KMAX];  // column k of sum_t outer(a_{t-1}, d_t n_t pg_t) over the block
#pragma unroll
  for (int i = 0; i < KMAX; ++i) acc[i] = (t1 < T && active && i < K) ? pb[i * K + k] : 0.f;

  const size_t step_k = (size_t)B * K;
  const float* ab = MODES && alpha16 != nullptr ? nullptr : alpha + (size_t)b0 * K + k;
  const __nv_bfloat16* ab16 = MODES && alpha16 != nullptr ? alpha16 + (size_t)b0 * K + k
                                                                   : nullptr;
  auto a_at = [&](int t, int s) {
    const size_t o = (size_t)t * step_k + (size_t)s * K;
    if constexpr (MODES) return ab16 != nullptr ? __bfloat162float(ab16[o]) : ab[o];
    return ab[o];
  };

  float a_cur[S], a_prev[S], s_prev[S], sh_cur[S], beta[S], w_cur[S];
  int pick[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool ok = s < ns;
    const float* sb = s_in + (size_t)(b0 + s) * T;
    a_cur[s] = (ok && active) ? a_at(t1 - 1, s) : 0.f;
    a_prev[s] = (ok && active && t1 >= 2) ? a_at(t1 - 2, s) : 0.f;
    pick[s] = (MODES && sel != nullptr && ok) ? sel[b0 + s] : -1;
    s_prev[s] = (ok && t1 >= 2) ? sb[t1 - 2] : 1.f;
    sh_cur[s] = ok ? sh_in[(size_t)(b0 + s) * T + t1 - 1] : 0.f;
    beta[s] = t1 == T ? 1.f / fmaxf(ok ? sb[T - 1] : 1.f, SUM_FLOOR)
                      : ((ok && active) ? carry[(size_t)(b0 + s) * K + k] : 0.f);
    w_cur[s] = GATED ? (ok ? w_in[(size_t)(t1 - 1) * B + b0 + s] : 0.f) : 1.f;
  }
  auto row_of = [t1](int q) { return t1 - 1 - q; };
  __syncthreads();  // A~, W^T, the zeroed slots and the table
  rows.prime(row_of);

  float ll[S];  // ll_{t1-1}: the forward's chain
#pragma unroll
  for (int s = 0; s < S; ++s) ll[s] = 0.f;
  ll_from<S>(ll, wk, wc, rows.slot(0), fpr, 0);

  for (int t = t1 - 1; t >= t0; --t) {
    const int p = t & 1;
    const int i = t1 - 1 - t;  // the step's place: it reads row i + 1 (time t - 1)
    float* dp = d_s + p * S * KMAX;
    float* ap = a_s + p * S * KMAX;
    float* rp = red + p * NWARP * S;

    float a_n[S], s_n[S], sh_n[S], w_n[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool ok = s < ns;
      a_n[s] = (ok && active && t >= 2) ? a_at(t - 2, s) : 0.f;
      w_n[s] = GATED ? ((ok && t >= 1) ? w_in[(size_t)(t - 1) * B + b0 + s] : 0.f) : 1.f;
      s_n[s] = (ok && t >= 2) ? s_in[(size_t)(b0 + s) * T + t - 2] : 1.f;
      sh_n[s] = (ok && t >= 1) ? sh_in[(size_t)(b0 + s) * T + t - 1] : 0.f;
    }

    float graw[S], d[S], gs[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float lik = active ? expf(ll[s] - sh_cur[s]) : 0.f;
      graw[s] = a_cur[s] * beta[s];
      d[s] = t >= 1 ? (lik * (1.f / fmaxf(s_prev[s], SUM_FLOOR))) * beta[s] : 0.f;
      dp[s * KMAX + k] = d[s];
      ap[s * KMAX + k] = a_prev[s];
      gs[s] = graw[s];
    }
    fbc::warp_sums<S>(gs);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) rp[warp * S + s] = gs[s];
    }
    fbs::cp_wait<1>();  // this thread's copies of row i + 1 (i + 2 built) have landed
    __syncthreads();    // d_t, a_{t-1}, the partial sums and row i + 1 are complete
    rows.advance(i + 1, row_of);

    float dn[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float n = s < ns ? 1.f / fmaxf(block_sum<S>(rp, s), SUM_FLOOR) : 0.f;
      const float gam = graw[s] * n;
      const float gw = GATED ? gam * w_cur[s] : gam;
      if (active && s < ns) {
        if (gamma != nullptr) gamma[((size_t)t * B + b0 + s) * K + k] = gam;
        gw_out[((size_t)(t - t0) * B + b0 + s) * K + k] = gw;
        float* g0 = gamma0 + (size_t)(b0 + s) * K + k;
        if (!MODES || sel == nullptr) {
          if (t == 0) *g0 = gw;
        } else if (t == pick[s]) {
          *g0 = gam;
        } else if (t == 0 && (pick[s] < 0 || pick[s] >= T)) {
          *g0 = 0.f;
        }
      }
      dn[s] = GATED ? (d[s] * n) * (w_n[s] * w_cur[s]) : d[s] * n;
    }

    // b'_{t-1} and ll_{t-1} (2S chains in one loop over the first 64
    // features, then the rest of ll's), beside acc += outer(a_{t-1}, dn_t)
    const float* fn = rows.slot(i + 1);
    float bn[S];
#pragma unroll
    for (int s = 0; s < S; ++s) bn[s] = ll[s] = 0.f;
#pragma unroll
    for (int i4 = 0; i4 < KMAX / 4; ++i4) {
      const float4 av = ld4(A_s + k * AST + 4 * i4);
      const float4 wv = ld4(wk + 4 * i4);
      float4 x[S], z[S];
      ld4s<S>(x, dp + 4 * i4, KMAX);
      ld4s<S>(z, fn + 4 * i4, fpr);
      fma4<S>(ll, z, wv.x, wv.y, wv.z, wv.w);
      fma4<S>(bn, x, av.x, av.y, av.z, av.w);
      float4 y[S];
      ld4s<S>(y, ap + 4 * i4, KMAX);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        acc[4 * i4] = fmaf(y[s].x, dn[s], acc[4 * i4]);
        acc[4 * i4 + 1] = fmaf(y[s].y, dn[s], acc[4 * i4 + 1]);
        acc[4 * i4 + 2] = fmaf(y[s].z, dn[s], acc[4 * i4 + 2]);
        acc[4 * i4 + 3] = fmaf(y[s].w, dn[s], acc[4 * i4 + 3]);
      }
    }
    ll_from<S>(ll, wk, wc, fn, fpr, KMAX / 4);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      beta[s] = bn[s];
      a_cur[s] = a_prev[s];
      a_prev[s] = a_n[s];
      s_prev[s] = s_n[s];
      sh_cur[s] = sh_n[s];
      w_cur[s] = w_n[s];
    }
  }
  fbs::cp_wait<0>();  // the copies asked for past the window

  if (active) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < K) pb[i * K + k] = acc[i];
    if (t0 > 0) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s < ns) carry[(size_t)(b0 + s) * K + k] = beta[s];  // b'_{t0-1}
    }
  }
}

// ---------------------------------------------------------------------------
// The tiled tier of the backward (the head of this file describes it).

// (t, b) rows a window, rows / (S G) steps: TILE_ROWS, or TILE_ROWS_MIN where
// the rings of TILE_ROWS do not fit beside W and eacc (tiled_plan)
constexpr int TILE_ROWS = 16, TILE_ROWS_MIN = 8;
constexpr int TILED_AREG = 16;  // entries of row k of A~ a chain thread keeps in registers
// feature slots, window j's in slot j % 3: eacc's (j), the next window's
// and the one whose rows are in flight or built for the likelihoods (j + 2)
constexpr int TILE_FEATS = 3;
// The tile warps: 2 where two blocks share an SM (a block's shared memory
// within TWO_BLOCK_SMEM), 4 where a block has the SM alone.
constexpr int TILE_NT_PAIR = 64, TILE_NT_ALONE = 128;
constexpr int TWO_BLOCK_SMEM = 113 * 1024;  // of the SM's 228 KB, 1 KB a block reserved
constexpr int MAX_GROUPS = 4;               // chain groups a block
// named barriers (0 is __syncthreads): the tile warps' own; for each ring
// slot "w gamma ready" (2, 3: every chain group arrives, the tile warps
// wait); each chain group's own (4 ..); for each group and ring slot
// "likelihoods ready" (8 + 2 g + slot: the tile warps arrive, the group
// waits), so that no group waits for another
constexpr int BAR_TILE = 1, BAR_GW = 2, BAR_CHAIN = 4, BAR_LL = 8;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The row stride of a feature slot: an odd number of 16-byte groups, so that
// the rows a warp reads at once fall in different banks.
__host__ __device__ constexpr int tiled_fpad(int F) { return 4 * (groups(F) | 1); }

// Floats of the tiled backward's dynamic shared memory at (S, F) with G
// chain groups and R rows a window, in the order of its regions: A~'s rows;
// each group's d, a and partial sums; the ring (2 slots of R x KMAX: ll_t,
// then w_t gamma_t); W and eacc (fpr rows of KMAX each, feature-major); the
// TILE_FEATS feature slots (R x tiled_fpad); a slot of raw rows (R x D
// floats for a built kind, D <= F / 2) and the feature table (F ints). Every
// kind takes the same, so that the tier, and with it eacc's bits, does not
// depend on the kind. Every region starts on 16 bytes.
template <int S>
__host__ __device__ inline int tiled_floats(int F, int G, int R) {
  const int fpr = 4 * groups(F);
  return KMAX * AST + G * (4 * S * KMAX + 2 * NWARP * S) + 2 * R * KMAX + 2 * KMAX * fpr +
         TILE_FEATS * R * tiled_fpad(F) + R * fpr / 2 + F;
}

// A tiled block at (S, F): G chain groups of KMAX threads, each running S
// sequences (S G a block), nt tile threads and windows of `rows` (t, b)
// rows. At S = 2 (the default up to B = 1,024) two groups where two blocks
// share an SM and four where one has it alone, so that 8 chain warps share
// each SM either way and B = 1,024 runs in one wave; at S = 4 one group.
// Windows of TILE_ROWS rows where they fit within SMEM_CAP, else of
// TILE_ROWS_MIN (F from 257 at S = 2, 261 at S = 4), whose smaller rings
// take the tier to about F = 310. The rows do not change a bit of any
// output: eacc's sums run over the rows in the same order whatever the
// window.
struct TiledPlan {
  int groups, nt, rows, floats;
  __host__ __device__ int threads() const { return groups * NT + nt; }
};

template <int S>
__host__ __device__ inline TiledPlan tiled_plan(int F) {
  const int pair = S == 2 ? 2 : 1;
  const bool two = 4 * tiled_floats<S>(F, pair, TILE_ROWS) <= TWO_BLOCK_SMEM;
  const int G = two ? pair : (S == 2 ? MAX_GROUPS : 1);
  const int R = 4 * tiled_floats<S>(F, G, TILE_ROWS) <= SMEM_CAP ? TILE_ROWS : TILE_ROWS_MIN;
  return {G, two ? TILE_NT_PAIR : TILE_NT_ALONE, R, tiled_floats<S>(F, G, R)};
}

template <int S>
__host__ __device__ constexpr int tiled_max_threads() {
  return (S == 2 ? MAX_GROUPS : 1) * NT + TILE_NT_ALONE;
}

template <int S>
__host__ __device__ inline int tiled_smem(int F) {
  return 4 * tiled_plan<S>(F).floats;
}

// The backward's tier at (S, F) up to K = 64, for every feature kind: tiled
// where its shared memory fits within SMEM_CAP (up to F = 316 at S = 4, 308
// at S = 2), else the window tier.
template <int S>
__host__ __device__ inline bool tiled_fits(int F) {
  return tiled_smem<S>(F) <= SMEM_CAP;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The tile warps' work on a block's windows, nt threads (tt in 0 .. nt -
// 1). In the likelihood tile a work item is RP rows by CC states (rows RP
// rp ..; states 4 kg .. 4 kg + 3, and 32 + 4 kg .. for CC = 8): two rows by
// 8 states for 64 tile threads, two by 4 for 128, one by 4 for 128 on
// windows of 8 rows; one item a thread, so that the
// threads of a quarter warp read consecutive bytes of a row of W; in
// eacc an item is eight states by four features (states 4 kg .. 4 kg + 3
// and 32 + 4 kg .. 32 + 4 kg + 3, kg = item % 8; features 4 (item / 8) ..),
// 8 nf4 items, eacc feature-major so that a warp's eight kg read eight
// different banks; each thread takes the items nt apart.
template <int KIND>
struct TileWarps {
  static constexpr bool BUILT = KIND != fbc::FEATS_ARRAY;

  const float* __restrict__ W;    // (F, K) in device memory
  const float* __restrict__ src;  // the block's first row: src + b0 D
  float* lg;    // the ring: 2 slots of rows x KMAX
  float* w_s;   // W, fpr rows of KMAX, zero outside (F, K)
  float* eacc;  // eacc^T, fpr rows of KMAX
  float* feat;  // TILE_FEATS slots of rows x fst
  float* raw;   // rows x D (built kinds)
  int* tab;     // F sources (built kinds; as WideRows' table)
  size_t step;  // floats from one time step's rows to the next (B D)
  int T, K, F, D, fpr, fst, nf4, sg, ns, tw, rows, tt, nt;
  // D: the floats of an input row (F for the array); sg: the block's
  // sequences (S G), of which ns exist; tw: steps a window, rows = tw sg

  // Window j's steps: [hi(j) - steps(j), hi(j)), the last window first.
  __device__ __forceinline__ int hi(int j) const { return T - j * tw; }
  __device__ __forceinline__ int steps(int j) const { return min(tw, hi(j)); }

  // W into w_s; zero eacc, the feature slots (their padding stays zero) and
  // the raw slot; fill the table. The caller syncs the block after.
  __device__ void init() const {
    for (int i = tt; i < fpr * KMAX; i += nt) {
      const int f = i / KMAX, k = i % KMAX;
      w_s[i] = (f < F && k < K) ? W[(size_t)f * K + k] : 0.f;
      eacc[i] = 0.f;
    }
    for (int i = tt; i < TILE_FEATS * rows * fst; i += nt) feat[i] = 0.f;
    if constexpr (BUILT) {
      for (int i = tt; i < rows * D; i += nt) raw[i] = 0.f;
      for (int f = tt; f < F; f += nt) {
        int ia, ja;
        fbc::feat_src(KIND, D, f, ia, ja);
        tab[f] = (ia + 1) | ((ja + 1) << 16);
      }
    }
  }

  __device__ __forceinline__ float* slot(int j) const {
    return feat + (j % TILE_FEATS) * rows * fst;
  }

  // Ask for window j's feature rows: row i sg + q is time step hi(j) - 1 - i
  // of sequence b0 + q, zero for a missing step or sequence; the array's
  // straight into slot(j), a built kind's raw rows into the raw slot. One
  // cp.async group, committed even when j is past the last window, so that
  // every thread counts the same groups.
  __device__ void ask(int j, int nw) const {
    if (j < nw) {
      const int n = steps(j), t_hi = hi(j);
      float* fs = slot(j);
      for (int r = 0; r < rows; ++r) {
        const int i = r / sg, q = r - i * sg;
        const bool ok = i < n && q < ns;
        const float* row = src + (ok ? (size_t)(t_hi - 1 - i) * step + (size_t)q * D : 0);
        float* dst = BUILT ? raw + r * D : fs + r * fst;
        for (int f = tt; f < D; f += nt) fbs::cp_async<1>(dst + f, ok ? row + f : src, ok);
      }
    }
    fbs::cp_commit();
  }

  // Window j's rows in slot(j), seen by every tile thread: its copies landed
  // (all but the PENDING latest groups; a built kind waits for all, then
  // builds the features from the raw slot, each product one __fmul_rn, as
  // the forward's).
  template <int PENDING>
  __device__ void land(int j) const {
    fbs::cp_wait<BUILT ? 0 : PENDING>();
    bar_sync(BAR_TILE, nt);
    if constexpr (BUILT) {
      float* fs = slot(j);
      for (int r = 0; r < rows; ++r) {
        const float* y = raw + r * D;
        for (int f = tt; f < F; f += nt) {
          const int ia = (tab[f] & 0xffff) - 1, ja = (tab[f] >> 16) - 1;
          fs[r * fst + f] = ia < 0 ? 1.f : fbc::feat_of(y[ia], ja < 0 ? 0.f : y[ja], ja >= 0);
        }
      }
      bar_sync(BAR_TILE, nt);
    }
  }

  // The likelihood tile of window j into ring slot j & 1: ll[r][k] = row r
  // of slot(j) . column k of W, ll_from's sum (each block of BLK
  // groups its own fmaf chain from zero, in feature order, the blocks added
  // in order), so lik_t is the forward's bits.
  template <int CC, int RP>
  __device__ void likelihoods_cc(int j) const {
    constexpr int NQ = CC / 4;        // float4 groups of states an item: 4 q kg + 32 q ..
    constexpr int KG = KMAX / CC;     // items along the states
    const float* fs = slot(j);
    float* ring = lg + (j & 1) * rows * KMAX;
    for (int item = tt; item < rows / RP * KG; item += nt) {
      const int rp = item / KG, kg = item % KG;
      const float* xp = fs + (RP * rp) * fst;
      const float* wp = w_s + 4 * kg;
      float tot[RP][CC];
      for (int b = 0; b < nf4; b += BLK) {
        float part[RP][CC];
#pragma unroll
        for (int q = 0; q < RP; ++q)
#pragma unroll
          for (int c = 0; c < CC; ++c) part[q][c] = 0.f;
        const int b1 = min(b + BLK, nf4);
#pragma unroll 2
        for (int f4 = b; f4 < b1; ++f4) {
          float4 x[RP];
#pragma unroll
          for (int q = 0; q < RP; ++q) x[q] = ld4(xp + q * fst + 4 * f4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float w[CC];
#pragma unroll
            for (int h = 0; h < NQ; ++h) {
              const float4 wv = ld4(wp + (4 * f4 + i) * KMAX + 32 * h);
              w[4 * h] = wv.x;
              w[4 * h + 1] = wv.y;
              w[4 * h + 2] = wv.z;
              w[4 * h + 3] = wv.w;
            }
#pragma unroll
            for (int q = 0; q < RP; ++q) {
              const float y = comp(x[q], i);
#pragma unroll
              for (int c = 0; c < CC; ++c) part[q][c] = fmaf(y, w[c], part[q][c]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < RP; ++q)
#pragma unroll
          for (int c = 0; c < CC; ++c) tot[q][c] = b == 0 ? part[q][c] : tot[q][c] + part[q][c];
      }
#pragma unroll
      for (int q = 0; q < RP; ++q)
#pragma unroll
        for (int h = 0; h < NQ; ++h)
          *reinterpret_cast<float4*>(ring + (RP * rp + q) * KMAX + 4 * kg + 32 * h) =
              make_float4(tot[q][4 * h], tot[q][4 * h + 1], tot[q][4 * h + 2], tot[q][4 * h + 3]);
    }
  }

  __device__ void likelihoods(int j) const {
    if (nt >= rows * KMAX / 4)
      likelihoods_cc<4, 1>(j);
    else if (nt >= rows / 2 * KMAX / 4)
      likelihoods_cc<4, 2>(j);
    else
      likelihoods_cc<8, 2>(j);
  }

  // eacc += (w gamma)^T . feats over window j's rows, in row order: ring
  // slot j & 1 (which the chains filled with w_t gamma_t, zero for a
  // missing sequence or state) and slot(j).
  __device__ void emission(int j) const {
    const float* g = lg + (j & 1) * rows * KMAX;
    const float* fs = slot(j);
    const int n = steps(j) * sg;
    for (int item = tt; item < 8 * nf4; item += nt) {
      const int kg = item & 7, f0 = 4 * (item >> 3);
      float4 ea[4], eb[4];  // features f0 + c: states 4 kg .., 32 + 4 kg ..
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ea[c] = ld4(eacc + (f0 + c) * KMAX + 4 * kg);
        eb[c] = ld4(eacc + (f0 + c) * KMAX + 32 + 4 * kg);
      }
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        const float4 ga = ld4(g + r * KMAX + 4 * kg), gb = ld4(g + r * KMAX + 32 + 4 * kg);
        const float4 x = ld4(fs + r * fst + f0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float xc = comp(x, c);
          ea[c].x = fmaf(ga.x, xc, ea[c].x);
          ea[c].y = fmaf(ga.y, xc, ea[c].y);
          ea[c].z = fmaf(ga.z, xc, ea[c].z);
          ea[c].w = fmaf(ga.w, xc, ea[c].w);
          eb[c].x = fmaf(gb.x, xc, eb[c].x);
          eb[c].y = fmaf(gb.y, xc, eb[c].y);
          eb[c].z = fmaf(gb.z, xc, eb[c].z);
          eb[c].w = fmaf(gb.w, xc, eb[c].w);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<float4*>(eacc + (f0 + c) * KMAX + 4 * kg) = ea[c];
        *reinterpret_cast<float4*>(eacc + (f0 + c) * KMAX + 32 + 4 * kg) = eb[c];
      }
    }
  }

  // The tile warps' whole part: the rows and likelihoods of windows 0 and 1;
  // then for each window j, once the chains have written its w gamma,
  // eacc's sums of j, and the likelihoods of j + 2 into the ring slot j
  // freed, its rows asked for a window earlier (the array's: a built kind's
  // raw rows, one slot of them, are asked for as soon as the previous rows
  // are built), so that their latency passes while the chains run. Last,
  // eacc (K x F) into the block's row of partials pe. nb: the block's
  // threads, which "w gamma ready" counts; G: its chain groups.
  __device__ void ready(int j, int G) const {  // window j's likelihoods, to each group
    for (int g = 0; g < G; ++g) bar_arrive(BAR_LL + 2 * g + (j & 1), NT + nt);
  }

  __device__ void run(float* __restrict__ pe, int nb, int G) const {
    const int nw = (T + tw - 1) / tw;
    if constexpr (BUILT) {
      ask(0, nw);
      land<0>(0);
      ask(1, nw);
    } else {
      ask(0, nw);
      ask(1, nw);
      ask(2, nw);
      land<2>(0);
    }
    likelihoods(0);
    ready(0, G);
    if (nw > 1) {
      land<1>(1);
      if constexpr (BUILT) ask(2, nw);
      likelihoods(1);
      ready(1, G);
    }
    for (int j = 0; j < nw; ++j) {
      bar_sync(BAR_GW + (j & 1), nb);
      emission(j);
      if (j + 2 < nw) {
        bar_sync(BAR_TILE, nt);  // slot(j) read by every tile thread
        if constexpr (BUILT) {
          land<0>(j + 2);
          ask(j + 3, nw);
        } else {
          ask(j + 3, nw);  // into slot(j)
          land<1>(j + 2);
        }
        likelihoods(j + 2);
        ready(j + 2, G);
      }
    }
    bar_sync(BAR_TILE, nt);
    for (int e = tt; e < K * F; e += nt) {
      const int k = e / F, f = e - k * F;
      pe[e] = eacc[f * KMAX + k];
    }
  }
};

// fbseq::seq_stats_backward with FEATS at any F, the tiled tier, in blocks
// of tiled_plan<S>(F): G chain groups of KMAX threads, each the window
// tier's chain over S sequences with ll_t read from the ring and w_t gamma_t
// written back into its place, then the tile warps (TileWarps::run). One
// launch over t = T-1 .. 0 (b'_{T-1} = 1 / s_{T-1}). `part` holds, first,
// a row of acc (K K, column k a chain thread, summed over the group's
// sequences) for each group in block order, ceil(B / (S G)) G rows, so that
// the rows of the first ceil(B / S) groups are an S-sequence block's each
// as at F <= FMAX; then a row of eacc (K F) a block. gamma0, gamma and the
// modes (alpha16, sel) as seq_stats_backward's. Every thread of the block
// calls it.
template <int S, bool GATED, int KIND, bool MODES>
__device__ __forceinline__ void seq_backward_tiled(
    const float* __restrict__ A, const float* __restrict__ W, const float* __restrict__ src,
    const float* __restrict__ alpha, const __nv_bfloat16* __restrict__ alpha16,
    const float* __restrict__ s_in, const float* __restrict__ sh_in,
    const float* __restrict__ w_in, const int* __restrict__ sel, float* __restrict__ gamma,
    float* __restrict__ gamma0, float* __restrict__ part, int T, int B, int K, int F, int blk,
    float* smem) {
  const TiledPlan plan = tiled_plan<S>(F);
  const int G = plan.groups, sg = S * G, rows = plan.rows, tw = rows / sg, nb = plan.threads();
  const int nf4 = groups(F), fpr = 4 * nf4, fst = tiled_fpad(F);
  const int D = fbc::obs_dim(KIND, F);          // F for the array
  const int chain_floats = 4 * S * KMAX + 2 * NWARP * S;
  float* A_s = smem;                            // A~[k][j] at k * AST + j
  float* chains = A_s + KMAX * AST;             // each group's d, a and partial sums
  float* lg = chains + G * chain_floats;        // the ring: ll_t, then w_t gamma_t
  float* w_s = lg + 2 * rows * KMAX;            // W, fpr rows of KMAX
  float* eacc_s = w_s + fpr * KMAX;             // eacc^T, fpr rows of KMAX
  float* feat = eacc_s + fpr * KMAX;            // the feature slots
  float* raw = feat + TILE_FEATS * rows * fst;  // rows x D (built kinds)
  int* tab = reinterpret_cast<int*>(raw + rows * fpr / 2);
  const int nblocks = (B + sg - 1) / sg;

  if (threadIdx.x >= G * NT) {
    const int tt = static_cast<int>(threadIdx.x) - G * NT, nt = plan.nt;
    const TileWarps<KIND> tw_{W,   src + (size_t)blk * sg * D, lg, w_s, eacc_s, feat, raw, tab,
                              (size_t)B * D, T, K, F, D, fpr, fst, nf4, sg,
                              min(sg, B - blk * sg), tw, rows, tt, nt};
    tw_.init();
    for (int idx = tt; idx < KMAX * KMAX; idx += nt) {
      const int r = idx / KMAX, c = idx % KMAX;
      A_s[r * AST + c] = (r < K && c < K) ? A[r * K + c] : 0.f;
    }
    __syncthreads();  // A~, W, the zeroed slots and eacc, the table
    tw_.run(part + (size_t)nblocks * G * K * K + (size_t)blk * K * F, nb, G);
    return;
  }

  const int g = threadIdx.x / NT, k = threadIdx.x % NT;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;
  const int b0 = blk * sg + g * S;
  const int ns = min(S, B - b0);  // none in a trailing group past B
  float* d_s = chains + g * chain_floats;  // d_t in slot t & 1, [S][KMAX] each
  float* a_s = d_s + 2 * S * KMAX;         // a_{t-1} in slot t & 1
  float* red = a_s + 2 * S * KMAX;         // partial sums of g_t in slot t & 1, [NWARP][S]
  float* pb = part + (size_t)(blk * G + g) * K * K;  // the group's row of acc partials
  float acc[KMAX];  // column k of sum_t outer(a_{t-1}, d_t n_t pg_t) over the group
#pragma unroll
  for (int i = 0; i < KMAX; ++i) acc[i] = 0.f;
  // row k of A~'s first TILED_AREG entries in registers, the rest read from
  // A_s: the same words, so the same bits, with fewer shared loads a step
  float Arow[TILED_AREG];
#pragma unroll
  for (int i = 0; i < TILED_AREG; ++i) Arow[i] = (active && i < K) ? ld_once(A + k * K + i) : 0.f;

  const size_t step_k = (size_t)B * K;
  const float* ab = MODES && alpha16 != nullptr ? nullptr : alpha + (size_t)b0 * K + k;
  const __nv_bfloat16* ab16 = MODES && alpha16 != nullptr ? alpha16 + (size_t)b0 * K + k
                                                                   : nullptr;
  auto a_at = [&](int t, int s) {
    const size_t o = (size_t)t * step_k + (size_t)s * K;
    if constexpr (MODES) return ab16 != nullptr ? __bfloat162float(ab16[o]) : ab[o];
    return ab[o];
  };

  float a_cur[S], a_prev[S], s_prev[S], sh_cur[S], beta[S], w_cur[S];
  int pick[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool ok = s < ns;
    const float* sb = s_in + (size_t)(b0 + s) * T;
    a_cur[s] = (ok && active) ? a_at(T - 1, s) : 0.f;
    a_prev[s] = (ok && active && T >= 2) ? a_at(T - 2, s) : 0.f;
    pick[s] = (MODES && sel != nullptr && ok) ? sel[b0 + s] : -1;
    s_prev[s] = (ok && T >= 2) ? sb[T - 2] : 1.f;
    sh_cur[s] = ok ? sh_in[(size_t)(b0 + s) * T + T - 1] : 0.f;
    beta[s] = 1.f / fmaxf(ok ? sb[T - 1] : 1.f, SUM_FLOOR);
    w_cur[s] = GATED ? (ok ? w_in[(size_t)(T - 1) * B + b0 + s] : 0.f) : 1.f;
  }
  __syncthreads();  // A~, W, the zeroed slots and eacc, the table

  for (int t = T - 1; t >= 0; --t) {
    const int p = t & 1;
    const int q = T - 1 - t;               // the step's place
    const int j = q / tw, i = q - j * tw;  // its window, and its step there
    float* dp = d_s + p * S * KMAX;
    float* ap = a_s + p * S * KMAX;
    float* rp = red + p * NWARP * S;
    float* lrow = lg + (j & 1) * rows * KMAX + (i * sg + g * S) * KMAX + k;  // + s KMAX
    if (i == 0) bar_sync(BAR_LL + 2 * g + (j & 1), NT + plan.nt);  // the window's likelihoods

    float a_n[S], s_n[S], sh_n[S], w_n[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool ok = s < ns;
      a_n[s] = (ok && active && t >= 2) ? a_at(t - 2, s) : 0.f;
      w_n[s] = GATED ? ((ok && t >= 1) ? w_in[(size_t)(t - 1) * B + b0 + s] : 0.f) : 1.f;
      s_n[s] = (ok && t >= 2) ? s_in[(size_t)(b0 + s) * T + t - 2] : 1.f;
      sh_n[s] = (ok && t >= 1) ? sh_in[(size_t)(b0 + s) * T + t - 1] : 0.f;
    }

    float graw[S], d[S], gs[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float lik = active ? expf(lrow[s * KMAX] - sh_cur[s]) : 0.f;
      graw[s] = a_cur[s] * beta[s];
      d[s] = t >= 1 ? (lik * (1.f / fmaxf(s_prev[s], SUM_FLOOR))) * beta[s] : 0.f;
      dp[s * KMAX + k] = d[s];
      ap[s * KMAX + k] = a_prev[s];
      gs[s] = graw[s];
    }
    fbc::warp_sums<S>(gs);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) rp[warp * S + s] = gs[s];
    }
    bar_sync(BAR_CHAIN + g, NT);  // d_t, a_{t-1} and the partial sums are complete

    float dn[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float n = s < ns ? 1.f / fmaxf(block_sum<S>(rp, s), SUM_FLOOR) : 0.f;
      const float gam = graw[s] * n;
      const float gw = GATED ? gam * w_cur[s] : gam;
      lrow[s * KMAX] = (active && s < ns) ? gw : 0.f;  // eacc's operand, in ll_t's place
      if (active && s < ns) {
        if (gamma != nullptr) gamma[((size_t)t * B + b0 + s) * K + k] = gam;
        float* g0 = gamma0 + (size_t)(b0 + s) * K + k;
        if (!MODES || sel == nullptr) {
          if (t == 0) *g0 = gw;
        } else if (t == pick[s]) {
          *g0 = gam;
        } else if (t == 0 && (pick[s] < 0 || pick[s] >= T)) {
          *g0 = 0.f;
        }
      }
      dn[s] = GATED ? (d[s] * n) * (w_n[s] * w_cur[s]) : d[s] * n;
    }
    if (i == tw - 1 || t == 0) bar_arrive(BAR_GW + (j & 1), nb);  // the window's w gamma

    // b'_{t-1} beside acc += outer(a_{t-1}, dn_t)
    float bn[S];
#pragma unroll
    for (int s = 0; s < S; ++s) bn[s] = 0.f;
#pragma unroll
    for (int i4 = 0; i4 < KMAX / 4; ++i4) {
      const float4 av = 4 * i4 < TILED_AREG ? make_float4(Arow[4 * i4], Arow[4 * i4 + 1],
                                                          Arow[4 * i4 + 2], Arow[4 * i4 + 3])
                                            : ld4(A_s + k * AST + 4 * i4);
      float4 x[S];
      ld4s<S>(x, dp + 4 * i4, KMAX);
      fma4<S>(bn, x, av.x, av.y, av.z, av.w);
      float4 y[S];
      ld4s<S>(y, ap + 4 * i4, KMAX);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        acc[4 * i4] = fmaf(y[s].x, dn[s], acc[4 * i4]);
        acc[4 * i4 + 1] = fmaf(y[s].y, dn[s], acc[4 * i4 + 1]);
        acc[4 * i4 + 2] = fmaf(y[s].z, dn[s], acc[4 * i4 + 2]);
        acc[4 * i4 + 3] = fmaf(y[s].w, dn[s], acc[4 * i4 + 3]);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      beta[s] = bn[s];
      a_cur[s] = a_prev[s];
      a_prev[s] = a_n[s];
      s_prev[s] = s_n[s];
      sh_cur[s] = sh_n[s];
      w_cur[s] = w_n[s];
    }
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < K) pb[i * K + k] = acc[i];
  }
}

}  // namespace fbwf
