// The fused pair's chain kernels up to K = 64 at any feature width F (the
// instances fused_fb_wide*.cu build for F > fbc::FMAX; fb_seqs.cuh holds the
// layout this follows, and its instances for F <= FMAX).
//
// What changes with the width. fb_seqs.cuh keeps column k of W (the
// forward) and row k of eacc (the backward) in registers and pads F to one
// of four compiled widths; neither scales past 64 features. Here F is a
// run-time loop bound over groups of four features (nf4 = ceil(F / 4)):
//   * W lies in dynamic shared memory, k-major, row k of W^T at k * wst with
//     wst = 4 (nws | 1): an odd number of 16-byte groups a row, so that the
//     float4 reads of 32 threads at 32 rows are free of bank conflicts (the
//     backward's W_s of fb_seqs.cuh, at any F). 64 x 260 floats at F = 256.
//     Its first nws groups, that is: as many as fit beside the block's other
//     arrays within SMEM_CAP (all of them up to F = 700 in the forward and
//     636 in the backward at S = 4 on the feature array); the groups beyond,
//     column k of W, are read from device memory (L2) at each step, in the
//     same order, so that the chain and its bits do not depend on where a
//     word lies. What bounds F is then the feature slots (S = 4 runs the
//     array to F = 3,020, S = 2 to 6,108).
//   * The feature rows of a step (S F floats a block) reach shared memory by
//     cp.async, several steps before they are read (WideRows below), as a
//     ring of slots [S][4 nf4] whose padding stays zero; a built kind
//     (fbc::FEATS_NIW, FEATS_NIG) copies the raw observation rows (S D
//     floats) instead and builds each feature in the step before it is read
//     (each product one __fmul_rn, ell_features' bits, as fbseq::ObsRows).
//   * ll_t is summed in blocks of 64 features (ll_from): the fmaf chain over
//     the first block, then each further block's own chain from zero, added
//     in order, over zero padding; in the forward and again in the
//     backward, so that lik_t is the same bits in both, and a built kind's
//     rows the array's.
//   * eacc leaves the chain: the backward writes w_t gamma_t for a window of
//     time steps a launch (fbs::WideStats, with acc kept in the chain), and
//     the eacc outer sums (3xTF32, fb_stats.cuh) add the windows in an order
//     fixed by (T, B, K, F). acc stays in registers, a column a thread, and
//     a window ends by writing it to the block's row of partials, which the
//     next window reads back and goes on summing into: the same fmaf chain
//     as in one launch. The windows carry b'_{t0-1} in `carry`, as the
//     large-K backward's do, so beta is the one recursion over all T.
// Everything else -- the matvec, the sums and maxima, the modes -- is
// fb_seqs.cuh's arithmetic, line for line. The instances run only at F >
// FMAX (nf4 > 16 groups), so the loop that interleaves ll's chain with the
// matvec's 16 groups needs no guard, and the forward keeps W's first 64
// rows of column k in registers, as the F = 64 instance does (the same
// words as W^T's in shared memory, so the same bits as the backward's).

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
// H100's 227 KB a block (opt-in) beside the forward's static arrays.
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
// forward's q is t, the backward's t1 - 1 - t); slot(q) holds row q as [S]
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

  // Before the chain's first barrier: rows 0 .. first - 1 ready to read (and
  // seen, after the caller's sync), and the copies the steps before r =
  // first would have asked for in flight. first is 1 (the backward reads row
  // 0 before its loop) or 2 (the forward reads rows 0 and 1); the forward's
  // row 2 of a built kind is built by build(2) after its peeled step.
  template <class RowOf>
  __device__ void prime(int first, RowOf row_of) const {
    if constexpr (BUILT) {
      for (int q = 0; q < 3; ++q) ask(q, row_of(q));
      fbs::cp_wait<0>();
      __syncthreads();
      build(0);
      build(1);
      __syncthreads();  // raw slots 0 and 1 are free
      for (int q = 3; q < first + 3; ++q) ask(q, row_of(q));
    } else {
      for (int q = 0; q < first + 2; ++q) ask(q, row_of(q));
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

// ll[s] over every group: the first block (KMAX / 4 groups) with W's rows
// from registers (wr, column k of W's first KMAX rows), the rest as
// ll_from's: the same sums over the same words as ll_from(..., 0).
template <int S>
__device__ __forceinline__ void ll_all(float (&ll)[S], const float (&wr)[KMAX], const float* wk,
                                       const WTail& wc, const float* slot, int fpr) {
#pragma unroll
  for (int f4 = 0; f4 < KMAX / 4; ++f4) {
    float4 y[S];
    ld4s<S>(y, slot + 4 * f4, fpr);
    fma4<S>(ll, y, wr[4 * f4], wr[4 * f4 + 1], wr[4 * f4 + 2], wr[4 * f4 + 3]);
  }
  ll_from<S>(ll, wk, wc, slot, fpr, KMAX / 4);
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

// The bytes of the forward's and the backward's dynamic shared memory
// beside W^T's rows, and W^T's groups there (smem_groups), at (S, F).
template <int S, int KIND>
__host__ __device__ inline int forward_fixed(int F) {
  return 4 * WideRows<S, KIND>::floats(F);
}

template <int S, int KIND>
__host__ __device__ inline int backward_fixed(int F) {
  return 4 * (KMAX * AST + 4 * S * KMAX + 2 * NWARP * S + WideRows<S, KIND>::floats(F));
}

// Dynamic shared memory, in bytes, of the forward and the backward at (S, F).
template <int S, int KIND>
__host__ __device__ inline int forward_smem(int F) {
  const int fixed = forward_fixed<S, KIND>(F);
  return fixed + 4 * KMAX * w_stride(smem_groups(F, fixed));
}

template <int S, int KIND>
__host__ __device__ inline int backward_smem(int F) {
  const int fixed = backward_fixed<S, KIND>(F);
  return fixed + 4 * KMAX * w_stride(smem_groups(F, fixed));
}

// fbseq::seq_forward with FEATS at any F: the same recursion, barriers and
// outputs (raw alpha, float32 or with ABF bf16 into alpha16; s of the stored
// values; sh), W^T in smem and the rows through WideRows. Every thread of
// the block calls it.
template <int S, int KIND, bool ABF>
__device__ __forceinline__ void seq_forward_wf(const float* __restrict__ pi,
                                               const float* __restrict__ A,
                                               const float* __restrict__ W,
                                               const float* __restrict__ src,
                                               float* __restrict__ alpha,
                                               float* __restrict__ s_out,
                                               float* __restrict__ sh_out, int T, int B, int K,
                                               int F, int blk, float* smem,
                                               __nv_bfloat16* __restrict__ alpha16) {
  __shared__ __align__(16) float a_s[2][S * KMAX];  // a_t in slot t & 1, zero beyond K
  __shared__ float red_max[2][NWARP * S];
  __shared__ float red_sum[2][NWARP * S];
  __shared__ float red_sr[2][NWARP * S];

  const int nf4 = groups(F), fpr = 4 * nf4;
  const int nws = smem_groups(F, forward_fixed<S, KIND>(F)), wst = w_stride(nws);
  const int b0 = blk * S;
  const int ns = min(S, B - b0);
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;
  float* W_s = smem;
  const float* wk = W_s + k * wst;
  const WTail wc{active ? W + k : nullptr, K, F, nws, nf4};
  const int in_w = fbc::obs_dim(KIND, F);  // F for the array
  const WideRows<S, KIND> rows(W_s + KMAX * wst, src + (size_t)b0 * in_w, B, F, ns, T);

  // column k of A~ and of W's first KMAX rows (F > KMAX), read once: as
  // volatile loads, which ptxas may not repeat in the loop to free registers
  float Acol[KMAX], Wcol[KMAX];
#pragma unroll
  for (int i = 0; i < KMAX; ++i) {
    Acol[i] = (active && i < K) ? ld_once(A + i * K + k) : 0.f;
    Wcol[i] = active ? ld_once(W + i * K + k) : 0.f;
  }
  const float pik = active ? pi[k] : 0.f;
  load_W(W, W_s, K, F, nws, wst);
  rows.init();
  for (int i = k; i < 2 * S * KMAX; i += NT) a_s[i / (S * KMAX)][i % (S * KMAX)] = 0.f;
  const size_t step_k = (size_t)B * K;
  const size_t a_base = (size_t)b0 * K + k;
  auto row_of = [](int q) { return q; };
  __syncthreads();  // W^T, the zeroed slots and the table
  rows.prime(2, row_of);

  float ll[S], m[S], inv[S], a[S], sm[S], mx[S];
#pragma unroll
  for (int s = 0; s < S; ++s) ll[s] = 0.f;
  ll_all<S>(ll, Wcol, wk, wc, rows.slot(0), fpr);
#pragma unroll
  for (int s = 0; s < S; ++s) mx[s] = active ? ll[s] : -INFINITY;
  fbc::warp_maxes<S>(mx);
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) red_max[0][warp * S + s] = mx[s];
  }
  __syncthreads();
  rows.build(2);  // a built kind's row 2, into row 0's slot (read above)
#pragma unroll
  for (int s = 0; s < S; ++s) {
    m[s] = block_max<S>(red_max[0], s);
    a[s] = active ? pik * expf(ll[s] - m[s]) : 0.f;
    ll[s] = 0.f;
  }
  ll_all<S>(ll, Wcol, wk, wc, rows.slot(1), fpr);  // ll_1 (unused when T = 1)

  for (int t = 0;; ++t) {
    const int p = t & 1;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      a_s[p][s * KMAX + k] = a[s];
      if (active && s < ns) {
        const size_t o = a_base + (size_t)t * step_k + (size_t)s * K;
        if constexpr (ABF)
          alpha16[o] = __float2bfloat16_rn(a[s]);
        else
          alpha[o] = a[s];
      }
      sm[s] = a[s];
      mx[s] = active ? ll[s] : -INFINITY;
    }
    fbc::warp_sums_maxes<S>(sm, mx);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        red_sum[p][warp * S + s] = sm[s];
        red_max[p ^ 1][warp * S + s] = mx[s];
      }
    }
    if constexpr (ABF) {
      float sr[S];
#pragma unroll
      for (int s = 0; s < S; ++s) sr[s] = fbc::bf16_round(a[s]);
      fbc::warp_sums<S>(sr);
      if (lane == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) red_sr[p][warp * S + s] = sr[s];
      }
    }
    fbs::cp_wait<1>();  // this thread's copies of row t + 2 (t + 3 built) have landed
    __syncthreads();    // a_t, row t + 2 and both partials are complete
    rows.advance(t + 2, row_of);

    float lik[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float sum = block_sum<S>(red_sum[p], s);
      inv[s] = 1.f / fmaxf(sum, SUM_FLOOR);
      if (k == s && s < ns) {
        s_out[(size_t)(b0 + s) * T + t] = ABF ? block_sum<S>(red_sr[p], s) : sum;
        sh_out[(size_t)(b0 + s) * T + t] = m[s];
      }
      m[s] = block_max<S>(red_max[p ^ 1], s);  // sh_{t+1}
      lik[s] = expf(ll[s] - m[s]);
    }
    if (t + 1 == T) break;

    // u_{t+1} = a_t @ A~ and ll_{t+2} = f_{t+2} . W: 2S chains in one loop
    // over the first 64 features, then the rest of ll's chain
    float u[S];
#pragma unroll
    for (int s = 0; s < S; ++s) u[s] = ll[s] = 0.f;
    const float* ap = a_s[p];
    const float* fp = rows.slot(t + 2);
#pragma unroll
    for (int i4 = 0; i4 < KMAX / 4; ++i4) {
      float4 x[S], y[S];
      ld4s<S>(x, ap + 4 * i4, KMAX);
      ld4s<S>(y, fp + 4 * i4, fpr);
      fma4<S>(ll, y, Wcol[4 * i4], Wcol[4 * i4 + 1], Wcol[4 * i4 + 2], Wcol[4 * i4 + 3]);
      fma4<S>(u, x, Acol[4 * i4], Acol[4 * i4 + 1], Acol[4 * i4 + 2], Acol[4 * i4 + 3]);
    }
    ll_from<S>(ll, wk, wc, fp, fpr, KMAX / 4);
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = active ? u[s] * (lik[s] * inv[s]) : 0.f;
  }
  fbs::cp_wait<0>();  // the copies asked for past T
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
  rows.prime(1, row_of);

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

}  // namespace fbwf
