// The duplex pair's kernels and the device code they share (duplex_fb.cu's
// head describes the kernels), for the two translation units of the
// duplex_fb library: duplex_fb.cu holds the launchers and the instances for
// features up to fbc::FMAX, duplex_fb_wide.cu the instances for wider ones,
// which read the likelihoods that fbs::ll_tile sums beforehand (the chain on
// fb_seqs.cuh's layout up to K = 64 and fb_wide.cuh's above, the combine
// beside them). A unit compiles only the instances it names, so the two
// build at once, one nvcc each (_build.py).

#pragma once

#include "fb_common.cuh"
#include "fb_seqs.cuh"
#include "fb_stats.cuh"
#include "fb_wide.cuh"

namespace fbd {
namespace {

using fbc::FMAX;
using fbc::KMAX;
using fbc::NT;
using fbc::NWARP;
using fbc::SUM_FLOOR;
using fbseq::block_max;
using fbseq::block_sum;
using fbseq::fma4;
using fbseq::ld4;
using fbseq::ld4s;
using fbseq::pad_f;
using fbseq::warp_sums_maxes;

// The backward message before its scale, e_t = lik_t b_t, and the scale
// 1 / sum_k b_t: the chain forms b_{t-1} = (A~ e_t) * back_scale and the
// combine d_t = e_t * back_scale, the same expressions in both kernels.
__device__ __forceinline__ float pair_e(float lik, float b) { return lik * b; }
__device__ __forceinline__ float back_scale(float bsum) {
  return 1.f / fmaxf(bsum, SUM_FLOOR);
}

// The raw backward recursion of the S sequences of block blk (the layout of
// fbseq::seq_forward, reversed in time): e_t in slot t & 1, the partial
// sums of b_t in slot t & 1 and the partial maxima of ll_t in slot t & 1.
// FEATS: ll_t = f_t . W in the kernel, f_t in slot t & 1, feats the feature
// array or for a built KIND the raw observations (the rows built as
// seq_forward's); else ll_t read from ll (T, B, K), `src`, through a ring of
// FWD_AHEAD slots in shared memory that each thread fills with its own
// elements by cp.async, FWD_AHEAD steps before they are read, as
// seq_forward's ll mode reads them (W and F unused, FP no width: no feature
// is read). Writes beta (T, B, K). Every thread of the block calls it.
template <int S, int FP, bool FEATS, int KIND = fbc::FEATS_ARRAY>
__device__ __forceinline__ void seq_backward(const float* __restrict__ A,
                                             const float* __restrict__ W,
                                             const float* __restrict__ src,
                                             float* __restrict__ beta, int T, int B, int K,
                                             int F, int blk) {
  constexpr int AHEAD = fbseq::FWD_AHEAD;
  __shared__ __align__(16) float f_s[2][FEATS ? S * FP : 4];  // f_t in slot t & 1
  __shared__ __align__(16) float e_s[2][S * KMAX];  // e_t in slot t & 1, zero beyond K
  __shared__ float red_max[2][NWARP * S];           // partial max of ll_t, slot t & 1
  __shared__ float red_sum[2][NWARP * S];           // partial sum of b_t, slot t & 1
  __shared__ float l_s[FEATS ? 1 : AHEAD * S * KMAX];  // ll of place q in slot q % AHEAD

  const int b0 = blk * S;
  const int ns = min(S, B - b0);
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  float Arow[KMAX];  // row k of A~
  float Wcol[FP];    // column k of W (FEATS)
#pragma unroll
  for (int i = 0; i < KMAX; ++i) Arow[i] = (active && i < K) ? A[k * K + i] : 0.f;
  if constexpr (FEATS) {
#pragma unroll
    for (int f = 0; f < FP; ++f) Wcol[f] = (active && f < F) ? W[f * K + k] : 0.f;
    for (int i = k; i < 2 * S * FP; i += NT) f_s[i / (S * FP)][i % (S * FP)] = 0.f;
  }
  for (int i = k; i < 2 * S * KMAX; i += NT) e_s[i / (S * KMAX)][i % (S * KMAX)] = 0.f;
  const int in_w = FEATS ? fbc::obs_dim(KIND, F) : K;  // floats of a (t, b) row of src
  const size_t step_f = (size_t)B * in_w;  // src stride of one time step
  const size_t step_k = (size_t)B * K;  // beta stride of one time step
  const float* fb = src + (size_t)b0 * in_w;
  float* bb = beta + (size_t)b0 * K + k;
  // the ll mode: ll_t of the block's sequences at place q = T - 1 - t (state
  // k of each, 0 before t = 0), asked for AHEAD places before it is read,
  // one cp.async group a place
  auto ll_ask = [&](int q) {
    const int t = T - 1 - q;
    float* slot = l_s + (q % AHEAD) * S * KMAX + k;
    const float* row = fb + (size_t)(t > 0 ? t : 0) * step_k + k;
#pragma unroll
    for (int s = 0; s < S; ++s)
      fbs::cp_async<1>(slot + s * KMAX, row + (size_t)s * K, t >= 0 && active && s < ns);
    fbs::cp_commit();
  };
  auto ll_row = [&](float (&v)[S], int q) {  // ll of place q, then ask for q + AHEAD
    fbs::cp_wait<AHEAD - 1>();
    const float* slot = l_s + (q % AHEAD) * S * KMAX + k;
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = slot[s * KMAX];
    ll_ask(q + AHEAD);
  };
  if constexpr (!FEATS) {
    for (int q = 0; q < AHEAD; ++q) ll_ask(q);
  }
  fbseq::RowsOf<S, FP, FEATS, KIND> rows(k, ns, F);
  __syncthreads();  // the zeroed slots before the rows land in them
  if constexpr (FEATS) {
    rows.load(fb + (size_t)(T - 1) * step_f);
    rows.store(f_s[(T - 1) & 1]);
    if (T > 1) {
      rows.load(fb + (size_t)(T - 2) * step_f);
      rows.store(f_s[(T - 2) & 1]);
    }
    if (T > 2) rows.load(fb + (size_t)(T - 3) * step_f);  // f_{T-3}, stored in step T-1
  }
  __syncthreads();

  float ll[S];   // ll_{t-1} in the loop
  float lik[S];  // lik_t
  float b[S];    // b_t
  float sm[S], mx[S];

  // step T-1 (b_{T-1} = 1, lik_{T-1}), then ll_{T-2}; the loop runs the steps
  // t <= T-1, each forming b_{t-1}, so that the matvec and the next ll are
  // both live in every iteration
  if constexpr (FEATS) {
#pragma unroll
    for (int s = 0; s < S; ++s) ll[s] = 0.f;
#pragma unroll
    for (int f4 = 0; f4 < FP / 4; ++f4) {
      float4 y[S];
      ld4s<S>(y, f_s[(T - 1) & 1] + 4 * f4, FP);
      fma4<S>(ll, y, Wcol[4 * f4], Wcol[4 * f4 + 1], Wcol[4 * f4 + 2], Wcol[4 * f4 + 3]);
    }
  } else {
    ll_row(ll, 0);
  }
#pragma unroll
  for (int s = 0; s < S; ++s) mx[s] = active ? ll[s] : -INFINITY;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) mx[s] = fmaxf(mx[s], __shfl_xor_sync(fbseq::FULL, mx[s], o));
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) red_max[(T - 1) & 1][warp * S + s] = mx[s];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const float m = block_max<S>(red_max[(T - 1) & 1], s);
    lik[s] = active ? expf(ll[s] - m) : 0.f;
    b[s] = active ? 1.f : 0.f;
    if (active && s < ns) bb[(size_t)(T - 1) * step_k + (size_t)s * K] = b[s];
    ll[s] = 0.f;
  }
  if constexpr (FEATS) {
#pragma unroll
    for (int f4 = 0; f4 < FP / 4; ++f4) {  // ll_{T-2} (a stale row when T = 1: unused)
      float4 y[S];
      ld4s<S>(y, f_s[(T - 2) & 1] + 4 * f4, FP);
      fma4<S>(ll, y, Wcol[4 * f4], Wcol[4 * f4 + 1], Wcol[4 * f4 + 2], Wcol[4 * f4 + 3]);
    }
  } else {
    ll_row(ll, 1);  // ll_{T-2} (0 when T = 1: unused)
  }

  for (int t = T - 1; t >= 1; --t) {
    const int p = t & 1;
    // b_t, lik_t and ll_{t-1} are in registers: store e_t, reduce sum b_t and
    // max ll_{t-1}, one barrier
#pragma unroll
    for (int s = 0; s < S; ++s) {
      e_s[p][s * KMAX + k] = pair_e(lik[s], b[s]);
      sm[s] = b[s];
      mx[s] = active ? ll[s] : -INFINITY;
    }
    warp_sums_maxes<S>(sm, mx);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        red_sum[p][warp * S + s] = sm[s];
        red_max[p ^ 1][warp * S + s] = mx[s];
      }
    }
    if (FEATS && t >= 2) {  // f_{t-2} into f_t's slot; f_{t-3} into registers
      rows.store(f_s[p]);
      if (t >= 3) rows.load(fb + (size_t)(t - 3) * step_f);
    }
    __syncthreads();  // e_t, f_{t-2} and both partials are complete

    float scale[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      scale[s] = back_scale(block_sum<S>(red_sum[p], s));
      const float m = block_max<S>(red_max[p ^ 1], s);  // sh_{t-1}
      lik[s] = active ? expf(ll[s] - m) : 0.f;           // lik_{t-1}
    }

    // u = A~ e_t (row k, j = 0..KMAX-1 in order) and (FEATS) ll_{t-2} =
    // f_{t-2} . W: 2S independent fmaf chains in one loop (at t < 2 a stale
    // row: unused)
    float u[S];
#pragma unroll
    for (int s = 0; s < S; ++s) u[s] = ll[s] = 0.f;
    const float* ep = e_s[p];  // e_t
    const float* fp = f_s[p];  // f_{t-2}
#pragma unroll
    for (int i4 = 0; i4 < KMAX / 4; ++i4) {
      float4 x[S];
      ld4s<S>(x, ep + 4 * i4, KMAX);
      if (FEATS && 4 * i4 < FP) {
        float4 y[S];
        ld4s<S>(y, fp + 4 * i4, FP);
        fma4<S>(ll, y, Wcol[4 * i4], Wcol[4 * i4 + 1], Wcol[4 * i4 + 2], Wcol[4 * i4 + 3]);
      }
      fma4<S>(u, x, Arow[4 * i4], Arow[4 * i4 + 1], Arow[4 * i4 + 2], Arow[4 * i4 + 3]);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      b[s] = active ? u[s] * scale[s] : 0.f;  // b_{t-1}
      if (active && s < ns) bb[(size_t)(t - 1) * step_k + (size_t)s * K] = b[s];
    }
    if constexpr (!FEATS) ll_row(ll, T + 1 - t);  // ll_{t-2} (0 at t < 2: unused)
  }
  if constexpr (!FEATS) fbs::cp_wait<0>();  // the copies asked for before t = 0
}

template <int S, int FP, int KIND>
__global__ void __launch_bounds__(NT)
duplex_chain_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                    const float* __restrict__ W, const float* __restrict__ feats,
                    float* __restrict__ alpha, float* __restrict__ s_out,
                    float* __restrict__ sh_out, float* __restrict__ beta, int T, int B, int K,
                    int F) {
  if (blockIdx.y == 0)
    fbseq::seq_forward<S, FP, true, KIND>(pi, A, W, feats, alpha, s_out, sh_out, T, B, K, F,
                                          blockIdx.x);
  else
    seq_backward<S, FP, true, KIND>(A, W, feats, beta, T, B, K, F, blockIdx.x);
}

// The chain at F > FMAX up to K = 64, on the likelihoods ll (T, B, K) that
// fbs::ll_tile summed beforehand, on a grid of (ceil(B/S), 2) blocks of NT
// threads: blockIdx.y = 0 runs fbseq::seq_forward in its ll mode (the fused
// WF forward's own function, fused_fwd_wf_kernel, so alpha, s and sh are its
// bits at the same S), 1 the raw backward above in its ll mode. Neither
// holds W nor a feature row, so one instance a S serves every feature kind
// and width.
template <int S>
__global__ void __launch_bounds__(NT)
duplex_chain_ll_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                       const float* __restrict__ ll, float* __restrict__ alpha,
                       float* __restrict__ s_out, float* __restrict__ sh_out,
                       float* __restrict__ beta, int T, int B, int K) {
  if (blockIdx.y == 0)
    fbseq::seq_forward<S, fbseq::LL_FP, false>(pi, A, nullptr, ll, alpha, s_out, sh_out, T, B,
                                               K, 0, blockIdx.x);
  else
    seq_backward<S, fbseq::LL_FP, false>(A, nullptr, ll, beta, T, B, K, 0, blockIdx.x);
}

// The raw backward recursion of the S sequences of block blk on
// fb_wide.cuh's layout (65 <= K <= 256; the layout of fbw::seqs_backward,
// blocks and missing sequences as fbw::seqs_forward), t = T-1 .. 1:
// b_{T-1} = 1, e_t = lik_t b_t, b_{t-1} = (A~ e_t) * back_scale(sum_k b_t),
// with lik_t = exp(ll_t - max_k ll_t), the max taken here over the same
// numbers as the forward's sh_t. FEATS: ll_t = f_t . W by the forward's
// chain (WCol; a built KIND reads the raw observations, fbw::feat_rows);
// else ll_t read from ll (T, B, K), `src`, a step before it is needed, as
// fbw::seqs_forward reads it without FEATS (W and F unused). Writes beta
// (T, B, K). Thread k runs state k of all S sequences on column k of A~^T
// (MatCol, rows in registers and shared memory): each word of A~^T (and of
// W) it reads in a step feeds S chains, one a sequence, and each chain is
// the one-sequence arithmetic (the matvec over i = 0..KP-1 in order, the
// sums and maxima each warp's butterfly, then the warps in order), so beta
// does not depend on S. Two barriers a step. Every thread of the block
// calls it.
template <int KP, int S, bool FEATS, int KIND = fbc::FEATS_ARRAY>
__device__ void seqs_raw_backward(const float* __restrict__ A, const float* __restrict__ W,
                                  const float* __restrict__ src, float* __restrict__ beta,
                                  int T, int B, int K, int F, int blk, float* smem) {
  using TT = fbw::Tier<KP>;
  constexpr int NW = TT::NWARP;
  constexpr int fs = FMAX;                // floats of a sequence's feature row
  float* M_s = smem;                      // A~^T rows RR..KP-1
  float* e_s = M_s + TT::SR * KP;         // e_t in slot t & 1, [S][KP] each
  float* f_s = e_s + 2 * S * KP;          // f_t in slot t & 1, [S][fs] each (FEATS)
  float* red_max = f_s + 2 * S * fs;      // partial maxima of ll_t, [t & 1][S][warp]
  float* red_sum = red_max + 2 * S * NW;  // partial sums of b_t, [t & 1][S][warp]
  const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
  const bool active = k < K;
  const int b0 = blk * S, ns = S == 1 ? 1 : min(S, B - b0);  // sequences held
  const int nf4 = (F + 3) / 4;

  fbw::MatCol<KP> col;
  col.load(A, M_s, K, true, k);
  fbw::WCol wc;
  if (FEATS) wc.load(W, K, F, k);
  const int D = fbc::obs_dim(KIND, F);    // built kinds: the observations' width
  const int in_w = FEATS ? D : K;         // floats of a (t, b) row of src
  const size_t step_f = (size_t)B * in_w, step_k = (size_t)B * K;
  const float* fb = src + (size_t)b0 * in_w;
  float* bb = beta + (size_t)b0 * K + k;
  if (FEATS) {
    for (int i = k; i < 2 * S * fs; i += KP) f_s[i] = 0.f;
  }
  __syncthreads();
  if (FEATS)
    fbw::feat_rows<S, KIND>(f_s + ((T - 1) & 1) * S * fs, fb + (size_t)(T - 1) * step_f, ns, F,
                            k, KP, D);
  float l_next[S];  // not FEATS: ll_t, read a step ahead
#pragma unroll
  for (int s = 0; s < S; ++s)
    l_next[s] = (!FEATS && active && s < ns) ? fb[(size_t)(T - 1) * step_k + s * K + k] : 0.f;
  __syncthreads();

  float bt[S];  // b_t
#pragma unroll
  for (int s = 0; s < S; ++s) {
    bt[s] = active ? 1.f : 0.f;
    if (active && s < ns) bb[(size_t)(T - 1) * step_k + (size_t)s * K] = bt[s];
  }
  for (int t = T - 1; t >= 1; --t) {
    const int p = t & 1;
    float ll[S], wm[S], ws[S];
    if (FEATS) {
      wc.template lls<S>(ll, f_s + p * S * fs, fs, nf4);
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        ll[s] = l_next[s];
        if (active && s < ns) l_next[s] = fb[(size_t)(t - 1) * step_k + s * K + k];
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      wm[s] = active ? ll[s] : -INFINITY;
      ws[s] = bt[s];
    }
    fbc::warp_maxes<S>(wm);
    fbc::warp_sums<S>(ws);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        red_max[(p * S + s) * NW + warp] = wm[s];
        red_sum[(p * S + s) * NW + warp] = ws[s];
      }
    }
    if (FEATS)
      fbw::feat_rows<S, KIND>(f_s + (p ^ 1) * S * fs, fb + (size_t)(t - 1) * step_f, ns, F, k,
                              KP, D);
    __syncthreads();  // f_t is read; the maxima and sums are complete

    float scale[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float m = fbw::block_max<NW>(red_max + (p * S + s) * NW);
      scale[s] = back_scale(fbw::block_sum<NW>(red_sum + (p * S + s) * NW));
      e_s[(p * S + s) * KP + k] = active ? pair_e(expf(ll[s] - m), bt[s]) : 0.f;
    }
    __syncthreads();  // e_t is complete

    // b_{t-1}[k] = sum_j A~[k][j] e_t[j] / sum_k b_t, for the S sequences at once
    float u[S];
    col.template dots<S>(u, e_s + p * S * KP, KP, M_s, k);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      bt[s] = active ? u[s] * scale[s] : 0.f;
      if (active && s < ns) bb[(size_t)(t - 1) * step_k + (size_t)s * K] = bt[s];
    }
  }
}

// The large-K chain on a grid of (ceil(B/S), 2) blocks of KP threads, S
// sequences a block: blockIdx.y = 0 runs the forward (fbw::seqs_forward, the
// fused large-K forward's own function at the same S), 1 the raw backward
// above.
template <int KP, int S, int KIND>
__global__ void __launch_bounds__(KP)
duplex_chain_wide_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                         const float* __restrict__ W, const float* __restrict__ feats,
                         float* __restrict__ alpha, float* __restrict__ s_out,
                         float* __restrict__ sh_out, float* __restrict__ beta, int T, int B,
                         int K, int F) {
  extern __shared__ __align__(16) float smem[];
  if (blockIdx.y == 0)
    fbw::seqs_forward<KP, S, true, KIND>(pi, A, W, feats, alpha, s_out, sh_out, T, B, K, F,
                                         blockIdx.x, smem);
  else
    seqs_raw_backward<KP, S, true, KIND>(A, W, feats, beta, T, B, K, F, blockIdx.x, smem);
}

// The large-K chain at F > FMAX, on the likelihoods ll (T, B, K) that
// fbs::ll_tile summed beforehand, over all T in one launch: the forward
// fused_fwd_wide_ll_kernel's (fbw::seqs_forward without FEATS, whose
// windows run this one recursion bit for bit), the backward the raw one
// above reading ll. Neither holds W nor a feature row, so one instance a
// (KP, S) serves every feature kind and width, in fbw::chain_smem_bytes.
template <int KP, int S>
__global__ void __launch_bounds__(KP)
duplex_chain_wide_ll_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                            const float* __restrict__ ll, float* __restrict__ alpha,
                            float* __restrict__ s_out, float* __restrict__ sh_out,
                            float* __restrict__ beta, int T, int B, int K) {
  extern __shared__ __align__(16) float smem[];
  if (blockIdx.y == 0)
    fbw::seqs_forward<KP, S, false>(pi, A, nullptr, ll, alpha, s_out, sh_out, T, B, K, 0,
                                    blockIdx.x, smem);
  else
    seqs_raw_backward<KP, S, false>(A, nullptr, ll, beta, T, B, K, 0, blockIdx.x, smem);
}

// ----------------------------------------------------------------- combine

constexpr int CNT = 256;           // threads of a combine block
constexpr int CW = CNT / 32;       // its warps: the block's sequences, one a warp
constexpr int CTT = 8;             // time steps a stage of the K <= 64 combine
constexpr int COMBINE_BLOCKS = 264;  // the most blocks a combine launch aims at (2 an SM
                                     // x 132 SMs, one wave on the H100; a constant, so
                                     // the chunks do not depend on the card)

// The combine's shared memory in floats: W's columns as rows of FP + 4
// floats (conflict-free float4 reads by state), then, K <= 64, a stage's
// a_{t-1} rows (CTT + 1 slots), dn and gw rows and feature rows, [slot][warp]
// each; above, two feature rows a warp.
template <int KP, int FP>
constexpr int combine_smem_floats() {
  return KP * (FP + 4) + (KP == KMAX ? (CTT + 1) * CW * KMAX + 2 * CTT * CW * KMAX + CTT * CW * FP
                                     : CW * 2 * FP);
}

// What a warp reads of two consecutive rows (t, b) and (t + 1, b) of one
// sequence (valid when okb and t + r < t_end): lane l holds the states
// l + 32 j of a_t and b_t and the feature floats l + 32 i; a warp loads the
// next pair while it computes this one, so the loads' latency hides behind
// the work.
template <int KP, int FP>
struct RowLoad {
  static constexpr int J = KP / 32;
  static constexpr int FL = (FP + 31) / 32;
  bool valid[2];
  float a[2][J], bv[2][J], f[2][FL], g[2][FL], sh[2], w[2];  // g: a built feature's 2nd factor
};

// Where lane l's features l + 32 i of a built kind come from (fbc::feat_src;
// ia = ja = -1 beyond F as for the constant), fixed for the kernel.
template <int FP>
struct LaneFeats {
  static constexpr int FL = (FP + 31) / 32;
  int ia[FL], ja[FL];

  __device__ LaneFeats(int kind, int D, int F) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int i = 0; i < FL; ++i) {
      ia[i] = ja[i] = -1;
      if (kind != fbc::FEATS_ARRAY && lane + 32 * i < F)
        fbc::feat_src(kind, D, lane + 32 * i, ia[i], ja[i]);
    }
  }
};

// feats holds the feature array, or for a built KIND the raw observations
// (D floats a row): then f holds each feature's first factor (1 for the
// constant) and g its second, multiplied where the row is stored (row_pair).
template <int KP, int FP, bool GATED, int KIND>
__device__ __forceinline__ void load_rows(RowLoad<KP, FP>& in, const LaneFeats<FP>& lf,
                                          const float* __restrict__ feats,
                                          const float* __restrict__ alpha,
                                          const float* __restrict__ beta,
                                          const float* __restrict__ sh_in,
                                          const float* __restrict__ w_in, int t, int t_end,
                                          bool okb, int b, int T, int B, int K, int F, int D) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tr = t + r;
    const bool valid = okb && tr < t_end;
    in.valid[r] = valid;
    const size_t row = ((size_t)tr * B + b) * K;
#pragma unroll
    for (int j = 0; j < RowLoad<KP, FP>::J; ++j) {
      const int k = lane + 32 * j;
      const bool ok = valid && k < K;
      in.a[r][j] = ok ? alpha[row + k] : 0.f;
      in.bv[r][j] = ok ? beta[row + k] : 0.f;
    }
    const float* frow = feats + ((size_t)tr * B + b) * D;
#pragma unroll
    for (int i = 0; i < RowLoad<KP, FP>::FL; ++i) {
      const int f = lane + 32 * i;
      if (KIND == fbc::FEATS_ARRAY) {
        in.f[r][i] = (valid && f < F) ? frow[f] : 0.f;
      } else {
        in.f[r][i] = !(valid && f < F) ? 0.f : lf.ia[i] >= 0 ? frow[lf.ia[i]] : 1.f;
        in.g[r][i] = (valid && lf.ja[i] >= 0) ? frow[lf.ja[i]] : 0.f;
      }
    }
    in.sh[r] = valid ? sh_in[(size_t)b * T + tr] : 0.f;
    in.w[r] = GATED ? (valid ? w_in[(size_t)tr * B + b] : 0.f) : 1.f;
  }
}

// One warp's share of the two rows: dn = d_t ginv_{t-1} pg_t (0 at t = 0)
// and gw = w_t gamma_t, 0 for an invalid row or state.
template <int KP>
struct RowPair {
  static constexpr int J = KP / 32;
  float dn[2][J];
  float gw[2][J];
};

// The sum over a row's states in the chain's order: each group of 32 (a warp
// of the chain's block) by the butterfly of fbc::warp_sum -- every lane ends
// with the same bits, float addition being commutative -- then the groups in
// order. v[n][j] holds lane l's state l + 32 j of the n-th sum.
template <int N, int J>
__device__ __forceinline__ void row_sums(float (&v)[N][J], float (&out)[N]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
#pragma unroll
      for (int j = 0; j < J; ++j) v[n][j] += __shfl_xor_sync(fbseq::FULL, v[n][j], o);
    }
  }
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float s = v[n][0];
#pragma unroll
    for (int j = 1; j < J; ++j) s += v[n][j];
    out[n] = s;
  }
}

// The feature floats lane + 32 i of the two rows of `in` into the warp's
// shared rows fr[r]: a built KIND's formed here from their factors.
template <int KP, int FP, int KIND>
__device__ __forceinline__ void store_feats(const RowLoad<KP, FP>& in, const LaneFeats<FP>& lf,
                                            float* const (&fr)[2]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < RowLoad<KP, FP>::FL; ++i)
      if (lane + 32 * i < FP)
        fr[r][lane + 32 * i] = KIND == fbc::FEATS_ARRAY
                                   ? in.f[r][i]
                                   : fbc::feat_of(in.f[r][i], in.g[r][i], lf.ja[i] >= 0);
}

// What the combine makes of the rows' ll = f . W[:, lane + 32 j] (the chain's
// sums): gamma and gamma0 written, dn and gw into `out`, ginv and w carried.
// Rows: RowLoad or RowLoadLL (the rows' a, bv, sh, w and valid).
template <int KP, bool GATED, class Rows>
__device__ __forceinline__ void row_finish(RowPair<KP>& out, const Rows& in,
                                           const float (&ll)[2][KP / 32],
                                           float* __restrict__ gamma, float* __restrict__ gamma0,
                                           int t, int b, int B, int K, float& ginv_prev,
                                           float& w_prev) {
  constexpr int J = KP / 32;
  const int lane = threadIdx.x & 31;
  // sum g_t and sum b_t of both rows, in the chain's order
  float v[4][J], sums[4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      v[r][j] = in.a[r][j] * in.bv[r][j];
      v[2 + r][j] = in.bv[r][j];
    }
  row_sums<4, J>(v, sums);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tr = t + r;
    const float ginv = 1.f / fmaxf(sums[r], SUM_FLOOR);
    const float scale = back_scale(sums[2 + r]);
    const size_t row = ((size_t)tr * B + b) * K;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int k = lane + 32 * j;
      const bool ok = in.valid[r] && k < K;
      const float gam = (in.a[r][j] * in.bv[r][j]) * ginv;
      const float gw = GATED ? gam * in.w[r] : gam;  // the statistics' gamma: kept steps
      float dn = 0.f;
      if (tr >= 1) {
        const float lik = expf(ll[r][j] - in.sh[r]);
        const float d = pair_e(lik, in.bv[r][j]) * scale;
        dn = GATED ? (d * ginv_prev) * (w_prev * in.w[r]) : d * ginv_prev;
      }
      out.gw[r][j] = ok ? gw : 0.f;
      out.dn[r][j] = ok ? dn : 0.f;
      if (ok) {
        if (gamma != nullptr) gamma[row + k] = gam;
        if (tr == 0) gamma0[(size_t)b * K + k] = gw;
      }
    }
    ginv_prev = ginv;
    w_prev = in.w[r];
  }
}

// The rows (t, b), (t + 1, b) of `in` by one warp: gamma (when not null) and
// gamma0 written, dn and gw into `out`. fr[r] is the warp's shared row for
// f_{t+r} (FP floats, 16-byte aligned), left holding it (zero beyond F).
// ginv_prev and w_prev carry ginv_{t-1} and w_{t-1} in and ginv_{t+1} and
// w_{t+1} out. A built KIND's features are formed here from their factors.
template <int KP, int FP, bool GATED, int KIND>
__device__ __forceinline__ void row_pair(RowPair<KP>& out, const RowLoad<KP, FP>& in,
                                         const LaneFeats<FP>& lf, const float* W_s,
                                         float* const (&fr)[2], float* __restrict__ gamma,
                                         float* __restrict__ gamma0, int t, int b, int B, int K,
                                         float& ginv_prev, float& w_prev) {
  constexpr int J = KP / 32;
  constexpr int WST = FP + 4;
  const int lane = threadIdx.x & 31;
  store_feats<KP, FP, KIND>(in, lf, fr);
  __syncwarp();  // the feature rows are complete

  // ll = f_t . W[:, k], the fmaf chain over f = 0..FP-1 in order
  float ll[2][J];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int j = 0; j < J; ++j) ll[r][j] = 0.f;
#pragma unroll
  for (int f4 = 0; f4 < FP / 4; ++f4) {
    float4 y[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) y[r] = ld4(fr[r] + 4 * f4);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float4 wv = ld4(W_s + (lane + 32 * j) * WST + 4 * f4);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        ll[r][j] = fmaf(y[r].x, wv.x, ll[r][j]);
        ll[r][j] = fmaf(y[r].y, wv.y, ll[r][j]);
        ll[r][j] = fmaf(y[r].z, wv.z, ll[r][j]);
        ll[r][j] = fmaf(y[r].w, wv.w, ll[r][j]);
      }
    }
  }

  row_finish<KP, GATED>(out, in, ll, gamma, gamma0, t, b, B, K, ginv_prev, w_prev);
}

// ginv_{t-1} and w_{t-1} of sequence b at the row before a chunk's first
// (t >= 1), and a_{t-1} into a_prev: read and recomputed, nothing is carried
// across blocks.
template <int KP, bool GATED>
__device__ __forceinline__ void halo_row(float (&a_prev)[KP / 32], float& ginv_prev, float& w_prev,
                                         const float* __restrict__ alpha,
                                         const float* __restrict__ beta,
                                         const float* __restrict__ w_in, int t, bool okb, int b,
                                         int B, int K) {
  constexpr int J = KP / 32;
  const int lane = threadIdx.x & 31;
  const size_t row = ((size_t)t * B + b) * K;
  float v[1][J], sum[1];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int k = lane + 32 * j;
    const bool ok = okb && k < K;
    a_prev[j] = ok ? alpha[row + k] : 0.f;
    v[0][j] = a_prev[j] * (ok ? beta[row + k] : 0.f);
  }
  row_sums<1, J>(v, sum);
  ginv_prev = 1.f / fmaxf(sum[0], SUM_FLOOR);
  w_prev = (GATED && okb) ? w_in[(size_t)t * B + b] : 0.f;
}

// The combine over the rows t0 <= t < t1 of its blocks: block (x, y) takes
// sequences 8x .. 8x+7 and time steps [t0 + y chunk, t0 + (y + 1) chunk).
// KP = 64: acc and eacc in-kernel, one row of partials a block in part;
// KP = 128, 256: dn and gw of the window into dn_out and gw_out, (t1 - t0,
// B, K) each from t0.
template <int KP, int FP, bool GATED, int KIND>
__global__ void __launch_bounds__(CNT, KP == KMAX ? 2 : 1)
duplex_combine_kernel(const float* __restrict__ W, const float* __restrict__ feats,
                      const float* __restrict__ alpha, const float* __restrict__ beta,
                      const float* __restrict__ sh_in, const float* __restrict__ w_in,
                      float* __restrict__ gamma, float* __restrict__ gamma0,
                      float* __restrict__ part, float* __restrict__ dn_out,
                      float* __restrict__ gw_out, int T, int B, int K, int F, int chunk, int t0,
                      int t1) {
  constexpr int J = KP / 32;
  constexpr int WST = FP + 4;
  extern __shared__ __align__(16) float smem[];
  float* W_s = smem;  // W[f][k] at k * WST + f, zero outside (F, K)
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x * CW + warp;
  const bool okb = b < B;
  const int t_begin = t0 + blockIdx.y * chunk;
  const int t_end = min(t1, t_begin + chunk);
  const int D = fbc::obs_dim(KIND, F);  // floats of a (t, b) row of feats
  const LaneFeats<FP> lf(KIND, D, F);

  for (int idx = tid; idx < KP * WST; idx += CNT) {
    const int k = idx / WST, f = idx % WST;
    W_s[idx] = (k < K && f < F) ? W[f * K + k] : 0.f;
  }
  float a_prev[J], ginv_prev = 0.f, w_prev = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) a_prev[j] = 0.f;
  if (t_begin >= 1)
    halo_row<KP, GATED>(a_prev, ginv_prev, w_prev, alpha, beta, w_in, t_begin - 1, okb, b, B, K);

  if constexpr (KP == KMAX) {
    float* a_s = W_s + KMAX * WST;             // a_{t-1} of stage row i at (i CW + warp) KMAX
    float* dn_s = a_s + (CTT + 1) * CW * KMAX;  // dn_t at (i CW + warp) KMAX
    float* gw_s = dn_s + CTT * CW * KMAX;       // gw_t
    float* f_s = gw_s + CTT * CW * KMAX;        // f_t at (i CW + warp) FP
    const int ty = tid / 16, tx = tid % 16;
    constexpr int FC = FP / 16;  // eacc columns a thread: f = tx + 16 c
    float acc[4][4], eacc[4][FC];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;
#pragma unroll
      for (int c = 0; c < FC; ++c) eacc[a][c] = 0.f;
    }
    __syncthreads();  // W_s is complete

    RowLoad<KP, FP> cur, nxt;
    load_rows<KP, FP, GATED, KIND>(cur, lf, feats, alpha, beta, sh_in, w_in, t_begin, t_end, okb,
                                   b, T, B, K, F, D);
    for (int ts = t_begin; ts < t_end; ts += CTT) {
      // the rows: warp w walks sequence b over the stage's CTT steps
#pragma unroll
      for (int j = 0; j < J; ++j) a_s[warp * KMAX + lane + 32 * j] = a_prev[j];
#pragma unroll
      for (int i = 0; i < CTT; i += 2) {
        load_rows<KP, FP, GATED, KIND>(nxt, lf, feats, alpha, beta, sh_in, w_in, ts + i + 2,
                                       t_end, okb, b, T, B, K, F, D);
        RowPair<KP> rp;
        float* const fr[2] = {f_s + (i * CW + warp) * FP, f_s + ((i + 1) * CW + warp) * FP};
        row_pair<KP, FP, GATED, KIND>(rp, cur, lf, W_s, fr, gamma, gamma0, ts + i, b, B, K,
                                      ginv_prev, w_prev);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int o = ((i + r) * CW + warp) * KMAX + lane;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            a_s[o + CW * KMAX + 32 * j] = cur.a[r][j];  // slot i + r + 1
            dn_s[o + 32 * j] = rp.dn[r][j];
            gw_s[o + 32 * j] = rp.gw[r][j];
          }
        }
#pragma unroll
        for (int j = 0; j < J; ++j) a_prev[j] = cur.a[1][j];
        cur = nxt;
      }
      __syncthreads();  // the stage's rows are complete

      // acc += a_{t-1} (x) dn_t and eacc += gw_t (x) f_t over the stage's rows
#pragma unroll 4
      for (int row = 0; row < CTT * CW; ++row) {
        const float4 xv = ld4(a_s + row * KMAX + 4 * ty);
        const float4 yv = ld4(dn_s + row * KMAX + 4 * tx);
        const float4 gv = ld4(gw_s + row * KMAX + 4 * ty);
        const float x[4] = {xv.x, xv.y, xv.z, xv.w};
        const float y[4] = {yv.x, yv.y, yv.z, yv.w};
        const float g[4] = {gv.x, gv.y, gv.z, gv.w};
        float fv[FC];
#pragma unroll
        for (int c = 0; c < FC; ++c) fv[c] = f_s[row * FP + tx + 16 * c];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
#pragma unroll
          for (int c = 0; c < FC; ++c) eacc[a][c] = fmaf(g[a], fv[c], eacc[a][c]);
        }
      }
      __syncthreads();  // the stage buffers are free again
    }

    // this block's row of partials: acc (K, K), then eacc (K, F)
    float* pb = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * (K * K + K * F);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = 4 * ty + a;
      if (i >= K) continue;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (4 * tx + c < K) pb[i * K + 4 * tx + c] = acc[a][c];
#pragma unroll
      for (int c = 0; c < FC; ++c)
        if (tx + 16 * c < F) pb[K * K + i * F + tx + 16 * c] = eacc[a][c];
    }
  } else {
    float* f_s = W_s + KP * WST;  // two feature rows a warp
    float* const fr[2] = {f_s + (2 * warp) * FP, f_s + (2 * warp + 1) * FP};
    __syncthreads();  // W_s is complete
    RowLoad<KP, FP> cur, nxt;
    load_rows<KP, FP, GATED, KIND>(cur, lf, feats, alpha, beta, sh_in, w_in, t_begin, t_end, okb,
                                   b, T, B, K, F, D);
    for (int t = t_begin; t < t_end; t += 2) {
      load_rows<KP, FP, GATED, KIND>(nxt, lf, feats, alpha, beta, sh_in, w_in, t + 2, t_end, okb,
                                     b, T, B, K, F, D);
      RowPair<KP> rp;
      row_pair<KP, FP, GATED, KIND>(rp, cur, lf, W_s, fr, gamma, gamma0, t, b, B, K, ginv_prev,
                                    w_prev);
      cur = nxt;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!okb || t + r >= t_end) continue;
        const size_t ow = ((size_t)(t + r - t0) * B + b) * K;  // in the window
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < K) {
            gw_out[ow + k] = rp.gw[r][j];
            if (t + r >= 1) dn_out[ow + k] = rp.dn[r][j];
          }
        }
      }
      __syncwarp();  // the feature rows are read before the next pair's land
    }
  }
}

// ------------------------------------------------- the combine on read ll
//
// At F > FMAX the combine reads ll_t (T, B, K), which fbs::ll_tile summed
// for the chain beforehand, where the instances above form f_t . W: the
// chain's own sums (each element a fmaf chain over each block of 64
// features, the blocks added in order), so d_t is the e_t and scale that
// built b_{t-1}. A warp loads the K-wide ll row of (t, b) beside its alpha
// and beta rows, a pair of rows ahead, and neither W nor a feature row
// reaches the kernel: one instance a (KP, GATED) serves every feature kind
// and width. eacc leaves the kernel: the rows write w_t gamma_t for a window
// of time steps (fbs::WideStats), and the outer sums (3xTF32) add the
// windows against the window's feature rows (a built kind's built there).
// Up to K = 64 acc stays in registers as in duplex_combine_kernel, a block's
// row of partials read back and written each window (WideStats with blocks
// > 0); above, dn goes out with gw as there.

// What a warp reads of two consecutive rows (t, b) and (t + 1, b) of one
// sequence (valid when okb and t + r < t_end): lane l holds the states
// l + 32 j of a_t, b_t and ll_t.
template <int KP>
struct RowLoadLL {
  static constexpr int J = KP / 32;
  bool valid[2];
  float a[2][J], bv[2][J], l[2][J], sh[2], w[2];
};

template <int KP, bool GATED>
__device__ __forceinline__ void load_rows_ll(RowLoadLL<KP>& in, const float* __restrict__ ll,
                                             const float* __restrict__ alpha,
                                             const float* __restrict__ beta,
                                             const float* __restrict__ sh_in,
                                             const float* __restrict__ w_in, int t, int t_end,
                                             bool okb, int b, int T, int B, int K) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int tr = t + r;
    const bool valid = okb && tr < t_end;
    in.valid[r] = valid;
    const size_t row = ((size_t)tr * B + b) * K;
#pragma unroll
    for (int j = 0; j < RowLoadLL<KP>::J; ++j) {
      const int k = lane + 32 * j;
      const bool ok = valid && k < K;
      in.a[r][j] = ok ? alpha[row + k] : 0.f;
      in.bv[r][j] = ok ? beta[row + k] : 0.f;
      in.l[r][j] = ok ? ll[row + k] : 0.f;
    }
    in.sh[r] = valid ? sh_in[(size_t)b * T + tr] : 0.f;
    in.w[r] = GATED ? (valid ? w_in[(size_t)tr * B + b] : 0.f) : 1.f;
  }
}

// The combine on read ll over the rows t0 <= t < t1 of a window of the
// statistics, the blocks as duplex_combine_kernel's: KP = 64 keeps acc in
// registers, starting from the block's row of partials in `part` (rows of
// K K, read back when t1 < T, the windows running last first) and writing
// it back, and writes gw for the window into gw_out; KP = 128, 256 write dn
// and gw, (t1 - t0, B, K) each from t0.
template <int KP, bool GATED>
__global__ void __launch_bounds__(CNT, KP == KMAX ? 2 : 1)
duplex_combine_ll_kernel(const float* __restrict__ ll, const float* __restrict__ alpha,
                         const float* __restrict__ beta, const float* __restrict__ sh_in,
                         const float* __restrict__ w_in, float* __restrict__ gamma,
                         float* __restrict__ gamma0, float* __restrict__ part,
                         float* __restrict__ dn_out, float* __restrict__ gw_out, int T, int B,
                         int K, int chunk, int t0, int t1) {
  constexpr int J = KP / 32;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.x * CW + warp;
  const bool okb = b < B;
  const int t_begin = t0 + blockIdx.y * chunk;
  const int t_end = min(t1, t_begin + chunk);
  float a_prev[J], ginv_prev = 0.f, w_prev = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) a_prev[j] = 0.f;
  if (t_begin >= 1)
    halo_row<KP, GATED>(a_prev, ginv_prev, w_prev, alpha, beta, w_in, t_begin - 1, okb, b, B, K);

  RowLoadLL<KP> cur, nxt;
  load_rows_ll<KP, GATED>(cur, ll, alpha, beta, sh_in, w_in, t_begin, t_end, okb, b, T, B, K);
  if constexpr (KP == KMAX) {
    __shared__ __align__(16) float a_s[(CTT + 1) * CW * KMAX];  // a_{t-1} of stage row i at
                                                               // (i CW + warp) KMAX
    __shared__ __align__(16) float dn_s[CTT * CW * KMAX];       // dn_t at (i CW + warp) KMAX
    const int ty = tid / 16, tx = tid % 16;
    float* pb = part + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * K * K;
    float acc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * ty + a, j = 4 * tx + c;
        acc[a][c] = (t1 < T && i < K && j < K) ? pb[i * K + j] : 0.f;
      }
    for (int ts = t_begin; ts < t_end; ts += CTT) {
#pragma unroll
      for (int j = 0; j < J; ++j) a_s[warp * KMAX + lane + 32 * j] = a_prev[j];
#pragma unroll
      for (int i = 0; i < CTT; i += 2) {
        load_rows_ll<KP, GATED>(nxt, ll, alpha, beta, sh_in, w_in, ts + i + 2, t_end, okb, b, T,
                                B, K);
        RowPair<KP> rp;
        row_finish<KP, GATED>(rp, cur, cur.l, gamma, gamma0, ts + i, b, B, K, ginv_prev, w_prev);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int o = ((i + r) * CW + warp) * KMAX + lane;
          const size_t ow = ((size_t)(ts + i + r - t0) * B + b) * K;  // in the window
#pragma unroll
          for (int j = 0; j < J; ++j) {
            a_s[o + CW * KMAX + 32 * j] = cur.a[r][j];  // slot i + r + 1
            dn_s[o + 32 * j] = rp.dn[r][j];
            if (cur.valid[r] && lane + 32 * j < K) gw_out[ow + lane + 32 * j] = rp.gw[r][j];
          }
        }
#pragma unroll
        for (int j = 0; j < J; ++j) a_prev[j] = cur.a[1][j];
        cur = nxt;
      }
      __syncthreads();  // the stage's rows are complete

      // acc += a_{t-1} (x) dn_t over the stage's rows
#pragma unroll 4
      for (int row = 0; row < CTT * CW; ++row) {
        const float4 xv = ld4(a_s + row * KMAX + 4 * ty);
        const float4 yv = ld4(dn_s + row * KMAX + 4 * tx);
        const float x[4] = {xv.x, xv.y, xv.z, xv.w};
        const float y[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
        for (int a = 0; a < 4; ++a)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
      }
      __syncthreads();  // the stage buffers are free again
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = 4 * ty + a, j = 4 * tx + c;
        if (i < K && j < K) pb[i * K + j] = acc[a][c];
      }
  } else {
    for (int t = t_begin; t < t_end; t += 2) {
      load_rows_ll<KP, GATED>(nxt, ll, alpha, beta, sh_in, w_in, t + 2, t_end, okb, b, T, B, K);
      RowPair<KP> rp;
      row_finish<KP, GATED>(rp, cur, cur.l, gamma, gamma0, t, b, B, K, ginv_prev, w_prev);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (!cur.valid[r]) continue;
        const size_t ow = ((size_t)(t + r - t0) * B + b) * K;  // in the window
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int k = lane + 32 * j;
          if (k < K) {
            gw_out[ow + k] = rp.gw[r][j];
            if (t + r >= 1) dn_out[ow + k] = rp.dn[r][j];
          }
        }
      }
      cur = nxt;
    }
  }
}

}  // namespace

// The instances at F > FMAX (defined in duplex_fb_wide.cu, which alone
// instantiates them), the chain's dynamic shared bytes in *smem; null for
// an S not built.
const void* ll_chain_instance(int S, int K, int* smem);
const void* ll_combine_instance(int K, bool gated);

}  // namespace fbd
