// Duplex E-step kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the duplex E-step:
//   duplex_chain_kernel    <- pysvihmm_tpu/messages/pallas_duplex.py:82 (_duplex_kernel)
//   duplex_combine_kernel  <- pysvihmm_tpu/messages/pallas_duplex.py:175 (_combine_kernel)
// The host wrapper and the plain PyTorch twin of both kernels live in
// pysvihmm_tpu_torch/messages/duplex_fb.py.
//
// What is computed (the TPU kernels' math, without their time tiles, lane
// packing and tile-edge carries); lik_t = exp(ll_t - max_k ll_t) with
// ll_t = f_t . W (the fused kernels' fmaf chain over f in order):
//   chain, forward, t = 0 .. T-1 (the fused forward's recursion):
//                         a_0 = pi~ * lik_0
//                         a_t = (a_{t-1} @ A~) * (lik_t / s_{t-1})
//                         s_t = sum_k a_t,  sh_t = max_k ll_t
//   chain, backward, t = T-1 .. 1, raw beta (normalisation deferred):
//                         b_{T-1} = 1
//                         e_t = lik_t * b_t
//                         b_{t-1} = (A~ e_t) * (1 / sum_k b_t)
//     The scale is applied after the matvec, as the forward applies
//     1 / s_{t-1} after its own, so the matvec does not wait for the sum.
//     Writes raw a_t, s_t, sh_t and raw b_t.
//   combine, chain-free, for every t:
//                         g_t = a_t * b_t,  ginv_t = 1 / sum_k g_t,  gamma_t = g_t ginv_t
//                         d_t = e_t * (1 / sum_k b_t)   (pallas_duplex.py:249)
//                         acc  += outer(a_{t-1}, d_t ginv_{t-1} pg_t)   (t >= 1;
//                                 the wrapper forms A~ * acc)
//                         eacc += outer(w_t gamma_t, f_t)
//                         gamma0 = w_0 gamma_0
//     The xi normaliser of the pair (t-1, t) is sum(a_{t-1} * A~ d_t) =
//     sum(a_{t-1} * b_{t-1}) = 1 / ginv_{t-1}, so no scale array crosses the
//     kernels (pallas_duplex.py:19-29). It holds to the last bit only if
//     d_t here is the e_t and scale that built b_{t-1}: ll_t comes from the
//     same fmaf chain, the shift is the forward's sh_t (the same max of the
//     same numbers), and sum_k b_t is reduced in the chain's order (each
//     warp's butterfly over 32 states, then the warps in order).
//     Gated mode (SVI windows) takes the kept-mask w (T, B) and forms the
//     pair gate pg_t = w_{t-1} w_t (pg_0 = 0) itself; ungated, w = pg = 1.
//     The gates touch the statistics only: gamma written out is ungated.
//     Every per-sequence sum is floored at SUM_FLOOR (pallas_fb.py:82).
//
// The chain, K <= 64: duplex_chain_kernel<S, FP> on a grid of (ceil(B/S), 2)
// blocks of 64 threads in fb_seqs.cuh's layout (S sequences a block, thread
// k running state k of all S). blockIdx.y = 0 runs fbseq::seq_forward, the
// fused forward's own function, so alpha, s and sh are the fused forward's
// bit for bit; blockIdx.y = 1 runs the backward on the same scheme: row k of
// A~ and column k of W in registers, loaded once; e_t of the S sequences
// read from shared memory as float4 broadcasts, each feeding S FMAs; ll_{t-1}
// and its max computed a step ahead in the matvec's loop; step T-1 peeled;
// one barrier a step. Both halves are chains of dependent K-wide products,
// bound by latency, not bytes or FLOPs; the two directions run side by side
// when 2 ceil(B/S) blocks fit one wave (the wrapper picks S from the card's
// occupancy). Above K = 64 duplex_chain_wide_kernel<KP, S> (KP = 128 or
// 256 padded states, S = 1, 2, 4 or 8) runs the same scheme on fb_wide.cuh's
// layout: a forward and a backward block for each S sequences, the forward
// fbw::seqs_forward (the fused large-K forward's at the same S) and the
// backward seqs_raw_backward, thread k running state k of all S on column k
// of A~^T, so each word of A~^T and W read in a step feeds S FMAs; beta is
// the same bits at every S. A step of either half at KP = 256, S = 8 holds S
// KP^2 FMAs and S KP / 4 broadcast float4 loads a thread, the fused
// forward's work; one block an SM at KP = 256 (218 KB of shared memory at S
// = 8), so the 2 ceil(B/S) blocks of B = 1024 take two waves there and one
// at KP = 128, S = 8 (2 blocks an SM).
//
// Both kernels take the fused pair's built feature kinds (KIND; pallas_duplex.py
// :290, `in_kernel_feats`): the chain's blocks build their rows as
// seq_forward does, the combine's warps load each feature's factors with
// the row and form it where the row is stored (LaneFeats), and above K = 64
// eacc's operand is built a window at a time (fbs::WideStats); every output
// is the array mode's bit for bit. alpha stays float32 here, as in JAX.
//
// The combine has no chain: every (t, b) row needs only a_t, b_t, f_t, sh_t
// and the pair's ginv_{t-1}. duplex_combine_kernel<KP, FP, GATED> takes a
// tile of 8 sequences (one a warp; lane j of a warp holds states j, j + 32,
// ...) by a chunk of time steps. Each warp walks its sequence two rows at a
// time (coalesced loads of the K-wide alpha and beta rows, the feature row
// into shared memory for the likelihood's broadcast, W's columns as rows of
// shared memory read as float4) and carries ginv and w from one row to the
// next, so no barrier is tied to a time step. Per row it writes gamma,
// gamma0 and forms dn_t = d_t ginv_{t-1} pg_t and gw_t = w_t gamma_t.
//   K <= 64 (KP = 64): the rows of a stage of 8 time steps x 8 sequences
//     land in shared memory (a_{t-1}, dn_t, gw_t, f_t), and after one
//     barrier all 256 threads add them into acc and eacc as register-blocked
//     outer products: thread (ty, tx) of 16 x 16 owns a 4 x 4 block of acc
//     and 4 x FP/16 of eacc, reads its operands as float4 (each load feeding
//     4 FMAs) and keeps the sums in registers over the whole chunk; a second
//     barrier frees the stage buffers. Each block writes one row of
//     partials, which fbs::sum_partials adds in block order.
//   K = 65..256 (KP = 128, 256): the rows write dn and gw for a window of
//     time steps (fbs::WideStats), and the outer sums of fb_stats.cuh add
//     them.
// The grid is (ceil(B/8), chunks), the chunks cut so that the launch holds
// at most about COMBINE_BLOCKS blocks, one wave at 2 blocks an SM: a function
// of (T, B) only, so the sums run in the same order on every card and call.
// What bounds the K <= 64 combine:
// per (t, b) about 2K (2F + K) + 10K flops (the likelihood dot, the two outer
// products) against 4 (F + 2K) bytes in, so FLOPs by a little (FMAs at 67
// TFLOP/s); the design keeps the FMA pipe fed with few shared-memory loads
// per FMA.

#include "fb_common.cuh"
#include "fb_seqs.cuh"
#include "fb_stats.cuh"
#include "fb_wide.cuh"

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
// fbseq::seq_forward, reversed in time): f_t in slot t & 1, e_t in slot
// t & 1, the partial sums of b_t in slot t & 1 and the partial maxima of
// ll_t in slot t & 1. feats holds the feature array, or for a built KIND the
// raw observations (the rows built as seq_forward's). Writes beta (T, B,
// K). Every thread of the block calls it.
template <int S, int FP, int KIND>
__device__ __forceinline__ void seq_backward(const float* __restrict__ A,
                                             const float* __restrict__ W,
                                             const float* __restrict__ feats,
                                             float* __restrict__ beta, int T, int B, int K,
                                             int F, int blk) {
  __shared__ __align__(16) float f_s[2][S * FP];    // f_t in slot t & 1
  __shared__ __align__(16) float e_s[2][S * KMAX];  // e_t in slot t & 1, zero beyond K
  __shared__ float red_max[2][NWARP * S];           // partial max of ll_t, slot t & 1
  __shared__ float red_sum[2][NWARP * S];           // partial sum of b_t, slot t & 1

  const int b0 = blk * S;
  const int ns = min(S, B - b0);
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  float Arow[KMAX];  // row k of A~
  float Wcol[FP];    // column k of W
#pragma unroll
  for (int i = 0; i < KMAX; ++i) Arow[i] = (active && i < K) ? A[k * K + i] : 0.f;
#pragma unroll
  for (int f = 0; f < FP; ++f) Wcol[f] = (active && f < F) ? W[f * K + k] : 0.f;

  for (int i = k; i < 2 * S * FP; i += NT) f_s[i / (S * FP)][i % (S * FP)] = 0.f;
  for (int i = k; i < 2 * S * KMAX; i += NT) e_s[i / (S * KMAX)][i % (S * KMAX)] = 0.f;
  const int in_w = fbc::obs_dim(KIND, F);  // floats of a (t, b) row of feats
  const size_t step_f = (size_t)B * in_w;  // feats stride of one time step
  const size_t step_k = (size_t)B * K;  // beta stride of one time step
  const float* fb = feats + (size_t)b0 * in_w;
  float* bb = beta + (size_t)b0 * K + k;
  fbseq::RowsOf<S, FP, true, KIND> rows(k, ns, F);
  __syncthreads();  // the zeroed slots before the rows land in them
  rows.load(fb + (size_t)(T - 1) * step_f);
  rows.store(f_s[(T - 1) & 1]);
  if (T > 1) {
    rows.load(fb + (size_t)(T - 2) * step_f);
    rows.store(f_s[(T - 2) & 1]);
  }
  if (T > 2) rows.load(fb + (size_t)(T - 3) * step_f);  // f_{T-3}, stored in step T-1
  __syncthreads();

  float ll[S];   // ll_{t-1} in the loop
  float lik[S];  // lik_t
  float b[S];    // b_t
  float sm[S], mx[S];

  // step T-1 (b_{T-1} = 1, lik_{T-1}), then ll_{T-2}; the loop runs the steps
  // t <= T-1, each forming b_{t-1}, so that the matvec and the next ll are
  // both live in every iteration
#pragma unroll
  for (int s = 0; s < S; ++s) ll[s] = 0.f;
#pragma unroll
  for (int f4 = 0; f4 < FP / 4; ++f4) {
    float4 y[S];
    ld4s<S>(y, f_s[(T - 1) & 1] + 4 * f4, FP);
    fma4<S>(ll, y, Wcol[4 * f4], Wcol[4 * f4 + 1], Wcol[4 * f4 + 2], Wcol[4 * f4 + 3]);
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
#pragma unroll
  for (int f4 = 0; f4 < FP / 4; ++f4) {  // ll_{T-2} (a stale row when T = 1: unused)
    float4 y[S];
    ld4s<S>(y, f_s[(T - 2) & 1] + 4 * f4, FP);
    fma4<S>(ll, y, Wcol[4 * f4], Wcol[4 * f4 + 1], Wcol[4 * f4 + 2], Wcol[4 * f4 + 3]);
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
    if (t >= 2) {  // f_{t-2} into f_t's slot; f_{t-3} into registers
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

    // u = A~ e_t (row k, j = 0..KMAX-1 in order) and ll_{t-2} = f_{t-2} . W:
    // 2S independent fmaf chains in one loop (at t < 2 a stale row: unused)
    float u[S];
#pragma unroll
    for (int s = 0; s < S; ++s) u[s] = ll[s] = 0.f;
    const float* ep = e_s[p];  // e_t
    const float* fp = f_s[p];  // f_{t-2}
#pragma unroll
    for (int i4 = 0; i4 < KMAX / 4; ++i4) {
      float4 x[S];
      ld4s<S>(x, ep + 4 * i4, KMAX);
      if (4 * i4 < FP) {
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
  }
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
    seq_backward<S, FP, KIND>(A, W, feats, beta, T, B, K, F, blockIdx.x);
}

// The raw backward recursion of the S sequences of block blk on
// fb_wide.cuh's layout (65 <= K <= 256; the layout of fbw::seqs_backward,
// blocks and missing sequences as fbw::seqs_forward), t = T-1 .. 1:
// b_{T-1} = 1, e_t = lik_t b_t, b_{t-1} = (A~ e_t) * back_scale(sum_k b_t),
// with ll_t = f_t . W by the forward's chain (WCol) and lik_t = exp(ll_t -
// max_k ll_t), the max taken here over the same numbers as the forward's sh_t.
// Writes beta (T, B, K). Thread k runs state k of all S sequences on column
// k of A~^T (MatCol, rows in registers and shared memory): each word of A~^T
// and of W it reads in a step feeds S chains, one a sequence, and each chain
// is the one-sequence arithmetic (the matvec over i = 0..KP-1 in order, the
// sums and maxima each warp's butterfly, then the warps in order), so beta
// does not depend on S. Two barriers a step. A built KIND reads the raw
// observations (fbw::feat_rows). Every thread of the block calls it.
template <int KP, int S, int KIND>
__device__ void seqs_raw_backward(const float* __restrict__ A, const float* __restrict__ W,
                                  const float* __restrict__ feats, float* __restrict__ beta,
                                  int T, int B, int K, int F, int blk, float* smem) {
  using TT = fbw::Tier<KP>;
  constexpr int NW = TT::NWARP;
  float* M_s = smem;                     // A~^T rows RR..KP-1
  float* e_s = M_s + TT::SR * KP;        // e_t in slot t & 1, [S][KP] each
  float* f_s = e_s + 2 * S * KP;         // f_t in slot t & 1, [S][FMAX] each
  float* red_max = f_s + 2 * S * FMAX;   // partial maxima of ll_t, [t & 1][S][warp]
  float* red_sum = red_max + 2 * S * NW;  // partial sums of b_t, [t & 1][S][warp]
  const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
  const bool active = k < K;
  const int b0 = blk * S, ns = S == 1 ? 1 : min(S, B - b0);  // sequences held
  const int nf4 = (F + 3) / 4;

  fbw::MatCol<KP> col;
  col.load(A, M_s, K, true, k);
  fbw::WCol wc;
  wc.load(W, K, F, k);
  const int D = fbc::obs_dim(KIND, F);  // floats of a (t, b) row of feats
  const size_t step_f = (size_t)B * D, step_k = (size_t)B * K;
  const float* fb = feats + (size_t)b0 * D;
  float* bb = beta + (size_t)b0 * K + k;
  for (int i = k; i < 2 * S * FMAX; i += KP) f_s[i] = 0.f;
  __syncthreads();
  fbw::feat_rows<S, KIND>(f_s + ((T - 1) & 1) * S * FMAX, fb + (size_t)(T - 1) * step_f, ns, F,
                          k, KP, D);
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
    wc.lls<S>(ll, f_s + p * S * FMAX, FMAX, nf4);
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
    fbw::feat_rows<S, KIND>(f_s + (p ^ 1) * S * FMAX, fb + (size_t)(t - 1) * step_f, ns, F, k,
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
    seqs_raw_backward<KP, S, KIND>(A, W, feats, beta, T, B, K, F, blockIdx.x, smem);
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
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int i = 0; i < RowLoad<KP, FP>::FL; ++i)
      if (lane + 32 * i < FP)
        fr[r][lane + 32 * i] = KIND == fbc::FEATS_ARRAY
                                   ? in.f[r][i]
                                   : fbc::feat_of(in.f[r][i], in.g[r][i], lf.ja[i] >= 0);
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

bool bad_shape(int T, int B, int K, int F) {
  return T < 1 || B < 1 || K < 1 || K > fbw::KWIDE || F < 1 || F > FMAX;
}

// The time steps a combine block takes of `steps` (a multiple of `mult`): the
// launch holds at most about COMBINE_BLOCKS blocks of CW sequences (more only
// where the groups alone outnumber them), whatever the card.
int combine_chunk(int steps, int B, int mult) {
  const int groups = (B + CW - 1) / CW;
  const int want = max(1, COMBINE_BLOCKS / groups);  // chunks a group
  const int chunk = (steps + want - 1) / want;
  return (chunk + mult - 1) / mult * mult;
}

// A feature kind the kernels take, whose width F is.
bool bad_kind(int kind, int F) {
  return kind < fbc::FEATS_ARRAY || kind > fbc::FEATS_NIG || fbc::obs_dim(kind, F) < 1;
}

// Floats of scratch the combine takes: K <= KMAX, a row of partials a block;
// above, a window's dn and gw, the two outer sums' partials and (a built
// kind) the window's feature rows (fbs::WideStats).
long long scratch_floats(int T, int B, int K, int F, int kind) {
  if (K <= KMAX) {
    const int chunk = combine_chunk(T, B, CTT);
    return (long long)((B + CW - 1) / CW) * ((T + chunk - 1) / chunk) * (K * K + K * F);
  }
  return fbs::WideStats::floats(T, B, K, F, kind);
}

// The chain instance of (S, F, KIND) up to K = 64: the S-sequence kernel at
// FP = pad_f(F).
template <int S, int KIND>
const void* chain_fp(int fp) {
  switch (fp) {
    case 16: return reinterpret_cast<const void*>(duplex_chain_kernel<S, 16, KIND>);
    case 32: return reinterpret_cast<const void*>(duplex_chain_kernel<S, 32, KIND>);
    case 48: return reinterpret_cast<const void*>(duplex_chain_kernel<S, 48, KIND>);
    default: return reinterpret_cast<const void*>(duplex_chain_kernel<S, 64, KIND>);
  }
}

template <int KP, int S, int KIND>
const void* wide_chain_at(int* smem) {
  *smem = fbw::chain_smem_bytes<KP, S>();
  return reinterpret_cast<const void*>(duplex_chain_wide_kernel<KP, S, KIND>);
}

template <int KP, int KIND>
const void* wide_chain_of(int S, int* smem) {
  switch (S) {
    case 1: return wide_chain_at<KP, 1, KIND>(smem);
    case 2: return wide_chain_at<KP, 2, KIND>(smem);
    case 4: return wide_chain_at<KP, 4, KIND>(smem);
    case 8: return wide_chain_at<KP, 8, KIND>(smem);
    default: *smem = 0; return nullptr;
  }
}

// The chain instance of (S, K, F, KIND) and its dynamic shared bytes in
// *smem: S in {2, 4} up to K = 64, in {1, 2, 4, 8} at KP = tier_of(K)
// above. Null for an S not built.
template <int KIND>
const void* chain_kind(int S, int K, int F, int* smem) {
  if (K > KMAX)
    return fbw::tier_of(K) == 128 ? wide_chain_of<128, KIND>(S, smem)
                                  : wide_chain_of<256, KIND>(S, smem);
  *smem = 0;
  switch (S) {
    case 2: return chain_fp<2, KIND>(pad_f(F));
    case 4: return chain_fp<4, KIND>(pad_f(F));
    default: return nullptr;
  }
}

const void* chain_of(int S, int K, int F, int kind, int* smem) {
  switch (kind) {
    case fbc::FEATS_ARRAY: return chain_kind<fbc::FEATS_ARRAY>(S, K, F, smem);
    case fbc::FEATS_NIW: return chain_kind<fbc::FEATS_NIW>(S, K, F, smem);
    case fbc::FEATS_NIG: return chain_kind<fbc::FEATS_NIG>(S, K, F, smem);
    default: *smem = 0; return nullptr;
  }
}

template <bool GATED, int KIND>
const void* combine_fp(int fp) {
  switch (fp) {
    case 16: return reinterpret_cast<const void*>(duplex_combine_kernel<KMAX, 16, GATED, KIND>);
    case 32: return reinterpret_cast<const void*>(duplex_combine_kernel<KMAX, 32, GATED, KIND>);
    case 48: return reinterpret_cast<const void*>(duplex_combine_kernel<KMAX, 48, GATED, KIND>);
    default: return reinterpret_cast<const void*>(duplex_combine_kernel<KMAX, 64, GATED, KIND>);
  }
}

template <int FP>
constexpr int combine_bytes_fp() {
  return 4 * combine_smem_floats<KMAX, FP>();
}

template <int KP, int KIND>
const void* combine_wide(bool gated) {
  return gated ? reinterpret_cast<const void*>(duplex_combine_kernel<KP, FMAX, true, KIND>)
               : reinterpret_cast<const void*>(duplex_combine_kernel<KP, FMAX, false, KIND>);
}

// The combine instance of (K, F, gated, KIND) and its dynamic shared bytes
// in *smem: KP = 64 at FP = pad_f(F) up to K = 64, KP = 128 or 256 at FP =
// FMAX above.
template <int KIND>
const void* combine_kind(int K, int F, bool gated, int* smem) {
  if (K <= KMAX) {
    const int fp = pad_f(F);
    *smem = fp == 16 ? combine_bytes_fp<16>() : fp == 32 ? combine_bytes_fp<32>()
          : fp == 48 ? combine_bytes_fp<48>() : combine_bytes_fp<64>();
    return gated ? combine_fp<true, KIND>(fp) : combine_fp<false, KIND>(fp);
  }
  if (fbw::tier_of(K) == 128) {
    *smem = 4 * combine_smem_floats<128, FMAX>();
    return combine_wide<128, KIND>(gated);
  }
  *smem = 4 * combine_smem_floats<256, FMAX>();
  return combine_wide<256, KIND>(gated);
}

const void* combine_of(int K, int F, bool gated, int kind, int* smem) {
  switch (kind) {
    case fbc::FEATS_ARRAY: return combine_kind<fbc::FEATS_ARRAY>(K, F, gated, smem);
    case fbc::FEATS_NIW: return combine_kind<fbc::FEATS_NIW>(K, F, gated, smem);
    case fbc::FEATS_NIG: return combine_kind<fbc::FEATS_NIG>(K, F, gated, smem);
    default: *smem = 0; return nullptr;
  }
}

}  // namespace

extern "C" {

// The largest K the launchers take (the large-K instances'), and F.
int duplex_fb_kmax() { return fbw::KWIDE; }
int duplex_fb_fmax() { return FMAX; }

const char* duplex_fb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// *out = the floats of scratch duplex_fb_combine takes at these shapes.
int duplex_fb_scratch(int T, int B, int K, int F, int kind, long long* out) {
  if (bad_shape(T, B, K, F) || bad_kind(kind, F)) return static_cast<int>(cudaErrorInvalidValue);
  *out = scratch_floats(T, B, K, F, kind);
  return 0;
}

// Each launcher returns the launch's CUDA error right after it (0 = ok).
// Pointers are device pointers of contiguous float32 tensors; the kernels
// run on `stream` and do not synchronise. S is the sequences a block of the
// chain: 2 or 4 up to K = 64, 1, 2, 4 or 8 above; any other is refused.
// kind names what feats holds, as fused_fb.cu's launchers take it: the
// (T, B, F) feature array, or the raw (T, B, D) observations of a built
// kind, F its width at D (an F no D gives is refused).
int duplex_fb_chain(const float* pi, const float* A, const float* W, const float* feats,
                    float* alpha, float* s, float* sh, float* beta, int T, int B, int K,
                    int F, int S, int kind, int device, void* stream) {
  if (bad_shape(T, B, K, F) || bad_kind(kind, F)) return static_cast<int>(cudaErrorInvalidValue);
  int smem = 0;
  const void* fn = chain_of(S, K, F, kind, &smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  void* args[] = {&pi, &A, &W, &feats, &alpha, &s, &sh, &beta, &T, &B, &K, &F};
  const dim3 grid((B + S - 1) / S, 2);
  if (K > KMAX) return static_cast<int>(fbw::launch_dyn(fn, grid, fbw::tier_of(K), smem, st, args));
  e = cudaLaunchKernel(fn, grid, dim3(NT), args, 0, st);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// Launches of the outer sums' kernel (fbs::outer_sum) by this library's
// large-K launcher since the count was last cleared; clears it when `clear`.
int duplex_fb_outer_launches(int clear) {
  return fbs::outer_launches(clear != 0);
}

// Launches of the large-K combine's operand kernels (fbs::build_feats,
// which = 0; fbs::widen, 1, which this library never runs) since the count
// was last cleared; clears it when `clear`.
int duplex_fb_prep_launches(int which, int clear) {
  return fbs::prep_launches(which, clear != 0);
}

// w is null for the ungated launch, else the (T, B) kept-mask. stats
// receives acc (K, K) and then eacc (K, F), summed in a fixed order
// (fb_stats.cuh); scratch holds duplex_fb_scratch floats. Above K = 64 the
// combine runs a window of time steps a launch (fbs::WideStats), its
// blocks' chunks cut from the window.
int duplex_fb_combine(const float* W, const float* feats, const float* alpha,
                      const float* beta, const float* sh, const float* w, float* gamma,
                      float* gamma0, float* stats, float* scratch, int T, int B, int K, int F,
                      int kind, int device, void* stream) {
  if (bad_shape(T, B, K, F) || bad_kind(kind, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int smem = 0;
  const void* fn = combine_of(K, F, w != nullptr, kind, &smem);
  const int groups = (B + CW - 1) / CW;
  if (K <= KMAX) {
    int chunk = combine_chunk(T, B, CTT), t0 = 0, t1 = T;
    const int nchunks = (T + chunk - 1) / chunk;
    float *dn = nullptr, *gw = nullptr;
    void* args[] = {&W,  &feats, &alpha, &beta, &sh,    &w,  &gamma, &gamma0, &scratch,
                    &dn, &gw,    &T,     &B,    &K,     &F,  &chunk, &t0,     &t1};
    e = fbw::launch_dyn(fn, dim3(groups, nchunks), CNT, smem, st, args);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(fbs::sum_partials(scratch, groups * nchunks, K * K + K * F, stats, st));
  }
  const fbs::WideStats ws(scratch, T, B, K, F, kind);
  float *dn = ws.dn, *gw = ws.gw, *part = nullptr;
  int chunk = combine_chunk(ws.steps, B, 2);
  return static_cast<int>(ws.run(alpha, nullptr, feats, stats, st, [&](int t0, int t1) {
    void* args[] = {&W,  &feats, &alpha, &beta, &sh, &w, &gamma, &gamma0, &part,
                    &dn, &gw,    &T,     &B,    &K,  &F, &chunk, &t0,     &t1};
    return fbw::launch_dyn(fn, dim3(groups, (t1 - t0 + chunk - 1) / chunk), CNT, smem, st, args);
  }));
}

// What the instance (which, S, K, F) of the launchers above takes on
// `device`: out[0] registers a thread, out[1] static and out[2] dynamic
// shared bytes a block, out[3] local (spilled) bytes a thread, out[4]
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// out[5] the device's SMs, out[6] threads a block. which = 0 the chain (S
// sequences a block), 1 the combine, 2 the gated combine (S unused); K > 64
// names the large-K instance of its KP; kind the feature kind.
int duplex_fb_kernel_info(int which, int S, int K, int F, int kind, int device, int* out) {
  if (bad_shape(1, 1, K, F) || bad_kind(kind, F) || which < 0 || which > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int smem = 0;
  const void* fn = which == 0 ? chain_of(S, K, F, kind, &smem)
                              : combine_of(K, F, which == 2, kind, &smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = which != 0 ? CNT : K > KMAX ? fbw::tier_of(K) : NT;
  cudaError_t e = cudaSetDevice(device);
  if (e == cudaSuccess && smem > 0)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0, sms = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, nt, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = smem;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = blocks;
  out[5] = sms;
  out[6] = nt;
  return 0;
}

}  // extern "C"
