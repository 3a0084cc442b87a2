// The S-sequences-a-block layout of the K <= 64 chain kernels, shared by
// fused_fb.cu (the fused forward and backward), duplex_fb.cu (the duplex
// chain) and split_fb.cu (the split forward and backward): a block carries S
// sequences (b0 .. b0+S-1; the last block may hold fewer, and the missing
// ones run on zeros and write nothing), one thread per state k (KMAX
// threads, those with k >= K idle but in every barrier and shuffle), and
// thread k runs state k of all S sequences as S interleaved chains, so that
// every word of A~ or W it reads feeds S FMAs.
//
// seq_forward is the forward recursion of fused_fb.cu's note, the body of
// fused_fwd_kernel<S, FP>, of the duplex chain's forward blocks and, reading
// ll_t instead of forming f_t . W (FEATS = false), of split_fwd_kernel<S>:
// all run this one function, so the duplex chain's alpha, s and sh are the
// fused forward's bit for bit. seq_stats_backward is the backward with the
// statistics, the body of fused_bwd_kernel<S, FP, GATED> and (FEATS =
// false) of split_bwd_kernel<S, GATED>. With FEATS, KIND names what the
// rows are read from: the feature array, or the raw observations whose
// features ObsRows builds (the fused pair's and the duplex chain's
// in-kernel mode). The helpers keep the numerics every kernel shares: ll_t as the fmaf chain over f = 0..FP-1 in order over zero
// padding, sums and maxima as each warp's butterfly (fbc::warp_sum's order)
// and then warp 0's plus warp 1's.

#pragma once

#include <type_traits>

#include "fb_common.cuh"
#include "fb_stats.cuh"

namespace fbseq {

using fbc::KMAX;
using fbc::NT;
using fbc::NWARP;
using fbc::SUM_FLOOR;

// How many steps ahead the ll mode (FEATS = false) reads its rows: the
// forward its likelihood rows, the backward its likelihood and alpha rows
// and the kept-mask. Each thread copies its own elements with cp.async into
// a ring of slots in shared memory, so no barrier guards them. One step
// ahead, as the feature rows go, left the K = 64 split pair waiting on
// device memory every step on the H100: a step there is shorter than the
// loads' latency. The depths are the fastest of those timed (PERF.md); the
// backward's s and sh, which mostly hit L1, stay one step ahead in
// registers, as each thread's own copies of them in the ring cost more than
// they hid.
constexpr int FWD_AHEAD = 12;
constexpr int BWD_AHEAD = 2;
// The entries of row k of A~ the ll-mode backward keeps in registers (the
// rest it reads from shared memory): with S = 2 sequences' columns of acc
// beside them a thread is near its 255 registers. On the H100 all 64 spilled
// (8-16 bytes) and took 3 % longer, 32 took 6 % longer (PERF.md).
constexpr int BWD_AREG = 48;

// The padded feature width an instance is built for.
constexpr int pad_f(int F) { return F <= 16 ? 16 : F <= 32 ? 32 : F <= 48 ? 48 : 64; }

// FP of the ll mode (FEATS = false), which reads no feature: the split pair's
// instances and the fused and duplex pairs' at F > FMAX.
constexpr int LL_FP = 4;

// One step's feature rows of a block's sequences, feats[t, b0 .. b0+ns-1, :]
// (ns * F contiguous floats), through registers into a shared slot
// [S][FP] (zero beyond F, and for missing sequences). Thread k moves the
// floats k, k + NT, ... of the row.
template <int S, int FP>
struct FeatRows {
  static constexpr int R = (S * FP + NT - 1) / NT;
  int k;
  int off[R];  // where float k + NT r goes in the slot, -1 for none
  float v[R];

  __device__ FeatRows(int k_, int ns, int F) : k(k_) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = k + NT * r;
      const int s = e / F;
      off[r] = e < ns * F ? s * FP + (e - s * F) : -1;
      v[r] = 0.f;
    }
  }
  __device__ __forceinline__ void load(const float* __restrict__ row) {
#pragma unroll
    for (int r = 0; r < R; ++r) v[r] = off[r] >= 0 ? row[k + NT * r] : 0.f;
  }
  __device__ __forceinline__ void store(float* slot) const {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (off[r] >= 0) slot[off[r]] = v[r];
  }
};

// FeatRows' counterpart for a built kind (fbc::FEATS_NIW, FEATS_NIG): one
// step's raw observation rows of the block's sequences (ns * D contiguous
// floats) into the same shared slot [S][FP], each feature built where it is
// stored (zero beyond F, and for missing sequences). Thread k builds the
// features k, k + NT, ... of the S rows: load() asks for their factors,
// store() forms the products, so that the loads' latency hides behind a step
// as FeatRows' does.
template <int S, int FP, int KIND>
struct ObsRows {
  static constexpr int R = (S * FP + NT - 1) / NT;
  int off[R];  // where feature k + NT r goes in the slot, -1 for none
  int src[R];  // its factors' offsets in the rows, (ia + 1) | (ja + 1) << 16 (fbc::feat_src)
  float x[R], y[R];

  __device__ ObsRows(int k, int ns, int F) {
    const int D = fbc::obs_dim(KIND, F);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = k + NT * r;
      const int s = e / F, f = e - s * F;
      int ia = -1, ja = -1;
      if (e < ns * F) fbc::feat_src(KIND, D, f, ia, ja);
      off[r] = e < ns * F ? s * FP + f : -1;
      src[r] = (ia < 0 ? 0 : ia + s * D + 1) | ((ja < 0 ? 0 : ja + s * D + 1) << 16);
      x[r] = y[r] = 0.f;
    }
  }
  __device__ __forceinline__ void load(const float* __restrict__ row) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int ia = (src[r] & 0xffff) - 1, ja = (src[r] >> 16) - 1;
      x[r] = ia >= 0 ? row[ia] : 1.f;
      y[r] = ja >= 0 ? row[ja] : 0.f;
    }
  }
  __device__ __forceinline__ void store(float* slot) const {
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (off[r] >= 0) slot[off[r]] = fbc::feat_of(x[r], y[r], (src[r] >> 16) != 0);
  }
};

// FeatRows' stand-in where no feature is read (the ll mode, FEATS = false):
// every move is a no-op.
struct NoRows {
  __device__ NoRows(int, int, int) {}
  __device__ __forceinline__ void load(const float*) {}
  __device__ __forceinline__ void store(float*) const {}
};

// The rows of (FEATS, KIND): none (the ll mode), the feature array's, or
// rows built from the observations.
template <int S, int FP, bool FEATS, int KIND = fbc::FEATS_ARRAY>
using RowsOf = typename std::conditional<
    !FEATS, NoRows,
    typename std::conditional<KIND == fbc::FEATS_ARRAY, FeatRows<S, FP>,
                              ObsRows<S, FP, KIND>>::type>::type;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

using fbc::FULL;
using fbc::warp_sums;
using fbc::warp_sums_maxes;

// The block's sum (or max) of one sequence from the per-warp partials
// red[warp * S + s]: warp 0's, then warp 1's added, as the duplex chain does.
template <int S>
__device__ __forceinline__ float block_sum(const float* red, int s) {
  float v = red[s];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) v += red[w * S + s];
  return v;
}

template <int S>
__device__ __forceinline__ float block_max(const float* red, int s) {
  float v = red[s];
#pragma unroll
  for (int w = 1; w < NWARP; ++w) v = fmaxf(v, red[w * S + s]);
  return v;
}

// acc[s] += x[s] . (c[4 j], .., c[4 j + 3]) for the S sequences, as four
// fmaf steps each, the sequences interleaved so that S chains are in flight.
template <int S>
__device__ __forceinline__ void fma4(float (&acc)[S], const float4 (&x)[S], float c0, float c1,
                                     float c2, float c3) {
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = fmaf(x[s].x, c0, acc[s]);
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = fmaf(x[s].y, c1, acc[s]);
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = fmaf(x[s].z, c2, acc[s]);
#pragma unroll
  for (int s = 0; s < S; ++s) acc[s] = fmaf(x[s].w, c3, acc[s]);
}

template <int S>
__device__ __forceinline__ void ld4s(float4 (&x)[S], const float* base, int stride) {
#pragma unroll
  for (int s = 0; s < S; ++s) x[s] = ld4(base + s * stride);
}

// The forward recursion of the S sequences of block blk: column k of A~ (and
// of W) in registers, loaded once; a step reads only the broadcast a_{t-1}
// (and f_{t+2}) of its S sequences from shared memory, as float4. One
// barrier a step: a_t, the per-sequence partial sums and maxima are
// double-buffered, and ll of the next step (its max included) is ready a
// step ahead: FEATS, computed as f . W in the same loop as the matvec (step 0
// is peeled off, so that both chains are live in every iteration and
// interleave); else read from ll (T, B, K), `src`, FWD_AHEAD steps before it
// is needed (W and F unused, FP no width: no feature is read). FEATS reads
// the feature array (KIND = FEATS_ARRAY) or builds the rows from the raw
// (T, B, D) observations in `src` (ObsRows; D from F and KIND). Writes raw
// alpha (T, B, K) -- float32 into alpha, or, ABF, rounded to bf16 into
// alpha16 (the chain carries float32 all the same) -- s and sh (B, T); s
// sums the values stored, so with bf16 the rounded ones (pallas_fb.py:311
// `_emit_scales`). ABF is a template parameter, so that the float32
// instances carry no trace of it (as a run-time pointer it made the K = 64
// fused forward 23 % slower on the H100, PERF.md). Every thread of the
// block calls it.
template <int S, int FP, bool FEATS = true, int KIND = fbc::FEATS_ARRAY, bool ABF = false>
__device__ __forceinline__ void seq_forward(const float* __restrict__ pi,
                                            const float* __restrict__ A,
                                            const float* __restrict__ W,
                                            const float* __restrict__ src,
                                            float* __restrict__ alpha, float* __restrict__ s_out,
                                            float* __restrict__ sh_out, int T, int B, int K,
                                            int F, int blk,
                                            __nv_bfloat16* __restrict__ alpha16 = nullptr) {
  __shared__ __align__(16) float f_s[2][FEATS ? S * FP : 4];  // f_t in slot t & 1
  __shared__ __align__(16) float a_s[2][S * KMAX];  // a_t in slot t & 1, zero beyond K
  __shared__ float red_max[2][NWARP * S];           // partial max of ll_t, slot t & 1
  __shared__ float red_sum[2][NWARP * S];           // partial sum of a_t, slot t & 1
  __shared__ float red_sr[2][NWARP * S];            // (bf16) partial sum of the stored a_t
  __shared__ float l_s[FEATS ? 1 : FWD_AHEAD * S * KMAX];  // ll_t in slot t % FWD_AHEAD

  const int b0 = blk * S;
  const int ns = min(S, B - b0);
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  float Acol[KMAX];  // column k of A~
  float Wcol[FP];    // column k of W (FEATS)
#pragma unroll
  for (int i = 0; i < KMAX; ++i) Acol[i] = (active && i < K) ? A[i * K + k] : 0.f;
  if constexpr (FEATS) {
#pragma unroll
    for (int f = 0; f < FP; ++f) Wcol[f] = (active && f < F) ? W[f * K + k] : 0.f;
  }
  const float pik = active ? pi[k] : 0.f;

  if constexpr (FEATS) {
    for (int i = k; i < 2 * S * FP; i += NT) f_s[i / (S * FP)][i % (S * FP)] = 0.f;
  }
  for (int i = k; i < 2 * S * KMAX; i += NT) a_s[i / (S * KMAX)][i % (S * KMAX)] = 0.f;
  const int in_w = FEATS ? fbc::obs_dim(KIND, F) : K;  // floats of a (t, b) row of src
  const size_t step_f = (size_t)B * in_w;  // feats (obs) stride of one time step
  const size_t step_k = (size_t)B * K;  // alpha (and ll) stride of one time step
  const float* fb = src + (size_t)b0 * in_w;
  const size_t a_base = (size_t)b0 * K + k;
  // the ll mode: ll_t of the block's sequences (state k of each, 0 past T),
  // asked for FWD_AHEAD steps before it is read, one cp.async group a step
  auto ll_ask = [&](int t) {
    float* slot = l_s + (t % FWD_AHEAD) * S * KMAX + k;
#pragma unroll
    for (int s = 0; s < S; ++s)
      fbs::cp_async<1>(slot + s * KMAX, fb + (size_t)t * step_k + (size_t)s * K + k,
                       t < T && active && s < ns);
    fbs::cp_commit();
  };
  auto ll_row = [&](float (&v)[S], int t) {  // ll_t, then ask for ll_{t + FWD_AHEAD}
    fbs::cp_wait<FWD_AHEAD - 1>();
    const float* slot = l_s + (t % FWD_AHEAD) * S * KMAX + k;
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] = slot[s * KMAX];
    ll_ask(t + FWD_AHEAD);
  };
  if constexpr (!FEATS) {
    for (int t = 0; t < FWD_AHEAD; ++t) ll_ask(t);
  }
  RowsOf<S, FP, FEATS, KIND> rows(k, ns, F);
  __syncthreads();  // the zeroed slots before the rows land in them
  if constexpr (FEATS) {
    rows.load(fb);
    rows.store(f_s[0]);
    if (T > 1) {
      rows.load(fb + step_f);
      rows.store(f_s[1]);
    }
    if (T > 2) rows.load(fb + 2 * step_f);  // f_2, stored in step 0
  }
  __syncthreads();

  float ll[S];   // ll_t
  float m[S];    // sh_t = max_k ll_t
  float inv[S];  // 1 / s_{t-1}
  float a[S], sm[S], mx[S];

  // step 0 (a_0 = pi~ lik_0), then ll_1 and the partials; the loop runs the
  // steps t >= 1, so that u and ll are both live in every iteration
  if constexpr (FEATS) {
#pragma unroll
    for (int s = 0; s < S; ++s) ll[s] = 0.f;
#pragma unroll
    for (int f4 = 0; f4 < FP / 4; ++f4) {
      float4 y[S];
      ld4s<S>(y, f_s[0] + 4 * f4, FP);
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
    for (int s = 0; s < S; ++s) mx[s] = fmaxf(mx[s], __shfl_xor_sync(FULL, mx[s], o));
  }
  if (lane == 0) {
#pragma unroll
    for (int s = 0; s < S; ++s) red_max[0][warp * S + s] = mx[s];
  }
  __syncthreads();
#pragma unroll
  for (int s = 0; s < S; ++s) {
    m[s] = block_max<S>(red_max[0], s);
    a[s] = active ? pik * expf(ll[s] - m[s]) : 0.f;
    ll[s] = 0.f;
  }
  if constexpr (FEATS) {
#pragma unroll
    for (int f4 = 0; f4 < FP / 4; ++f4) {  // ll_1 (a stale row when T = 1: unused)
      float4 y[S];
      ld4s<S>(y, f_s[1] + 4 * f4, FP);
      fma4<S>(ll, y, Wcol[4 * f4], Wcol[4 * f4 + 1], Wcol[4 * f4 + 2], Wcol[4 * f4 + 3]);
    }
  } else {
    ll_row(ll, 1);  // ll_1 (0 when T = 1: unused)
  }

  for (int t = 0;; ++t) {
    const int p = t & 1;
    // a_t and ll_{t+1} are in registers: store a_t, reduce both, one barrier
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
    warp_sums_maxes<S>(sm, mx);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        red_sum[p][warp * S + s] = sm[s];
        red_max[p ^ 1][warp * S + s] = mx[s];
      }
    }
    if constexpr (ABF) {  // s_t: the sum of the stored, rounded a_t
      float sr[S];
#pragma unroll
      for (int s = 0; s < S; ++s) sr[s] = fbc::bf16_round(a[s]);
      fbc::warp_sums<S>(sr);
      if (lane == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) red_sr[p][warp * S + s] = sr[s];
      }
    }
    if (FEATS && t + 2 < T) {  // f_{t+2} into f_t's slot; f_{t+3} into registers
      rows.store(f_s[p]);
      if (t + 3 < T) rows.load(fb + (size_t)(t + 3) * step_f);
    }
    __syncthreads();  // a_t, f_{t+2} and both partials are complete

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
    if (t + 1 == T) {
      if constexpr (!FEATS) fbs::cp_wait<0>();  // the copies asked for past T
      break;
    }

    // u_{t+1} = a_t @ A~ and (FEATS) ll_{t+2} = f_{t+2} . W: 2S independent
    // fmaf chains in one loop (at t + 2 = T a stale row: unused)
    float u[S];
#pragma unroll
    for (int s = 0; s < S; ++s) u[s] = ll[s] = 0.f;
    const float* ap = a_s[p];      // a_t
    const float* fp = f_s[p];      // f_{t+2}
#pragma unroll
    for (int i4 = 0; i4 < KMAX / 4; ++i4) {
      float4 x[S];
      ld4s<S>(x, ap + 4 * i4, KMAX);
      if (FEATS && 4 * i4 < FP) {
        float4 y[S];
        ld4s<S>(y, fp + 4 * i4, FP);
        fma4<S>(ll, y, Wcol[4 * i4], Wcol[4 * i4 + 1], Wcol[4 * i4 + 2], Wcol[4 * i4 + 3]);
      }
      fma4<S>(u, x, Acol[4 * i4], Acol[4 * i4 + 1], Acol[4 * i4 + 2], Acol[4 * i4 + 3]);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = active ? u[s] * (lik[s] * inv[s]) : 0.f;
    if constexpr (!FEATS) ll_row(ll, t + 2);
  }
}

constexpr int AST = KMAX + 4;  // row stride of A~ in the backward's shared memory

// seq_stats_backward's dynamic shared memory, in bytes: A~ rows, (feats) W
// columns and three feature slots, two slots of d and of a_{t-1}, two of the
// partial sums, and (not feats) the ring of BWD_AHEAD slots of ll, alpha and
// kept-mask rows; A~'s rows take KMAX * AST floats (not feats: the entries
// past BWD_AREG).
constexpr int stats_smem_bytes(int S, int FP, bool feats) {
  return 4 * (KMAX * AST +
              (feats ? KMAX * (FP + 4) + 3 * S * FP : 3 * BWD_AHEAD * S * KMAX) +
              4 * S * KMAX + 2 * NWARP * S);
}

// The backward recursion with the statistics of the S sequences of block blk,
// t = T-1 .. 0 (fused_fb.cu's note): FEATS, row k of A~ and column k of W from
// shared memory, padded rows so that the float4 reads are free of bank
// conflicts, each word feeding S FMAs; else row k of A~ in registers (its
// first BWD_AREG entries; no W, no eacc), loaded once. One barrier a step
// (double-buffered d, a and partial sums, triple-buffered features); after it,
// one loop runs the beta chain, (FEATS) the next step's ll chain and the acc
// (and eacc) updates side by side. FEATS: ll_t = f_t . W by the forward's
// chain (feats (T, B, F), `src`), acc summed over the block's sequences
// (column k of acc and row k of eacc in registers) into the block's row of
// partials `part`, acc (K, K) then eacc (K, F), and gamma0 = w_0 gamma_0
// written. Else ll_t (from ll (T, B, K)), a_{t-1} and w_t are read BWD_AHEAD
// steps before they are needed, through a ring in shared memory; each sequence
// keeps its own column k of acc (S K registers), written to its own row of
// partials (K, K) at b0 + s, so that acc's sums do not depend on S, and there
// is no eacc and no gamma0. Gated, w (T, B) is the kept-mask and the pair gate
// pg_t = w_{t-1} w_t is formed here; it touches the statistics only. gamma
// (ungated) is written when not null. FEATS also takes the built kinds (src
// the raw observations, rows built as seq_forward's) and, MODES, two
// run-time pointers, null when unused: alpha16, alpha stored as bf16 (in
// place of alpha: read and widened, the replay factors 1 / s then the sums
// of those same rounded values), and sel (B,), the per-sequence time pick
// (pallas_fb.py:608 `sel_mode`): gamma0 then takes each sequence's ungated
// gamma at t = sel[b] (zeros for a pick outside 0 .. T-1) in place of w_0
// gamma_0. Without MODES neither is read, so the default instances carry
// no trace of them. Not FEATS (the split backward), MODES means that alpha
// is stored as bf16 (alpha16, never null then; sel unused): the ring's
// slots take, for each element, the aligned 32-bit word that holds it (a
// bf16 pair; cp.async moves 4 bytes at least), and the element's half is
// widened where it is read. Every thread of the block calls it.
template <int S, int FP, bool FEATS, bool GATED, int KIND = fbc::FEATS_ARRAY,
          bool MODES = false>
__device__ __forceinline__ void seq_stats_backward(
    const float* __restrict__ A, const float* __restrict__ W, const float* __restrict__ src,
    const float* __restrict__ alpha, const float* __restrict__ s_in,
    const float* __restrict__ sh_in, const float* __restrict__ w_in, float* __restrict__ gamma,
    float* __restrict__ gamma0, float* __restrict__ part, int T, int B, int K, int F, int blk,
    float* smem, const __nv_bfloat16* __restrict__ alpha16 = nullptr,
    const int* __restrict__ sel = nullptr) {
  constexpr int WST = FP + 4;            // row stride of W's columns in shared memory
  constexpr int AG = FEATS ? 1 : S;      // acc's sums: one a block, or one a sequence
  float* A_s = smem;                              // A~[k][j] at k * AST + j
  float* W_s = A_s + KMAX * AST;                  // W[f][k] at k * WST + f (FEATS)
  float* f_s = W_s + (FEATS ? KMAX * WST : 0);    // f_t in slot t % 3, [S][FP] each (FEATS)
  float* d_s = f_s + (FEATS ? 3 * S * FP : 0);    // d_t in slot t & 1, [S][KMAX] each
  float* a_s = d_s + 2 * S * KMAX;                // a_{t-1} in slot t & 1
  float* red = a_s + 2 * S * KMAX;                // partial sums of g_t in slot t & 1, [NWARP][S]
  float* q_s = red + 2 * NWARP * S;  // not FEATS: the ring, [3][S][KMAX] a slot

  const int b0 = blk * S;
  const int ns = min(S, B - b0);
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  constexpr int AREG = FEATS ? 0 : BWD_AREG;  // A~[k][j] in registers for j < AREG
  constexpr int AR = AREG > 0 ? AREG : 4;     // Arow's size (the FEATS instances' unused)
  float Arow[AR];
  for (int idx = k; idx < KMAX * KMAX; idx += NT) {
    const int r = idx / KMAX, c = idx % KMAX;
    A_s[r * AST + c] = (r < K && c < K) ? A[r * K + c] : 0.f;
  }
  if constexpr (FEATS) {
    for (int idx = k; idx < KMAX * FP; idx += NT) {
      const int r = idx / FP, c = idx % FP;
      W_s[r * WST + c] = (r < K && c < F) ? W[c * K + r] : 0.f;
    }
    for (int i = k; i < 3 * S * FP; i += NT) f_s[i] = 0.f;
  }

  float acc[AG][KMAX];  // column k of sum_t outer(a_{t-1}, d_t n_t pg_t), per group
  float eacc[FEATS ? FP : 1];  // row k of sum_t outer(w_t gamma_t, f_t) (FEATS)
#pragma unroll
  for (int g = 0; g < AG; ++g) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i) acc[g][i] = 0.f;
  }
  if constexpr (FEATS) {
#pragma unroll
    for (int f = 0; f < FP; ++f) eacc[f] = 0.f;
  }

  const int in_w = FEATS ? fbc::obs_dim(KIND, F) : K;  // floats of a (t, b) row of src
  const size_t step_f = (size_t)B * in_w;
  const size_t step_k = (size_t)B * K;
  const float* fb = src + (size_t)b0 * in_w;
  const float* ab = MODES && alpha16 != nullptr ? nullptr : alpha + (size_t)b0 * K + k;
  const size_t n_alpha = (size_t)T * step_k;  // alpha's elements (the ring's bf16 words)
  const __nv_bfloat16* ab16 = MODES && alpha16 != nullptr ? alpha16 + (size_t)b0 * K + k
                                                                   : nullptr;
  // a_t of sequence s (FEATS reads, as stored: float32 or bf16 widened)
  auto a_at = [&](int t, int s) {
    const size_t o = (size_t)t * step_k + (size_t)s * K;
    if constexpr (MODES) return ab16 != nullptr ? __bfloat162float(ab16[o]) : ab[o];
    return ab[o];
  };

  // per sequence: a_t, a_{t-1}, s_{t-1}, sh_t, b'_t, the kept-mask w_t and
  // (sel) the time pick
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
  RowsOf<S, FP, FEATS, KIND> rows(k, ns, F);
  __syncthreads();  // the zeroed slots before the rows land in them
  if constexpr (FEATS) {
    rows.load(fb + (size_t)(T - 1) * step_f);
    rows.store(f_s + ((T - 1) % 3) * S * FP);
    if (T >= 2) rows.load(fb + (size_t)(T - 2) * step_f);  // f_{T-2}, stored in step T-1
  }
  __syncthreads();

  // ll_{T-1}: FEATS the forward's fmaf chain, column k of W from shared
  // memory, and every later ll_{t-1} computed in step t beside the beta
  // chain; else read, and every later ll_{t-1} read in step t
  float ll[S];
  if constexpr (FEATS) {
#pragma unroll
    for (int s = 0; s < S; ++s) ll[s] = 0.f;
#pragma unroll
    for (int f4 = 0; f4 < FP / 4; ++f4) {
      const float4 wv = ld4(W_s + k * WST + 4 * f4);
      float4 y[S];
      ld4s<S>(y, f_s + ((T - 1) % 3) * S * FP + 4 * f4, FP);
      fma4<S>(ll, y, wv.x, wv.y, wv.z, wv.w);
    }
  } else {
#pragma unroll
    for (int j = 0; j < AREG; ++j) Arow[j] = (active && j < K) ? A[k * K + j] : 0.f;
#pragma unroll
    for (int s = 0; s < S; ++s)
      ll[s] = (s < ns && active) ? fb[(size_t)(T - 1) * step_k + (size_t)s * K + k] : 0.f;
  }
  // not FEATS: the rows of step j (j = T-2 down), ll_j, a_{j-1} and (gated)
  // w_j, asked for BWD_AHEAD steps before they are read, one cp.async group a
  // step; the i-th group (j = T-2-i) in slot i % BWD_AHEAD. The kept-mask
  // misses every cache a step (its stride is B), so each thread copies its
  // own w; s and sh, contiguous in t, mostly hit L1 and stay one step ahead
  // in registers.
  auto ask = [&](int i) {
    const int j = T - 2 - i;
    float* slot = q_s + (i % BWD_AHEAD) * 3 * S * KMAX + k;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool ok = s < ns;
      fbs::cp_async<1>(slot + s * KMAX, fb + (size_t)j * step_k + (size_t)s * K + k,
                       ok && active && j >= 0);
      if constexpr (MODES) {  // the word of a_{j-1}'s bf16 element
        const size_t o = (size_t)(j - 1) * step_k + (size_t)(b0 + s) * K + k;
        const bool in = ok && active && j >= 1;
        fbs::cp_async_n(slot + (S + s) * KMAX, in ? alpha16 + (o & ~(size_t)1) : alpha16,
                        !in ? 0 : (o | 1) < n_alpha ? 4 : 2);
      } else {
        fbs::cp_async<1>(slot + (S + s) * KMAX, ab + (size_t)(j - 1) * step_k + (size_t)s * K,
                         ok && active && j >= 1);
      }
      if (GATED)
        fbs::cp_async<1>(slot + (2 * S + s) * KMAX, w_in + (size_t)j * B + b0 + s, ok && j >= 0);
    }
    fbs::cp_commit();
  };
  if constexpr (!FEATS) {
    for (int i = 0; i < BWD_AHEAD; ++i) ask(i);
  }

  for (int t = T - 1; t >= 0; --t) {
    const int p = t & 1;
    const float* ft = f_s + (t % 3) * S * FP;        // f_t (FEATS)
    float* fn = f_s + ((t + 2) % 3) * S * FP;        // f_{t-1} (FEATS)
    float* dp = d_s + p * S * KMAX;
    float* ap = a_s + p * S * KMAX;
    float* rp = red + p * NWARP * S;

    // operands of step t-1, loaded now so their latency hides behind step t
    // (not FEATS: ll_{t-1} and a_{t-2} from the ring, asked for BWD_AHEAD
    // steps ago)
    float a_n[S], s_n[S], sh_n[S], w_n[S], l_n[S];
    if constexpr (!FEATS) {
      const int i = T - 1 - t;
      fbs::cp_wait<BWD_AHEAD - 1>();
      const float* slot = q_s + (i % BWD_AHEAD) * 3 * S * KMAX + k;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        l_n[s] = slot[s * KMAX];
        a_n[s] = slot[(S + s) * KMAX];
        if constexpr (MODES) {  // a_{t-2}: its half of the word, widened
          const size_t o = (size_t)(t - 2) * step_k + (size_t)(b0 + s) * K + k;
          const unsigned u = __float_as_uint(a_n[s]);
          a_n[s] = __uint_as_float((o & 1) ? (u & 0xffff0000u) : (u << 16));
        }
        w_n[s] = GATED ? slot[(2 * S + s) * KMAX] : 1.f;
      }
      ask(i + BWD_AHEAD);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool ok = s < ns;
      if constexpr (FEATS) {
        a_n[s] = (ok && active && t >= 2) ? a_at(t - 2, s) : 0.f;
        w_n[s] = GATED ? ((ok && t >= 1) ? w_in[(size_t)(t - 1) * B + b0 + s] : 0.f) : 1.f;
      }
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
    warp_sums<S>(gs);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) rp[warp * S + s] = gs[s];
    }
    if (FEATS && t >= 1) {  // f_{t-1} into its slot; f_{t-2} into registers
      rows.store(fn);
      if (t >= 2) rows.load(fb + (size_t)(t - 2) * step_f);
    }
    __syncthreads();  // d_t, a_{t-1}, the partial sums and f_{t-1} are complete

    float gw[S], dn[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float n = s < ns ? 1.f / fmaxf(block_sum<S>(rp, s), SUM_FLOOR) : 0.f;
      const float gam = graw[s] * n;
      gw[s] = GATED ? gam * w_cur[s] : gam;  // the statistics' gamma: kept steps
      if (active && s < ns) {
        if (gamma != nullptr) gamma[((size_t)t * B + b0 + s) * K + k] = gam;
        if (FEATS) {
          float* g0 = gamma0 + (size_t)(b0 + s) * K + k;
          if (!MODES || sel == nullptr) {
            if (t == 0) *g0 = gw[s];
          } else if (t == pick[s]) {
            *g0 = gam;  // the pick: ungated
          } else if (t == 0 && (pick[s] < 0 || pick[s] >= T)) {
            *g0 = 0.f;
          }
        }
      }
      // stats side, with the pair gate w_{t-1} w_t; the chain keeps d (0 at t = 0)
      dn[s] = GATED ? (d[s] * n) * (w_n[s] * w_cur[s]) : d[s] * n;
    }

    // b'_{t-1}[k] = sum_j d_t[j] A~[k][j] (j = 0..K-1 in order) and (FEATS)
    // ll_{t-1}: 2S independent fmaf chains in one loop, beside acc +=
    // outer(a_{t-1}, dn_t) and (FEATS) eacc += outer(gw_t, f_t). At t = 0 the
    // chains' results are unused (f_{t-1}'s slot is stale) and dn = 0, so acc
    // is unchanged.
    float bn[S];
#pragma unroll
    for (int s = 0; s < S; ++s) bn[s] = ll[s] = 0.f;
#pragma unroll
    for (int i4 = 0; i4 < KMAX / 4; ++i4) {
      const int j = 4 * i4 % AR;  // the registers' column, when 4 i4 < AREG
      const float4 av = 4 * i4 >= AREG
                            ? ld4(A_s + k * AST + 4 * i4)
                            : make_float4(Arow[j], Arow[j + 1], Arow[j + 2], Arow[j + 3]);
      float4 x[S];
      ld4s<S>(x, dp + 4 * i4, KMAX);
      if (FEATS && 4 * i4 < FP) {
        const float4 wv = ld4(W_s + k * WST + 4 * i4);
        float4 z[S];
        ld4s<S>(z, fn + 4 * i4, FP);
        fma4<S>(ll, z, wv.x, wv.y, wv.z, wv.w);
      }
      fma4<S>(bn, x, av.x, av.y, av.z, av.w);
      float4 y[S];
      ld4s<S>(y, ap + 4 * i4, KMAX);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const int g = FEATS ? 0 : s;
        acc[g][4 * i4] = fmaf(y[s].x, dn[s], acc[g][4 * i4]);
        acc[g][4 * i4 + 1] = fmaf(y[s].y, dn[s], acc[g][4 * i4 + 1]);
        acc[g][4 * i4 + 2] = fmaf(y[s].z, dn[s], acc[g][4 * i4 + 2]);
        acc[g][4 * i4 + 3] = fmaf(y[s].w, dn[s], acc[g][4 * i4 + 3]);
      }
      if (FEATS && 4 * i4 < FP) {
        float4 e[S];
        ld4s<S>(e, ft + 4 * i4, FP);
#pragma unroll
        for (int s = 0; s < S; ++s) {
          eacc[4 * i4] = fmaf(gw[s], e[s].x, eacc[4 * i4]);
          eacc[4 * i4 + 1] = fmaf(gw[s], e[s].y, eacc[4 * i4 + 1]);
          eacc[4 * i4 + 2] = fmaf(gw[s], e[s].z, eacc[4 * i4 + 2]);
          eacc[4 * i4 + 3] = fmaf(gw[s], e[s].w, eacc[4 * i4 + 3]);
        }
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
      if constexpr (!FEATS) ll[s] = l_n[s];
    }
  }

  if constexpr (!FEATS) fbs::cp_wait<0>();  // the copies asked for past step 0

  // the rows of partials: FEATS the block's, acc (K, K) then eacc (K, F);
  // else each sequence's acc (K, K)
  if (active) {
    if constexpr (FEATS) {
      float* pb = part + (size_t)blk * (K * K + K * F);
#pragma unroll
      for (int i = 0; i < KMAX; ++i)
        if (i < K) pb[i * K + k] = acc[0][i];
#pragma unroll
      for (int f = 0; f < FP; ++f)
        if (f < F) pb[K * K + k * F + f] = eacc[f];
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (s < ns) {
          float* pb = part + (size_t)(b0 + s) * K * K;
#pragma unroll
          for (int i = 0; i < KMAX; ++i)
            if (i < K) pb[i * K + k] = acc[s][i];
        }
      }
    }
  }
}

}  // namespace fbseq
