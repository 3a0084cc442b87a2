// The S-sequences-a-block layout of the K <= 64 chain kernels, shared by
// fused_fb.cu (the fused forward and backward) and duplex_fb.cu (the duplex
// chain): a block carries S sequences (b0 .. b0+S-1; the last block may hold
// fewer, and the missing ones run on zero features and write nothing), one
// thread per state k (KMAX threads, those with k >= K idle but in every
// barrier and shuffle), and thread k runs state k of all S sequences as S
// interleaved chains, so that every word of A~ or W it reads feeds S FMAs.
//
// seq_forward is the forward recursion of fused_fb.cu's note, the body of
// fused_fwd_kernel<S, FP> and of the duplex chain's forward blocks: both
// kernels run this one function, so the duplex chain's alpha, s and sh are
// the fused forward's bit for bit. The helpers keep the numerics every
// kernel shares: ll_t as the fmaf chain over f = 0..FP-1 in order over zero
// padding, sums and maxima as each warp's butterfly (fbc::warp_sum's order)
// and then warp 0's plus warp 1's.

#pragma once

#include "fb_common.cuh"

namespace fbseq {

using fbc::KMAX;
using fbc::NT;
using fbc::NWARP;
using fbc::SUM_FLOOR;

// The padded feature width an instance is built for.
constexpr int pad_f(int F) { return F <= 16 ? 16 : F <= 32 ? 32 : F <= 48 ? 48 : 64; }

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

// The forward recursion of the S sequences of block blk: column k of A~ and
// of W in registers, loaded once; a step reads only the broadcast a_{t-1}
// and f_{t+2} of its S sequences from shared memory, as float4. One barrier
// a step: a_t, the per-sequence partial sums and maxima are double-buffered,
// and ll of the next step (its max included) is computed a step ahead in the
// same loop as the matvec (step 0 is peeled off, so that both chains are live
// in every iteration and interleave). Writes raw alpha (T, B, K), s and sh
// (B, T). Every thread of the block calls it.
template <int S, int FP>
__device__ __forceinline__ void seq_forward(const float* __restrict__ pi,
                                            const float* __restrict__ A,
                                            const float* __restrict__ W,
                                            const float* __restrict__ feats,
                                            float* __restrict__ alpha, float* __restrict__ s_out,
                                            float* __restrict__ sh_out, int T, int B, int K,
                                            int F, int blk) {
  __shared__ __align__(16) float f_s[2][S * FP];    // f_t in slot t & 1
  __shared__ __align__(16) float a_s[2][S * KMAX];  // a_t in slot t & 1, zero beyond K
  __shared__ float red_max[2][NWARP * S];           // partial max of ll_t, slot t & 1
  __shared__ float red_sum[2][NWARP * S];           // partial sum of a_t, slot t & 1

  const int b0 = blk * S;
  const int ns = min(S, B - b0);
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  float Acol[KMAX];  // column k of A~
  float Wcol[FP];    // column k of W
#pragma unroll
  for (int i = 0; i < KMAX; ++i) Acol[i] = (active && i < K) ? A[i * K + k] : 0.f;
#pragma unroll
  for (int f = 0; f < FP; ++f) Wcol[f] = (active && f < F) ? W[f * K + k] : 0.f;
  const float pik = active ? pi[k] : 0.f;

  for (int i = k; i < 2 * S * FP; i += NT) f_s[i / (S * FP)][i % (S * FP)] = 0.f;
  for (int i = k; i < 2 * S * KMAX; i += NT) a_s[i / (S * KMAX)][i % (S * KMAX)] = 0.f;
  const size_t step_f = (size_t)B * F;  // feats stride of one time step
  const size_t step_k = (size_t)B * K;  // alpha stride of one time step
  const float* fb = feats + (size_t)b0 * F;
  float* ab = alpha + (size_t)b0 * K + k;
  FeatRows<S, FP> rows(k, ns, F);
  __syncthreads();  // the zeroed slots before the rows land in them
  rows.load(fb);
  rows.store(f_s[0]);
  if (T > 1) {
    rows.load(fb + step_f);
    rows.store(f_s[1]);
  }
  if (T > 2) rows.load(fb + 2 * step_f);  // f_2, stored in step 0
  __syncthreads();

  float ll[S];   // ll_t
  float m[S];    // sh_t = max_k ll_t
  float inv[S];  // 1 / s_{t-1}
  float a[S], sm[S], mx[S];

  // step 0 (a_0 = pi~ lik_0), then ll_1 and the partials; the loop runs the
  // steps t >= 1, so that u and ll are both live in every iteration
#pragma unroll
  for (int s = 0; s < S; ++s) ll[s] = 0.f;
#pragma unroll
  for (int f4 = 0; f4 < FP / 4; ++f4) {
    float4 y[S];
    ld4s<S>(y, f_s[0] + 4 * f4, FP);
    fma4<S>(ll, y, Wcol[4 * f4], Wcol[4 * f4 + 1], Wcol[4 * f4 + 2], Wcol[4 * f4 + 3]);
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
#pragma unroll
  for (int f4 = 0; f4 < FP / 4; ++f4) {  // ll_1 (a stale row when T = 1: unused)
    float4 y[S];
    ld4s<S>(y, f_s[1] + 4 * f4, FP);
    fma4<S>(ll, y, Wcol[4 * f4], Wcol[4 * f4 + 1], Wcol[4 * f4 + 2], Wcol[4 * f4 + 3]);
  }

  for (int t = 0;; ++t) {
    const int p = t & 1;
    // a_t and ll_{t+1} are in registers: store a_t, reduce both, one barrier
#pragma unroll
    for (int s = 0; s < S; ++s) {
      a_s[p][s * KMAX + k] = a[s];
      if (active && s < ns) ab[(size_t)t * step_k + (size_t)s * K] = a[s];
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
    if (t + 2 < T) {  // f_{t+2} into f_t's slot; f_{t+3} into registers
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
        s_out[(size_t)(b0 + s) * T + t] = sum;
        sh_out[(size_t)(b0 + s) * T + t] = m[s];
      }
      m[s] = block_max<S>(red_max[p ^ 1], s);  // sh_{t+1}
      lik[s] = expf(ll[s] - m[s]);
    }
    if (t + 1 == T) break;

    // u_{t+1} = a_t @ A~ and ll_{t+2} = f_{t+2} . W: 2S independent fmaf
    // chains in one loop (at t + 2 = T a stale row: unused)
    float u[S];
#pragma unroll
    for (int s = 0; s < S; ++s) u[s] = ll[s] = 0.f;
    const float* ap = a_s[p];      // a_t
    const float* fp = f_s[p];      // f_{t+2}
#pragma unroll
    for (int i4 = 0; i4 < KMAX / 4; ++i4) {
      float4 x[S];
      ld4s<S>(x, ap + 4 * i4, KMAX);
      if (4 * i4 < FP) {
        float4 y[S];
        ld4s<S>(y, fp + 4 * i4, FP);
        fma4<S>(ll, y, Wcol[4 * i4], Wcol[4 * i4 + 1], Wcol[4 * i4 + 2], Wcol[4 * i4 + 3]);
      }
      fma4<S>(u, x, Acol[4 * i4], Acol[4 * i4 + 1], Acol[4 * i4 + 2], Acol[4 * i4 + 3]);
    }
#pragma unroll
    for (int s = 0; s < S; ++s) a[s] = active ? u[s] * (lik[s] * inv[s]) : 0.f;
  }
}

}  // namespace fbseq
