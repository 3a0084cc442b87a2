// The large-K layout of the forward-backward kernels (65 <= K <= 256),
// shared by fused_fb.cu, split_fb.cu, duplex_fb.cu and split_probe.cu.
//
// An instance is built for KP = 128 or 256 padded states and S sequences a
// block: one thread a state (KP threads, those with k >= K idle but in every
// barrier and shuffle), thread k running state k of all S sequences as S
// interleaved chains (S = 1, 2, 4 or 8: the fused and the split pair pick S
// so that ceil(B / S) blocks fill the card in one wave, the duplex chain so
// that its 2 ceil(B / S) do where they can). Three numbers shape it: A~ in
// float32 takes 64 KB at KP = 128 and 256 KB at 256, a block may use 227 KB
// of shared memory, and a thread 255 registers. So a thread keeps the first
// RR rows of the matrix its matvec reads (A~ for the forward, A~^T for the
// backward) in registers -- RR = 0 at KP = 128, 64 at KP = 256, column k of
// those rows -- and the other rows lie in dynamic shared memory, 192 KB at
// most, beside two slots of the S vectors a_{t-1} (d_t) and feature rows (16
// + 4 KB at KP = 256, S = 8: 217 KB a block, one block an SM); W's column k
// (FMAX floats) stays in registers. Each word of the matrix and of W a
// thread reads in a step feeds S independent FMAs, one a sequence; what each
// step reads per thread is S KP / 4 broadcast float4 loads of a_{t-1} (d_t)
// and S ceil(F / 4) of the feature rows, beside SR conflict-free loads of
// its column.
//
// Per sequence the arithmetic does not depend on S: the matvec is one fmaf
// chain over i = 0..KP-1 in order (the rows in registers, then those in
// shared memory) over zero padding, and the per-step sums and maxima are
// each warp's butterfly, then the warps' partials added in warp order. The
// forward device function below is the fused forward's at every S and the
// duplex chain's, so their alpha, s and sh agree bit for bit, and the
// backward (and the duplex chain's raw backward) recomputes ll by the same
// chain.
//
// The statistics leave the chain at these K (fb_stats.cuh): the backward
// writes d_t n_t pg_t and w_t gamma_t for a window of time steps a launch,
// and outer products summed in a fixed order form acc and eacc, an order
// that depends on (T, B, K, F) alone, not on S.
//
// Features wider than FMAX (the fused pair's WF instances): W's column k no
// longer fits a thread's registers, nor W beside A~ in shared memory (at KP =
// 256 A~'s shared rows take 192 of 227 KB). So each step reads it from
// device memory, where L2 keeps it (F K floats, 0.3 MB at F = 300, K = 256):
// thread k the words W[f][k], a warp 128 contiguous bytes a feature, each
// word feeding S chains (WGlobal). The feature slots take 4 ceil(F / 4)
// floats a sequence, and the rows are moved by a strided loop
// (feat_rows<..., true>). ll_t is summed in blocks of 64 features, as the
// K <= 64 WF instances sum it (fb_seqs_wf.cuh): the first block's fmaf
// chain, then each later block's own chain added in order; in the forward
// and the backward alike.

#pragma once

#include <type_traits>

#include "fb_common.cuh"

namespace fbw {

using fbc::FMAX;
using fbc::SUM_FLOOR;

template <int KP>
struct Tier {
  static constexpr int NT = KP;             // threads a block
  static constexpr int NWARP = KP / 32;
  static constexpr int RR = KP > 192 ? KP - 192 : 0;  // matrix rows in registers
  static constexpr int SR = KP - RR;        // matrix rows in shared memory
};

constexpr int KWIDE = 256;  // the largest K of the large-K instances

// The padded state count of the instance that takes K (65..256).
inline int tier_of(int K) { return K <= 128 ? 128 : 256; }

// Launch `fn` with `smem` bytes of dynamic shared memory (above 48 KB only
// after the attribute is raised), then report the launch's error.
inline cudaError_t launch_dyn(const void* fn, dim3 grid, int nt, int smem, cudaStream_t st,
                              void** args) {
  cudaError_t e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernel(fn, grid, dim3(nt), args, smem, st);
  return e != cudaSuccess ? e : cudaGetLastError();
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Column k of a KP x KP matrix M, zero outside (K, K): M = A (transposed =
// false) or A^T (M[i][k] = A[k][i]), A (K, K) row-major in device memory.
// Rows i < RR in registers, rows i >= RR in shared memory at
// M_s[(i - RR) * KP + k], so that a warp reads 32 consecutive words.
template <int KP>
struct MatCol {
  static constexpr int RR = Tier<KP>::RR;
  static constexpr int SR = Tier<KP>::SR;
  float r[RR > 0 ? RR : 1];

  // Every thread of the block (KP of them, thread k) calls it; the caller
  // syncs before reading M_s. The shared rows' loads are unrolled so that
  // several are in flight: with one block an SM nothing else hides them, and
  // the large-K backward loads the matrix once a window of time steps.
  __device__ void load(const float* __restrict__ A, float* M_s, int K, bool transposed, int k) {
#pragma unroll
    for (int i = 0; i < RR; ++i)
      r[i] = (i < K && k < K) ? (transposed ? A[k * K + i] : A[i * K + k]) : 0.f;
#pragma unroll 8
    for (int i = RR; i < KP; ++i)
      M_s[(i - RR) * KP + k] =
          (i < K && k < K) ? (transposed ? A[k * K + i] : A[i * K + k]) : 0.f;
  }

  // u[s] = sum_i v[s * vstride + i] M[i][k] for NS vectors v in shared memory
  // (16-byte aligned), i = 0..KP-1 in order; each word of M feeds NS chains.
  template <int NS>
  __device__ __forceinline__ void dots(float (&u)[NS], const float* v, int vstride,
                                       const float* M_s, int k) const {
#pragma unroll
    for (int s = 0; s < NS; ++s) u[s] = 0.f;
#pragma unroll
    for (int i4 = 0; i4 < RR / 4; ++i4) {
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float4 x = ld4(v + s * vstride + 4 * i4);
        u[s] = fmaf(x.x, r[4 * i4], u[s]);
        u[s] = fmaf(x.y, r[4 * i4 + 1], u[s]);
        u[s] = fmaf(x.z, r[4 * i4 + 2], u[s]);
        u[s] = fmaf(x.w, r[4 * i4 + 3], u[s]);
      }
    }
#pragma unroll 4
    for (int i = RR; i < KP; i += 4) {
      const float* m = M_s + (i - RR) * KP + k;
      const float m0 = m[0], m1 = m[KP], m2 = m[2 * KP], m3 = m[3 * KP];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        const float4 x = ld4(v + s * vstride + i);
        u[s] = fmaf(x.x, m0, u[s]);
        u[s] = fmaf(x.y, m1, u[s]);
        u[s] = fmaf(x.z, m2, u[s]);
        u[s] = fmaf(x.w, m3, u[s]);
      }
    }
  }

  __device__ __forceinline__ float dot(const float* v, const float* M_s, int k) const {
    float u[1];
    dots<1>(u, v, 0, M_s, k);
    return u[0];
  }
};

// Column k of W (F, K) row-major in registers, zero beyond F (or K).
struct WCol {
  float w[FMAX];
  __device__ void load(const float* __restrict__ W, int K, int F, int k) {
#pragma unroll
    for (int f = 0; f < FMAX; ++f) w[f] = (k < K && f < F) ? W[f * K + k] : 0.f;
  }
  // out[s] = f_s[s] . W[:, k] for S feature rows f_s + s * fstride (zero
  // beyond F, 16-byte aligned): for each the fmaf chain over f = 0..FMAX-1 in
  // order, each word of W feeding S chains. For S > 1 the chains stop after
  // nf4 groups of 4 (nf4 = ceil(F / 4)): the rest would add fmaf(0, 0, acc)
  // == acc, the same bits, unless acc is -0 (every product so far rounding
  // to zero from below), which that padding would turn into +0. A single
  // chain runs to FMAX without a branch, as the one-sequence layout did: the
  // branch made the S = 1 forward 6 % and backward up to 29 % slower on the
  // H100 (PERF.md).
  template <int S>
  __device__ __forceinline__ void lls(float (&out)[S], const float* f_s, int fstride,
                                      int nf4) const {
#pragma unroll
    for (int s = 0; s < S; ++s) out[s] = 0.f;
#pragma unroll
    for (int f4 = 0; f4 < FMAX / 4; ++f4) {
      if (S > 1 && f4 >= nf4) break;
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float4 y = ld4(f_s + s * fstride + 4 * f4);
        out[s] = fmaf(y.x, w[4 * f4], out[s]);
        out[s] = fmaf(y.y, w[4 * f4 + 1], out[s]);
        out[s] = fmaf(y.z, w[4 * f4 + 2], out[s]);
        out[s] = fmaf(y.w, w[4 * f4 + 3], out[s]);
      }
    }
  }
};

// Column k of W (F, K) row-major read from device memory at each use (the
// WF instances), zero beyond F (or K).
struct WGlobal {
  const float* __restrict__ w;  // W + k, null for an idle state
  int K, F;
  __device__ void load(const float* __restrict__ W, int K_, int F_, int k) {
    w = k < K_ ? W + k : nullptr;
    K = K_;
    F = F_;
  }
  __device__ __forceinline__ float at(int f) const {
    return (w != nullptr && f < F) ? __ldg(w + (size_t)f * K) : 0.f;
  }
  // acc[s] += the groups [f0, f1) of f_s[s] . W[:, k], each word of W
  // feeding S chains.
  template <int S>
  __device__ __forceinline__ void span(float (&acc)[S], const float* f_s, int fstride, int f0,
                                       int f1) const {
#pragma unroll 4
    for (int f4 = f0; f4 < f1; ++f4) {
      const float c0 = at(4 * f4), c1 = at(4 * f4 + 1), c2 = at(4 * f4 + 2), c3 = at(4 * f4 + 3);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float4 y = ld4(f_s + s * fstride + 4 * f4);
        acc[s] = fmaf(y.x, c0, acc[s]);
        acc[s] = fmaf(y.y, c1, acc[s]);
        acc[s] = fmaf(y.z, c2, acc[s]);
        acc[s] = fmaf(y.w, c3, acc[s]);
      }
    }
  }
  // out[s] = f_s[s] . W[:, k] over f = 0 .. 4 nf4 - 1 (to the padded width)
  // in blocks of 16 groups: the first block's chain in out, each later
  // block's from zero, added in order.
  template <int S>
  __device__ __forceinline__ void lls(float (&out)[S], const float* f_s, int fstride,
                                      int nf4) const {
    constexpr int BLK = FMAX / 4;
#pragma unroll
    for (int s = 0; s < S; ++s) out[s] = 0.f;
    span<S>(out, f_s, fstride, 0, min(BLK, nf4));
    for (int b = BLK; b < nf4; b += BLK) {
      float part[S];
#pragma unroll
      for (int s = 0; s < S; ++s) part[s] = 0.f;
      span<S>(part, f_s, fstride, b, min(b + BLK, nf4));
#pragma unroll
      for (int s = 0; s < S; ++s) out[s] += part[s];
    }
  }
};

// The feature slot's stride a sequence: FMAX, or (WF) F padded to a group of 4.
template <bool WF>
__host__ __device__ constexpr int slot_stride(int F) {
  return WF ? 4 * ((F + 3) / 4) : FMAX;
}

// The block's sum (max) of the per-warp partials red[0 .. NW-1], in warp order.
template <int NW>
__device__ __forceinline__ float block_sum(const float* red) {
  float v = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) v += red[w];
  return v;
}

template <int NW>
__device__ __forceinline__ float block_max(const float* red) {
  float v = red[0];
#pragma unroll
  for (int w = 1; w < NW; ++w) v = fmaxf(v, red[w]);
  return v;
}


// Dynamic shared memory of seqs_forward and seqs_backward at S sequences a
// block, in bytes: A~'s shared rows, two slots of the S vectors a_t (d_t) and
// of the S feature rows, two of the per-sequence partials (two kinds); also
// the duplex chain's backward half's (duplex_fb.cu::seqs_raw_backward).
template <int KP, int S = 1>
constexpr int chain_smem_bytes() {
  return 4 * (Tier<KP>::SR * KP + 2 * S * KP + 2 * S * FMAX + 6 * S * Tier<KP>::NWARP);
}

// The same for the WF instances at F features: their slots are F wide.
template <int KP, int S>
inline int chain_smem_bytes_wf(int F) {
  return 4 * (Tier<KP>::SR * KP + 2 * S * KP + 2 * S * slot_stride<true>(F) +
              6 * S * Tier<KP>::NWARP);
}

// The feature rows of step t of a block's sequences, feats[t, b0 .. b0+ns-1, :]
// (ns * F contiguous floats from row), into a slot [S][FMAX] whose padding
// (beyond F, and the missing sequences') stays zero. One sequence takes one
// guarded load a thread (F <= FMAX < KP): at KP = 256 the strided loop in
// its place made the S = 1 forward 7 % and backward 25 % slower on the H100
// (PERF.md), a step of one sequence being a latency-bound chain. A built
// KIND (fbc::FEATS_NIW, FEATS_NIG) reads the raw observation rows (ns * D
// floats from row) and builds each feature where it is stored
// (fbc::feat_at: ell_features' float32 bits).
// WF: any F, slots `stride` floats a sequence, by a strided loop at every S.
template <int S, int KIND = fbc::FEATS_ARRAY, bool WF = false>
__device__ __forceinline__ void feat_rows(float* slot, const float* __restrict__ row, int ns,
                                          int F, int k, int nt, int D = 0, int stride = FMAX) {
  if (WF) {
    for (int e = k; e < ns * F; e += nt) {
      const int s = e / F;
      slot[s * stride + e - s * F] =
          KIND == fbc::FEATS_ARRAY ? row[e] : fbc::feat_at<KIND>(row + s * D, D, e - s * F);
    }
    return;
  }
  if (S == 1) {
    if (k < F) slot[k] = KIND == fbc::FEATS_ARRAY ? row[k] : fbc::feat_at<KIND>(row, D, k);
    return;
  }
  for (int e = k; e < ns * F; e += nt) {
    const int s = e / F;
    slot[s * FMAX + e - s * F] =
        KIND == fbc::FEATS_ARRAY ? row[e] : fbc::feat_at<KIND>(row + s * D, D, e - s * F);
  }
}

// The forward recursion of the S sequences of block blk, b0 = blk S .. b0+S-1
// (the last block may hold fewer; the missing ones run on zeros and write
// nothing): ll_t = f_t . W (FEATS; feats (T, B, F)) or read from ll (T, B,
// K); sh_t = max_k ll_t, lik_t = exp(ll_t - sh_t), a_0 = pi~ lik_0, a_t =
// (a_{t-1} @ A~) (lik_t / s_{t-1}), s_t = sum_k a_t. Writes raw alpha (T, B,
// K), s and sh (B, T). Thread k runs state k of all S sequences: each word
// of A~ (and of W) it reads in a step feeds S chains, and each chain is one
// sequence's arithmetic as at S = 1 (the matvec over i in order, the sums
// each warp's butterfly, then the warps in order), so alpha, s and sh do
// not depend on S. Two barriers a step. Every thread of the block calls it.
// At S = 1 the block's one sequence always exists (B blocks), and here and
// in seqs_backward the compiler is told so: with ns a run-time value the
// S = 1 backward at KP = 256 took 26 % longer on the H100 (PERF.md). FEATS
// with a built KIND reads the raw (T, B, D) observations (feat_rows); ABF
// stores alpha rounded to bf16 into alpha16, the chain carrying float32,
// and s sums the rounded values (as seq_forward). WF takes any F (W read
// from device memory, WGlobal; slots F wide).
template <int KP, int S, bool FEATS, int KIND = fbc::FEATS_ARRAY, bool ABF = false,
          bool WF = false>
__device__ void seqs_forward(const float* __restrict__ pi, const float* __restrict__ A,
                             const float* __restrict__ W, const float* __restrict__ src,
                             float* __restrict__ alpha, float* __restrict__ s_out,
                             float* __restrict__ sh_out, int T, int B, int K, int F, int blk,
                             float* smem, __nv_bfloat16* __restrict__ alpha16 = nullptr) {
  using TT = Tier<KP>;
  constexpr int NW = TT::NWARP;
  const int fs = slot_stride<WF>(F);     // floats of a sequence's feature row
  float* M_s = smem;                       // A~ rows RR..KP-1
  float* a_s = M_s + TT::SR * KP;          // a_t in slot t & 1, [S][KP] each
  float* f_s = a_s + 2 * S * KP;           // f_t in slot t & 1, [S][fs] each
  float* red_max = f_s + 2 * S * fs;       // [t & 1][S][warp]
  float* red_sum = red_max + 2 * S * NW;
  float* red_sr = red_sum + 2 * S * NW;    // (bf16) partial sums of the stored a_t
  const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
  const bool active = k < K;
  const int b0 = blk * S, ns = S == 1 ? 1 : min(S, B - b0);  // sequences held
  const int nf4 = (F + 3) / 4;

  MatCol<KP> col;
  col.load(A, M_s, K, false, k);
  typename std::conditional<WF, WGlobal, WCol>::type wc;
  if (FEATS) wc.load(W, K, F, k);
  const float pik = active ? pi[k] : 0.f;
  const int D = fbc::obs_dim(KIND, F);         // built kinds: the observations' width
  const int in_w = FEATS ? D : K;              // floats of a (t, b) row of src
  const size_t step_f = (size_t)B * in_w, step_k = (size_t)B * K;
  const float* fb = src + (size_t)b0 * in_w;
  const size_t a_base = (size_t)b0 * K + k;
  for (int i = k; i < 2 * S * KP; i += KP) a_s[i] = 0.f;
  for (int i = k; i < 2 * S * fs; i += KP) f_s[i] = 0.f;
  __syncthreads();
  if (FEATS) feat_rows<S, KIND, WF>(f_s, fb, ns, F, k, KP, D, fs);
  float l_next[S];  // not FEATS: ll_t, read a step ahead
#pragma unroll
  for (int s = 0; s < S; ++s)
    l_next[s] = (!FEATS && active && s < ns) ? fb[(size_t)s * K + k] : 0.f;
  __syncthreads();

  float inv[S];  // 1 / s_{t-1}
#pragma unroll
  for (int s = 0; s < S; ++s) inv[s] = 1.f;
  for (int t = 0; t < T; ++t) {
    const int p = t & 1;
    float ll[S];
    if (FEATS) {
      wc.template lls<S>(ll, f_s + p * S * fs, fs, nf4);
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        ll[s] = l_next[s];
        if (t + 1 < T && active && s < ns) l_next[s] = fb[(size_t)(t + 1) * step_k + s * K + k];
      }
    }
    float u[S];
    if (t > 0) {
      col.template dots<S>(u, a_s + (p ^ 1) * S * KP, KP, M_s, k);
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) u[s] = 0.f;
    }
    float wm[S];
#pragma unroll
    for (int s = 0; s < S; ++s) wm[s] = active ? ll[s] : -INFINITY;
    fbc::warp_maxes<S>(wm);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) red_max[(p * S + s) * NW + warp] = wm[s];
    }
    if (FEATS && t + 1 < T)
      feat_rows<S, KIND, WF>(f_s + (p ^ 1) * S * fs, fb + (size_t)(t + 1) * step_f, ns, F, k,
                             KP, D, fs);
    __syncthreads();  // a_{t-1} and f_t are read; the maxima are complete

    float m[S], ws[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      m[s] = block_max<NW>(red_max + (p * S + s) * NW);
      const float lik = active ? expf(ll[s] - m[s]) : 0.f;
      const float a = active ? (t == 0 ? pik * lik : u[s] * (lik * inv[s])) : 0.f;
      a_s[(p * S + s) * KP + k] = a;
      if (active && s < ns) {
        const size_t o = a_base + (size_t)t * step_k + (size_t)s * K;
        if constexpr (ABF)
          alpha16[o] = __float2bfloat16_rn(a);
        else
          alpha[o] = a;
      }
      ws[s] = a;
    }
    fbc::warp_sums<S>(ws);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) red_sum[(p * S + s) * NW + warp] = ws[s];
    }
    if constexpr (ABF) {  // s_t: the sum of the stored, rounded a_t
      float sr[S];
#pragma unroll
      for (int s = 0; s < S; ++s) sr[s] = fbc::bf16_round(a_s[(p * S + s) * KP + k]);
      fbc::warp_sums<S>(sr);
      if (lane == 0) {
#pragma unroll
        for (int s = 0; s < S; ++s) red_sr[(p * S + s) * NW + warp] = sr[s];
      }
    }
    __syncthreads();  // a_t and the sums are complete

#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float sum = block_sum<NW>(red_sum + (p * S + s) * NW);
      inv[s] = 1.f / fmaxf(sum, SUM_FLOOR);
      if (k == s && s < ns) {
        s_out[(size_t)(b0 + s) * T + t] =
            ABF ? block_sum<NW>(red_sr + (p * S + s) * NW) : sum;
        sh_out[(size_t)(b0 + s) * T + t] = m[s];
      }
    }
  }
}

// The backward recursion of the S sequences of block blk (as seqs_forward)
// over the window t = t1-1 .. t0, b'_{T-1} = 1 / s_{T-1}:
//   g_t = a_t b'_t, n_t = 1 / sum_k g_t, gamma_t = g_t n_t,
//   d_t = (lik_t / s_{t-1}) b'_t, b'_{t-1} = d_t @ A~^T,
// with lik_t re-derived from ll_t (FEATS: f_t . W by the forward's chain;
// else read from ll (T, B, K), with sh_t and s_{t-1}, a step before it is
// needed) and the forward's sh_t. A window below T starts from the
// b'_{t1-1} that the window above left in carry (B, K), and one above 0
// leaves b'_{t0-1} there: the chain is the one recursion over all T, bit
// for bit. Writes dn_t = d_t n_t pg_t (t >= 1) to dn and, FEATS, w_t
// gamma_t to gw, (t1 - t0, B, K) each from t0; gamma0 = w_0 gamma_0 and
// gamma (when not null), ungated. Gated, g is the kept-mask w and the pair
// gate pg_t = w_{t-1} w_t is formed here; ungated, g is null. Not FEATS
// (the split backward) gamma is always written and gw and gamma0 are not.
// Each word of A~^T (and of W) a thread reads in a step feeds S chains,
// each the one-sequence arithmetic, so nothing it writes depends on S. One
// barrier a step. FEATS also takes the built kinds (src the raw
// observations) and, MODES, as fbseq::seq_stats_backward: alpha16 (alpha
// stored as bf16, widened where read) and the time pick sel (B,), gamma0
// then each sequence's ungated gamma at t = sel[b] (zeros for a pick
// outside 0 .. T-1) in place of w_0 gamma_0. WF as seqs_forward's.
template <int KP, int S, bool FEATS, bool GATED, int KIND = fbc::FEATS_ARRAY,
          bool MODES = false, bool WF = false>
__device__ void seqs_backward(const float* __restrict__ A, const float* __restrict__ W,
                              const float* __restrict__ src, const float* __restrict__ alpha,
                              const float* __restrict__ s_in, const float* __restrict__ sh_in,
                              const float* __restrict__ g, float* __restrict__ gamma,
                              float* __restrict__ gamma0, float* __restrict__ dn_out,
                              float* __restrict__ gw_out, float* __restrict__ carry, int T,
                              int B, int K, int F, int t0, int t1, int blk, float* smem,
                              const __nv_bfloat16* __restrict__ alpha16 = nullptr,
                              const int* __restrict__ sel = nullptr) {
  using TT = Tier<KP>;
  constexpr int NW = TT::NWARP;
  const int fs = slot_stride<WF>(F);   // floats of a sequence's feature row
  float* M_s = smem;                     // A~^T rows RR..KP-1
  float* d_s = M_s + TT::SR * KP;        // d_t in slot t & 1, [S][KP] each
  float* f_s = d_s + 2 * S * KP;         // f_t in slot t & 1, [S][fs] each
  float* red = f_s + 2 * S * fs;         // partial sums of g_t, [t & 1][S][warp]
  const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
  const bool active = k < K;
  const int b0 = blk * S, ns = S == 1 ? 1 : min(S, B - b0);  // sequences held
  const int nf4 = (F + 3) / 4;

  MatCol<KP> col;
  col.load(A, M_s, K, true, k);
  typename std::conditional<WF, WGlobal, WCol>::type wc;
  if (FEATS) wc.load(W, K, F, k);
  const int D = fbc::obs_dim(KIND, F);  // built kinds: the observations' width
  const int in_w = FEATS ? D : K;       // floats of a (t, b) row of src
  const size_t step_f = (size_t)B * in_w, step_k = (size_t)B * K;
  const float* fb = src + (size_t)b0 * in_w;
  const float* ab = MODES && alpha16 != nullptr ? nullptr : alpha + (size_t)b0 * K + k;
  const __nv_bfloat16* ab16 = MODES && alpha16 != nullptr ? alpha16 + (size_t)b0 * K + k
                                                                   : nullptr;
  auto a_at = [&](int t, int s) {  // a_t of sequence s as stored, widened
    const size_t o = (size_t)t * step_k + (size_t)s * K;
    if constexpr (MODES) return ab16 != nullptr ? __bfloat162float(ab16[o]) : ab[o];
    return ab[o];
  };
  for (int i = k; i < 2 * S * fs; i += KP) f_s[i] = 0.f;
  __syncthreads();
  if (FEATS)
    feat_rows<S, KIND, WF>(f_s + ((t1 - 1) & 1) * S * fs, fb + (size_t)(t1 - 1) * step_f, ns,
                           F, k, KP, D, fs);
  __syncthreads();

  // per sequence: a_t, b'_t (an idle state's is 0 in the one recursion: its
  // column of A~^T is; a missing sequence's 0), w_t and (sel) the time pick
  float a_cur[S], beta[S], g_cur[S];
  int pick[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool ok = s < ns;
    const int b = b0 + s;
    a_cur[s] = (ok && active) ? a_at(t1 - 1, s) : 0.f;
    pick[s] = (MODES && sel != nullptr && ok) ? sel[b] : -1;
    beta[s] = !ok ? 0.f
                  : t1 == T ? 1.f / fmaxf(s_in[(size_t)b * T + T - 1], SUM_FLOOR)
                            : (active ? carry[(size_t)b * K + k] : 0.f);
    g_cur[s] = GATED ? (ok ? g[(size_t)(t1 - 1) * B + b] : 0.f) : 1.f;
  }
  // not FEATS: ll_t, sh_t, s_{t-1} and (gated) w_{t-1} of the step to come,
  // read in the step before it (the window's first step's here): the
  // kept-mask misses every cache (its stride is B), and read in its own step
  // it made the one-sequence gated instance at KP = 256 take 26 % longer at
  // B = 32, W = 70 on the H100 (PERF.md)
  float l_nx[S], sh_nx[S], sp_nx[S], gp_nx[S];
  auto read_ahead = [&](const int t) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool ok = s < ns;
      const int b = b0 + s;
      l_nx[s] = (ok && active) ? fb[(size_t)t * step_k + s * K + k] : 0.f;
      sh_nx[s] = ok ? sh_in[(size_t)b * T + t] : 0.f;
      sp_nx[s] = (ok && t >= 1) ? s_in[(size_t)b * T + t - 1] : 1.f;
      if (GATED) gp_nx[s] = (ok && t >= 1) ? g[(size_t)(t - 1) * B + b] : 0.f;
    }
  };
  if constexpr (!FEATS) read_ahead(t1 - 1);
  // one step; Z (t == 0) is a compile-time flag, so that the steps t >= 1
  // run without a branch on t (step 0 is peeled off the loop)
  auto step = [&](const int t, auto z) {
    constexpr bool Z = decltype(z)::value;
    const int p = t & 1;
    float ll[S], shs[S], sps[S], gps[S];
    if constexpr (FEATS) {
      wc.template lls<S>(ll, f_s + p * S * fs, fs, nf4);
    } else {
#pragma unroll
      for (int s = 0; s < S; ++s) {
        ll[s] = l_nx[s];
        shs[s] = sh_nx[s];
        sps[s] = sp_nx[s];
        gps[s] = gp_nx[s];
      }
      if (!Z) read_ahead(t - 1);
    }
    float a_prev[S], g_prev[S], graw[S], d[S], gs[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool ok = s < ns;
      const int b = b0 + s;
      a_prev[s] = (ok && active && !Z) ? a_at(t - 1, s) : 0.f;
      g_prev[s] = (GATED && !Z) ? (!FEATS ? gps[s] : ok ? g[(size_t)(t - 1) * B + b] : 0.f)
                                : 1.f;
      const float sh = !FEATS ? shs[s] : ok ? sh_in[(size_t)b * T + t] : 0.f;
      const float sp = !FEATS ? sps[s] : (ok && !Z) ? s_in[(size_t)b * T + t - 1] : 1.f;
      const float lik = active ? expf(ll[s] - sh) : 0.f;
      graw[s] = a_cur[s] * beta[s];
      d[s] = !Z ? (lik * (1.f / fmaxf(sp, SUM_FLOOR))) * beta[s] : 0.f;
      d_s[(p * S + s) * KP + k] = d[s];
      gs[s] = graw[s];
    }
    fbc::warp_sums<S>(gs);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) red[(p * S + s) * NW + warp] = gs[s];
    }
    if (FEATS && !Z)
      feat_rows<S, KIND, WF>(f_s + (p ^ 1) * S * fs, fb + (size_t)(t - 1) * step_f, ns, F, k,
                             KP, D, fs);
    __syncthreads();  // d_t, the partial sums and f_{t-1} are complete

#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int b = b0 + s;
      const float n = 1.f / fmaxf(block_sum<NW>(red + (p * S + s) * NW), SUM_FLOOR);
      const float gam = graw[s] * n;
      const size_t o = ((size_t)t * B + b) * K + k;
      const size_t ow = ((size_t)(t - t0) * B + b) * K + k;  // in the window
      if (active && s < ns) {
        if (gamma != nullptr) gamma[o] = gam;
        if (FEATS) {
          const float gw = GATED ? gam * g_cur[s] : gam;  // the statistics' gamma: kept steps
          gw_out[ow] = gw;
          float* g0 = gamma0 + (size_t)b * K + k;
          if (!MODES || sel == nullptr) {
            if (Z) *g0 = gw;
          } else if (t == pick[s]) {
            *g0 = gam;  // the pick: ungated
          } else if (Z && (pick[s] < 0 || pick[s] >= T)) {
            *g0 = 0.f;
          }
        }
        if (!Z) {
          // stats side, pair-gated; the chain keeps d
          float dn = d[s] * n;
          if (GATED) dn = dn * (g_prev[s] * g_cur[s]);
          dn_out[ow] = dn;
        }
      }
    }
    // b'_{t-1}[k] = sum_j d_t[j] A~[k][j], for the S sequences at once
    if (!Z) col.template dots<S>(beta, d_s + p * S * KP, KP, M_s, k);
#pragma unroll
    for (int s = 0; s < S; ++s) {
      a_cur[s] = a_prev[s];
      g_cur[s] = g_prev[s];
    }
  };
  for (int t = t1 - 1; t >= (t0 > 0 ? t0 : 1); --t) step(t, std::false_type{});
  if (t0 == 0) step(0, std::true_type{});
  if (t0 > 0 && active) {
#pragma unroll
    for (int s = 0; s < S; ++s)
      if (s < ns) carry[(size_t)(b0 + s) * K + k] = beta[s];  // b'_{t0-1}
  }
}

}  // namespace fbw
