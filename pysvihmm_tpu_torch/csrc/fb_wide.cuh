// The large-K layout of the forward-backward kernels (65 <= K <= 256),
// shared by fused_fb.cu, split_fb.cu, duplex_fb.cu and split_probe.cu.
//
// An instance is built for KP = 128 or 256 padded states: one block a
// sequence (the duplex chain: a block a direction), one thread a state (KP
// threads, those with k >= K idle but in every barrier and shuffle). Three
// numbers shape it: A~ in float32 takes 64 KB at KP = 128 and 256 KB at 256,
// a block may use 227 KB of shared memory, and a thread 255 registers. So a
// thread keeps the first RR rows of the matrix its matvec reads (A~ for the
// forward, A~^T for the backward) in registers -- RR = 0 at KP = 128, 64 at
// KP = 256, column k of those rows -- and the other rows lie in dynamic
// shared memory, 192 KB at most; W's column k (FMAX floats) stays in
// registers. The matvec is one fmaf chain over i = 0..KP-1 in order (the
// rows in registers, then those in shared memory) over zero padding, and
// the per-step sums and maxima are each warp's butterfly, then the warps'
// partials added in warp order: the forward device function below is the
// fused forward's and the duplex chain's at these K, so their alpha, s and
// sh agree bit for bit, and the backward recomputes ll by the same chain.
//
// The statistics leave the chain at these K (fb_stats.cuh): the backward
// writes d_t n_t pg_t and w_t gamma_t for a window of time steps a launch,
// and outer products summed in a fixed order form acc and eacc.

#pragma once

#include <type_traits>

#include "fb_common.cuh"

namespace fbw {

using fbc::FMAX;
using fbc::SUM_FLOOR;
using fbc::warp_max;
using fbc::warp_sum;

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
  // ll = f . W[:, k], the fmaf chain over f = 0..FMAX-1 in order (the row
  // f_s in shared memory, zero beyond F, 16-byte aligned)
  __device__ __forceinline__ float ll(const float* f_s) const {
    float acc = 0.f;
#pragma unroll
    for (int f4 = 0; f4 < FMAX / 4; ++f4) {
      const float4 y = ld4(f_s + 4 * f4);
      acc = fmaf(y.x, w[4 * f4], acc);
      acc = fmaf(y.y, w[4 * f4 + 1], acc);
      acc = fmaf(y.z, w[4 * f4 + 2], acc);
      acc = fmaf(y.w, w[4 * f4 + 3], acc);
    }
    return acc;
  }
};

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

// Dynamic shared memory of wide_forward, wide_backward and the duplex chain's
// backward half, in bytes (the largest of the three).
template <int KP>
constexpr int chain_smem_bytes() {
  return 4 * (Tier<KP>::SR * KP + 2 * KP + 2 * FMAX + 4 * Tier<KP>::NWARP);
}

// The forward recursion of sequence b (fused_fb.cu's math): ll_t = f_t . W
// (FEATS; feats (T, B, F)) or read from ll (T, B, K); sh_t = max_k ll_t,
// lik_t = exp(ll_t - sh_t), a_0 = pi~ lik_0, a_t = (a_{t-1} @ A~) (lik_t /
// s_{t-1}), s_t = sum_k a_t. Writes raw alpha (T, B, K), s and sh (B, T).
template <int KP, bool FEATS>
__device__ void wide_forward(const float* __restrict__ pi, const float* __restrict__ A,
                             const float* __restrict__ W, const float* __restrict__ src,
                             float* __restrict__ alpha, float* __restrict__ s_out,
                             float* __restrict__ sh_out, int T, int B, int K, int F, int b,
                             float* smem) {
  using TT = Tier<KP>;
  float* M_s = smem;                     // A~ rows RR..KP-1
  float* a_s = M_s + TT::SR * KP;        // a_t in slot t & 1
  float* f_s = a_s + 2 * KP;             // f_t in slot t & 1
  float* red_max = f_s + 2 * FMAX;       // [t & 1][warp]
  float* red_sum = red_max + 2 * TT::NWARP;
  const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  MatCol<KP> col;
  col.load(A, M_s, K, false, k);
  WCol wc;
  if (FEATS) wc.load(W, K, F, k);
  const float pik = active ? pi[k] : 0.f;
  const size_t step_f = (size_t)B * F, step_k = (size_t)B * K;
  const float* fb = src + (size_t)b * (FEATS ? F : K);
  float* ab = alpha + (size_t)b * K;
  for (int i = k; i < 2 * KP; i += KP) a_s[i] = 0.f;
  if (k < 2 * FMAX) f_s[k] = 0.f;
  __syncthreads();
  if (FEATS && k < F) f_s[k] = fb[k];
  float l_next = (!FEATS && active) ? fb[k] : -INFINITY;
  __syncthreads();

  float inv = 1.f;  // 1 / s_{t-1}
  for (int t = 0; t < T; ++t) {
    const int p = t & 1;
    float ll;
    if (FEATS) {
      ll = wc.ll(f_s + p * FMAX);
    } else {
      ll = l_next;
      if (t + 1 < T && active) l_next = fb[(size_t)(t + 1) * step_k + k];
    }
    const float u = t > 0 ? col.dot(a_s + (p ^ 1) * KP, M_s, k) : 0.f;
    const float wm = warp_max(active ? ll : -INFINITY);
    if (lane == 0) red_max[p * TT::NWARP + warp] = wm;
    if (FEATS && t + 1 < T && k < F) f_s[(p ^ 1) * FMAX + k] = fb[(size_t)(t + 1) * step_f + k];
    __syncthreads();  // a_{t-1} and f_t are read; the maxima are complete

    const float m = block_max<TT::NWARP>(red_max + p * TT::NWARP);
    const float lik = active ? expf(ll - m) : 0.f;
    const float a = active ? (t == 0 ? pik * lik : u * (lik * inv)) : 0.f;
    a_s[p * KP + k] = a;
    if (active) ab[(size_t)t * step_k + k] = a;
    const float ws = warp_sum(a);
    if (lane == 0) red_sum[p * TT::NWARP + warp] = ws;
    __syncthreads();  // a_t and the sums are complete

    const float s = block_sum<TT::NWARP>(red_sum + p * TT::NWARP);
    inv = 1.f / fmaxf(s, SUM_FLOOR);
    if (k == 0) {
      s_out[(size_t)b * T + t] = s;
      sh_out[(size_t)b * T + t] = m;
    }
  }
}

// The backward recursion of sequence b over the window t = t1-1 .. t0,
// b'_{T-1} = 1 / s_{T-1}:
//   g_t = a_t b'_t, n_t = 1 / sum_k g_t, gamma_t = g_t n_t,
//   d_t = (lik_t / s_{t-1}) b'_t, b'_{t-1} = d_t @ A~^T,
// with lik_t re-derived from ll_t (FEATS: f_t . W by the forward's chain,
// else read) and the forward's sh_t. A window below T starts from the
// b'_{t1-1} that the window above left in carry (B, K), and one above 0
// leaves b'_{t0-1} there: the chain is the one recursion over all T, bit
// for bit. Writes dn_t = d_t n_t pg_t (t >= 1) to dn and, FEATS, w_t
// gamma_t to gw, (t1 - t0, B, K) each from t0; gamma0 = w_0 gamma_0 and
// gamma (when not null), ungated. FEATS: g is the kept-mask w and pg_t =
// w_{t-1} w_t (the fused backward); else g is the pair gate pg itself and
// gamma is always written (the split backward). Ungated: g null.
template <int KP, bool FEATS, bool GATED>
__device__ void wide_backward(const float* __restrict__ A, const float* __restrict__ W,
                              const float* __restrict__ src, const float* __restrict__ alpha,
                              const float* __restrict__ s_in, const float* __restrict__ sh_in,
                              const float* __restrict__ g, float* __restrict__ gamma,
                              float* __restrict__ gamma0, float* __restrict__ dn_out,
                              float* __restrict__ gw_out, float* __restrict__ carry, int T,
                              int B, int K, int F, int t0, int t1, int b, float* smem) {
  using TT = Tier<KP>;
  float* M_s = smem;                     // A~^T rows RR..KP-1
  float* d_s = M_s + TT::SR * KP;        // d_t in slot t & 1
  float* f_s = d_s + 2 * KP;             // f_t in slot t & 1
  float* red = f_s + 2 * FMAX;           // partial sums of g_t, [t & 1][warp]
  const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  MatCol<KP> col;
  col.load(A, M_s, K, true, k);
  WCol wc;
  if (FEATS) wc.load(W, K, F, k);
  const size_t step_f = (size_t)B * F, step_k = (size_t)B * K;
  const float* fb = src + (size_t)b * (FEATS ? F : K);
  const float* ab = alpha + (size_t)b * K + k;
  const float* sb = s_in + (size_t)b * T;
  const float* shb = sh_in + (size_t)b * T;
  if (k < 2 * FMAX) f_s[k] = 0.f;
  __syncthreads();
  if (FEATS && k < F) f_s[((t1 - 1) & 1) * FMAX + k] = fb[(size_t)(t1 - 1) * step_f + k];
  __syncthreads();

  float a_cur = active ? ab[(size_t)(t1 - 1) * step_k] : 0.f;  // a_t
  // b'_t; an idle state's is 0 in the one recursion (its column of A~^T is)
  float beta = t1 == T ? 1.f / fmaxf(sb[T - 1], SUM_FLOOR)
                       : (active ? carry[(size_t)b * K + k] : 0.f);
  float g_cur = GATED ? g[(size_t)(t1 - 1) * B + b] : 1.f;  // w_t (FEATS) or pg_t
  // one step; Z (t == 0) is a compile-time flag, so that the steps t >= 1
  // run without a branch on t (step 0 is peeled off the loop)
  auto step = [&](const int t, auto z) {
    constexpr bool Z = decltype(z)::value;
    const int p = t & 1;
    const float ll = FEATS ? wc.ll(f_s + p * FMAX)
                           : (active ? fb[(size_t)t * step_k + k] : 0.f);
    const float a_prev = (active && !Z) ? ab[(size_t)(t - 1) * step_k] : 0.f;
    const float g_prev = (GATED && !Z) ? g[(size_t)(t - 1) * B + b] : 1.f;
    const float lik = active ? expf(ll - shb[t]) : 0.f;
    const float graw = a_cur * beta;
    const float d = !Z ? (lik * (1.f / fmaxf(sb[t - 1], SUM_FLOOR))) * beta : 0.f;
    d_s[p * KP + k] = d;
    const float ws = warp_sum(graw);
    if (lane == 0) red[p * TT::NWARP + warp] = ws;
    if (FEATS && !Z && k < F) f_s[(p ^ 1) * FMAX + k] = fb[(size_t)(t - 1) * step_f + k];
    __syncthreads();  // d_t, the partial sums and f_{t-1} are complete

    const float n = 1.f / fmaxf(block_sum<TT::NWARP>(red + p * TT::NWARP), SUM_FLOOR);
    const float gam = graw * n;
    const size_t o = ((size_t)t * B + b) * K + k;
    const size_t ow = ((size_t)(t - t0) * B + b) * K + k;  // in the window
    if (active) {
      if (gamma != nullptr) gamma[o] = gam;
      if (FEATS) {
        const float gw = GATED ? gam * g_cur : gam;  // the statistics' gamma: kept steps
        gw_out[ow] = gw;
        if (Z) gamma0[(size_t)b * K + k] = gw;
      }
      if (!Z) {
        // stats side, pair-gated; the chain keeps d
        float dn = d * n;
        if (GATED) dn = FEATS ? dn * (g_prev * g_cur) : dn * g_cur;
        dn_out[ow] = dn;
      }
    }
    if (!Z) beta = col.dot(d_s + p * KP, M_s, k);  // b'_{t-1}[k] = sum_j d_t[j] A~[k][j]
    a_cur = a_prev;
    g_cur = g_prev;
  };
  for (int t = t1 - 1; t >= (t0 > 0 ? t0 : 1); --t) step(t, std::false_type{});
  if (t0 == 0) step(0, std::true_type{});
  if (t0 > 0 && active) carry[(size_t)b * K + k] = beta;  // b'_{t0-1}
}

}  // namespace fbw
