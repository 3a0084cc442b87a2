// Fused forward and backward E-step kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the fused E-step:
//   fused_fwd_kernel  <- pysvihmm_tpu/messages/pallas_fb.py:516 (_fwd_kernel_fused)
//   fused_bwd_kernel  <- pysvihmm_tpu/messages/pallas_fb.py:577 (_bwd_kernel_fused)
// The host wrapper and the plain PyTorch twin of both kernels live in
// pysvihmm_tpu_torch/messages/fused_fb.py.
//
// What is computed (same math as the TPU kernels, with the TPU mechanisms --
// lane packing, time tiles, VMEM budgets, tile-edge carries, bf16x3 dots --
// left out):
//   forward, per step t:  ll_t = f_t . W  (F-length dot, in-kernel)
//                         lik_t = exp(ll_t - max_k ll_t)
//                         a_0 = pi~ * lik_0
//                         a_t = (a_{t-1} @ A~) * (lik_t / s_{t-1})
//                         s_t = sum_k a_t,  sh_t = max_k ll_t
//     The per-sequence renormalisation runs every step and is folded into
//     the next step's likelihood operand, so the matvec does not wait for
//     the sum. Writes the raw a_t, s_t and sh_t; log c_t = log s_t + sh_t.
//   backward, t = T-1 .. 0, with b'_{T-1} = 1 / s_{T-1}:
//                         g_t = a_t * b'_t,  n_t = 1 / sum_k g_t,  gamma_t = g_t n_t
//                         d_t = (lik_t / s_{t-1}) * b'_t
//                         acc   += outer(a_{t-1}, d_t n_t pg_t)   (wrapper forms A~ * acc)
//                         eacc  += outer(w_t gamma_t, f_t)
//                         gamma0 = w_0 gamma_0
//                         b'_{t-1} = d_t @ A~^T
//     Gated mode (SVI windows; pallas_fb.py:693-697, :1095-1099) takes the
//     kept-mask w (T, B) and forms the pair gate pg_t = w_{t-1} w_t itself
//     (pg_0 is never used); ungated, w = pg = 1. The gates touch the
//     statistics only: the beta chain runs on the ungated d, buffer steps
//     drive the chain like kept ones, and the gamma written out is the
//     ungated one.
//     Every per-sequence sum is floored at SUM_FLOOR (pallas_fb.py:82).
//     beta, xi and the (T, B, K) likelihood array never reach device memory.
//
// Numerics shared with duplex_fb.cu: ll_t is the fmaf chain over f = 0..F-1
// in order (fbc::ll_dot's), the matvec the fmaf chain over i = 0..K-1 in
// order, s_t the warp butterfly (fbc::warp_sum) of each 32 states and then
// warp 0's sum plus warp 1's. The kernels run those chains to the padded K
// and F, over zero-padded A~, W and features: fmaf(0, 0, u) == u, so the
// padding changes no bit, and the duplex chain's alpha, s and sh equal this
// forward's bit for bit. The backward recomputes ll_t by the same chain and
// shifts it by the forward's own sh_t, so lik_t is bit-identical.
//
// Layout. A block carries S sequences (b0 .. b0+S-1; the last block may
// hold fewer, and the missing ones run on zero features and write nothing),
// one thread per state k (KMAX threads, those with k >= K idle but in every
// barrier and shuffle), the whole T loop inside the block. Thread k runs
// state k of all S sequences as S interleaved chains, so every word of A~ or
// W it reads in a step feeds S independent FMAs, and B/S blocks fit the card
// in one wave (the wrapper picks S from B). Arrays are time-major as the JAX
// wrapper takes them: feats (T, B, F), so a block's feature row of a step is
// S*F contiguous floats; alpha and gamma (T, B, K), w (T, B); s and sh are
// (B, T); gamma0 (B, K); acc (K, K); eacc (K, F).
//
// What bounds it on this card. Per (t, b) the pair moves about 4 (2F + 2K)
// bytes and does about 2K (2F + 3K) flops; the FMAs alone at 67 TFLOP/s take
// a fifth to a half of a millisecond at the VB shape, and bytes a tenth of
// that. Each step is a chain of dependent K-wide products, so what matters
// is the instructions each step issues on an SM, FMAs and shared-memory
// loads, and that enough independent chains are in flight to cover their
// latency. The design, for each:
//   forward: thread k holds column k of A~ and of W in registers, loaded
//     once; a step reads only the broadcast a_{t-1} and f_{t+1} of its S
//     sequences from shared memory, as float4. One barrier a step: a_t, the
//     per-sequence partial sums and maxima are double-buffered, and ll of
//     the next step (its max included) is computed a step ahead in the same
//     loop as the matvec (step 0 is peeled off, so that both chains are live
//     in every iteration and interleave), so the matvec never waits for a
//     reduction of its own step.
//   backward: column k of acc and row k of eacc take K + F registers, so A~
//     (row k) and W (column k) are read from shared memory, padded rows so
//     that the float4 reads are free of bank conflicts, and each word feeds
//     S FMAs. One barrier a step (double-buffered d, a and partial sums,
//     triple-buffered features); after it, one loop runs the beta chain, the
//     next step's ll chain and the acc and eacc updates side by side. acc
//     and eacc are added across blocks with one atomicAdd per entry at the
//     end, B/S blocks of them; their summation order varies from run to run.
//   Each step's feature row is loaded a step (backward) or two steps
//   (forward) ahead into registers, so the global loads are off the chain.
//   The chains stay on CUDA cores in float32 FFMA: per step the products
//   are (S x K) @ (K x K) with S <= 4, far below wgmma's 64 rows, and TF32
//   would round alpha and A~ every step.
// A hypothesis, fitted to three timings on an H100 and not yet profiled
// (PERF.md): at S = 2 both kernels are bound by the shared-memory pipe, about
// 3 cycles a broadcast float4 load and 4 a conflict-free one per warp, with
// the FMA pipe about half busy; every state a thread owns needs the whole
// a_{t-1} (and d_t, f_t) delivered to it each step, so more states a thread,
// not more sequences, would be the next lever.

#include "fb_common.cuh"

namespace {

using fbc::FMAX;
using fbc::KMAX;
using fbc::NT;
using fbc::NWARP;
using fbc::SUM_FLOOR;

constexpr int AST = KMAX + 4;  // row stride of A~ in the backward's shared memory

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

constexpr unsigned FULL = 0xffffffffu;

// The butterflies of fbc::warp_sum and fbc::warp_max for S sequences at
// once, their shuffles interleaved: each sequence's sum is added in the
// same order as warp_sum's, bit for bit.
template <int S>
__device__ __forceinline__ void warp_sums(float (&v)[S]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] += __shfl_xor_sync(FULL, v[s], o);
  }
}

template <int S>
__device__ __forceinline__ void warp_sums_maxes(float (&v)[S], float (&m)[S]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      v[s] += __shfl_xor_sync(FULL, v[s], o);
      m[s] = fmaxf(m[s], __shfl_xor_sync(FULL, m[s], o));
    }
  }
}

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

template <int S, int FP>
__global__ void __launch_bounds__(NT)
fused_fwd_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                 const float* __restrict__ W, const float* __restrict__ feats,
                 float* __restrict__ alpha, float* __restrict__ s_out,
                 float* __restrict__ sh_out, int T, int B, int K, int F) {
  __shared__ __align__(16) float f_s[2][S * FP];    // f_t in slot t & 1
  __shared__ __align__(16) float a_s[2][S * KMAX];  // a_t in slot t & 1, zero beyond K
  __shared__ float red_max[2][NWARP * S];           // partial max of ll_t, slot t & 1
  __shared__ float red_sum[2][NWARP * S];           // partial sum of a_t, slot t & 1

  const int b0 = blockIdx.x * S;
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

// The backward's dynamic shared memory, in bytes: A~ rows, W columns, three
// feature slots, two of d and of a_{t-1}, two of the partial sums.
constexpr int bwd_smem_bytes(int S, int FP) {
  return 4 * (KMAX * AST + KMAX * (FP + 4) + 3 * S * FP + 4 * S * KMAX + 2 * NWARP * S);
}

// GATED is a template parameter, so that the ungated instance carries no
// trace of the gates: no loads, no multiplies, no extra live registers.
template <int S, int FP, bool GATED>
__global__ void __launch_bounds__(NT)
fused_bwd_kernel(const float* __restrict__ A, const float* __restrict__ W,
                 const float* __restrict__ feats, const float* __restrict__ alpha,
                 const float* __restrict__ s_in, const float* __restrict__ sh_in,
                 const float* __restrict__ w_in, float* __restrict__ gamma,
                 float* __restrict__ gamma0, float* __restrict__ acc_out,
                 float* __restrict__ eacc_out, int T, int B, int K, int F) {
  constexpr int WST = FP + 4;  // row stride of W's columns in shared memory
  extern __shared__ __align__(16) float smem[];
  float* A_s = smem;                  // A~[k][j] at k * AST + j
  float* W_s = A_s + KMAX * AST;      // W[f][k] at k * WST + f
  float* f_s = W_s + KMAX * WST;      // f_t in slot t % 3, [S][FP] each
  float* d_s = f_s + 3 * S * FP;      // d_t in slot t & 1, [S][KMAX] each
  float* a_s = d_s + 2 * S * KMAX;    // a_{t-1} in slot t & 1
  float* red = a_s + 2 * S * KMAX;    // partial sums of g_t in slot t & 1, [NWARP][S]

  const int b0 = blockIdx.x * S;
  const int ns = min(S, B - b0);
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  for (int idx = k; idx < KMAX * KMAX; idx += NT) {
    const int r = idx / KMAX, c = idx % KMAX;
    A_s[r * AST + c] = (r < K && c < K) ? A[r * K + c] : 0.f;
  }
  for (int idx = k; idx < KMAX * FP; idx += NT) {
    const int r = idx / FP, c = idx % FP;
    W_s[r * WST + c] = (r < K && c < F) ? W[c * K + r] : 0.f;
  }
  for (int i = k; i < 3 * S * FP; i += NT) f_s[i] = 0.f;

  float acc[KMAX];  // column k of sum_t outer(a_{t-1}, d_t n_t pg_t)
  float eacc[FP];   // row k of sum_t outer(w_t gamma_t, f_t)
#pragma unroll
  for (int i = 0; i < KMAX; ++i) acc[i] = 0.f;
#pragma unroll
  for (int f = 0; f < FP; ++f) eacc[f] = 0.f;

  const size_t step_f = (size_t)B * F;
  const size_t step_k = (size_t)B * K;
  const float* fb = feats + (size_t)b0 * F;
  const float* ab = alpha + (size_t)b0 * K + k;

  // per sequence: a_t, a_{t-1}, s_{t-1}, sh_t, b'_t and the kept-mask w_t
  float a_cur[S], a_prev[S], s_prev[S], sh_cur[S], beta[S], w_cur[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool ok = s < ns;
    const float* sb = s_in + (size_t)(b0 + s) * T;
    a_cur[s] = (ok && active) ? ab[(size_t)(T - 1) * step_k + (size_t)s * K] : 0.f;
    a_prev[s] = (ok && active && T >= 2) ? ab[(size_t)(T - 2) * step_k + (size_t)s * K] : 0.f;
    s_prev[s] = (ok && T >= 2) ? sb[T - 2] : 1.f;
    sh_cur[s] = ok ? sh_in[(size_t)(b0 + s) * T + T - 1] : 0.f;
    beta[s] = 1.f / fmaxf(ok ? sb[T - 1] : 1.f, SUM_FLOOR);
    w_cur[s] = GATED ? (ok ? w_in[(size_t)(T - 1) * B + b0 + s] : 0.f) : 1.f;
  }
  FeatRows<S, FP> rows(k, ns, F);
  __syncthreads();  // the zeroed slots before the rows land in them
  rows.load(fb + (size_t)(T - 1) * step_f);
  rows.store(f_s + ((T - 1) % 3) * S * FP);
  if (T >= 2) rows.load(fb + (size_t)(T - 2) * step_f);  // f_{T-2}, stored in step T-1
  __syncthreads();

  // ll_{T-1}: the forward's fmaf chain, column k of W from shared memory;
  // every later ll_{t-1} is computed in step t beside the beta chain
  float ll[S];
#pragma unroll
  for (int s = 0; s < S; ++s) ll[s] = 0.f;
#pragma unroll
  for (int f4 = 0; f4 < FP / 4; ++f4) {
    const float4 wv = ld4(W_s + k * WST + 4 * f4);
    float4 y[S];
    ld4s<S>(y, f_s + ((T - 1) % 3) * S * FP + 4 * f4, FP);
    fma4<S>(ll, y, wv.x, wv.y, wv.z, wv.w);
  }

  for (int t = T - 1; t >= 0; --t) {
    const int p = t & 1;
    const float* ft = f_s + (t % 3) * S * FP;        // f_t
    float* fn = f_s + ((t + 2) % 3) * S * FP;        // f_{t-1}
    float* dp = d_s + p * S * KMAX;
    float* ap = a_s + p * S * KMAX;
    float* rp = red + p * NWARP * S;

    // operands of step t-1, loaded now so their latency hides behind step t
    float a_n[S], s_n[S], sh_n[S], w_n[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool ok = s < ns;
      a_n[s] = (ok && active && t >= 2) ? ab[(size_t)(t - 2) * step_k + (size_t)s * K] : 0.f;
      s_n[s] = (ok && t >= 2) ? s_in[(size_t)(b0 + s) * T + t - 2] : 1.f;
      sh_n[s] = (ok && t >= 1) ? sh_in[(size_t)(b0 + s) * T + t - 1] : 0.f;
      w_n[s] = GATED ? ((ok && t >= 1) ? w_in[(size_t)(t - 1) * B + b0 + s] : 0.f) : 1.f;
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
    if (t >= 1) {  // f_{t-1} into its slot; f_{t-2} into registers
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
        if (t == 0) gamma0[(size_t)(b0 + s) * K + k] = gw[s];
      }
      // stats side, with the pair gate w_{t-1} w_t; the chain keeps d (0 at t = 0)
      dn[s] = GATED ? (d[s] * n) * (w_n[s] * w_cur[s]) : d[s] * n;
    }

    // b'_{t-1}[k] = sum_j d_t[j] A~[k][j] (j = 0..K-1 in order) and ll_{t-1}:
    // 2S independent fmaf chains in one loop, beside acc += outer(a_{t-1},
    // dn_t) and eacc += outer(gw_t, f_t). At t = 0 the chains' results are
    // unused (f_{t-1}'s slot is stale) and dn = 0, so acc is unchanged.
    float bn[S];
#pragma unroll
    for (int s = 0; s < S; ++s) bn[s] = ll[s] = 0.f;
#pragma unroll
    for (int i4 = 0; i4 < KMAX / 4; ++i4) {
      const float4 av = ld4(A_s + k * AST + 4 * i4);
      float4 x[S];
      ld4s<S>(x, dp + 4 * i4, KMAX);
      if (4 * i4 < FP) {
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
        acc[4 * i4] = fmaf(y[s].x, dn[s], acc[4 * i4]);
        acc[4 * i4 + 1] = fmaf(y[s].y, dn[s], acc[4 * i4 + 1]);
        acc[4 * i4 + 2] = fmaf(y[s].z, dn[s], acc[4 * i4 + 2]);
        acc[4 * i4 + 3] = fmaf(y[s].w, dn[s], acc[4 * i4 + 3]);
      }
      if (4 * i4 < FP) {
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
    }
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < K) atomicAdd(&acc_out[i * K + k], acc[i]);
#pragma unroll
    for (int f = 0; f < FP; ++f)
      if (f < F) atomicAdd(&eacc_out[k * F + f], eacc[f]);
  }
}

// The built instances: S in {2, 4} sequences a block, FP = pad_f(F).
template <int S>
const void* fwd_of(int fp) {
  switch (fp) {
    case 16: return reinterpret_cast<const void*>(fused_fwd_kernel<S, 16>);
    case 32: return reinterpret_cast<const void*>(fused_fwd_kernel<S, 32>);
    case 48: return reinterpret_cast<const void*>(fused_fwd_kernel<S, 48>);
    default: return reinterpret_cast<const void*>(fused_fwd_kernel<S, 64>);
  }
}

template <int S, bool GATED>
const void* bwd_of(int fp) {
  switch (fp) {
    case 16: return reinterpret_cast<const void*>(fused_bwd_kernel<S, 16, GATED>);
    case 32: return reinterpret_cast<const void*>(fused_bwd_kernel<S, 32, GATED>);
    case 48: return reinterpret_cast<const void*>(fused_bwd_kernel<S, 48, GATED>);
    default: return reinterpret_cast<const void*>(fused_bwd_kernel<S, 64, GATED>);
  }
}

// The kernel of (which, S, F): which = 0 forward, 1 backward, 2 gated
// backward; its dynamic shared memory in *smem. Null for an S not built.
const void* kernel_of(int which, int S, int F, int* smem) {
  const int fp = pad_f(F);
  *smem = 0;
  switch (S) {
#define FB_CASE(SS)                                                    \
  case SS:                                                             \
    if (which == 0) return fwd_of<SS>(fp);                             \
    *smem = bwd_smem_bytes(SS, fp);                                    \
    return which == 1 ? bwd_of<SS, false>(fp) : bwd_of<SS, true>(fp);
    FB_CASE(2)
    FB_CASE(4)
#undef FB_CASE
    default: return nullptr;
  }
}

bool bad_shape(int T, int B, int K, int F) {
  return T < 1 || B < 1 || K < 1 || K > KMAX || F < 1 || F > FMAX;
}

cudaError_t launch(int which, int S, int T, int B, int K, int F, int device, void* stream,
                   void** args) {
  if (bad_shape(T, B, K, F)) return cudaErrorInvalidValue;
  int smem = 0;
  const void* fn = kernel_of(which, S, F, &smem);
  if (fn == nullptr) return cudaErrorInvalidValue;
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernel(fn, dim3((B + S - 1) / S), dim3(NT), args, smem,
                       static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_fb_kmax() { return KMAX; }
int fused_fb_fmax() { return FMAX; }

const char* fused_fb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launcher returns the launch's CUDA error right after it (0 = ok).
// Pointers are device pointers of contiguous float32 tensors; the kernel
// runs on `stream` and does not synchronise. S is the sequences a block
// (2 or 4); any other is refused.
int fused_fb_forward(const float* pi, const float* A, const float* W, const float* feats,
                     float* alpha, float* s, float* sh, int T, int B, int K, int F, int S,
                     int device, void* stream) {
  void* args[] = {&pi, &A, &W, &feats, &alpha, &s, &sh, &T, &B, &K, &F};
  return static_cast<int>(launch(0, S, T, B, K, F, device, stream, args));
}

// w is null for the ungated launch, else the (T, B) kept-mask; the kernel
// forms the pair gate from it.
int fused_fb_backward(const float* A, const float* W, const float* feats, const float* alpha,
                      const float* s, const float* sh, const float* w, float* gamma,
                      float* gamma0, float* acc, float* eacc, int T, int B, int K, int F,
                      int S, int device, void* stream) {
  void* args[] = {&A,     &W,      &feats, &alpha, &s, &sh, &w, &gamma,
                  &gamma0, &acc, &eacc, &T,     &B, &K, &F};
  return static_cast<int>(launch(w != nullptr ? 2 : 1, S, T, B, K, F, device, stream, args));
}

// What the instance (which, S, F) of the launchers above takes on `device`:
// out[0] registers a thread, out[1] static and out[2] dynamic shared bytes a
// block, out[3] local (spilled) bytes a thread, out[4] resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[5] the device's SMs.
// which = 0 forward, 1 backward, 2 gated backward.
int fused_fb_kernel_info(int which, int S, int F, int device, int* out) {
  int smem = 0;
  const void* fn = kernel_of(which, S, F, &smem);
  if (fn == nullptr || F < 1 || F > FMAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  int blocks = 0, sms = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, NT, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = smem;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = blocks;
  out[5] = sms;
  return 0;
}

}  // extern "C"
