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
//     kept-mask w (T, B) and the pair gate pg (T, B), pg_t = w_{t-1} w_t,
//     pg_0 = 0; ungated, w = pg = 1. The gates touch the statistics only:
//     the beta chain runs on the ungated d, buffer steps drive the chain like
//     kept ones, and the gamma written out is the ungated one.
//     ll_t is recomputed by the same device function as in the forward
//     (explicit fmaf chain, same order) and shifted by the forward's own sh_t,
//     so lik_t is bit-identical and gamma = a * b' holds up to rounding.
//     Every per-sequence sum is floored at SUM_FLOOR (pallas_fb.py:82).
//     beta, xi and the (T, B, K) likelihood array never reach device memory.
//
// Layout: one block per sequence, one thread per state (KMAX threads, the
// ones with k >= K idle but in every barrier), the whole T loop inside the
// block. A~ (row-major in the forward, transposed in the backward so that
// thread i reads row i without bank conflicts) and W sit in shared memory.
// Arrays are time-major as the JAX wrapper takes them: feats (T, B, F),
// alpha and gamma (T, B, K), w and pg (T, B); s and sh are (B, T); gamma0
// (B, K); acc (K, K); eacc (K, F).
//
// What bounds it on this card: the T-step recursion is a chain of dependent
// K-wide matvecs with two block reductions per step, so a block is bound by
// the latency of that chain (barriers, shared-memory round trips), not by
// bytes or FLOPs: per (t, b) the pair of kernels moves about 4 (2F + 2K)
// bytes and does about 2K (2F + 3K) flops, both far below what the card
// streams in the time the chain takes. The design keeps many independent chains
// in flight instead: one block per sequence, about six resident blocks per
// SM, each step's feature row prefetched into a register one step ahead,
// one barrier per backward step (double-buffered d, a and partial sums,
// triple-buffered features), and the backward's two accumulators in
// registers (column k of acc, row k of eacc: K + F floats per thread), added
// across blocks with one atomicAdd per entry at the end. Summation order of
// those atomics varies from run to run.

#include "fb_common.cuh"

namespace {

using fbc::FMAX;
using fbc::KMAX;
using fbc::ll_dot;
using fbc::load_W;
using fbc::NT;
using fbc::NWARP;
using fbc::SUM_FLOOR;
using fbc::warp_max;
using fbc::warp_sum;

__global__ void __launch_bounds__(NT)
fused_fwd_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                 const float* __restrict__ W, const float* __restrict__ feats,
                 float* __restrict__ alpha, float* __restrict__ s_out,
                 float* __restrict__ sh_out, int T, int B, int K, int F) {
  __shared__ float A_s[KMAX * KMAX];  // A~[i][k] at i * KMAX + k
  __shared__ float W_s[FMAX * KMAX];
  __shared__ float a_s[KMAX];         // a_{t-1}
  __shared__ float f_s[FMAX];         // f_t
  __shared__ float red_max[NWARP];
  __shared__ float red_sum[NWARP];

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  fbc::load_A(A, A_s, K, false);
  load_W(W, W_s, K, F);
  const size_t step_f = (size_t)B * F;  // feats stride of one time step
  const size_t step_k = (size_t)B * K;  // alpha stride of one time step
  const float* fb = feats + (size_t)b * F;
  float* ab = alpha + (size_t)b * K;
  if (k < F) f_s[k] = fb[k];
  a_s[k] = 0.f;
  const float pik = active ? pi[k] : 0.f;
  __syncthreads();

  float inv = 1.f;  // 1 / s_{t-1}
  for (int t = 0; t < T; ++t) {
    float f_next = 0.f;
    if (t + 1 < T && k < F) f_next = fb[(size_t)(t + 1) * step_f + k];

    const float ll = ll_dot(f_s, W_s, k, F);
    float u = 0.f;
    if (t > 0) {
      for (int i = 0; i < K; ++i) u = fmaf(a_s[i], A_s[i * KMAX + k], u);
    }
    const float wm = warp_max(active ? ll : -INFINITY);
    if (lane == 0) red_max[warp] = wm;
    __syncthreads();  // a_s and f_s are read; red_max is complete

    float m = red_max[0];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) m = fmaxf(m, red_max[w]);
    const float lik = expf(ll - m);
    const float a = active ? (t == 0 ? pik * lik : u * (lik * inv)) : 0.f;
    a_s[k] = a;
    if (k < F) f_s[k] = f_next;
    if (active) ab[(size_t)t * step_k + k] = a;
    const float ws = warp_sum(a);
    if (lane == 0) red_sum[warp] = ws;
    __syncthreads();  // a_s, f_s and red_sum are complete

    float s = red_sum[0];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) s += red_sum[w];
    inv = 1.f / fmaxf(s, SUM_FLOOR);
    if (k == 0) {
      s_out[(size_t)b * T + t] = s;
      sh_out[(size_t)b * T + t] = m;
    }
  }
}

// GATED is a template parameter, so that the ungated instance carries no
// trace of the gates: no loads, no multiplies, no extra live registers.
template <bool GATED>
__global__ void __launch_bounds__(NT)
fused_bwd_kernel(const float* __restrict__ A, const float* __restrict__ W,
                 const float* __restrict__ feats, const float* __restrict__ alpha,
                 const float* __restrict__ s_in, const float* __restrict__ sh_in,
                 const float* __restrict__ w_in, const float* __restrict__ pg_in,
                 float* __restrict__ gamma, float* __restrict__ gamma0,
                 float* __restrict__ acc_out, float* __restrict__ eacc_out, int T,
                 int B, int K, int F) {
  __shared__ float At_s[KMAX * KMAX];  // A~[i][j] at j * KMAX + i
  __shared__ float W_s[FMAX * KMAX];
  __shared__ float f_s[3][FMAX];       // f_t in slot t % 3
  __shared__ float d_s[2][KMAX];       // d_t in slot t & 1
  __shared__ float a_s[2][KMAX];       // a_{t-1} in slot t & 1
  __shared__ float red[2][NWARP];

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  fbc::load_A(A, At_s, K, true);
  load_W(W, W_s, K, F);

  float acc[KMAX];   // column k of sum_t outer(a_{t-1}, d_t n_t pg_t)
  float eacc[FMAX];  // row k of sum_t outer(w_t gamma_t, f_t)
#pragma unroll
  for (int i = 0; i < KMAX; ++i) acc[i] = 0.f;
#pragma unroll
  for (int f = 0; f < FMAX; ++f) eacc[f] = 0.f;

  const size_t step_f = (size_t)B * F;
  const size_t step_k = (size_t)B * K;
  const float* fb = feats + (size_t)b * F;
  const float* ab = alpha + (size_t)b * K;
  const float* sb = s_in + (size_t)b * T;
  const float* shb = sh_in + (size_t)b * T;

  if (k < F) f_s[(T - 1) % 3][k] = fb[(size_t)(T - 1) * step_f + k];
  float a_cur = active ? ab[(size_t)(T - 1) * step_k + k] : 0.f;       // a_t
  float a_prev = (T >= 2 && active) ? ab[(size_t)(T - 2) * step_k + k] : 0.f;
  float s_prev = T >= 2 ? sb[T - 2] : 1.f;                            // s_{t-1}
  float sh_cur = shb[T - 1];                                          // sh_t
  float beta = 1.f / fmaxf(sb[T - 1], SUM_FLOOR);                     // b'_t
  // kept-mask w_t and pair gate pg_t of this sequence (1 when ungated)
  float w_cur = GATED ? w_in[(size_t)(T - 1) * B + b] : 1.f;
  float pg_cur = GATED ? pg_in[(size_t)(T - 1) * B + b] : 1.f;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const int p = t & 1;
    const float* f_t = f_s[t % 3];

    // operands of step t-1, loaded now so their latency hides behind step t
    float f_n = 0.f, a_n = 0.f, s_n = 1.f, sh_n = 0.f, w_n = 1.f, pg_n = 1.f;
    if (t >= 1) {
      if (k < F) f_n = fb[(size_t)(t - 1) * step_f + k];
      sh_n = shb[t - 1];
      if (GATED) {
        w_n = w_in[(size_t)(t - 1) * B + b];
        pg_n = pg_in[(size_t)(t - 1) * B + b];
      }
    }
    if (t >= 2) {
      if (active) a_n = ab[(size_t)(t - 2) * step_k + k];
      s_n = sb[t - 2];
    }

    const float ll = ll_dot(f_t, W_s, k, F);
    const float lik = active ? expf(ll - sh_cur) : 0.f;
    const float graw = a_cur * beta;
    float d = 0.f;
    if (t >= 1) d = (lik * (1.f / fmaxf(s_prev, SUM_FLOOR))) * beta;
    d_s[p][k] = d;
    a_s[p][k] = a_prev;
    if (t >= 1 && k < F) f_s[(t - 1) % 3][k] = f_n;
    const float ws = warp_sum(graw);
    if (lane == 0) red[p][warp] = ws;
    __syncthreads();  // d_s[p], a_s[p], red[p] and f_{t-1} are complete

    float g = red[p][0];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) g += red[p][w];
    const float n = 1.f / fmaxf(g, SUM_FLOOR);
    const float gam = graw * n;
    const float gam_w = GATED ? gam * w_cur : gam;  // the statistics' gamma: kept steps
    if (active) {
      if (gamma != nullptr) gamma[((size_t)t * B + b) * K + k] = gam;
      if (t == 0) gamma0[(size_t)b * K + k] = gam_w;
    }
#pragma unroll
    for (int f = 0; f < FMAX; ++f)
      if (f < F) eacc[f] = fmaf(gam_w, f_t[f], eacc[f]);
    if (t >= 1) {
      const float dn = GATED ? (d * n) * pg_cur : d * n;  // stats side; the chain keeps d
#pragma unroll
      for (int i = 0; i < KMAX; ++i)
        if (i < K) acc[i] = fmaf(a_s[p][i], dn, acc[i]);
      float bn = 0.f;
      for (int j = 0; j < K; ++j) bn = fmaf(d_s[p][j], At_s[j * KMAX + k], bn);
      beta = bn;
    }
    a_cur = a_prev;
    a_prev = a_n;
    s_prev = s_n;
    sh_cur = sh_n;
    w_cur = w_n;
    pg_cur = pg_n;
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < K) atomicAdd(&acc_out[i * K + k], acc[i]);
#pragma unroll
    for (int f = 0; f < FMAX; ++f)
      if (f < F) atomicAdd(&eacc_out[k * F + f], eacc[f]);
  }
}

bool bad_shape(int T, int B, int K, int F) {
  return T < 1 || B < 1 || K < 1 || K > KMAX || F < 1 || F > FMAX;
}

}  // namespace

extern "C" {

int fused_fb_kmax() { return KMAX; }
int fused_fb_fmax() { return FMAX; }

const char* fused_fb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launcher returns cudaGetLastError() right after the launch (0 = ok).
// Pointers are device pointers of contiguous float32 tensors; the kernel
// runs on `stream` and does not synchronise.
int fused_fb_forward(const float* pi, const float* A, const float* W,
                     const float* feats, float* alpha, float* s, float* sh,
                     int T, int B, int K, int F, int device, void* stream) {
  if (bad_shape(T, B, K, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  fused_fwd_kernel<<<B, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      pi, A, W, feats, alpha, s, sh, T, B, K, F);
  return static_cast<int>(cudaGetLastError());
}

// w and pg are null for the ungated launch, else the (T, B) kept-mask and
// pair gate; one without the other is refused.
int fused_fb_backward(const float* A, const float* W, const float* feats,
                      const float* alpha, const float* s, const float* sh,
                      const float* w, const float* pg, float* gamma, float* gamma0,
                      float* acc, float* eacc, int T, int B, int K, int F,
                      int device, void* stream) {
  if (bad_shape(T, B, K, F)) return static_cast<int>(cudaErrorInvalidValue);
  if ((w == nullptr) != (pg == nullptr)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (w != nullptr)
    fused_bwd_kernel<true><<<B, NT, 0, st>>>(A, W, feats, alpha, s, sh, w, pg, gamma,
                                              gamma0, acc, eacc, T, B, K, F);
  else
    fused_bwd_kernel<false><<<B, NT, 0, st>>>(A, W, feats, alpha, s, sh, w, pg, gamma,
                                               gamma0, acc, eacc, T, B, K, F);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
