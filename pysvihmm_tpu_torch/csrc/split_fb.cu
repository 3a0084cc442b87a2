// Split forward and backward E-step kernels for NVIDIA Hopper (sm_90a): the
// forward-backward recursion over log-likelihoods already in device memory.
//
// Replaces the two Pallas TPU kernels of the split E-step:
//   split_fwd_kernel  <- pysvihmm_tpu/messages/pallas_fb.py:339 (_fwd_kernel, log_in)
//   split_bwd_kernel  <- pysvihmm_tpu/messages/pallas_fb.py:406 (_bwd_kernel)
// The host wrapper and the plain PyTorch twin of both kernels live in
// pysvihmm_tpu_torch/messages/split_fb.py.
//
// What is computed (the recursion of fused_fb.cu, with ll_t read instead of
// computed as f_t . W, and no emission statistics):
//   forward, per step t:  sh_t = max_k ll_t,  lik_t = exp(ll_t - sh_t)
//                         a_0 = pi~ * lik_0
//                         a_t = (a_{t-1} @ A~) * (lik_t / s_{t-1})
//                         s_t = sum_k a_t
//     The per-sequence renormalisation runs every step and is folded into
//     the next step's likelihood operand. Writes the raw a_t, s_t and sh_t;
//     log c_t = log s_t + sh_t.
//   backward, t = T-1 .. 0, with b'_{T-1} = 1 / s_{T-1}:
//                         g_t = a_t * b'_t,  n_t = 1 / sum_k g_t,  gamma_t = g_t n_t
//                         d_t = (exp(ll_t - sh_t) / s_{t-1}) * b'_t
//                         acc += outer(a_{t-1}, d_t n_t pg_t)   (wrapper forms A~ * acc)
//                         b'_{t-1} = d_t @ A~^T
//     The optional pair gate pg (T, B), pg_t = w_{t-1} w_t (pallas_fb.py:1243-
//     1256), touches acc only: the beta chain runs on the ungated d and gamma
//     is written ungated (the wrapper gates init_stats with w_0). lik_t is
//     re-derived from the stored ll_t and the forward's own sh_t, so it is
//     bit-identical to the forward's. Every per-sequence sum is floored at
//     SUM_FLOOR (pallas_fb.py:82). beta and xi never reach device memory.
//
// Layout: as fused_fb.cu, one block per sequence and one thread per state
// (K <= KMAX = 64), the whole T loop inside the block, A~ in shared memory
// (row-major forward, transposed backward). Arrays are time-major: ll, alpha
// and gamma (T, B, K), pg (T, B); s and sh are (B, T); acc (K, K).
//
// What bounds it on this card: per (t, b) the forward moves 8K bytes (ll in,
// alpha out) for about 2K^2 flops, and the backward 12K bytes (ll and alpha
// in, gamma out) for about 4K^2 flops. At K=64, B=1024, T=1000 that is a
// least time of about 0.16 ms (bytes) forward and 0.25 ms (flops) backward,
// while each block walks a chain of T dependent steps, each a K-wide matvec
// and one or two block reductions: like the fused pair, the kernels are bound
// by that chain's latency. The design hides what it can behind it: the next
// step's ll, alpha and scales are loaded one step ahead into registers, the
// backward needs one barrier per step (double-buffered d, a and partial
// sums), and acc stays in registers (column k of acc, K floats per thread)
// and is added across blocks with one atomicAdd per entry at the end, so its
// summation order varies from run to run.

#include "fb_common.cuh"

namespace {

using fbc::KMAX;
using fbc::NT;
using fbc::NWARP;
using fbc::SUM_FLOOR;
using fbc::warp_max;
using fbc::warp_sum;

__global__ void __launch_bounds__(NT)
split_fwd_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                 const float* __restrict__ ll, float* __restrict__ alpha,
                 float* __restrict__ s_out, float* __restrict__ sh_out, int T, int B,
                 int K) {
  __shared__ float A_s[KMAX * KMAX];  // A~[i][k] at i * KMAX + k
  __shared__ float a_s[KMAX];         // a_{t-1}
  __shared__ float red_max[NWARP];
  __shared__ float red_sum[NWARP];

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  fbc::load_A(A, A_s, K, false);
  const size_t step_k = (size_t)B * K;  // stride of one time step
  const float* lb = ll + (size_t)b * K;
  float* ab = alpha + (size_t)b * K;
  a_s[k] = 0.f;
  const float pik = active ? pi[k] : 0.f;
  float l_cur = active ? lb[k] : -INFINITY;  // ll_t
  __syncthreads();

  float inv = 1.f;  // 1 / s_{t-1}
  for (int t = 0; t < T; ++t) {
    float l_next = -INFINITY;
    if (t + 1 < T && active) l_next = lb[(size_t)(t + 1) * step_k + k];

    float u = 0.f;
    if (t > 0) {
      for (int i = 0; i < K; ++i) u = fmaf(a_s[i], A_s[i * KMAX + k], u);
    }
    const float wm = warp_max(l_cur);
    if (lane == 0) red_max[warp] = wm;
    __syncthreads();  // a_s is read; red_max is complete

    float m = red_max[0];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) m = fmaxf(m, red_max[w]);
    const float lik = active ? expf(l_cur - m) : 0.f;
    const float a = active ? (t == 0 ? pik * lik : u * (lik * inv)) : 0.f;
    a_s[k] = a;
    if (active) ab[(size_t)t * step_k + k] = a;
    const float ws = warp_sum(a);
    if (lane == 0) red_sum[warp] = ws;
    __syncthreads();  // a_s and red_sum are complete

    float s = red_sum[0];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) s += red_sum[w];
    inv = 1.f / fmaxf(s, SUM_FLOOR);
    if (k == 0) {
      s_out[(size_t)b * T + t] = s;
      sh_out[(size_t)b * T + t] = m;
    }
    l_cur = l_next;
  }
}

// GATED is a template parameter, as in fused_fb.cu: the ungated instance
// carries no trace of the gate.
template <bool GATED>
__global__ void __launch_bounds__(NT)
split_bwd_kernel(const float* __restrict__ A, const float* __restrict__ ll,
                 const float* __restrict__ alpha, const float* __restrict__ s_in,
                 const float* __restrict__ sh_in, const float* __restrict__ pg_in,
                 float* __restrict__ gamma, float* __restrict__ acc_out, int T, int B,
                 int K) {
  __shared__ float At_s[KMAX * KMAX];  // A~[i][j] at j * KMAX + i
  __shared__ float d_s[2][KMAX];       // d_t in slot t & 1
  __shared__ float a_s[2][KMAX];       // a_{t-1} in slot t & 1
  __shared__ float red[2][NWARP];

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  fbc::load_A(A, At_s, K, true);

  float acc[KMAX];  // column k of sum_t outer(a_{t-1}, d_t n_t pg_t)
#pragma unroll
  for (int i = 0; i < KMAX; ++i) acc[i] = 0.f;

  const size_t step_k = (size_t)B * K;
  const float* lb = ll + (size_t)b * K;
  const float* ab = alpha + (size_t)b * K;
  const float* sb = s_in + (size_t)b * T;
  const float* shb = sh_in + (size_t)b * T;

  float l_cur = active ? lb[(size_t)(T - 1) * step_k + k] : 0.f;       // ll_t
  float a_cur = active ? ab[(size_t)(T - 1) * step_k + k] : 0.f;       // a_t
  float a_prev = (T >= 2 && active) ? ab[(size_t)(T - 2) * step_k + k] : 0.f;
  float s_prev = T >= 2 ? sb[T - 2] : 1.f;                            // s_{t-1}
  float sh_cur = shb[T - 1];                                          // sh_t
  float pg_cur = GATED ? pg_in[(size_t)(T - 1) * B + b] : 1.f;        // pg_t
  float beta = 1.f / fmaxf(sb[T - 1], SUM_FLOOR);                     // b'_t
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const int p = t & 1;

    // operands of step t-1, loaded now so their latency hides behind step t
    float l_n = 0.f, a_n = 0.f, s_n = 1.f, sh_n = 0.f, pg_n = 1.f;
    if (t >= 1) {
      if (active) l_n = lb[(size_t)(t - 1) * step_k + k];
      sh_n = shb[t - 1];
      if (GATED) pg_n = pg_in[(size_t)(t - 1) * B + b];
    }
    if (t >= 2) {
      if (active) a_n = ab[(size_t)(t - 2) * step_k + k];
      s_n = sb[t - 2];
    }

    const float lik = active ? expf(l_cur - sh_cur) : 0.f;
    const float graw = a_cur * beta;
    float d = 0.f;
    if (t >= 1) d = (lik * (1.f / fmaxf(s_prev, SUM_FLOOR))) * beta;
    d_s[p][k] = d;
    a_s[p][k] = a_prev;
    const float ws = warp_sum(graw);
    if (lane == 0) red[p][warp] = ws;
    __syncthreads();  // d_s[p], a_s[p] and red[p] are complete

    float g = red[p][0];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) g += red[p][w];
    const float n = 1.f / fmaxf(g, SUM_FLOOR);
    if (active) gamma[((size_t)t * B + b) * K + k] = graw * n;
    if (t >= 1) {
      const float dn = GATED ? (d * n) * pg_cur : d * n;  // stats side; the chain keeps d
#pragma unroll
      for (int i = 0; i < KMAX; ++i)
        if (i < K) acc[i] = fmaf(a_s[p][i], dn, acc[i]);
      float bn = 0.f;
      for (int j = 0; j < K; ++j) bn = fmaf(d_s[p][j], At_s[j * KMAX + k], bn);
      beta = bn;
    }
    l_cur = l_n;
    a_cur = a_prev;
    a_prev = a_n;
    s_prev = s_n;
    sh_cur = sh_n;
    pg_cur = pg_n;
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < K) atomicAdd(&acc_out[i * K + k], acc[i]);
  }
}

bool bad_shape(int T, int B, int K) {
  return T < 1 || B < 1 || K < 1 || K > KMAX;
}

}  // namespace

extern "C" {

int split_fb_kmax() { return KMAX; }

const char* split_fb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launcher returns cudaGetLastError() right after the launch (0 = ok).
// Pointers are device pointers of contiguous float32 tensors; the kernel
// runs on `stream` and does not synchronise.
int split_fb_forward(const float* pi, const float* A, const float* ll, float* alpha,
                     float* s, float* sh, int T, int B, int K, int device,
                     void* stream) {
  if (bad_shape(T, B, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  split_fwd_kernel<<<B, NT, 0, static_cast<cudaStream_t>(stream)>>>(pi, A, ll, alpha,
                                                                    s, sh, T, B, K);
  return static_cast<int>(cudaGetLastError());
}

// pg is null for the ungated launch, else the (T, B) pair gate.
int split_fb_backward(const float* A, const float* ll, const float* alpha,
                      const float* s, const float* sh, const float* pg, float* gamma,
                      float* acc, int T, int B, int K, int device, void* stream) {
  if (bad_shape(T, B, K)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pg != nullptr)
    split_bwd_kernel<true><<<B, NT, 0, st>>>(A, ll, alpha, s, sh, pg, gamma, acc, T, B, K);
  else
    split_bwd_kernel<false><<<B, NT, 0, st>>>(A, ll, alpha, s, sh, pg, gamma, acc, T, B, K);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
