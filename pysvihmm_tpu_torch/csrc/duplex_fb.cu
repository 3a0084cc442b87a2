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
// ll_t = f_t . W (fbc::ll_dot, the fused kernels' fmaf chain):
//   chain, forward, t = 0 .. T-1 (the fused forward's recursion):
//                         a_0 = pi~ * lik_0
//                         a_t = (a_{t-1} @ A~) * (lik_t / s_{t-1})
//                         s_t = sum_k a_t,  sh_t = max_k ll_t
//   chain, backward, t = T-1 .. 1, raw beta (normalisation deferred):
//                         b_{T-1} = 1
//                         d_t = (lik_t / sum_k b_t) * b_t
//                         b_{t-1} = A~ d_t
//     The two recursions are independent: one block per sequence, threads
//     0..63 walk forward and 64..127 walk backward, each half on its own
//     named barrier (bar.sync 1 / 2, 64 threads), so neither waits on the
//     other and the scheduler fills one chain's stalls with the other's work
//     (the TPU got this by interleaving both steps in one loop). Writes raw
//     a_t, s_t, sh_t and raw b_t.
//   combine, chain-free, for every t:
//                         g_t = a_t * b_t,  ginv_t = 1 / sum_k g_t,  gamma_t = g_t ginv_t
//                         acc  += outer(a_{t-1}, d_t ginv_{t-1} pg_t)   (t >= 1;
//                                 the wrapper forms A~ * acc)
//                         eacc += outer(w_t gamma_t, f_t)
//                         gamma0 = w_0 gamma_0
//     with d_t as in the chain. The xi normaliser of the pair (t-1, t) is
//     sum(a_{t-1} * A~ d_t) = sum(a_{t-1} * b_{t-1}) = 1 / ginv_{t-1}, so no
//     scale array crosses the kernels (pallas_duplex.py:19-29). It holds
//     only if d_t here is the d_t that built b_{t-1}: ll_t comes from the
//     same ll_dot, the shift is the forward's sh_t (the same max of the same
//     numbers), and sum_k b_t is reduced in the same order as in the chain.
//     Gated mode (SVI windows) takes the kept-mask w (T, B) and forms the
//     pair gate pg_t = w_{t-1} w_t (pg_0 = 0) itself; ungated, w = pg = 1.
//     The gates touch the statistics only: gamma written out is ungated.
//     Every per-sequence sum is floored at SUM_FLOOR (pallas_fb.py:82).
//
// Layout and what bounds it on this card. The chain kernel is two dependent
// K-wide matvecs per step, one per half, each with block reductions: bound by
// the latency of the chain, like the fused forward, and the second chain
// rides in the first one's stalls. A~ sits in shared memory once with row
// stride KMAX + 1, so the forward's column reads and the backward's row reads
// are both free of bank conflicts; with W that is 33 KB, under the 48 KB of
// static shared memory. The combine has no chain: a grid of (sequence, chunk
// of time steps), one thread per state, one barrier a step (double-buffered
// alpha_{t-1} and partial sums, triple-buffered features), the pair at the
// chunk's first step read from memory (a_{t-1}, b_{t-1}) instead of carried,
// and acc (column k) and eacc (row k) in registers, added across blocks with
// one atomicAdd per entry at the end: their summation order varies from run
// to run. Chunks are sized so that the grid holds about 2048 blocks, at least
// 16 steps each. Per (t, b) the pair moves about 4 (2F + 5K) bytes and does
// about 2K (2F + 3K) flops: far below what the card streams in the time the
// chain takes.

#include "fb_common.cuh"

namespace {

using fbc::FMAX;
using fbc::KMAX;
using fbc::ll_dot;
using fbc::NT;
using fbc::NWARP;
using fbc::SUM_FLOOR;
using fbc::warp_max;
using fbc::warp_sum;

constexpr int HALF = KMAX;          // threads of one chain
constexpr int CHAIN_NT = 2 * HALF;  // the chain kernel's block
constexpr int AST = KMAX + 1;       // row stride of A~ in the chain kernel's shared memory

// A barrier of one half of the chain kernel's block (64 threads).
__device__ __forceinline__ void half_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(HALF) : "memory");
}

// The backward message d_t, the same expression in both kernels.
__device__ __forceinline__ float pair_d(float lik, float b, float bsum) {
  return (lik * (1.f / fmaxf(bsum, SUM_FLOOR))) * b;
}

__global__ void __launch_bounds__(CHAIN_NT)
duplex_chain_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                    const float* __restrict__ W, const float* __restrict__ feats,
                    float* __restrict__ alpha, float* __restrict__ s_out,
                    float* __restrict__ sh_out, float* __restrict__ beta, int T, int B,
                    int K, int F) {
  __shared__ float A_s[KMAX * AST];   // A~[i][j] at i * AST + j
  __shared__ float W_s[FMAX * KMAX];
  __shared__ float v_s[2][KMAX];      // per half: a_{t-1} (forward) or d_t (backward)
  __shared__ float f_s[2][FMAX];      // per half: this step's feature row
  __shared__ float red_max[2][NWARP];
  __shared__ float red_sum[2][NWARP];

  const int b = blockIdx.x;
  const int h = threadIdx.x / HALF;  // 0: forward, 1: backward
  const int k = threadIdx.x % HALF;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  fbc::load_A(A, A_s, K, false, AST, CHAIN_NT);
  fbc::load_W(W, W_s, K, F, CHAIN_NT);
  const size_t step_f = (size_t)B * F;  // feats stride of one time step
  const size_t step_k = (size_t)B * K;  // alpha / beta stride of one time step
  const float* fb = feats + (size_t)b * F;
  float* v = v_s[h];
  float* f = f_s[h];
  float* rmax = red_max[h];
  float* rsum = red_sum[h];
  if (k < F) f[k] = fb[(size_t)(h == 0 ? 0 : T - 1) * step_f + k];
  v[k] = 0.f;
  __syncthreads();  // the only barrier of the whole block

  if (h == 0) {
    // forward: fused_fwd_kernel's loop (fused_fb.cu) on this half's barrier
    float* ab = alpha + (size_t)b * K;
    const float pik = active ? pi[k] : 0.f;
    float inv = 1.f;  // 1 / s_{t-1}
    for (int t = 0; t < T; ++t) {
      float f_next = 0.f;
      if (t + 1 < T && k < F) f_next = fb[(size_t)(t + 1) * step_f + k];

      const float ll = ll_dot(f, W_s, k, F);
      float u = 0.f;
      if (t > 0) {
        for (int i = 0; i < K; ++i) u = fmaf(v[i], A_s[i * AST + k], u);
      }
      const float wm = warp_max(active ? ll : -INFINITY);
      if (lane == 0) rmax[warp] = wm;
      half_sync(1);  // v and f are read; rmax is complete

      float m = rmax[0];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) m = fmaxf(m, rmax[w]);
      const float lik = expf(ll - m);
      const float a = active ? (t == 0 ? pik * lik : u * (lik * inv)) : 0.f;
      v[k] = a;
      if (k < F) f[k] = f_next;
      if (active) ab[(size_t)t * step_k + k] = a;
      const float ws = warp_sum(a);
      if (lane == 0) rsum[warp] = ws;
      half_sync(1);  // v, f and rsum are complete

      float s = rsum[0];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) s += rsum[w];
      inv = 1.f / fmaxf(s, SUM_FLOOR);
      if (k == 0) {
        s_out[(size_t)b * T + t] = s;
        sh_out[(size_t)b * T + t] = m;
      }
    }
  } else {
    // backward: raw b_t, the per-sequence sum folded into the next d
    float* bb = beta + (size_t)b * K;
    float bt = active ? 1.f : 0.f;  // b_t
    if (active) bb[(size_t)(T - 1) * step_k + k] = bt;
    for (int t = T - 1; t >= 1; --t) {
      float f_next = 0.f;
      if (k < F) f_next = fb[(size_t)(t - 1) * step_f + k];

      const float ll = ll_dot(f, W_s, k, F);
      const float wm = warp_max(active ? ll : -INFINITY);
      const float ws = warp_sum(bt);
      if (lane == 0) {
        rmax[warp] = wm;
        rsum[warp] = ws;
      }
      half_sync(2);  // f is read; rmax and rsum are complete

      float m = rmax[0], bs = rsum[0];
#pragma unroll
      for (int w = 1; w < NWARP; ++w) {
        m = fmaxf(m, rmax[w]);
        bs += rsum[w];
      }
      v[k] = active ? pair_d(expf(ll - m), bt, bs) : 0.f;
      if (k < F) f[k] = f_next;
      half_sync(2);  // v (d_t) and f are complete

      float bn = 0.f;
      for (int j = 0; j < K; ++j) bn = fmaf(A_s[k * AST + j], v[j], bn);
      bt = active ? bn : 0.f;
      if (active) bb[(size_t)(t - 1) * step_k + k] = bt;
    }
  }
}

// GATED is a template parameter, as in fused_bwd_kernel: the ungated instance
// carries no trace of the gates.
template <bool GATED>
__global__ void __launch_bounds__(NT)
duplex_combine_kernel(const float* __restrict__ W, const float* __restrict__ feats,
                      const float* __restrict__ alpha, const float* __restrict__ beta,
                      const float* __restrict__ sh_in, const float* __restrict__ w_in,
                      float* __restrict__ gamma, float* __restrict__ gamma0,
                      float* __restrict__ acc_out, float* __restrict__ eacc_out, int T,
                      int B, int K, int F, int chunk) {
  __shared__ float W_s[FMAX * KMAX];
  __shared__ float f_s[3][FMAX];       // f_t in slot t % 3
  __shared__ float a_s[2][KMAX];       // a_{t-1} in slot t & 1
  __shared__ float red[2][2][NWARP];   // [t & 1][sum of g_t, sum of b_t][warp]
  __shared__ float red0[NWARP];        // sum of g at the chunk's first t - 1

  const int b = blockIdx.x;
  const int t_begin = blockIdx.y * chunk;
  const int t_end = min(T, t_begin + chunk);
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  fbc::load_W(W, W_s, K, F);

  float acc[KMAX];   // column k of sum_t outer(a_{t-1}, d_t ginv_{t-1} pg_t)
  float eacc[FMAX];  // row k of sum_t outer(w_t gamma_t, f_t)
#pragma unroll
  for (int i = 0; i < KMAX; ++i) acc[i] = 0.f;
#pragma unroll
  for (int f = 0; f < FMAX; ++f) eacc[f] = 0.f;

  const size_t step_f = (size_t)B * F;
  const size_t step_k = (size_t)B * K;
  const float* fb = feats + (size_t)b * F;
  const float* ab = alpha + (size_t)b * K;
  const float* bb = beta + (size_t)b * K;
  const float* shb = sh_in + (size_t)b * T;

  // The pair (t_begin - 1, t_begin) is this block's: a_{t-1}, 1 / sum(g_{t-1})
  // and w_{t-1} are read and recomputed here, nothing is carried across blocks.
  float a_prev = 0.f, ginv_prev = 0.f, w_prev = 0.f;
  if (t_begin >= 1) {
    const size_t o = (size_t)(t_begin - 1) * step_k + k;
    a_prev = active ? ab[o] : 0.f;
    const float ws = warp_sum(a_prev * (active ? bb[o] : 0.f));
    if (lane == 0) red0[warp] = ws;
    if (GATED) w_prev = w_in[(size_t)(t_begin - 1) * B + b];
  }
  if (k < F) f_s[t_begin % 3][k] = fb[(size_t)t_begin * step_f + k];
  __syncthreads();  // red0 and f_{t_begin} are complete
  if (t_begin >= 1) {
    float g = red0[0];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) g += red0[w];
    ginv_prev = 1.f / fmaxf(g, SUM_FLOOR);
  }

  float a_cur = active ? ab[(size_t)t_begin * step_k + k] : 0.f;  // a_t
  float b_cur = active ? bb[(size_t)t_begin * step_k + k] : 0.f;  // b_t
  float sh_cur = shb[t_begin];
  float w_cur = GATED ? w_in[(size_t)t_begin * B + b] : 1.f;

  for (int t = t_begin; t < t_end; ++t) {
    const int p = t & 1;
    const float* f_t = f_s[t % 3];

    // operands of step t+1, loaded now so their latency hides behind step t
    float f_n = 0.f, a_n = 0.f, b_n = 0.f, sh_n = 0.f, w_n = 1.f;
    if (t + 1 < t_end) {
      if (k < F) f_n = fb[(size_t)(t + 1) * step_f + k];
      if (active) {
        a_n = ab[(size_t)(t + 1) * step_k + k];
        b_n = bb[(size_t)(t + 1) * step_k + k];
      }
      sh_n = shb[t + 1];
      if (GATED) w_n = w_in[(size_t)(t + 1) * B + b];
    }

    const float ll = ll_dot(f_t, W_s, k, F);
    const float lik = active ? expf(ll - sh_cur) : 0.f;
    const float graw = a_cur * b_cur;
    a_s[p][k] = a_prev;
    if (t + 1 < t_end && k < F) f_s[(t + 1) % 3][k] = f_n;
    const float wg = warp_sum(graw);
    const float wb = warp_sum(b_cur);
    if (lane == 0) {
      red[p][0][warp] = wg;
      red[p][1][warp] = wb;
    }
    __syncthreads();  // a_s[p], red[p] and f_{t+1} are complete

    float gs = red[p][0][0], bs = red[p][1][0];
#pragma unroll
    for (int w = 1; w < NWARP; ++w) {
      gs += red[p][0][w];
      bs += red[p][1][w];
    }
    const float ginv = 1.f / fmaxf(gs, SUM_FLOOR);
    const float gam = graw * ginv;
    const float gam_w = GATED ? gam * w_cur : gam;  // the statistics' gamma: kept steps
    if (active) {
      if (gamma != nullptr) gamma[((size_t)t * B + b) * K + k] = gam;
      if (t == 0) gamma0[(size_t)b * K + k] = gam_w;
    }
#pragma unroll
    for (int f = 0; f < FMAX; ++f)
      if (f < F) eacc[f] = fmaf(gam_w, f_t[f], eacc[f]);
    if (t >= 1) {
      const float d = active ? pair_d(lik, b_cur, bs) : 0.f;
      const float dn = GATED ? (d * ginv_prev) * (w_prev * w_cur) : d * ginv_prev;
#pragma unroll
      for (int i = 0; i < KMAX; ++i)
        if (i < K) acc[i] = fmaf(a_s[p][i], dn, acc[i]);
    }
    a_prev = a_cur;
    ginv_prev = ginv;
    w_prev = w_cur;
    a_cur = a_n;
    b_cur = b_n;
    sh_cur = sh_n;
    w_cur = w_n;
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

int duplex_fb_kmax() { return KMAX; }
int duplex_fb_fmax() { return FMAX; }

const char* duplex_fb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launcher returns cudaGetLastError() right after the launch (0 = ok).
// Pointers are device pointers of contiguous float32 tensors; the kernel
// runs on `stream` and does not synchronise.
int duplex_fb_chain(const float* pi, const float* A, const float* W, const float* feats,
                    float* alpha, float* s, float* sh, float* beta, int T, int B, int K,
                    int F, int device, void* stream) {
  if (bad_shape(T, B, K, F)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  duplex_chain_kernel<<<B, CHAIN_NT, 0, static_cast<cudaStream_t>(stream)>>>(
      pi, A, W, feats, alpha, s, sh, beta, T, B, K, F);
  return static_cast<int>(cudaGetLastError());
}

// w is null for the ungated launch, else the (T, B) kept-mask. A block takes
// `chunk` time steps: about 2048 blocks in all, at least 16 steps each (so a
// short T gives chunks of 16 and a last one that is cut short).
int duplex_fb_combine(const float* W, const float* feats, const float* alpha,
                      const float* beta, const float* sh, const float* w, float* gamma,
                      float* gamma0, float* acc, float* eacc, int T, int B, int K, int F,
                      int device, void* stream) {
  if (bad_shape(T, B, K, F)) return static_cast<int>(cudaErrorInvalidValue);
  const int want = (2048 + B - 1) / B;  // chunks per sequence
  const int chunk = max(16, (T + want - 1) / want);
  const int nchunks = (T + chunk - 1) / chunk;
  if (nchunks > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B, nchunks);
  if (w != nullptr)
    duplex_combine_kernel<true><<<grid, NT, 0, st>>>(W, feats, alpha, beta, sh, w, gamma,
                                                     gamma0, acc, eacc, T, B, K, F, chunk);
  else
    duplex_combine_kernel<false><<<grid, NT, 0, st>>>(W, feats, alpha, beta, sh, w, gamma,
                                                      gamma0, acc, eacc, T, B, K, F, chunk);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
