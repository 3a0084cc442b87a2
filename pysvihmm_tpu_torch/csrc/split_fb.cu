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
//     The optional kept-mask w (T, B) gives the pair gate pg_t = w_{t-1} w_t
//     (pallas_fb.py:1243-1256), which the kernel forms; it touches acc only:
//     the beta chain runs on the ungated d and gamma is written ungated (the
//     wrapper gates init_stats with w_0). lik_t is
//     re-derived from the stored ll_t and the forward's own sh_t, so it is
//     bit-identical to the forward's. Every per-sequence sum is floored at
//     SUM_FLOOR (pallas_fb.py:82). beta and xi never reach device memory.
//
// Layout (fb_seqs.cuh up to K = 64, fb_wide.cuh above): a block carries S
// sequences, one thread per state, the whole T loop inside the block, and
// thread k runs state k of all S sequences as S interleaved chains, so that
// every word of A~ it reads feeds S FMAs. Arrays are time-major: ll, alpha
// and gamma (T, B, K), w (T, B); s and sh are (B, T); acc (K, K).
//   K <= 64: split_fwd_kernel<S> is fbseq::seq_forward, the fused forward's
//     function, reading ll_t instead of forming f_t . W (column k of A~ in
//     registers, a_{t-1} of the S sequences read as float4 broadcasts, one
//     barrier a step); split_bwd_kernel<S, GATED> is fbseq::seq_stats_backward,
//     the fused backward's function without W and eacc (row k of A~ mostly
//     in registers, d_t and a_{t-1} of the S sequences as float4
//     broadcasts, one barrier a step). Both read their rows (ll, alpha and
//     the kept-mask) several steps ahead through a ring in shared memory that
//     each thread fills for itself with cp.async: a step here is shorter than
//     device memory's latency. Each sequence keeps its own column k of acc in
//     registers (S K of them) and writes it to its row of partials, which a
//     second kernel adds in sequence order (fb_stats.cuh): acc's bits do not
//     depend on S, and every output is the one-sequence-a-block kernel's bit
//     for bit (the matvec and sums in the same order, over zero padding). So
//     S is built only where S K accumulators fit a thread's registers: S = 2
//     for the backward, 2 and 4 for the forward (SEQS in split_fb.py).
//   K = 65..256: split_fwd_wide_kernel<KP, S> and split_bwd_wide_kernel<KP, S,
//     GATED> (KP = 128 or 256, S = 1, 2, 4, 8) run fbw::seqs_forward and
//     seqs_backward on read likelihoods: one copy of A~ a block (in shared
//     memory, its first 64 rows in registers at KP = 256), acc off the chain
//     as outer products summed in an order fixed by (T, B, K), so every
//     output is the same bits at every S.
//   K = 257..1024: split_fwd_xl_kernel<KP, S> and split_bwd_xl_kernel<KP, S,
//     GATED> (KP = 512 or 1024, S = 1, 2, 4, 8; split_fb_xl.cu, fb_xl.cuh)
//     run the same two chains with A~ read from device memory (L2) each
//     step, the backward from a transposed copy the launcher makes once a
//     call; acc as above. bf16 alpha has no XL instance.
// The launchers take S from the caller (the wrapper picks it by the one-wave
// rule of fused_fb.py from split_fb_kernel_info's occupancy) and refuse an S
// not built.
//
// bf16-stored alpha (pallas_fb.py:1213, `_alpha_store_dtype()` on the split
// forward's alpha): ABF, a template switch on every instance of both
// kernels, as the fused pair's. The forward stores alpha rounded to bf16
// while its chain carries float32, and s sums the rounded values
// (fbseq::seq_forward, fbw::seqs_forward); the backward reads those words
// back, its replay factors 1 / s from the same numbers. Up to K = 64 its
// ring of rows takes, for each alpha element, the aligned 32-bit word that
// holds it (cp.async moves 4 bytes at least) and widens its half where it is
// read; above, acc's outer sums get each window's alpha widened to float32
// (fbs::widen, as the fused backward's).
//
// What bounds it on this card: per (t, b) the forward moves 8K bytes (ll in,
// alpha out) for about 2K^2 flops, and the backward 12K bytes (ll and alpha
// in, gamma out) for about 4K^2 flops. At K=64, B=1024, T=1000 that is a
// least time of about 0.16 ms (bytes) forward and 0.25 ms (flops) backward,
// while each block walks a chain of T dependent steps, each a K-wide matvec
// and one or two block reductions: like the fused pair, the kernels are bound
// by that chain's latency and by the shared-memory loads each step issues
// (PERF.md: at K = 64 the backward issues about 90 of them a step and
// thread, 64 of them float4 broadcasts).

#include "fb_common.cuh"
#include "fb_seqs.cuh"
#include "fb_stats.cuh"
#include "fb_wide.cuh"
#include "fb_xl.cuh"

// The XL instances (split_fb_xl.cu): which = 0 forward, 1 backward, 2 gated
// backward, S = 1, 2, 4 or 8; null for an S not built.
const void* split_xl_instance(int which, int S, int K, int* smem);

namespace {

using fbc::KMAX;
using fbc::NT;

using fbseq::LL_FP;

template <int S, bool ABF>
__global__ void __launch_bounds__(NT)
split_fwd_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                 const float* __restrict__ ll, float* __restrict__ alpha,
                 __nv_bfloat16* __restrict__ alpha16, float* __restrict__ s_out,
                 float* __restrict__ sh_out, int T, int B, int K) {
  fbseq::seq_forward<S, LL_FP, false, fbc::FEATS_ARRAY, ABF>(
      pi, A, nullptr, ll, alpha, s_out, sh_out, T, B, K, 0, blockIdx.x, alpha16);
}

// GATED is a template parameter, as in fused_fb.cu: the ungated instance
// carries no trace of the gate. w is the kept-mask (T, B); the kernel forms
// the pair gate.
// ABF: alpha16 (bf16 alpha) in place of alpha, read through the ring.
template <int S, bool GATED, bool ABF>
__global__ void __launch_bounds__(NT)
split_bwd_kernel(const float* __restrict__ A, const float* __restrict__ ll,
                 const float* __restrict__ alpha, const __nv_bfloat16* __restrict__ alpha16,
                 const float* __restrict__ s_in, const float* __restrict__ sh_in,
                 const float* __restrict__ w_in, float* __restrict__ gamma,
                 float* __restrict__ part, int T, int B, int K) {
  extern __shared__ __align__(16) float smem[];
  fbseq::seq_stats_backward<S, LL_FP, false, GATED, fbc::FEATS_ARRAY, ABF>(
      A, nullptr, ll, alpha, s_in, sh_in, w_in, gamma, nullptr, part, T, B, K, 0, blockIdx.x,
      smem, alpha16);
}

template <int KP, int S, bool ABF>
__global__ void __launch_bounds__(KP)
split_fwd_wide_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                      const float* __restrict__ ll, float* __restrict__ alpha,
                      __nv_bfloat16* __restrict__ alpha16, float* __restrict__ s_out,
                      float* __restrict__ sh_out, int T, int B, int K) {
  extern __shared__ __align__(16) float smem[];
  fbw::seqs_forward<KP, S, false, fbc::FEATS_ARRAY, ABF>(pi, A, nullptr, ll, alpha, s_out,
                                                         sh_out, T, B, K, 0, blockIdx.x, smem,
                                                         alpha16);
}

template <int KP, int S, bool GATED, bool ABF>
__global__ void __launch_bounds__(KP)
split_bwd_wide_kernel(const float* __restrict__ A, const float* __restrict__ ll,
                      const float* __restrict__ alpha, const __nv_bfloat16* __restrict__ alpha16,
                      const float* __restrict__ s_in, const float* __restrict__ sh_in,
                      const float* __restrict__ w_in, float* __restrict__ gamma,
                      float* __restrict__ dn, float* __restrict__ carry, int T, int B, int K,
                      int t0, int t1) {
  extern __shared__ __align__(16) float smem[];
  fbw::seqs_backward<KP, S, false, GATED, fbc::FEATS_ARRAY, ABF>(
      A, nullptr, ll, alpha, s_in, sh_in, w_in, gamma, nullptr, dn, nullptr, carry, T, B, K, 0,
      t0, t1, blockIdx.x, smem, alpha16, nullptr);
}

// The instance of (which, S, K, ABF): which = 0 forward, 1 backward, 2 gated
// backward; its dynamic shared memory in *smem. Up to KMAX states S = 2 or 4
// (forward) and 2 (backward); above, S = 1, 2, 4 or 8 at KP = tier_of(K),
// and above KWIDE at KP = xl_tier_of(K) (no ABF). Null for an S not built.
template <bool ABF>
const void* narrow_of(int which, int S, int* smem) {
  *smem = which == 0 ? 0 : fbseq::stats_smem_bytes(S, LL_FP, false);
  if (which == 0) {
    if (S == 2) return reinterpret_cast<const void*>(split_fwd_kernel<2, ABF>);
    if (S == 4) return reinterpret_cast<const void*>(split_fwd_kernel<4, ABF>);
    return nullptr;
  }
  if (S != 2) return nullptr;
  return which == 1 ? reinterpret_cast<const void*>(split_bwd_kernel<2, false, ABF>)
                    : reinterpret_cast<const void*>(split_bwd_kernel<2, true, ABF>);
}

template <int KP, int S, bool ABF>
const void* wide_at(int which, int* smem) {
  *smem = fbw::chain_smem_bytes<KP, S>();
  if (which == 0) return reinterpret_cast<const void*>(split_fwd_wide_kernel<KP, S, ABF>);
  return which == 1 ? reinterpret_cast<const void*>(split_bwd_wide_kernel<KP, S, false, ABF>)
                    : reinterpret_cast<const void*>(split_bwd_wide_kernel<KP, S, true, ABF>);
}

template <int KP, bool ABF>
const void* wide_of(int which, int S, int* smem) {
  switch (S) {
    case 1: return wide_at<KP, 1, ABF>(which, smem);
    case 2: return wide_at<KP, 2, ABF>(which, smem);
    case 4: return wide_at<KP, 4, ABF>(which, smem);
    case 8: return wide_at<KP, 8, ABF>(which, smem);
    default: *smem = 0; return nullptr;
  }
}

template <bool ABF>
const void* instance_abf(int which, int S, int K, int* smem) {
  if (K <= KMAX) return narrow_of<ABF>(which, S, smem);
  return fbw::tier_of(K) == 128 ? wide_of<128, ABF>(which, S, smem)
                                : wide_of<256, ABF>(which, S, smem);
}

const void* instance(int which, int S, int K, bool abf, int* smem) {
  if (K > fbw::KWIDE) {
    if (abf) return *smem = 0, nullptr;
    return split_xl_instance(which, S, K, smem);
  }
  return abf ? instance_abf<true>(which, S, K, smem) : instance_abf<false>(which, S, K, smem);
}

// The kernel of (which, S, K, abf) on ceil(B / S) blocks of KMAX threads up
// to KMAX states (under 48 KB of shared memory), of KP threads above (512 or
// 1024 in the XL tiers); an S not built is refused.
cudaError_t launch(int which, int S, int B, int K, bool abf, cudaStream_t st, void** args) {
  int smem = 0;
  const void* fn = instance(which, S, K, abf, &smem);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const dim3 grid((B + S - 1) / S);
  if (K > KMAX) return fbw::launch_dyn(fn, grid, fbw::chain_tier(K), smem, st, args);
  const cudaError_t e = cudaLaunchKernel(fn, grid, dim3(NT), args, smem, st);
  return e != cudaSuccess ? e : cudaGetLastError();
}

bool bad_shape(int T, int B, int K) {
  return T < 1 || B < 1 || K < 1 || K > fbw::KXL;
}

// Floats of scratch the backward takes: K <= KMAX, a row of partials a
// sequence (whatever S); above, a window's dn, the carry, the outer sum's
// partials and (abf) the window's widened alpha (fbs::WideStats), and above
// KWIDE after them A~^T (K K floats), the XL chain's matrix.
long long scratch_floats(int T, int B, int K, bool abf) {
  if (K <= KMAX) return (long long)B * K * K;
  return fbs::WideStats::floats(T, B, K, 0, fbc::FEATS_ARRAY, abf) +
         (K > fbw::KWIDE ? (long long)K * K : 0);
}

}  // namespace

extern "C" {

// The largest K the launchers take (the XL instances').
int split_fb_kmax() { return fbw::KXL; }

// *out = the floats of scratch split_fb_backward takes at these shapes, for
// alpha's storage (abf: bf16).
int split_fb_scratch(int T, int B, int K, int abf, long long* out) {
  if (bad_shape(T, B, K)) return static_cast<int>(cudaErrorInvalidValue);
  *out = scratch_floats(T, B, K, abf != 0);
  return 0;
}

const char* split_fb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launcher returns the launch's CUDA error right after it (0 = ok).
// Pointers are device pointers of contiguous float32 tensors; the kernels
// run on `stream` and do not synchronise. S is the sequences a block: 2 or 4
// (forward) and 2 (backward) up to K = 64, 1, 2, 4 or 8 above; any other is
// refused. alpha is stored float32 into alpha or, where alpha16 is not null
// (alpha then null), as bf16 into alpha16 (up to K = 256 only: above, bf16
// alpha is refused).
int split_fb_forward(const float* pi, const float* A, const float* ll, float* alpha,
                     void* alpha16, float* s, float* sh, int T, int B, int K, int S, int device,
                     void* stream) {
  if (bad_shape(T, B, K) || (alpha == nullptr) == (alpha16 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  __nv_bfloat16* a16 = static_cast<__nv_bfloat16*>(alpha16);
  void* args[] = {&pi, &A, &ll, &alpha, &a16, &s, &sh, &T, &B, &K};
  return static_cast<int>(
      launch(0, S, B, K, a16 != nullptr, static_cast<cudaStream_t>(stream), args));
}

// Launches of the outer sums' kernel (fbs::outer_sum) by this library's
// large-K launcher since the count was last cleared; clears it when `clear`.
int split_fb_outer_launches(int clear) {
  return fbs::outer_launches(clear != 0);
}

// w is null for the ungated launch, else the (T, B) kept-mask; the kernel
// forms the pair gate from it. acc (K, K) is summed in a fixed order
// (fb_stats.cuh) that does not depend on S; scratch holds split_fb_scratch
// floats. Above K = 64 the backward runs a window of time steps a launch
// (fbs::WideStats), several launches for a long T. alpha and alpha16 as
// split_fb_forward's (alpha as stored there).
int split_fb_backward(const float* A, const float* ll, const float* alpha, const void* alpha16,
                      const float* s, const float* sh, const float* w, float* gamma,
                      float* acc, float* scratch, int T, int B, int K, int S, int device,
                      void* stream) {
  if (bad_shape(T, B, K) || (alpha == nullptr) == (alpha16 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int which = w != nullptr ? 2 : 1;
  const __nv_bfloat16* a16 = static_cast<const __nv_bfloat16*>(alpha16);
  const bool abf = a16 != nullptr;
  if (K <= KMAX) {
    void* args[] = {&A, &ll, &alpha, &a16, &s, &sh, &w, &gamma, &scratch, &T, &B, &K};
    e = launch(which, S, B, K, abf, st, args);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(fbs::sum_partials(scratch, B, K * K, acc, st));
  }
  int smem = 0;
  if (instance(which, S, K, abf, &smem) == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const fbs::WideStats ws(scratch, T, B, K, 0, fbc::FEATS_ARRAY, abf);
  float *dn = ws.dn, *carry = ws.carry;
  const float* M = A;  // the chain's matrix: A~, or above KWIDE its transposed copy
  if (K > fbw::KWIDE) {
    float* AT = scratch + fbs::WideStats::floats(T, B, K, 0, fbc::FEATS_ARRAY, abf);
    e = fbw::xl_transpose(A, AT, K, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    M = AT;
  }
  return static_cast<int>(ws.run(alpha, a16, nullptr, acc, st, [&](int t0, int t1) {
    void* args[] = {&M, &ll, &alpha, &a16, &s, &sh, &w, &gamma, &dn, &carry, &T, &B, &K, &t0,
                    &t1};
    return launch(which, S, B, K, abf, st, args);
  }));
}

// Launches of fbs::widen_kernel by this library's large-K backward (bf16
// alpha) since the count was last cleared; clears it when `clear`.
int split_fb_prep_launches(int which, int clear) {
  return fbs::prep_launches(which, clear != 0);
}

// What the instance (which, S, K) of the launchers above takes on `device`:
// out[0] registers a thread, out[1] static and out[2] dynamic shared bytes a
// block, out[3] local (spilled) bytes a thread, out[4] resident blocks an SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[5] the device's SMs,
// out[6] threads a block. which = 0 forward, 1 backward, 2 gated backward;
// K > 64 names the large-K instance of its KP (the XL one above 256); abf
// the bf16-alpha one (none above 256).
int split_fb_kernel_info(int which, int S, int K, int abf, int device, int* out) {
  if (bad_shape(1, 1, K) || which < 0 || which > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int smem = 0;
  const void* fn = instance(which, S, K, abf != 0, &smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = K > KMAX ? fbw::chain_tier(K) : NT;
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
