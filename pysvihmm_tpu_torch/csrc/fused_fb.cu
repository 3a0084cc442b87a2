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
//     beta, xi and (at F <= FMAX) the (T, B, K) likelihood array never reach
//     device memory.
//
// Numerics shared with duplex_fb.cu: ll_t is the fmaf chain over f = 0..F-1
// in order, the matvec the fmaf chain over i = 0..K-1 in order, s_t the warp
// butterfly (fbc::warp_sum) of each 32 states and then
// warp 0's sum plus warp 1's. The kernels run those chains to the padded K
// and F, over zero-padded A~, W and features: fmaf(0, 0, u) == u, so the
// padding changes no bit. The forward's body is fb_seqs.cuh's seq_forward,
// which the duplex chain runs too, so its alpha, s and sh equal this
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
//   forward (fbseq::seq_forward): thread k holds column k of A~ and of W
//     in registers, loaded once; a step reads only the broadcast a_{t-1}
//     and f_{t+1} of its S sequences from shared memory, as float4. One barrier a step: a_t, the
//     per-sequence partial sums and maxima are double-buffered, and ll of
//     the next step (its max included) is computed a step ahead in the same
//     loop as the matvec (step 0 is peeled off, so that both chains are live
//     in every iteration and interleave), so the matvec never waits for a
//     reduction of its own step.
//   backward (fbseq::seq_stats_backward, which the split backward runs on read
//     likelihoods): column k of acc and row k of eacc take K + F registers, so
//     A~ (row k) and W (column k) are read from shared memory, padded rows so
//     that the float4 reads are free of bank conflicts, and each word feeds S
//     FMAs. One barrier a step (double-buffered d, a and partial sums, triple-
//     buffered features); after it, one loop runs the beta chain, the next
//     step's ll chain and the acc and eacc updates side by side. Each block
//     writes its acc and eacc to a row of partials, which a second kernel adds
//     in block order (fb_stats.cuh): the same bits every call for one S, another
//     grouping for another S.
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
//
// Modes (pallas_estep_fused's): a built feature kind (KIND, fbc::FEATS_NIW
// or FEATS_NIG; pallas_fb.py:287 `_build_feats`) has both kernels read the
// raw (T, B, D) observations and build each step's feature rows where they
// are stored in shared memory (fbseq::ObsRows, fbw::feat_rows), each
// product one float32 multiply kept as it is, so the rows hold
// ell_features' bits and every output is the array mode's; above K = 64 the
// statistics' eacc operand is built a window at a time into the scratch
// (fbs::WideStats). alpha16 stores alpha as bf16 (pallas_fb.py:198
// `_alpha_store_dtype`): the chain carries float32, s sums the rounded
// values, and the backward reads them back, its replay factors 1 / s from
// those same numbers. sel, the backward's per-sequence time pick
// (pallas_fb.py:608 `sel_mode`), puts each sequence's ungated gamma at
// t = sel[b] where gamma0 goes, with no gamma written. KIND is a template
// parameter (every FP instance for each kind), and so is a second switch:
// each kernel has a default instance, which carries no trace of the two
// other modes, and a modes' instance (the forward's stores bf16 alpha, the
// backward's takes alpha16 and sel as run-time pointers, either null); as
// run-time pointers in the default instances they made the K = 64 forward
// 23 % and the K = 128 backward 15 % slower on the H100 (PERF.md). The
// kernels and their instance tables are in fused_fb_kernels.cuh; this unit
// compiles the default instances, fused_fb_modes.cu the modes', each by its
// own nvcc at once.
//
// Features wider than FMAX = 64 (a Gaussian-NIW at D >= 10, a multinomial
// of 65-256 symbols; JAX's fused kernels take any F) run the WF instances,
// F a run-time loop bound (fused_fb_kernels.cuh; built by fused_fb_wide.cu
// and fused_fb_wide_modes.cu). The likelihoods leave both serial chains
// there: ll_tile_kernel (fb_stats.cuh, a float32 FFMA tile, the ll half of
// the TPU kernels' tile matmul) sums them from the feature rows (a built
// kind's built as they are staged) and the chains read them. Up to K = 64
// the forward sums ll over all T B rows into its scratch and runs the split
// forward's chain on it (fb_seqs.cuh's seq_forward in its ll mode); the
// backward's tiled tier (fb_seqs_wf.cuh, up to about F = 310) runs its
// chain beside two or four tile warps, which compute ll a window of steps
// ahead and add eacc a window behind in shared memory, one launch over T,
// a row of acc partials a chain group and of eacc a block; its window tier
// (wider F) has both F-wide products leave the chain as the large-K
// backward's do: for each window of fbs::WideStats::window(T, B) steps,
// ll_tile_kernel sums its likelihoods, the chain reads them and writes w_t
// gamma_t, and the 3xTF32 outer sums add eacc, while acc stays in
// registers, carried between the windows through the blocks' rows of
// partials. Above K = 64 both chains read each window's likelihoods, which
// ll_tile_kernel sums from the window's feature rows before it: the
// forward's is the split forward's chain (fb_wide.cuh's seqs_forward
// without FEATS), carrying its float32 state from a window to the next, the
// backward's fb_wide.cuh's LL. ll_t is summed in blocks of 64 features (one
// fmaf chain a block, the blocks added in order), in the chains and the
// tile alike, so the forward and the backward see the same lik_t. Only the
// tiled tier holds W and feature rows in shared memory, and the launchers
// leave it for the window tier where they no longer fit, so the pair takes
// any F.
//
// Above K = 64 the launchers take the large-K instances instead
// (fused_fwd_wide_kernel<KP, S>, fused_bwd_wide_kernel<KP, S, GATED>, KP =
// 128 or 256, S = 1, 2, 4 or 8; fb_wide.cuh holds their layout): S
// sequences a block over one copy of A~ (in shared memory, its first 64
// rows in registers at KP = 256), one thread a state, the statistics off the
// chain as outer products summed in a fixed order. A step and SM at KP =
// 256, S = 8 holds S KP^2 FMAs of the matvec (about 4,100 cycles on 128
// lanes), 192 KB of A~ read from shared memory (1,536 cycles at 128 bytes a
// cycle) and S KP / 4 broadcast float4 loads of a_{t-1} a thread (4,096 warp
// loads); measured on the H100, those loads set the time, about 3 cycles
// each (PERF.md), so more states a thread is the next lever. The
// one-sequence layout ran one 256-long dependent chain a thread and 7.8
// waves at B = 1024; S sequences interleave S chains, and S is picked so
// that B = 1024 runs in one wave (S = 8 at KP = 256: 128 blocks, one an SM),
// while a small B keeps S = 1 and its blocks.
//
// Above KWIDE = 256 states (to fbw::KXL = 1024) the launchers take the XL
// instances (fused_fb_xl.cu, fb_xl.cuh): fused_fwd_xl_kernel<KP, S> and
// fused_bwd_xl_kernel<KP, S, GATED>, KP = 512 or 1024, at every F and kind,
// F <= FMAX too, since no room is left for W beside A~: for each window of
// fbs::WideStats::window(T, B) steps ll_tile_kernel sums the likelihoods,
// then the chain reads them, as the WF instances above K = 64 do; A~ (and
// for the backward a transposed copy, xl_transpose_kernel, made once a call)
// is read from device memory each step. bf16 alpha and the pick have no XL
// instance: the launchers refuse them there.

#include "fb_common.cuh"
#include "fb_seqs.cuh"
#include "fb_stats.cuh"
#include "fb_wide.cuh"
#include "fb_xl.cuh"
#include "fused_fb_kernels.cuh"

namespace {

using fbc::FMAX;
using fbc::KMAX;
using fbc::NT;

bool bad_shape(int T, int B, int K, int F) {
  return T < 1 || B < 1 || K < 1 || K > fbw::KXL || F < 1;
}

// A feature kind the kernels take, whose width F is (a built kind's F must
// be its width at some D).
bool bad_kind(int kind, int F) {
  return kind < fbc::FEATS_ARRAY || kind > fbc::FEATS_NIG || fbc::obs_dim(kind, F) < 1;
}

// modes: the forward stores bf16 alpha, or the backward takes bf16 alpha or
// the pick. F > FMAX: the WF instances. K > KWIDE: the XL ones (no modes).
const void* instance(int which, int S, int K, int F, int kind, bool modes, int* smem) {
  if (K > fbw::KWIDE) {
    if (modes) return *smem = 0, nullptr;
    return fbf::xl_instance(which, S, K, smem);
  }
  if (F > FMAX)
    return modes ? fbf::wf_modes_instance(which, S, K, F, kind, smem)
                 : fbf::wf_default_instance(which, S, K, F, kind, smem);
  return modes ? fbf::modes_instance(which, S, K, F, kind, smem)
               : fbf::instance_m<false>(which, S, K, F, kind, smem);
}

// The threads a block of the chain kernel (which, S, K, F): KMAX up to KMAX
// states (the chain groups' and the tile warps' in the WF backward's tiled
// tier), KP above.
int threads_of(int which, int S, int K, int F) {
  if (K > KMAX) return fbw::chain_tier(K);
  return which != 0 && fbf::wf_tiled(S, K, F) ? fbf::wf_tiled_plan(S, F).threads() : NT;
}

// The chain groups of S sequences a block of (which, S, K, F) runs: G in the
// WF backward's tiled tier, else 1.
int groups_of(int which, int S, int K, int F) {
  return which != 0 && fbf::wf_tiled(S, K, F) ? fbf::wf_tiled_plan(S, F).groups : 1;
}

// Whether the forward at (K, F) sums its likelihoods first (fbs::ll_tile)
// and runs its chain on them: the WF instances, up to K = 64 over all T B
// rows at once, above over each window of fbs::WideStats::window(T, B)
// steps; the XL instances (K > KWIDE) at every F, a window at a time.
bool forward_reads_ll(int K, int F) { return F > FMAX || K > fbw::KWIDE; }

// Floats of scratch the forward takes: the likelihoods it reads (all T B K
// up to K = 64, a window's above, then the carry between windows: a_{t0-1}
// (B, K) and 1 / s_{t0-1} (B)).
long long forward_scratch_floats(int T, int B, int K, int F) {
  if (!forward_reads_ll(K, F)) return 0;
  if (K <= KMAX) return (long long)T * B * K;
  return (long long)fbs::WideStats::window(T, B) * B * K + (long long)B * K + B;
}

// Launches of the forward's and of the backward's chain kernels since each
// count was last cleared (fused_fb_forward_launches,
// fused_fb_backward_launches).
long long forward_launch_count = 0;
long long backward_launch_count = 0;

// The chain kernel of (which, S, K, kind): ceil(B / (S G)) blocks of
// threads_of threads, G = groups_of.
cudaError_t launch(int which, int S, int T, int B, int K, int F, int kind, bool modes,
                   cudaStream_t st, void** args) {
  int smem = 0;
  const void* fn = instance(which, S, K, F, kind, modes, &smem);
  if (fn == nullptr) return cudaErrorInvalidValue;
  const int per_block = S * groups_of(which, S, K, F);
  const dim3 grid((B + per_block - 1) / per_block);
  const int nt = threads_of(which, S, K, F);
  cudaError_t e;
  if (K > KMAX || F > FMAX) {
    e = fbw::launch_dyn(fn, grid, nt, smem, st, args);
  } else {
    e = cudaLaunchKernel(fn, grid, dim3(nt), args, smem, st);
    if (e == cudaSuccess) e = cudaGetLastError();
  }
  if (e == cudaSuccess) ++(which != 0 ? backward_launch_count : forward_launch_count);
  return e;
}

// Floats of scratch the backward takes: K <= KMAX, a row of partials a
// block (at F > FMAX the same in the tiled tier, and in the window tier a
// row of acc partials a block beside a window's gw, likelihoods and, for a
// built kind, feature rows, the carry and eacc's outer-sum partials);
// above, a window's dn and gw, the carry, the outer sums' partials, (bf16
// alpha, a built kind) the window's widened alpha and built feature rows
// and (F > FMAX) its likelihoods (fbs::WideStats); above KWIDE a window's
// likelihoods at every F and then A~^T (K K floats), the XL chain's matrix.
long long scratch_floats(int T, int B, int K, int F, int S, int kind, bool abf) {
  if (K > fbw::KWIDE)
    return fbs::WideStats::floats(T, B, K, F, kind, abf, 0, true) + (long long)K * K;
  const int blocks = (B + S - 1) / S;
  if (K <= KMAX && F <= FMAX) return (long long)blocks * (K * K + K * F);
  if (fbf::wf_tiled(S, K, F)) {  // a row of acc a chain group, of eacc a block
    const int G = fbf::wf_tiled_plan(S, F).groups;
    const long long nb = (B + S * G - 1) / (S * G);
    return nb * G * K * K + nb * K * F;
  }
  return fbs::WideStats::floats(T, B, K, F, kind, abf, K <= KMAX ? blocks : 0, F > FMAX);
}

}  // namespace

extern "C" {

// The largest K the launchers take (the XL instances'). They take any F.
int fused_fb_kmax() { return fbw::KXL; }

const char* fused_fb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// *out = the floats of scratch fused_fb_forward takes at these shapes: at F
// > FMAX the likelihoods (T B K up to K = 64; above, a window's and the
// carry between windows), else none.
int fused_fb_forward_scratch(int T, int B, int K, int F, int kind, long long* out) {
  if (bad_shape(T, B, K, F) || bad_kind(kind, F)) return static_cast<int>(cudaErrorInvalidValue);
  *out = forward_scratch_floats(T, B, K, F);
  return 0;
}

// *out = the floats of scratch fused_fb_backward takes at these shapes, for
// the feature kind and alpha's storage (abf: bf16).
int fused_fb_scratch(int T, int B, int K, int F, int S, int kind, int abf, long long* out) {
  if (bad_shape(T, B, K, F) || bad_kind(kind, F) || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  *out = scratch_floats(T, B, K, F, S, kind, abf != 0);
  return 0;
}

// Each launcher returns the launch's CUDA error right after it (0 = ok).
// Pointers are device pointers of contiguous tensors; the kernels run on
// `stream` and do not synchronise. S is the sequences a block: 2 or 4 up to
// K = 64, 1, 2, 4 or 8 above; any other is refused. kind names what src
// holds: the (T, B, F) float32 feature array (fbc::FEATS_ARRAY), or the raw
// (T, B, D) float32 observations whose features the kernels build, F =
// feat_width(kind, D) wide (FEATS_NIW, FEATS_NIG); an F no D gives is
// refused, and so is an S whose shared memory at this F the card cannot
// give (the launch's error). alpha is stored float32 into alpha or, where
// alpha16 is not null (alpha then null), as bf16 into alpha16. scratch
// holds fused_fb_forward_scratch floats: at F > FMAX the likelihoods, which
// ll_tile sums before the chain reads them, up to K = 64 of every (t, b)
// row, above of a window of steps at a time, one tile and one chain launch
// a window.
int fused_fb_forward(const float* pi, const float* A, const float* W, const float* src,
                     float* alpha, void* alpha16, float* s, float* sh, float* scratch, int T,
                     int B, int K, int F, int S, int kind, int device, void* stream) {
  if (bad_shape(T, B, K, F) || bad_kind(kind, F) || (alpha == nullptr) == (alpha16 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* a16 = static_cast<__nv_bfloat16*>(alpha16);
  if (forward_reads_ll(K, F) && K <= KMAX) {
    e = fbs::ll_tile(src, W, scratch, (long long)T * B, F, K, kind, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    const float* ll = scratch;
    void* args[] = {&pi, &A, &ll, &alpha, &a16, &s, &sh, &T, &B, &K};
    return static_cast<int>(launch(0, S, T, B, K, F, kind, a16 != nullptr, st, args));
  }
  if (forward_reads_ll(K, F)) {  // a window at a time: its tile, then its chain
    const int steps = fbs::WideStats::window(T, B), D = fbc::obs_dim(kind, F);
    float* ll = scratch;
    float* carry = scratch + (size_t)steps * B * K;
    for (int t0 = 0; t0 < T; t0 += steps) {
      int t1 = std::min(T, t0 + steps);
      e = fbs::ll_tile(src + (size_t)t0 * B * D, W, ll, (long long)(t1 - t0) * B, F, K, kind,
                       st);
      if (e != cudaSuccess) return static_cast<int>(e);
      void* args[] = {&pi, &A, &ll, &alpha, &a16, &s, &sh, &carry, &T, &B, &K, &t0, &t1};
      e = launch(0, S, T, B, K, F, kind, a16 != nullptr, st, args);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    return 0;
  }
  void* args[] = {&pi, &A, &W, &src, &alpha, &a16, &s, &sh, &T, &B, &K, &F};
  return static_cast<int>(launch(0, S, T, B, K, F, kind, a16 != nullptr, st, args));
}

// w is null for the ungated launch, else the (T, B) kept-mask; the kernel
// forms the pair gate from it. stats receives acc (K, K) and then eacc
// (K, F), summed in a fixed order (fb_stats.cuh); scratch holds
// fused_fb_scratch floats. Above K = 64, and up to it in the WF window tier,
// the backward runs a window of time steps a launch (fbs::WideStats),
// several launches for a long T. src,
// kind, alpha and alpha16 as fused_fb_forward's (alpha as stored there).
// sel, where not null, is the (B,) int32 time pick: gamma0 then takes each
// sequence's ungated gamma at t = sel[b] (zeros for a pick outside 0 ..
// T-1) in place of w_0 gamma_0; it is refused together with gamma.
int fused_fb_backward(const float* A, const float* W, const float* src, const float* alpha,
                      const void* alpha16, const float* s, const float* sh, const float* w,
                      const int* sel, float* gamma, float* gamma0, float* stats, float* scratch,
                      int T, int B, int K, int F, int S, int kind, int device, void* stream) {
  if (bad_shape(T, B, K, F) || bad_kind(kind, F) || (alpha == nullptr) == (alpha16 == nullptr) ||
      (sel != nullptr && gamma != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __nv_bfloat16* a16 = static_cast<const __nv_bfloat16*>(alpha16);
  const int which = w != nullptr ? 2 : 1;
  const bool modes = a16 != nullptr || sel != nullptr;
  if (K <= KMAX && (F <= FMAX || fbf::wf_tiled(S, K, F))) {
    void* args[] = {&A, &W, &src, &alpha, &a16, &s, &sh, &w, &sel, &gamma, &gamma0, &scratch,
                    &T, &B, &K, &F};
    e = launch(which, S, T, B, K, F, kind, modes, st, args);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (F <= FMAX)
      return static_cast<int>(
          fbs::sum_partials(scratch, (B + S - 1) / S, K * K + K * F, stats, st));
    // the tiled tier: acc's rows a group (the first ceil(B / S), an S-sequence
    // block's each), then eacc's a block
    const int G = fbf::wf_tiled_plan(S, F).groups;
    const int nb = (B + S * G - 1) / (S * G);
    e = fbs::sum_partials(scratch, (B + S - 1) / S, K * K, stats, st);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(fbs::sum_partials(scratch + (size_t)nb * G * K * K, nb, K * F,
                                              stats + K * K, st));
  }
  if (F > FMAX || K > fbw::KWIDE) {
    // a window's likelihoods, which ll_tile sums first, then its chain; up
    // to K = 64 (the WF window tier) acc stays in the chain, a row of
    // partials a block, which the kernel takes in the place of dn
    const int blocks = K <= KMAX ? (B + S - 1) / S : 0;
    const fbs::WideStats ws(scratch, T, B, K, F, kind, a16 != nullptr, blocks, true);
    float *dn = blocks > 0 ? ws.part_a : ws.dn, *gw = ws.gw, *carry = ws.carry, *ll = ws.ll;
    const float* M = A;  // the chain's matrix: A~, or above KWIDE its transposed copy
    if (K > fbw::KWIDE) {
      float* AT = scratch + fbs::WideStats::floats(T, B, K, F, kind, a16 != nullptr, 0, true);
      e = fbw::xl_transpose(A, AT, K, st);
      if (e != cudaSuccess) return static_cast<int>(e);
      M = AT;
    }
    e = ws.run(
        alpha, a16, src, stats, st,
        [&](int t0, int t1) {
          void* args[] = {&M,      &ll, &alpha, &a16,   &s, &sh, &w,  &sel, &gamma,
                          &gamma0, &dn, &gw,    &carry, &T, &B,  &K,  &t0,  &t1};
          return launch(which, S, T, B, K, F, kind, modes, st, args);
        },
        [&](const float* rows, long long n) {  // the window's feature rows
          return fbs::ll_tile(rows, W, ll, n, F, K, fbc::FEATS_ARRAY, st);
        });
    if (e != cudaSuccess || blocks == 0) return static_cast<int>(e);
    return static_cast<int>(fbs::sum_partials(ws.part_a, blocks, K * K, stats, st));
  }
  const fbs::WideStats ws(scratch, T, B, K, F, kind, a16 != nullptr);
  float *dn = ws.dn, *gw = ws.gw, *carry = ws.carry;
  return static_cast<int>(ws.run(alpha, a16, src, stats, st, [&](int t0, int t1) {
    void* args[] = {&A, &W, &src, &alpha, &a16, &s, &sh, &w, &sel, &gamma, &gamma0, &dn, &gw,
                    &carry, &T, &B, &K, &F, &t0, &t1};
    return launch(which, S, T, B, K, F, kind, modes, st, args);
  }));
}

// The large-K statistics' outer sums alone (fbs::outer_sum, which the
// backward kernels' launchers here and in split_fb.cu and duplex_fb.cu run):
// out (I, J) = X^T Y for row-major X (N, I) and Y (N, J), 3xTF32 on the
// tensor cores, summed in an order fixed by (N, I, J). scratch holds
// fused_fb_outer_scratch floats.
int fused_fb_outer_scratch(int N, int I, int J, long long* out) {
  if (N < 1 || I < 1 || J < 1) return static_cast<int>(cudaErrorInvalidValue);
  *out = fbs::outer_scratch(N, I, J);
  return 0;
}

int fused_fb_outer_sum(const float* X, const float* Y, float* scratch, float* out, int N, int I,
                       int J, int device, void* stream) {
  if (N < 1 || I < 1 || J < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      fbs::outer_sum(X, Y, N, I, J, scratch, out, false, static_cast<cudaStream_t>(stream)));
}

// Launches of the outer sums' kernel by this library (the large-K backward
// and fused_fb_outer_sum) since the count was last cleared; clears it when
// `clear`.
int fused_fb_outer_launches(int clear) {
  return fbs::outer_launches(clear != 0);
}

// The large-K backward's two operand kernels alone (fbs::build_feats and
// fbs::widen, which fbs::WideStats runs on each window): out (rows, F) =
// the built features of kind (fbc::FEATS_NIW or FEATS_NIG) of the
// observation rows obs (rows, D), F = feat_width(kind, D); out (n) = a16
// (n) bf16 widened to float32.
int fused_fb_build_feats(const float* obs, float* out, long long rows, int D, int F, int kind,
                         int device, void* stream) {
  if (rows < 1 || D < 1 || kind == fbc::FEATS_ARRAY || bad_kind(kind, F) ||
      fbc::obs_dim(kind, F) != D)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      fbs::build_feats(kind, obs, out, rows, D, F, static_cast<cudaStream_t>(stream)));
}

int fused_fb_widen(const void* a16, float* out, long long n, int device, void* stream) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(fbs::widen(static_cast<const __nv_bfloat16*>(a16), out, n,
                                     static_cast<cudaStream_t>(stream)));
}

// Launches of the forward's chain kernels (one a call, one a window above K
// = 64 at F > FMAX) since the count was last cleared; clears it when
// `clear`.
int fused_fb_forward_launches(int clear) {
  const long long n = forward_launch_count;
  if (clear != 0) forward_launch_count = 0;
  return static_cast<int>(n);
}

// Launches of the backward's chain kernels (every tier, one a window where
// the backward runs windows) since the count was last cleared; clears it
// when `clear`.
int fused_fb_backward_launches(int clear) {
  const long long n = backward_launch_count;
  if (clear != 0) backward_launch_count = 0;
  return static_cast<int>(n);
}

// 1 where the backward (S, K, F) runs the WF instances' tiled tier (K <= 64,
// F > FMAX and its shared memory within fbwf::SMEM_CAP: every feature kind
// alike), else 0.
int fused_fb_wf_tiled(int S, int K, int F) {
  return fbf::wf_tiled(S, K, F) ? 1 : 0;
}

// The WF instances' likelihood tile alone (fbs::ll_tile, which the forward
// up to K = 64 runs over all rows and the backward above K = 64 over each
// window): out (N, K) = the feature rows of src . W (F, K), row-major, each
// element summed as the chain kernels sum ll_t; src the (N, F) feature
// array, or the (N, D) raw observations of a built kind.
int fused_fb_ll_tile(const float* src, const float* W, float* out, long long N, int F, int K,
                     int kind, int device, void* stream) {
  if (N < 1 || F < 1 || K < 1 || bad_kind(kind, F))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      fbs::ll_tile(src, W, out, N, F, K, kind, static_cast<cudaStream_t>(stream)));
}

// Launches of build_feats_kernel (which = 0), widen_kernel (1) or
// ll_tile_kernel's 64- (2) or 128-state tile (3) by this library (the WF
// instances, the large-K backward and the entry points above) since the
// count was last cleared; clears it when `clear`.
int fused_fb_prep_launches(int which, int clear) {
  return fbs::prep_launches(which, clear != 0);
}

// What the instance (which, S, K, F, kind) of the launchers above takes on
// `device`: out[0] registers a thread, out[1] static and out[2] dynamic
// shared bytes a block, out[3] local (spilled) bytes a thread, out[4]
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// out[5] the device's SMs, out[6] threads a block, out[7] chain groups of S
// sequences a block (G in the WF backward's tiled tier, else 1). which = 0
// forward, 1 backward, 2 gated backward; K > 64 names the large-K instance
// of its KP (the XL one above 256, which has no modes' instance); modes
// the modes' instance (the launchers' with bf16 alpha or
// the pick), else the default one; F > FMAX the WF instance (out[4] would be
// 0 for an instance whose shared memory the card cannot give; the tiled
// tier, whose shared memory grows with F, is taken only where it fits).
int fused_fb_kernel_info(int which, int S, int K, int F, int kind, int modes, int device,
                         int* out) {
  if (bad_shape(1, 1, K, F) || bad_kind(kind, F) || which < 0 || which > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int smem = 0;
  const void* fn = instance(which, S, K, F, kind, modes != 0, &smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = threads_of(which, S, K, F);
  cudaError_t e = cudaSetDevice(device);
  cudaFuncAttributes attr;
  if (e == cudaSuccess) e = cudaFuncGetAttributes(&attr, fn);
  int optin = 0;
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  const bool fits = e == cudaSuccess && smem + static_cast<int>(attr.sharedSizeBytes) <= optin;
  if (fits && smem > 0)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int blocks = 0, sms = 0;
  if (e == cudaSuccess && fits)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, nt, smem);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.sharedSizeBytes);
  out[2] = smem;
  out[3] = static_cast<int>(attr.localSizeBytes);
  out[4] = blocks;
  out[5] = sms;
  out[6] = nt;
  out[7] = groups_of(which, S, K, F);
  return 0;
}

}  // extern "C"
