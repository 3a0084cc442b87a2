// Duplex E-step kernels for NVIDIA Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the duplex E-step:
//   duplex_chain_kernel    <- pysvihmm_tpu/messages/pallas_duplex.py:82 (_duplex_kernel)
//   duplex_combine_kernel  <- pysvihmm_tpu/messages/pallas_duplex.py:175 (_combine_kernel)
// The host wrapper and the plain PyTorch twin of both kernels live in
// pysvihmm_tpu_torch/messages/duplex_fb.py; the kernels and their instance
// tables in duplex_fb_kernels.cuh, this unit holding the launchers and the
// instances for F <= FMAX, duplex_fb_wide.cu those for wider features,
// which read likelihood tiles (below).
//
// What is computed (the TPU kernels' math, without their time tiles, lane
// packing and tile-edge carries); lik_t = exp(ll_t - max_k ll_t) with
// ll_t = f_t . W (the fused kernels' fmaf chain over f in order):
//   chain, forward, t = 0 .. T-1 (the fused forward's recursion):
//                         a_0 = pi~ * lik_0
//                         a_t = (a_{t-1} @ A~) * (lik_t / s_{t-1})
//                         s_t = sum_k a_t,  sh_t = max_k ll_t
//   chain, backward, t = T-1 .. 1, raw beta (normalisation deferred):
//                         b_{T-1} = 1
//                         e_t = lik_t * b_t
//                         b_{t-1} = (A~ e_t) * (1 / sum_k b_t)
//     The scale is applied after the matvec, as the forward applies
//     1 / s_{t-1} after its own, so the matvec does not wait for the sum.
//     Writes raw a_t, s_t, sh_t and raw b_t.
//   combine, chain-free, for every t:
//                         g_t = a_t * b_t,  ginv_t = 1 / sum_k g_t,  gamma_t = g_t ginv_t
//                         d_t = e_t * (1 / sum_k b_t)   (pallas_duplex.py:249)
//                         acc  += outer(a_{t-1}, d_t ginv_{t-1} pg_t)   (t >= 1;
//                                 the wrapper forms A~ * acc)
//                         eacc += outer(w_t gamma_t, f_t)
//                         gamma0 = w_0 gamma_0
//     The xi normaliser of the pair (t-1, t) is sum(a_{t-1} * A~ d_t) =
//     sum(a_{t-1} * b_{t-1}) = 1 / ginv_{t-1}, so no scale array crosses the
//     kernels (pallas_duplex.py:19-29). It holds to the last bit only if
//     d_t here is the e_t and scale that built b_{t-1}: ll_t comes from the
//     same fmaf chain, the shift is the forward's sh_t (the same max of the
//     same numbers), and sum_k b_t is reduced in the chain's order (each
//     warp's butterfly over 32 states, then the warps in order).
//     Gated mode (SVI windows) takes the kept-mask w (T, B) and forms the
//     pair gate pg_t = w_{t-1} w_t (pg_0 = 0) itself; ungated, w = pg = 1.
//     The gates touch the statistics only: gamma written out is ungated.
//     Every per-sequence sum is floored at SUM_FLOOR (pallas_fb.py:82).
//
// The chain, K <= 64: duplex_chain_kernel<S, FP> on a grid of (ceil(B/S), 2)
// blocks of 64 threads in fb_seqs.cuh's layout (S sequences a block, thread
// k running state k of all S). blockIdx.y = 0 runs fbseq::seq_forward, the
// fused forward's own function, so alpha, s and sh are the fused forward's
// bit for bit; blockIdx.y = 1 runs the backward on the same scheme: row k of
// A~ and column k of W in registers, loaded once; e_t of the S sequences
// read from shared memory as float4 broadcasts, each feeding S FMAs; ll_{t-1}
// and its max computed a step ahead in the matvec's loop; step T-1 peeled;
// one barrier a step. Both halves are chains of dependent K-wide products,
// bound by latency, not bytes or FLOPs; the two directions run side by side
// when 2 ceil(B/S) blocks fit one wave (the wrapper picks S from the card's
// occupancy). Above K = 64 duplex_chain_wide_kernel<KP, S> (KP = 128 or
// 256 padded states, S = 1, 2, 4 or 8) runs the same scheme on fb_wide.cuh's
// layout: a forward and a backward block for each S sequences, the forward
// fbw::seqs_forward (the fused large-K forward's at the same S) and the
// backward seqs_raw_backward, thread k running state k of all S on column k
// of A~^T, so each word of A~^T and W read in a step feeds S FMAs; beta is
// the same bits at every S. A step of either half at KP = 256, S = 8 holds S
// KP^2 FMAs and S KP / 4 broadcast float4 loads a thread, the fused
// forward's work; one block an SM at KP = 256 (218 KB of shared memory at S
// = 8), so the 2 ceil(B/S) blocks of B = 1024 take two waves there and one
// at KP = 128, S = 8 (2 blocks an SM).
//
// Both kernels take the fused pair's built feature kinds (KIND; pallas_duplex.py
// :290, `in_kernel_feats`): the chain's blocks build their rows as
// seq_forward does, the combine's warps load each feature's factors with
// the row and form it where the row is stored (LaneFeats), and above K = 64
// eacc's operand is built a window at a time (fbs::WideStats); every output
// is the array mode's bit for bit. alpha stays float32 here, as in JAX.
//
// The combine has no chain: every (t, b) row needs only a_t, b_t, f_t, sh_t
// and the pair's ginv_{t-1}. duplex_combine_kernel<KP, FP, GATED> takes a
// tile of 8 sequences (one a warp; lane j of a warp holds states j, j + 32,
// ...) by a chunk of time steps. Each warp walks its sequence two rows at a
// time (coalesced loads of the K-wide alpha and beta rows, the feature row
// into shared memory for the likelihood's broadcast, W's columns as rows of
// shared memory read as float4) and carries ginv and w from one row to the
// next, so no barrier is tied to a time step. Per row it writes gamma,
// gamma0 and forms dn_t = d_t ginv_{t-1} pg_t and gw_t = w_t gamma_t.
//   K <= 64 (KP = 64): the rows of a stage of 8 time steps x 8 sequences
//     land in shared memory (a_{t-1}, dn_t, gw_t, f_t), and after one
//     barrier all 256 threads add them into acc and eacc as register-blocked
//     outer products: thread (ty, tx) of 16 x 16 owns a 4 x 4 block of acc
//     and 4 x FP/16 of eacc, reads its operands as float4 (each load feeding
//     4 FMAs) and keeps the sums in registers over the whole chunk; a second
//     barrier frees the stage buffers. Each block writes one row of
//     partials, which fbs::sum_partials adds in block order.
//   K = 65..256 (KP = 128, 256): the rows write dn and gw for a window of
//     time steps (fbs::WideStats), and the outer sums of fb_stats.cuh add
//     them.
// The grid is (ceil(B/8), chunks), the chunks cut so that the launch holds
// at most about COMBINE_BLOCKS blocks, one wave at 2 blocks an SM: a function
// of (T, B) only, so the sums run in the same order on every card and call.
// What bounds the K <= 64 combine:
// per (t, b) about 2K (2F + K) + 10K flops (the likelihood dot, the two outer
// products) against 4 (F + 2K) bytes in, so FLOPs by a little (FMAs at 67
// TFLOP/s); the design keeps the FMA pipe fed with few shared-memory loads
// per FMA.

//
// Features wider than FMAX = 64 (a Gaussian-NIW at D >= 10, a diagonal
// Gaussian at D >= 32, a multinomial of 65-256 symbols; JAX's duplex
// kernels take any F) run the instances of duplex_fb_wide.cu, which read
// the likelihoods instead of forming f_t . W: ll_tile_kernel (fb_stats.cuh,
// fbs::ll_tile, the fused WF pair's tile; duplex_fb_ll_tile) sums ll_t of
// all T B rows once into a (T, B, K) array, each element the chains' own sum
// (a fmaf chain over each block of 64 features, the blocks added in order),
// and both kernels read it, so the serial chains hold no F-wide product and
// no kernel stages W or a feature row. The chain: up to K = 64
// duplex_chain_ll_kernel<S>, whose forward block runs fb_seqs.cuh's
// seq_forward in its ll mode (the fused WF forward's own function, so
// alpha, s and sh are its bits at the same S) and whose backward block the
// raw backward on the same layout reading ll_t through the same cp.async
// ring; above, duplex_chain_wide_ll_kernel<KP, S> (fb_wide.cuh's
// seqs_forward without FEATS over all T, the fused large-K WF forward's
// recursion, and seqs_raw_backward reading ll_t a step ahead). beta is the
// same bits at every S. The combine: duplex_combine_ll_kernel<KP, GATED>
// (duplex_fb_kernels.cuh says how) takes lik_t = exp(ll_t - sh_t) from the
// same array, so d_t is the e_t and scale that built b_{t-1}; eacc leaves
// the kernel as w_t gamma_t a window of time steps, summed by the 3xTF32
// outer sums against the window's feature rows (fbs::WideStats), while up
// to K = 64 acc stays in registers, a block's row of partials carried
// across the windows. None of them depends on the feature kind or width,
// nor does their shared memory grow with F: they take any F, the tile's
// (T, B, K) array beside alpha and beta in device memory.

#include "fb_common.cuh"
#include "fb_seqs.cuh"
#include "fb_stats.cuh"
#include "fb_wide.cuh"
#include "duplex_fb_kernels.cuh"

namespace fbd {
namespace {

bool bad_shape(int T, int B, int K, int F) {
  return T < 1 || B < 1 || K < 1 || K > fbw::KWIDE || F < 1;
}

// The time steps a combine block takes of `steps` (a multiple of `mult`): the
// launch holds at most about COMBINE_BLOCKS blocks of CW sequences (more only
// where the groups alone outnumber them), whatever the card.
int combine_chunk(int steps, int B, int mult) {
  const int groups = (B + CW - 1) / CW;
  const int want = max(1, COMBINE_BLOCKS / groups);  // chunks a group
  const int chunk = (steps + want - 1) / want;
  return (chunk + mult - 1) / mult * mult;
}

// A feature kind the kernels take, whose width F is.
bool bad_kind(int kind, int F) {
  return kind < fbc::FEATS_ARRAY || kind > fbc::FEATS_NIG || fbc::obs_dim(kind, F) < 1;
}

// The combine's blocks a window up to K = 64 at F > FMAX: the rows of acc's
// partials it carries across the windows of the statistics.
int wf_blocks(int T, int B) {
  const int steps = fbs::WideStats::window(T, B);
  const int chunk = combine_chunk(steps, B, CTT);
  return ((B + CW - 1) / CW) * ((steps + chunk - 1) / chunk);
}

// Floats of scratch the combine takes: K <= KMAX, a row of partials a block;
// above, a window's dn and gw, the two outer sums' partials and (a built
// kind) the window's feature rows (fbs::WideStats); at F > FMAX up to K =
// 64, a window's gw, eacc's partials, the built rows and acc's rows of
// partials.
long long scratch_floats(int T, int B, int K, int F, int kind) {
  if (K <= KMAX && F <= FMAX) {
    const int chunk = combine_chunk(T, B, CTT);
    return (long long)((B + CW - 1) / CW) * ((T + chunk - 1) / chunk) * (K * K + K * F);
  }
  if (K <= KMAX) return fbs::WideStats::floats(T, B, K, F, kind, false, wf_blocks(T, B));
  return fbs::WideStats::floats(T, B, K, F, kind);
}

// The chain instance of (S, F, KIND) up to K = 64: the S-sequence kernel at
// FP = pad_f(F).
template <int S, int KIND>
const void* chain_fp(int fp) {
  switch (fp) {
    case 16: return reinterpret_cast<const void*>(duplex_chain_kernel<S, 16, KIND>);
    case 32: return reinterpret_cast<const void*>(duplex_chain_kernel<S, 32, KIND>);
    case 48: return reinterpret_cast<const void*>(duplex_chain_kernel<S, 48, KIND>);
    default: return reinterpret_cast<const void*>(duplex_chain_kernel<S, 64, KIND>);
  }
}

template <int KP, int S, int KIND>
const void* wide_chain_at(int* smem) {
  *smem = fbw::chain_smem_bytes<KP, S>();
  return reinterpret_cast<const void*>(duplex_chain_wide_kernel<KP, S, KIND>);
}

template <int KP, int KIND>
const void* wide_chain_of(int S, int* smem) {
  switch (S) {
    case 1: return wide_chain_at<KP, 1, KIND>(smem);
    case 2: return wide_chain_at<KP, 2, KIND>(smem);
    case 4: return wide_chain_at<KP, 4, KIND>(smem);
    case 8: return wide_chain_at<KP, 8, KIND>(smem);
    default: *smem = 0; return nullptr;
  }
}

// The chain instance of (S, K, F, KIND) and its dynamic shared bytes in
// *smem: S in {2, 4} up to K = 64, in {1, 2, 4, 8} at KP = tier_of(K)
// above. Null for an S not built.
template <int KIND>
const void* chain_kind(int S, int K, int F, int* smem) {
  if (K > KMAX)
    return fbw::tier_of(K) == 128 ? wide_chain_of<128, KIND>(S, smem)
                                  : wide_chain_of<256, KIND>(S, smem);
  *smem = 0;
  switch (S) {
    case 2: return chain_fp<2, KIND>(pad_f(F));
    case 4: return chain_fp<4, KIND>(pad_f(F));
    default: return nullptr;
  }
}

// F > FMAX: the instances on read likelihoods (duplex_fb_wide.cu), one a
// (S, K) whatever the kind.
const void* chain_of(int S, int K, int F, int kind, int* smem) {
  if (F > FMAX) return ll_chain_instance(S, K, smem);
  switch (kind) {
    case fbc::FEATS_ARRAY: return chain_kind<fbc::FEATS_ARRAY>(S, K, F, smem);
    case fbc::FEATS_NIW: return chain_kind<fbc::FEATS_NIW>(S, K, F, smem);
    case fbc::FEATS_NIG: return chain_kind<fbc::FEATS_NIG>(S, K, F, smem);
    default: *smem = 0; return nullptr;
  }
}

template <bool GATED, int KIND>
const void* combine_fp(int fp) {
  switch (fp) {
    case 16: return reinterpret_cast<const void*>(duplex_combine_kernel<KMAX, 16, GATED, KIND>);
    case 32: return reinterpret_cast<const void*>(duplex_combine_kernel<KMAX, 32, GATED, KIND>);
    case 48: return reinterpret_cast<const void*>(duplex_combine_kernel<KMAX, 48, GATED, KIND>);
    default: return reinterpret_cast<const void*>(duplex_combine_kernel<KMAX, 64, GATED, KIND>);
  }
}

template <int FP>
constexpr int combine_bytes_fp() {
  return 4 * combine_smem_floats<KMAX, FP>();
}

template <int KP, int KIND>
const void* combine_wide(bool gated) {
  return gated ? reinterpret_cast<const void*>(duplex_combine_kernel<KP, FMAX, true, KIND>)
               : reinterpret_cast<const void*>(duplex_combine_kernel<KP, FMAX, false, KIND>);
}

// The combine instance of (K, F, gated, KIND) and its dynamic shared bytes
// in *smem: KP = 64 at FP = pad_f(F) up to K = 64, KP = 128 or 256 at FP =
// FMAX above.
template <int KIND>
const void* combine_kind(int K, int F, bool gated, int* smem) {
  if (K <= KMAX) {
    const int fp = pad_f(F);
    *smem = fp == 16 ? combine_bytes_fp<16>() : fp == 32 ? combine_bytes_fp<32>()
          : fp == 48 ? combine_bytes_fp<48>() : combine_bytes_fp<64>();
    return gated ? combine_fp<true, KIND>(fp) : combine_fp<false, KIND>(fp);
  }
  if (fbw::tier_of(K) == 128) {
    *smem = 4 * combine_smem_floats<128, FMAX>();
    return combine_wide<128, KIND>(gated);
  }
  *smem = 4 * combine_smem_floats<256, FMAX>();
  return combine_wide<256, KIND>(gated);
}

const void* combine_of(int K, int F, bool gated, int kind, int* smem) {
  if (F > FMAX) {
    *smem = 0;
    return ll_combine_instance(K, gated);
  }
  switch (kind) {
    case fbc::FEATS_ARRAY: return combine_kind<fbc::FEATS_ARRAY>(K, F, gated, smem);
    case fbc::FEATS_NIW: return combine_kind<fbc::FEATS_NIW>(K, F, gated, smem);
    case fbc::FEATS_NIG: return combine_kind<fbc::FEATS_NIG>(K, F, gated, smem);
    default: *smem = 0; return nullptr;
  }
}

}  // namespace
}  // namespace fbd

using namespace fbd;

extern "C" {

// The largest K the launchers take (the large-K instances'), and the widest
// F of the instances for F <= FMAX: wider features run the instances on read
// likelihoods, which take any F.
int duplex_fb_kmax() { return fbw::KWIDE; }
int duplex_fb_fmax() { return FMAX; }

const char* duplex_fb_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// *out = the floats of scratch duplex_fb_combine takes at these shapes.
int duplex_fb_scratch(int T, int B, int K, int F, int kind, long long* out) {
  if (bad_shape(T, B, K, F) || bad_kind(kind, F)) return static_cast<int>(cudaErrorInvalidValue);
  *out = scratch_floats(T, B, K, F, kind);
  return 0;
}

// The likelihoods the instances at F > FMAX read (fbs::ll_tile, one launch
// of ll_tile_kernel, counted): out (N, K) = the feature rows of src . W (F,
// K), row-major, each element the chains' own sum; src the (N, F) feature
// array, or the (N, D) raw observations of a built kind.
int duplex_fb_ll_tile(const float* src, const float* W, float* out, long long N, int F, int K,
                      int kind, int device, void* stream) {
  if (N < 1 || F < 1 || K < 1 || bad_kind(kind, F))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(
      fbs::ll_tile(src, W, out, N, F, K, kind, static_cast<cudaStream_t>(stream)));
}

// Each launcher returns the launch's CUDA error right after it (0 = ok).
// Pointers are device pointers of contiguous float32 tensors; the kernels
// run on `stream` and do not synchronise. S is the sequences a block of the
// chain: 2 or 4 up to K = 64, 1, 2, 4 or 8 above; any other is refused.
// kind names what feats holds, as fused_fb.cu's launchers take it: the
// (T, B, F) feature array, or the raw (T, B, D) observations of a built
// kind, F its width at D (an F no D gives is refused). ll is the (T, B, K)
// likelihoods of duplex_fb_ll_tile at F > FMAX, where the kernels read them
// (W and feats unused by the chain), and must be null at F <= FMAX, where
// the kernels form them.
int duplex_fb_chain(const float* pi, const float* A, const float* W, const float* feats,
                    const float* ll, float* alpha, float* s, float* sh, float* beta, int T,
                    int B, int K, int F, int S, int kind, int device, void* stream) {
  if (bad_shape(T, B, K, F) || bad_kind(kind, F) || (ll != nullptr) != (F > FMAX))
    return static_cast<int>(cudaErrorInvalidValue);
  int smem = 0;
  const void* fn = chain_of(S, K, F, kind, &smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((B + S - 1) / S, 2);
  const int nt = K > KMAX ? fbw::tier_of(K) : NT;
  if (F > FMAX) {
    void* args[] = {&pi, &A, &ll, &alpha, &s, &sh, &beta, &T, &B, &K};
    return static_cast<int>(fbw::launch_dyn(fn, grid, nt, smem, st, args));
  }
  void* args[] = {&pi, &A, &W, &feats, &alpha, &s, &sh, &beta, &T, &B, &K, &F};
  if (K > KMAX) return static_cast<int>(fbw::launch_dyn(fn, grid, nt, smem, st, args));
  e = cudaLaunchKernel(fn, grid, dim3(NT), args, 0, st);
  return static_cast<int>(e != cudaSuccess ? e : cudaGetLastError());
}

// Launches of the outer sums' kernel (fbs::outer_sum) by this library's
// large-K launcher since the count was last cleared; clears it when `clear`.
int duplex_fb_outer_launches(int clear) {
  return fbs::outer_launches(clear != 0);
}

// Launches of the operand kernels of this library (fbs::build_feats, which
// = 0, in the combine's windows; fbs::widen, 1, which it never runs;
// ll_tile_kernel's 64- (2) or 128-state tile (3), duplex_fb_ll_tile) since
// the count was last cleared; clears it when `clear`.
int duplex_fb_prep_launches(int which, int clear) {
  return fbs::prep_launches(which, clear != 0);
}

// w is null for the ungated launch, else the (T, B) kept-mask. stats
// receives acc (K, K) and then eacc (K, F), summed in a fixed order
// (fb_stats.cuh); scratch holds duplex_fb_scratch floats. ll as
// duplex_fb_chain's: at F > FMAX the kernel reads lik_t from it, feats then
// only the operand of eacc's outer sums. Above K = 64, and at F > FMAX, the
// combine runs a window of time steps a launch (fbs::WideStats), its
// blocks' chunks cut from the window; at F > FMAX up to K = 64 acc's rows of
// partials are carried from a window to the next and added in block order
// after the last.
int duplex_fb_combine(const float* W, const float* feats, const float* ll, const float* alpha,
                      const float* beta, const float* sh, const float* w, float* gamma,
                      float* gamma0, float* stats, float* scratch, int T, int B, int K, int F,
                      int kind, int device, void* stream) {
  if (bad_shape(T, B, K, F) || bad_kind(kind, F) || (ll != nullptr) != (F > FMAX))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int smem = 0;
  const void* fn = combine_of(K, F, w != nullptr, kind, &smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int groups = (B + CW - 1) / CW;
  if (K <= KMAX && F <= FMAX) {
    int chunk = combine_chunk(T, B, CTT), t0 = 0, t1 = T;
    const int nchunks = (T + chunk - 1) / chunk;
    float *dn = nullptr, *gw = nullptr;
    void* args[] = {&W,  &feats, &alpha, &beta, &sh,    &w,  &gamma, &gamma0, &scratch,
                    &dn, &gw,    &T,     &B,    &K,     &F,  &chunk, &t0,     &t1};
    e = fbw::launch_dyn(fn, dim3(groups, nchunks), CNT, smem, st, args);
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(fbs::sum_partials(scratch, groups * nchunks, K * K + K * F, stats, st));
  }
  if (K <= KMAX) {  // F > FMAX: acc in the kernel, eacc a window at a time
    const int blocks = wf_blocks(T, B);
    const fbs::WideStats ws(scratch, T, B, K, F, kind, false, blocks);
    float *part = ws.part_a, *dn = nullptr, *gw = ws.gw;
    int chunk = combine_chunk(ws.steps, B, CTT);
    e = ws.run(alpha, nullptr, feats, stats, st, [&](int t0, int t1) {
      void* args[] = {&ll, &alpha, &beta, &sh, &w,     &gamma, &gamma0, &part,
                      &dn, &gw,    &T,    &B,  &K,     &chunk, &t0,     &t1};
      return fbw::launch_dyn(fn, dim3(groups, (t1 - t0 + chunk - 1) / chunk), CNT, smem, st,
                             args);
    });
    if (e != cudaSuccess) return static_cast<int>(e);
    return static_cast<int>(fbs::sum_partials(part, blocks, K * K, stats, st));
  }
  const fbs::WideStats ws(scratch, T, B, K, F, kind);
  float *dn = ws.dn, *gw = ws.gw, *part = nullptr;
  int chunk = combine_chunk(ws.steps, B, 2);
  return static_cast<int>(ws.run(alpha, nullptr, feats, stats, st, [&](int t0, int t1) {
    if (F > FMAX) {
      void* args[] = {&ll, &alpha, &beta, &sh, &w,     &gamma, &gamma0, &part,
                      &dn, &gw,    &T,    &B,  &K,     &chunk, &t0,     &t1};
      return fbw::launch_dyn(fn, dim3(groups, (t1 - t0 + chunk - 1) / chunk), CNT, smem, st,
                             args);
    }
    void* args[] = {&W,  &feats, &alpha, &beta, &sh, &w, &gamma, &gamma0, &part,
                    &dn, &gw,    &T,     &B,    &K,  &F, &chunk, &t0,     &t1};
    return fbw::launch_dyn(fn, dim3(groups, (t1 - t0 + chunk - 1) / chunk), CNT, smem, st, args);
  }));
}

// What the instance (which, S, K, F) of the launchers above takes on
// `device`: out[0] registers a thread, out[1] static and out[2] dynamic
// shared bytes a block, out[3] local (spilled) bytes a thread, out[4]
// resident blocks an SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor),
// out[5] the device's SMs, out[6] threads a block. which = 0 the chain (S
// sequences a block), 1 the combine, 2 the gated combine (S unused); K > 64
// names the large-K instance of its KP; kind the feature kind; F > FMAX the
// instance on read likelihoods, the same for every such F and kind. out[4]
// is 0 where the card cannot give an instance its shared memory.
int duplex_fb_kernel_info(int which, int S, int K, int F, int kind, int device, int* out) {
  if (bad_shape(1, 1, K, F) || bad_kind(kind, F) || which < 0 || which > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  int smem = 0;
  const void* fn = which == 0 ? chain_of(S, K, F, kind, &smem)
                              : combine_of(K, F, which == 2, kind, &smem);
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const int nt = which != 0 ? CNT : K > KMAX ? fbw::tier_of(K) : NT;
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
  return 0;
}

}  // extern "C"
