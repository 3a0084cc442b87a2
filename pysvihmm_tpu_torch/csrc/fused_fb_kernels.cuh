// The fused pair's kernels and the tables of their instances (fused_fb.cu's
// head describes the kernels), shared by the five translation units of the
// fused_fb library: fused_fb.cu holds the launchers and the default
// instances, fused_fb_modes.cu the modes' instances (the forward's bf16 alpha
// store, the backward's run-time bf16 alpha and pick), fused_fb_wide.cu and
// fused_fb_wide_modes.cu the same two sets for features wider than FMAX (the
// WF instances: fb_seqs_wf.cuh up to K = 64, fb_wide.cuh's chains on read
// likelihoods above), fused_fb_xl.cu the XL instances above 256 states
// (fb_xl.cuh).
// A unit compiles only the instances it names, so the library's instances
// build at once, one nvcc a unit (_build.py).

#pragma once

#include "fb_common.cuh"
#include "fb_seqs.cuh"
#include "fb_seqs_wf.cuh"
#include "fb_stats.cuh"
#include "fb_wide.cuh"

namespace fbf {
namespace {

using fbc::KMAX;
using fbc::NT;
using fbseq::pad_f;

// The forward: fb_seqs.cuh's seq_forward, which the duplex chain runs too.
// KIND: the feature array, or the raw observations of a built kind (the rows
// built on the chip); ABF stores alpha as bf16 into alpha16 (alpha unused).
template <int S, int FP, int KIND, bool ABF>
__global__ void __launch_bounds__(NT)
fused_fwd_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                 const float* __restrict__ W, const float* __restrict__ src,
                 float* __restrict__ alpha, __nv_bfloat16* __restrict__ alpha16,
                 float* __restrict__ s_out, float* __restrict__ sh_out, int T, int B, int K,
                 int F) {
  fbseq::seq_forward<S, FP, true, KIND, ABF>(pi, A, W, src, alpha, s_out, sh_out, T, B, K, F,
                                             blockIdx.x, alpha16);
}

// The backward: fb_seqs.cuh's seq_stats_backward with the features, which
// the split backward runs on read likelihoods. GATED is a template
// parameter, so that the ungated instance carries no trace of the gates: no
// loads, no multiplies, no extra live registers. MODES takes alpha16 (bf16
// alpha) and sel (the per-sequence time pick, gamma0 then the pick) as
// run-time pointers; the default instances read neither.
template <int S, int FP, bool GATED, int KIND, bool MODES>
__global__ void __launch_bounds__(NT)
fused_bwd_kernel(const float* __restrict__ A, const float* __restrict__ W,
                 const float* __restrict__ src, const float* __restrict__ alpha,
                 const __nv_bfloat16* __restrict__ alpha16, const float* __restrict__ s_in,
                 const float* __restrict__ sh_in, const float* __restrict__ w_in,
                 const int* __restrict__ sel, float* __restrict__ gamma,
                 float* __restrict__ gamma0, float* __restrict__ part, int T, int B, int K,
                 int F) {
  extern __shared__ __align__(16) float smem[];
  fbseq::seq_stats_backward<S, FP, true, GATED, KIND, MODES>(A, W, src, alpha, s_in, sh_in, w_in,
                                                             gamma, gamma0, part, T, B, K, F,
                                                             blockIdx.x, smem, alpha16, sel);
}

// The large-K pair: fb_wide.cuh's S-sequence chains at KP padded states.
template <int KP, int S, int KIND, bool ABF>
__global__ void __launch_bounds__(KP)
fused_fwd_wide_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                      const float* __restrict__ W, const float* __restrict__ src,
                      float* __restrict__ alpha, __nv_bfloat16* __restrict__ alpha16,
                      float* __restrict__ s_out, float* __restrict__ sh_out, int T, int B, int K,
                      int F) {
  extern __shared__ __align__(16) float smem[];
  fbw::seqs_forward<KP, S, true, KIND, ABF>(pi, A, W, src, alpha, s_out, sh_out, T, B, K, F,
                                            blockIdx.x, smem, alpha16);
}

template <int KP, int S, bool GATED, int KIND, bool MODES>
__global__ void __launch_bounds__(KP)
fused_bwd_wide_kernel(const float* __restrict__ A, const float* __restrict__ W,
                      const float* __restrict__ src, const float* __restrict__ alpha,
                      const __nv_bfloat16* __restrict__ alpha16, const float* __restrict__ s_in,
                      const float* __restrict__ sh_in, const float* __restrict__ w_in,
                      const int* __restrict__ sel, float* __restrict__ gamma,
                      float* __restrict__ gamma0, float* __restrict__ dn,
                      float* __restrict__ gw, float* __restrict__ carry, int T, int B, int K,
                      int F, int t0, int t1) {
  extern __shared__ __align__(16) float smem[];
  fbw::seqs_backward<KP, S, true, GATED, KIND, MODES>(A, W, src, alpha, s_in, sh_in, w_in,
                                                      gamma, gamma0, dn, gw, carry, T, B, K, F,
                                                      t0, t1, blockIdx.x, smem, alpha16, sel);
}

// The WF instances, at any F. Up to K = 64: the forward's chain on the
// likelihoods fbs::ll_tile summed beforehand (fb_seqs.cuh's seq_forward in
// its ll mode, the split forward's: (pi, A, ll) in place of (pi, A, W, src)),
// and fbwf's backward in two tiers (fb_seqs_wf.cuh): the tiled one, which
// takes the F <= FMAX backward's arguments (one launch; a row of acc partials
// a chain group, of eacc a block) in blocks of fbwf::tiled_plan, and the
// window one over a window [t0, t1) of time steps, which takes the large-K
// backward's on read likelihoods (its `part` in the place of dn: the block's
// rows of acc partials, read back and written each window; gw the window's
// w_t gamma_t; carry b'_{t0-1}) and, holding neither W nor a feature row,
// serves every feature kind and width.
using fbseq::LL_FP;

template <int S, bool ABF>
__global__ void __launch_bounds__(NT)
fused_fwd_wf_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                    const float* __restrict__ ll, float* __restrict__ alpha,
                    __nv_bfloat16* __restrict__ alpha16, float* __restrict__ s_out,
                    float* __restrict__ sh_out, int T, int B, int K) {
  fbseq::seq_forward<S, LL_FP, false, fbc::FEATS_ARRAY, ABF>(
      pi, A, nullptr, ll, alpha, s_out, sh_out, T, B, K, 0, blockIdx.x, alpha16);
}

template <int S, bool GATED, int KIND, bool MODES>
__global__ void __launch_bounds__(fbwf::tiled_max_threads<S>())
fused_bwd_wf_kernel(const float* __restrict__ A, const float* __restrict__ W,
                    const float* __restrict__ src, const float* __restrict__ alpha,
                    const __nv_bfloat16* __restrict__ alpha16, const float* __restrict__ s_in,
                    const float* __restrict__ sh_in, const float* __restrict__ w_in,
                    const int* __restrict__ sel, float* __restrict__ gamma,
                    float* __restrict__ gamma0, float* __restrict__ part, int T, int B, int K,
                    int F) {
  extern __shared__ __align__(16) float smem[];
  fbwf::seq_backward_tiled<S, GATED, KIND, MODES>(A, W, src, alpha, alpha16, s_in, sh_in, w_in,
                                                  sel, gamma, gamma0, part, T, B, K, F,
                                                  blockIdx.x, smem);
}

template <int S, bool GATED, bool MODES>
__global__ void __launch_bounds__(NT)
fused_bwd_wf_window_kernel(const float* __restrict__ A, const float* __restrict__ ll,
                           const float* __restrict__ alpha,
                           const __nv_bfloat16* __restrict__ alpha16,
                           const float* __restrict__ s_in, const float* __restrict__ sh_in,
                           const float* __restrict__ w_in, const int* __restrict__ sel,
                           float* __restrict__ gamma, float* __restrict__ gamma0,
                           float* __restrict__ part, float* __restrict__ gw,
                           float* __restrict__ carry, int T, int B, int K, int t0, int t1) {
  extern __shared__ __align__(16) float smem[];
  fbwf::seq_backward_window<S, GATED, MODES>(A, ll, alpha, alpha16, s_in, sh_in, w_in, sel, gamma,
                                             gamma0, gw, carry, part, T, B, K, t0, t1,
                                             blockIdx.x, smem);
}

// Above K = 64: the forward's and the backward's chains on a window's
// likelihoods, which fbs::ll_tile sums beforehand from the window's feature
// rows (a built kind's built as staged): the forward the split forward's
// chain (fb_wide.cuh's seqs_forward without FEATS) over the window [t0, t1),
// carrying its float32 state between windows in `carry`; the backward
// fbs::WideStats' windows (fb_wide.cuh's LL). Neither holds W nor a feature
// row, so one instance serves every feature kind and width.
template <int KP, int S, bool ABF>
__global__ void __launch_bounds__(KP)
fused_fwd_wide_ll_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                         const float* __restrict__ ll, float* __restrict__ alpha,
                         __nv_bfloat16* __restrict__ alpha16, float* __restrict__ s_out,
                         float* __restrict__ sh_out, float* __restrict__ carry, int T, int B,
                         int K, int t0, int t1) {
  extern __shared__ __align__(16) float smem[];
  fbw::seqs_forward<KP, S, false, fbc::FEATS_ARRAY, ABF>(pi, A, nullptr, ll, alpha, s_out,
                                                         sh_out, T, B, K, 0, blockIdx.x, smem,
                                                         alpha16, t0, t1, carry);
}

template <int KP, int S, bool GATED, bool MODES>
__global__ void __launch_bounds__(KP)
fused_bwd_wide_wf_kernel(const float* __restrict__ A, const float* __restrict__ ll,
                         const float* __restrict__ alpha,
                         const __nv_bfloat16* __restrict__ alpha16,
                         const float* __restrict__ s_in, const float* __restrict__ sh_in,
                         const float* __restrict__ w_in, const int* __restrict__ sel,
                         float* __restrict__ gamma, float* __restrict__ gamma0,
                         float* __restrict__ dn, float* __restrict__ gw,
                         float* __restrict__ carry, int T, int B, int K, int t0, int t1) {
  extern __shared__ __align__(16) float smem[];
  fbw::seqs_backward<KP, S, true, GATED, fbc::FEATS_ARRAY, MODES, true>(
      A, nullptr, ll, alpha, s_in, sh_in, w_in, gamma, gamma0, dn, gw, carry, T, B, K,
      fbc::FMAX, t0, t1, blockIdx.x, smem, alpha16, sel);
}

// The WF instance of (which, S, K, F, KIND, M) and its dynamic shared memory
// at F: S in {2, 4} up to K = 64, {1, 2, 4, 8} above, as the instances for F
// <= FMAX; up to K = 64 the backward's tier by fbwf::tiled_fits (the window
// tier's shared memory does not grow with F). Null for an S not built.
template <int S, int KIND, bool M>
const void* wf_at(int which, int F, int* smem) {
  if (which == 0) {  // every kind: the chain reads the likelihoods
    *smem = 0;
    return reinterpret_cast<const void*>(fused_fwd_wf_kernel<S, M>);
  }
  if (fbwf::tiled_fits<S>(F)) {
    *smem = fbwf::tiled_smem<S>(F);
    return which == 1 ? reinterpret_cast<const void*>(fused_bwd_wf_kernel<S, false, KIND, M>)
                      : reinterpret_cast<const void*>(fused_bwd_wf_kernel<S, true, KIND, M>);
  }
  *smem = fbwf::window_smem<S>();
  return which == 1 ? reinterpret_cast<const void*>(fused_bwd_wf_window_kernel<S, false, M>)
                    : reinterpret_cast<const void*>(fused_bwd_wf_window_kernel<S, true, M>);
}

// Whether the backward (S, K, F) is the WF instance's tiled tier (up to K =
// 64 at F > FMAX, where fbwf::tiled_fits; every feature kind alike), which
// takes the F <= FMAX backward's arguments in blocks of wf_tiled_plan.
inline bool wf_tiled(int S, int K, int F) {
  if (K > KMAX || F <= fbc::FMAX) return false;
  return S == 2 ? fbwf::tiled_fits<2>(F) : S == 4 ? fbwf::tiled_fits<4>(F) : false;
}

inline fbwf::TiledPlan wf_tiled_plan(int S, int F) {
  return S == 2 ? fbwf::tiled_plan<2>(F) : fbwf::tiled_plan<4>(F);
}

// Above K = 64 one instance a (which, KP, S, M) serves every kind and F.
template <int KP, int S, bool M>
const void* wf_wide_at(int which, int* smem) {
  *smem = fbw::chain_smem_bytes<KP, S>();
  if (which == 0) return reinterpret_cast<const void*>(fused_fwd_wide_ll_kernel<KP, S, M>);
  return which == 1 ? reinterpret_cast<const void*>(fused_bwd_wide_wf_kernel<KP, S, false, M>)
                    : reinterpret_cast<const void*>(fused_bwd_wide_wf_kernel<KP, S, true, M>);
}

template <int KP, bool M>
const void* wf_wide_of(int which, int S, int* smem) {
  switch (S) {
    case 1: return wf_wide_at<KP, 1, M>(which, smem);
    case 2: return wf_wide_at<KP, 2, M>(which, smem);
    case 4: return wf_wide_at<KP, 4, M>(which, smem);
    case 8: return wf_wide_at<KP, 8, M>(which, smem);
    default: *smem = 0; return nullptr;
  }
}

template <int KIND, bool M>
const void* wf_instance_of(int which, int S, int K, int F, int* smem) {
  if (K <= KMAX) {
    if (S == 2) return wf_at<2, KIND, M>(which, F, smem);
    if (S == 4) return wf_at<4, KIND, M>(which, F, smem);
    *smem = 0;
    return nullptr;
  }
  return fbw::tier_of(K) == 128 ? wf_wide_of<128, M>(which, S, smem)
                                : wf_wide_of<256, M>(which, S, smem);
}

template <bool M>
const void* wf_instance_m(int which, int S, int K, int F, int kind, int* smem) {
  switch (kind) {
    case fbc::FEATS_ARRAY: return wf_instance_of<fbc::FEATS_ARRAY, M>(which, S, K, F, smem);
    case fbc::FEATS_NIW: return wf_instance_of<fbc::FEATS_NIW, M>(which, S, K, F, smem);
    case fbc::FEATS_NIG: return wf_instance_of<fbc::FEATS_NIG, M>(which, S, K, F, smem);
    default: *smem = 0; return nullptr;
  }
}

// The built instances: S in {2, 4} sequences a block, FP = pad_f(F), for
// each feature kind (both built kinds reach every FP at F <= FMAX: the NIW
// up to D = 9, F = 55; the NIG up to D = 31, F = 63), each in its default
// form and its modes' (M: the forward's bf16 alpha, the backward's run-time
// bf16 alpha and pick).
template <int S, int KIND, bool M>
const void* fwd_of(int fp) {
  switch (fp) {
    case 16: return reinterpret_cast<const void*>(fused_fwd_kernel<S, 16, KIND, M>);
    case 32: return reinterpret_cast<const void*>(fused_fwd_kernel<S, 32, KIND, M>);
    case 48: return reinterpret_cast<const void*>(fused_fwd_kernel<S, 48, KIND, M>);
    default: return reinterpret_cast<const void*>(fused_fwd_kernel<S, 64, KIND, M>);
  }
}

template <int S, bool GATED, int KIND, bool M>
const void* bwd_of(int fp) {
  switch (fp) {
    case 16: return reinterpret_cast<const void*>(fused_bwd_kernel<S, 16, GATED, KIND, M>);
    case 32: return reinterpret_cast<const void*>(fused_bwd_kernel<S, 32, GATED, KIND, M>);
    case 48: return reinterpret_cast<const void*>(fused_bwd_kernel<S, 48, GATED, KIND, M>);
    default: return reinterpret_cast<const void*>(fused_bwd_kernel<S, 64, GATED, KIND, M>);
  }
}

// The kernel of (which, S, F, KIND, M): which = 0 forward, 1 backward, 2
// gated backward; its dynamic shared memory in *smem. Null for an S not
// built.
template <int KIND, bool M>
const void* kernel_of(int which, int S, int F, int* smem) {
  const int fp = pad_f(F);
  *smem = 0;
  switch (S) {
#define FB_CASE(SS)                                                    \
  case SS:                                                             \
    if (which == 0) return fwd_of<SS, KIND, M>(fp);                    \
    *smem = fbseq::stats_smem_bytes(SS, fp, true);                     \
    return which == 1 ? bwd_of<SS, false, KIND, M>(fp) : bwd_of<SS, true, KIND, M>(fp);
    FB_CASE(2)
    FB_CASE(4)
#undef FB_CASE
    default: return nullptr;
  }
}

// The large-K instance of (which, KP, S, KIND, M), its dynamic shared memory
// in *smem: S in {1, 2, 4, 8} sequences a block. Null for an S not built.
template <int KP, int S, int KIND, bool M>
const void* wide_at(int which, int* smem) {
  *smem = fbw::chain_smem_bytes<KP, S>();
  if (which == 0) return reinterpret_cast<const void*>(fused_fwd_wide_kernel<KP, S, KIND, M>);
  return which == 1
             ? reinterpret_cast<const void*>(fused_bwd_wide_kernel<KP, S, false, KIND, M>)
             : reinterpret_cast<const void*>(fused_bwd_wide_kernel<KP, S, true, KIND, M>);
}

template <int KP, int KIND, bool M>
const void* wide_of(int which, int S, int* smem) {
  switch (S) {
    case 1: return wide_at<KP, 1, KIND, M>(which, smem);
    case 2: return wide_at<KP, 2, KIND, M>(which, smem);
    case 4: return wide_at<KP, 4, KIND, M>(which, smem);
    case 8: return wide_at<KP, 8, KIND, M>(which, smem);
    default: *smem = 0; return nullptr;
  }
}

// The kernel of (which, S, K, F, KIND, M) and its dynamic shared memory: the
// S instance at FP = pad_f(F) up to KMAX states, the large-K one at KP =
// tier_of(K) above. Null for an S not built.
template <int KIND, bool M>
const void* instance_of(int which, int S, int K, int F, int* smem) {
  if (K <= KMAX) return kernel_of<KIND, M>(which, S, F, smem);
  return fbw::tier_of(K) == 128 ? wide_of<128, KIND, M>(which, S, smem)
                                : wide_of<256, KIND, M>(which, S, smem);
}

template <bool M>
const void* instance_m(int which, int S, int K, int F, int kind, int* smem) {
  switch (kind) {
    case fbc::FEATS_ARRAY: return instance_of<fbc::FEATS_ARRAY, M>(which, S, K, F, smem);
    case fbc::FEATS_NIW: return instance_of<fbc::FEATS_NIW, M>(which, S, K, F, smem);
    case fbc::FEATS_NIG: return instance_of<fbc::FEATS_NIG, M>(which, S, K, F, smem);
    default: *smem = 0; return nullptr;
  }
}

}  // namespace

// The modes' instance of (which, S, K, F, kind) (instance_m<true>, defined
// in fused_fb_modes.cu), its dynamic shared memory in *smem; null for an S
// or a kind not built.
const void* modes_instance(int which, int S, int K, int F, int kind, int* smem);

// The WF instances at F > FMAX, default and modes' (wf_instance_m<false>
// and <true>, defined in fused_fb_wide.cu and fused_fb_wide_modes.cu).
const void* wf_default_instance(int which, int S, int K, int F, int kind, int* smem);
const void* wf_modes_instance(int which, int S, int K, int F, int kind, int* smem);

// The XL instances above fbw::KWIDE states (fused_fb_xl.cu): one a (which,
// KP, S) for every kind and F, the default mode only; null for an S not
// built.
const void* xl_instance(int which, int S, int K, int* smem);

}  // namespace fbf
