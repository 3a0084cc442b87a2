// The fused pair's XL instances (257 <= K <= 1024; fb_xl.cuh holds their
// layout), at every F and feature kind: above 256 states there is no room
// for W beside A~'s traffic, so both chains read likelihoods that
// fbs::ll_tile sums beforehand from each window's feature rows (a built
// kind's built as staged), as the large-K WF instances do:
//   fused_fwd_xl_kernel<KP, S> <- pysvihmm_tpu/messages/pallas_fb.py:516 (_fwd_kernel_fused):
//     fbw::seqs_forward on the window's likelihoods over [t0, t1), its
//     float32 state a_{t0-1}, 1 / s_{t0-1} carried between windows;
//   fused_bwd_xl_kernel<KP, S, GATED> <- pysvihmm_tpu/messages/pallas_fb.py:577
//     (_bwd_kernel_fused):
//     fbw::seqs_backward's LL chain on fbs::WideStats' windows, reading
//     A~^T (the launcher's copy), writing w_t gamma_t and the gated d_t n_t
//     for the outer sums.
// KP = 512 or 1024, S = 1, 2, 4, 8. A translation unit of the fused_fb
// library, compiled by its own nvcc beside fused_fb.cu (_build.py), whose
// launchers reach these instances through fbf::xl_instance. Their
// arguments are the large-K WF instances' (alpha16 and sel unused: bf16
// alpha and the pick have no XL instance).

#include "fused_fb_kernels.cuh"
#include "fb_xl.cuh"

namespace fbf {
namespace {

template <int KP, int S>
__global__ void __launch_bounds__(KP)
fused_fwd_xl_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                    const float* __restrict__ ll, float* __restrict__ alpha,
                    __nv_bfloat16* __restrict__, float* __restrict__ s_out,
                    float* __restrict__ sh_out, float* __restrict__ carry, int T, int B, int K,
                    int t0, int t1) {
  extern __shared__ __align__(16) float smem[];
  fbw::seqs_forward<KP, S, false>(pi, A, nullptr, ll, alpha, s_out, sh_out, T, B, K, 0,
                                  blockIdx.x, smem, nullptr, t0, t1, carry);
}

template <int KP, int S, bool GATED>
__global__ void __launch_bounds__(KP)
fused_bwd_xl_kernel(const float* __restrict__ AT, const float* __restrict__ ll,
                    const float* __restrict__ alpha, const __nv_bfloat16* __restrict__,
                    const float* __restrict__ s_in, const float* __restrict__ sh_in,
                    const float* __restrict__ w_in, const int* __restrict__,
                    float* __restrict__ gamma, float* __restrict__ gamma0,
                    float* __restrict__ dn, float* __restrict__ gw, float* __restrict__ carry,
                    int T, int B, int K, int t0, int t1) {
  extern __shared__ __align__(16) float smem[];
  fbw::seqs_backward<KP, S, true, GATED, fbc::FEATS_ARRAY, false, true>(
      AT, nullptr, ll, alpha, s_in, sh_in, w_in, gamma, gamma0, dn, gw, carry, T, B, K,
      fbc::FMAX, t0, t1, blockIdx.x, smem);
}

// The pair's kernels by (KP, S, GATED), for fbw::xl_pick.
struct FusedXl {
  template <int KP, int S>
  static const void* forward() {
    return reinterpret_cast<const void*>(fused_fwd_xl_kernel<KP, S>);
  }
  template <int KP, int S, bool GATED>
  static const void* backward() {
    return reinterpret_cast<const void*>(fused_bwd_xl_kernel<KP, S, GATED>);
  }
};

}  // namespace

const void* xl_instance(int which, int S, int K, int* smem) {
  return fbw::xl_pick<FusedXl>(which, S, K, smem);
}

}  // namespace fbf
