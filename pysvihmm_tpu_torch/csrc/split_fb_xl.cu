// The split pair's XL instances (257 <= K <= 1024; fb_xl.cuh holds their
// layout): split_fwd_xl_kernel<KP, S> and split_bwd_xl_kernel<KP, S, GATED>
// for KP = 512 and 1024 and S = 1, 2, 4, 8, the large-K chains
// (fbw::seqs_forward on read likelihoods, fbw::seqs_backward without the
// features) reading A~ (A~^T) from device memory. They replace the split
// E-step's TPU kernels above 256 states, as split_fb.cu's instances do up
// to it:
//   split_fwd_xl_kernel  <- pysvihmm_tpu/messages/pallas_fb.py:339 (_fwd_kernel, log_in)
//   split_bwd_xl_kernel  <- pysvihmm_tpu/messages/pallas_fb.py:406 (_bwd_kernel)
// A translation unit of the split_fb library, compiled by its own nvcc
// beside split_fb.cu (_build.py), whose launchers reach these instances
// through split_xl_instance. Their arguments are the large-K instances'
// (alpha16 unused: bf16 alpha has no XL instance).

#include "fb_xl.cuh"

namespace {

template <int KP, int S>
__global__ void __launch_bounds__(KP)
split_fwd_xl_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                    const float* __restrict__ ll, float* __restrict__ alpha,
                    __nv_bfloat16* __restrict__, float* __restrict__ s_out,
                    float* __restrict__ sh_out, int T, int B, int K) {
  extern __shared__ __align__(16) float smem[];
  fbw::seqs_forward<KP, S, false>(pi, A, nullptr, ll, alpha, s_out, sh_out, T, B, K, 0,
                                  blockIdx.x, smem);
}

// AT is A~^T (the launcher's copy).
template <int KP, int S, bool GATED>
__global__ void __launch_bounds__(KP)
split_bwd_xl_kernel(const float* __restrict__ AT, const float* __restrict__ ll,
                    const float* __restrict__ alpha, const __nv_bfloat16* __restrict__,
                    const float* __restrict__ s_in, const float* __restrict__ sh_in,
                    const float* __restrict__ w_in, float* __restrict__ gamma,
                    float* __restrict__ dn, float* __restrict__ carry, int T, int B, int K,
                    int t0, int t1) {
  extern __shared__ __align__(16) float smem[];
  fbw::seqs_backward<KP, S, false, GATED>(AT, nullptr, ll, alpha, s_in, sh_in, w_in, gamma,
                                          nullptr, dn, nullptr, carry, T, B, K, 0, t0, t1,
                                          blockIdx.x, smem);
}

// The pair's kernels by (KP, S, GATED), for fbw::xl_pick.
struct SplitXl {
  template <int KP, int S>
  static const void* forward() {
    return reinterpret_cast<const void*>(split_fwd_xl_kernel<KP, S>);
  }
  template <int KP, int S, bool GATED>
  static const void* backward() {
    return reinterpret_cast<const void*>(split_bwd_xl_kernel<KP, S, GATED>);
  }
};

}  // namespace

// The XL instance of (which, S, K): which = 0 forward, 1 backward, 2 gated
// backward, at KP = fbw::xl_tier_of(K); its dynamic shared memory in *smem.
// Null for an S not built.
const void* split_xl_instance(int which, int S, int K, int* smem) {
  return fbw::xl_pick<SplitXl>(which, S, K, smem);
}
