// The duplex pair's instances for features wider than fbc::FMAX, which read
// the likelihoods fbs::ll_tile sums beforehand: the chain
// (duplex_chain_ll_kernel up to K = 64, duplex_chain_wide_ll_kernel above)
// for every S, and the combine (duplex_combine_ll_kernel) for every KP and
// gate; none depends on the feature kind or width. A translation unit of
// the duplex_fb library, compiled by its own nvcc beside duplex_fb.cu
// (_build.py), whose launchers reach these instances through
// fbd::ll_chain_instance and fbd::ll_combine_instance; only this unit
// instantiates them.

#include "duplex_fb_kernels.cuh"

namespace fbd {
namespace {

template <int KP>
const void* wide_ll_chain(int S, int* smem) {
  switch (S) {
    case 1: *smem = fbw::chain_smem_bytes<KP, 1>();
      return reinterpret_cast<const void*>(duplex_chain_wide_ll_kernel<KP, 1>);
    case 2: *smem = fbw::chain_smem_bytes<KP, 2>();
      return reinterpret_cast<const void*>(duplex_chain_wide_ll_kernel<KP, 2>);
    case 4: *smem = fbw::chain_smem_bytes<KP, 4>();
      return reinterpret_cast<const void*>(duplex_chain_wide_ll_kernel<KP, 4>);
    case 8: *smem = fbw::chain_smem_bytes<KP, 8>();
      return reinterpret_cast<const void*>(duplex_chain_wide_ll_kernel<KP, 8>);
    default: *smem = 0; return nullptr;
  }
}

template <int KP>
const void* ll_combine_at(bool gated) {
  return gated ? reinterpret_cast<const void*>(duplex_combine_ll_kernel<KP, true>)
               : reinterpret_cast<const void*>(duplex_combine_ll_kernel<KP, false>);
}

}  // namespace

// The chain of (S, K): S in {2, 4} up to K = 64 (static shared memory, none
// dynamic), {1, 2, 4, 8} at KP = tier_of(K) above (fbw::chain_smem_bytes).
const void* ll_chain_instance(int S, int K, int* smem) {
  if (K > KMAX)
    return fbw::tier_of(K) == 128 ? wide_ll_chain<128>(S, smem) : wide_ll_chain<256>(S, smem);
  *smem = 0;
  switch (S) {
    case 2: return reinterpret_cast<const void*>(duplex_chain_ll_kernel<2>);
    case 4: return reinterpret_cast<const void*>(duplex_chain_ll_kernel<4>);
    default: return nullptr;
  }
}

// The combine of (K, gated): KP = 64 up to K = 64, KP = tier_of(K) above; no
// dynamic shared memory.
const void* ll_combine_instance(int K, bool gated) {
  if (K <= KMAX) return ll_combine_at<KMAX>(gated);
  return fbw::tier_of(K) == 128 ? ll_combine_at<128>(gated) : ll_combine_at<256>(gated);
}

}  // namespace fbd
