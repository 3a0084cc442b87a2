// The fused pair's modes' instances at features wider than fbc::FMAX (the
// WF instances of fused_fb_kernels.cuh: fb_seqs_wf.cuh up to K = 64,
// fb_wide.cuh's WF flag above) for every S, feature kind and gate. A
// translation unit of the fused_fb library, compiled by its own nvcc beside
// fused_fb.cu (_build.py), whose launchers reach these instances through
// fbf::wf_modes_instance.

#include "fused_fb_kernels.cuh"

namespace fbf {

const void* wf_modes_instance(int which, int S, int K, int F, int kind, int* smem) {
  return wf_instance_m<true>(which, S, K, F, kind, smem);
}

}  // namespace fbf
