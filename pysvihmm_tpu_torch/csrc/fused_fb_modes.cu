// The modes' instances of the fused pair (fused_fb_kernels.cuh): the
// forward that stores alpha as bf16 and the backward that takes bf16 alpha
// and the per-sequence gamma pick as run-time pointers, for every S, FP,
// feature kind and gate. The second translation unit of the fused_fb
// library, compiled by its own nvcc beside fused_fb.cu (_build.py), whose
// launchers reach these instances through fbf::modes_instance.

#include "fused_fb_kernels.cuh"

namespace fbf {

const void* modes_instance(int which, int S, int K, int F, int kind, int* smem) {
  return instance_m<true>(which, S, K, F, kind, smem);
}

}  // namespace fbf
