// Device code shared by the forward-backward kernels of fused_fb.cu and
// split_fb.cu: the block layout (one block per sequence, one thread per
// state), the per-sequence sum floor and the warp reductions. Each .cu still
// builds into its own library; _build.py hashes this header into the name of
// every library whose source includes it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fbc {

constexpr int KMAX = 64;  // threads per block; largest K the kernels take
constexpr int NT = KMAX;
constexpr int NWARP = NT / 32;
constexpr float SUM_FLOOR = 1e-38f;  // per-sequence sum floor (pallas_fb.py:82)

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// A~ (K, K) row-major into shared memory, zero outside (K, K): row-major
// (A_s[i * KMAX + j] = A~[i][j]) for the forward's a @ A~, or transposed
// (A_s[j * KMAX + i] = A~[i][j]) for the backward's d @ A~^T, so that thread
// i reads consecutive words of its own row without bank conflicts.
__device__ __forceinline__ void load_A(const float* __restrict__ A, float* A_s, int K,
                                       bool transposed) {
  for (int idx = threadIdx.x; idx < KMAX * KMAX; idx += NT) {
    const int r = idx / KMAX, c = idx % KMAX;
    const int i = transposed ? c : r, j = transposed ? r : c;
    A_s[idx] = (i < K && j < K) ? A[i * K + j] : 0.f;
  }
}

}  // namespace fbc
