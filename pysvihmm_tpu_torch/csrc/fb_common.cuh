// Device code shared by the forward-backward kernels of fused_fb.cu,
// split_fb.cu, duplex_fb.cu and split_probe.cu: one thread per state (KMAX
// threads), the widths the kernels take, the per-sequence sum floor and the
// warp reductions; and, for the sources with one block per sequence, the A~
// and W loaders and the in-kernel likelihood dot, whose fmaf order
// fused_fb.cu's own loops keep. Each .cu still builds into its own
// library; _build.py hashes this header into the name of every library whose
// source includes it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace fbc {

constexpr int KMAX = 64;  // threads per block; largest K the kernels take
constexpr int NT = KMAX;
constexpr int NWARP = NT / 32;
constexpr int FMAX = 64;  // largest feature width F the in-kernel likelihood takes
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

// A~ (K, K) row-major into shared memory, zero outside (K, K), with row
// stride `stride` (KMAX, or KMAX + 1 for a copy read by rows and by columns
// without bank conflicts): row-major (A_s[i * stride + j] = A~[i][j]) for the
// forward's a @ A~, or transposed (A_s[j * stride + i] = A~[i][j]) for the
// backward's d @ A~^T, so that thread i reads consecutive words of its own
// row. `nthreads` is the block's thread count.
__device__ __forceinline__ void load_A(const float* __restrict__ A, float* A_s, int K,
                                       bool transposed, int stride = KMAX,
                                       int nthreads = NT) {
  for (int idx = threadIdx.x; idx < KMAX * KMAX; idx += nthreads) {
    const int r = idx / KMAX, c = idx % KMAX;
    const int i = transposed ? c : r, j = transposed ? r : c;
    A_s[r * stride + c] = (i < K && j < K) ? A[i * K + j] : 0.f;
  }
}

// W (F, K) row-major -> W_s[f * KMAX + k], zero outside (F, K).
__device__ __forceinline__ void load_W(const float* __restrict__ W, float* W_s, int K,
                                       int F, int nthreads = NT) {
  for (int idx = threadIdx.x; idx < FMAX * KMAX; idx += nthreads) {
    const int f = idx / KMAX, k = idx % KMAX;
    W_s[idx] = (f < F && k < K) ? W[f * K + k] : 0.f;
  }
}

// One step's log-likelihood for state k, ll = f . W[:, k]: the same explicit
// fmaf chain in every kernel that computes it, so a recomputation matches the
// first computation bit for bit.
__device__ __forceinline__ float ll_dot(const float* f, const float* W_s, int k, int F) {
  float acc = 0.f;
  for (int i = 0; i < F; ++i) acc = fmaf(f[i], W_s[i * KMAX + k], acc);
  return acc;
}

}  // namespace fbc
