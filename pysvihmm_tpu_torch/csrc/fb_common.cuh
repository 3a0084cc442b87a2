// Device code shared by the forward-backward kernels of fused_fb.cu,
// split_fb.cu, duplex_fb.cu and split_probe.cu: one thread per state (KMAX
// threads), the widths the kernels take, the per-sequence sum floor and the
// warp reductions; the feature kinds (the feature array, or the features
// built on the chip from a Gaussian family's raw observations); and, for the
// sources with one block per sequence, the A~ loader. Each .cu still builds
// into its own library; _build.py hashes this header into the name of every
// library whose source includes it.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace fbc {

constexpr int KMAX = 64;  // threads per block; largest K the kernels take
constexpr int NT = KMAX;
constexpr int NWARP = NT / 32;
constexpr int FMAX = 64;  // largest feature width F the in-kernel likelihood takes
constexpr float SUM_FLOOR = 1e-38f;  // per-sequence sum floor (pallas_fb.py:82)

// What the fused and duplex kernels read a (t, b) row of: the (T, B, F)
// feature array (FEATS_ARRAY), or a Gaussian family's raw (T, B, D)
// observations, from which they build the features on the chip
// (pallas_fb.py:287 `_build_feats`): [1, y, triu(y y^T) row-major]
// (FEATS_NIW, distributions/niw.py::ell_features) or [1, y, y * y]
// (FEATS_NIG, distributions/diag_gaussian.py::ell_features).
constexpr int FEATS_ARRAY = 0;
constexpr int FEATS_NIW = 1;
constexpr int FEATS_NIG = 2;

// The feature width of `kind` at D observation dimensions (D for the array).
__host__ __device__ constexpr int feat_width(int kind, int D) {
  return kind == FEATS_NIW ? 1 + D + D * (D + 1) / 2 : kind == FEATS_NIG ? 1 + 2 * D : D;
}

// The floats of one input row: D, whose features are F wide, for a built
// kind (-1 when no D gives F); F for the array.
__host__ __device__ inline int obs_dim(int kind, int F) {
  if (kind == FEATS_ARRAY) return F;
  for (int D = 1; feat_width(kind, D) <= F; ++D)
    if (feat_width(kind, D) == F) return D;
  return -1;
}

// Where feature f of a built row comes from: the constant 1 (ia < 0), y[ia]
// (ja < 0) or y[ia] y[ja] (ia <= ja), in ell_features' order.
__host__ __device__ inline void feat_src(int kind, int D, int f, int& ia, int& ja) {
  ia = ja = -1;
  if (f == 0) return;
  if (f <= D) {
    ia = f - 1;
    return;
  }
  int q = f - 1 - D;
  if (kind == FEATS_NIG) {
    ia = ja = q;
    return;
  }
  int i = 0;
  while (q >= D - i) {
    q -= D - i;
    ++i;
  }
  ia = i;
  ja = i + q;
}

// A built feature from its factors: x alone, or one float32 product rounded
// and kept as it is (__fmul_rn is never contracted into an FMA), so that a
// built row holds the bits of ell_features' float32 output.
__device__ __forceinline__ float feat_of(float x, float y, bool product) {
  return product ? __fmul_rn(x, y) : x;
}

// Feature f of the observation row y (D floats).
template <int KIND>
__device__ __forceinline__ float feat_at(const float* __restrict__ y, int D, int f) {
  int ia, ja;
  feat_src(KIND, D, f, ia, ja);
  return ia < 0 ? 1.f : feat_of(y[ia], ja < 0 ? 0.f : y[ja], ja >= 0);
}

// alpha as the kernels store it: float32, or bf16 (round to nearest) where
// a16 is not null; the chain itself always carries float32.
__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

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

constexpr unsigned FULL = 0xffffffffu;

// The butterflies of warp_sum and warp_max for S sequences at once, their
// shuffles interleaved: each sequence's sum (max) is taken in the same order
// as warp_sum's (warp_max's), bit for bit.
template <int S>
__device__ __forceinline__ void warp_sums(float (&v)[S]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) v[s] += __shfl_xor_sync(FULL, v[s], o);
  }
}

template <int S>
__device__ __forceinline__ void warp_maxes(float (&m)[S]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) m[s] = fmaxf(m[s], __shfl_xor_sync(FULL, m[s], o));
  }
}

template <int S>
__device__ __forceinline__ void warp_sums_maxes(float (&v)[S], float (&m)[S]) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
      v[s] += __shfl_xor_sync(FULL, v[s], o);
      m[s] = fmaxf(m[s], __shfl_xor_sync(FULL, m[s], o));
    }
  }
}

// A~ (K, K) row-major into shared memory, zero outside (K, K), with row
// stride `stride`: row-major (A_s[i * stride + j] = A~[i][j]) for the
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

}  // namespace fbc
