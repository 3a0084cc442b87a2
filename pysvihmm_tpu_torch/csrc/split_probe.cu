// Probes of the split forward chain for NVIDIA Hopper (sm_90a): variants of
// the forward recursion that each leave out or change one part of it, so that
// their times split the split forward kernel's time into products, stores,
// scales, the shift and exp, bf16 and interleaving.
//
// Replaces the three Pallas TPU kernels of scripts/debug_pallas_split.py:
//   probe_fwd_nos_kernel              <- :25 (_fwd_nos, launched at :166)
//   probe_fwd_stack_kernel            <- :48 (_fwd_stack, launched at :182)
//   probe_micro_kernel<BODY, OUT_T>   <- :203 (make_micro's kern, launched at
//       :211), one instance per body: DOT_ONLY (:229), DOT_STORE (:235),
//       BF16 (:241) and CHUNKED (:250, 8 and 4 chunks at :268, :270)
// The host wrappers and the plain PyTorch twins live in
// pysvihmm_tpu_torch/messages/split_probe.py.
//
// What is computed, per sequence, over tiles of C steps (tile j holds steps
// jC .. jC+C-1; the TPU grid's time axis becomes a loop inside the block):
//   fwd_nos:   a = pi * lik_0 at t = 0, stored to alpha; at every other step
//              if (t % C) % 4 == 0: a = a / sum_k a
//              a = (a @ A) * lik_t, stored to alpha.
//              (The division at a tile's first step is the TPU kernel's
//              carry = a / sum(a) at the previous tile's end.) Raw lik in,
//              no scale output, no shift, no floor.
//   fwd_stack: the same chain, dividing by the sum of the previous stored a,
//              and each stored a's sum written to s (T, B).
//   micro:     a tile starts from a = pi * lik_0 (tile 0) or the carry, then
//              takes C products a = a @ A, with no likelihood. DOT_ONLY stores
//              only the last product, at row jC (rows jC+1 .. jC+C-1 stay
//              unwritten, as on the TPU); DOT_STORE and CHUNKED store each
//              product at its own row; BF16 rounds A to bf16 once and a before
//              each product, sums the exact products in float32 with fmaf and
//              stores alpha as bf16. The carry is the last product times 1e-20
//              (float32), which makes the third tile subnormal and the fourth
//              underflow: the library is built without -ftz or fast math, so
//              subnormals are kept.
//
// Layout: as split_fb.cu, one block per sequence and one thread per state
// (K <= KMAX = 64), A in shared memory (row-major; thread k reads column k,
// conflict-free), the whole T loop inside the block, block sums through
// fbc::warp_sum and shared partials. CHUNKED is the one exception and the
// reading of the TPU's interleaved chunks on this card: one block carries
// NSEQ independent sequences (8 or 4), NSEQ * KMAX threads, A in shared
// memory once for all of them, every chain's product issued before its
// store; a ragged last block is masked. Arrays are time-major: lik and alpha
// (T, B, K), s (T, B); pi (K,), A (K, K).
//
// What bounds it on this card: per (t, b) fwd_nos and fwd_stack move 8K
// bytes (lik in, alpha out) for about 2K^2 flops; the micro bodies read only
// lik_0 and write 4K (DOT_STORE, CHUNKED), 2K (BF16) or 4K / C (DOT_ONLY)
// bytes for 2K^2 flops. At K = 64, B = 1024, T = 1000 the least times are
// 0.16 ms (bytes) for the forwards, 0.125 ms (float32 flops) for the float32
// micro bodies and 0.04 ms (bytes) for BF16. Like the split forward, each
// block walks a chain of T dependent steps, each a K-wide matvec through
// shared memory and one barrier, so the chain's latency bounds them; the
// design keeps the next step's lik in a register one step ahead and
// double-buffers a and the partial sums (one barrier per product), and
// CHUNKED tests whether more chains per block hide more of that latency.

#include <cuda_bf16.h>

#include <type_traits>

#include "fb_common.cuh"

namespace {

using fbc::KMAX;
using fbc::NT;
using fbc::NWARP;
using fbc::warp_sum;

enum Body { DOT_ONLY = 0, DOT_STORE = 1, BF16 = 2, CHUNKED = 3 };

// Sum of v over the block's first NT threads (one sequence); red holds
// NWARP partials, and the caller alternates two of them so that one barrier
// per call suffices.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const float w = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = w;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int i = 1; i < NWARP; ++i) s += red[i];
  return s;
}

// (a @ A)[k] for a in shared memory: column k of the row-major A_s, which is
// zero outside (K, K), so idle threads get 0.
__device__ __forceinline__ float col_dot(const float* a_s, const float* A_s, int k, int K) {
  float u = 0.f;
  for (int i = 0; i < K; ++i) u = fmaf(a_s[i], A_s[i * KMAX + k], u);
  return u;
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The chain of both forward probes, one sequence per block. STACK:
// fwd_stack (divide by the previous stored a's sum, write s) instead of
// fwd_nos (divide by a fresh sum, no s). p % 4 == 0 takes in p == 0, the
// TPU kernel's carry = a / sum(a) at the end of the previous tile.
template <bool STACK>
__device__ __forceinline__ void fwd_chain(const float* __restrict__ pi,
                                          const float* __restrict__ A,
                                          const float* __restrict__ lik,
                                          float* __restrict__ alpha,
                                          float* __restrict__ s_out, int T, int B, int K,
                                          int C) {
  __shared__ float A_s[KMAX * KMAX];  // A[i][k] at i * KMAX + k
  __shared__ float a_s[2][KMAX];      // the product's operand, alternating
  __shared__ float red[2][NWARP];     // block-sum partials, alternating

  const int b = blockIdx.x;
  const int k = threadIdx.x;
  const bool active = k < K;

  fbc::load_A(A, A_s, K, false);
  const size_t step_k = (size_t)B * K;
  const float* lb = lik + (size_t)b * K;
  float* ab = alpha + (size_t)b * K;
  float l_cur = active ? lb[k] : 0.f;  // lik_t
  float a = active ? pi[k] * l_cur : 0.f;
  float ss = 0.f;  // STACK: sum of the previous stored a
  int pa = 0, pr = 0;
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    float l_next = 0.f;
    if (t + 1 < T && active) l_next = lb[(size_t)(t + 1) * step_k + k];
    if (t > 0) {
      if ((t % C) % 4 == 0) {
        if (STACK) {
          a = a / ss;
        } else {
          a = a / block_sum(a, red[pr]);
          pr ^= 1;
        }
      }
      a_s[pa][k] = a;
      __syncthreads();  // a_s[pa] is complete
      a = col_dot(a_s[pa], A_s, k, K) * l_cur;
      pa ^= 1;
    }
    if (active) ab[(size_t)t * step_k + k] = a;
    if (STACK) {
      ss = block_sum(a, red[pr]);
      pr ^= 1;
      if (k == 0) s_out[(size_t)t * B + b] = ss;
    }
    l_cur = l_next;
  }
}

__global__ void __launch_bounds__(NT)
probe_fwd_nos_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                     const float* __restrict__ lik, float* __restrict__ alpha, int T,
                     int B, int K, int C) {
  fwd_chain<false>(pi, A, lik, alpha, nullptr, T, B, K, C);
}

__global__ void __launch_bounds__(NT)
probe_fwd_stack_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                       const float* __restrict__ lik, float* __restrict__ alpha,
                       float* __restrict__ s_out, int T, int B, int K, int C) {
  fwd_chain<true>(pi, A, lik, alpha, s_out, T, B, K, C);
}

// One block carries NSEQ sequences (NSEQ > 1 only for CHUNKED), thread
// q * KMAX + k holding state k of the block's sequence q.
template <Body BODY, typename OUT_T, int NSEQ>
__global__ void __launch_bounds__(NSEQ * KMAX)
probe_micro_kernel(const float* __restrict__ pi, const float* __restrict__ A,
                   const float* __restrict__ lik, OUT_T* __restrict__ alpha, int T,
                   int B, int K, int C) {
  static_assert((BODY == BF16) == std::is_same<OUT_T, __nv_bfloat16>::value,
                "BF16 stores bf16, every other body float32");
  static_assert(NSEQ == 1 || BODY == CHUNKED, "only CHUNKED carries several sequences");
  constexpr int NTH = NSEQ * KMAX;
  __shared__ float A_s[KMAX * KMAX];
  __shared__ float a_s[2][NSEQ][KMAX];

  const int q = threadIdx.x / KMAX;
  const int k = threadIdx.x % KMAX;
  const int b = blockIdx.x * NSEQ + q;
  const bool active = b < B && k < K;  // masks the ragged last block too

  fbc::load_A(A, A_s, K, false, KMAX, NTH);
  if (BODY == BF16) {  // the same indices this thread loaded: no barrier needed
    for (int idx = threadIdx.x; idx < KMAX * KMAX; idx += NTH) A_s[idx] = round_bf16(A_s[idx]);
  }
  const size_t step_k = (size_t)B * K;
  OUT_T* ab = alpha + (size_t)b * K;
  float a = active ? pi[k] * lik[(size_t)b * K + k] : 0.f;  // tile 0 starts from lik_0
  int pa = 0;
  __syncthreads();

  for (int t0 = 0; t0 < T; t0 += C) {
    for (int p = 0; p < C; ++p) {
      if (BODY == BF16) a = round_bf16(a);
      a_s[pa][q][k] = a;
      __syncthreads();  // every chain's operand is complete
      a = col_dot(a_s[pa][q], A_s, k, K);
      pa ^= 1;
      if (BODY != DOT_ONLY && active) {
        if constexpr (BODY == BF16)
          ab[(size_t)(t0 + p) * step_k + k] = __float2bfloat16_rn(a);
        else
          ab[(size_t)(t0 + p) * step_k + k] = a;
      }
    }
    if constexpr (BODY == DOT_ONLY) {
      if (active) ab[(size_t)t0 * step_k + k] = a;
    }
    a = a * 1e-20f;  // the carry
  }
}

bool bad_shape(int T, int B, int K, int C) {
  return T < 1 || B < 1 || K < 1 || K > KMAX || C < 1 || T % C != 0;
}

template <Body BODY, typename OUT_T, int NSEQ>
void launch_micro(const float* pi, const float* A, const float* lik, void* alpha, int T,
                  int B, int K, int C, cudaStream_t st) {
  probe_micro_kernel<BODY, OUT_T, NSEQ><<<(B + NSEQ - 1) / NSEQ, NSEQ * KMAX, 0, st>>>(
      pi, A, lik, static_cast<OUT_T*>(alpha), T, B, K, C);
}

}  // namespace

extern "C" {

int split_probe_kmax() { return KMAX; }

const char* split_probe_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Each launcher returns cudaGetLastError() right after the launch (0 = ok).
// Pointers are device pointers of contiguous tensors (float32, alpha bf16
// for the BF16 body); the kernel runs on `stream` and does not synchronise.
// T must be a multiple of C.
int split_probe_fwd_nos(const float* pi, const float* A, const float* lik, float* alpha,
                        int T, int B, int K, int C, int device, void* stream) {
  if (bad_shape(T, B, K, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  probe_fwd_nos_kernel<<<B, NT, 0, static_cast<cudaStream_t>(stream)>>>(pi, A, lik, alpha,
                                                                        T, B, K, C);
  return static_cast<int>(cudaGetLastError());
}

int split_probe_fwd_stack(const float* pi, const float* A, const float* lik, float* alpha,
                          float* s, int T, int B, int K, int C, int device, void* stream) {
  if (bad_shape(T, B, K, C)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  probe_fwd_stack_kernel<<<B, NT, 0, static_cast<cudaStream_t>(stream)>>>(pi, A, lik, alpha,
                                                                          s, T, B, K, C);
  return static_cast<int>(cudaGetLastError());
}

// body: 0 DOT_ONLY, 1 DOT_STORE, 2 BF16, 3 CHUNKED with 8 sequences a block,
// 4 CHUNKED with 4.
int split_probe_micro(const float* pi, const float* A, const float* lik, void* alpha,
                      int body, int T, int B, int K, int C, int device, void* stream) {
  if (bad_shape(T, B, K, C) || body < 0 || body > 4)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (body) {
    case 0: launch_micro<DOT_ONLY, float, 1>(pi, A, lik, alpha, T, B, K, C, st); break;
    case 1: launch_micro<DOT_STORE, float, 1>(pi, A, lik, alpha, T, B, K, C, st); break;
    case 2: launch_micro<BF16, __nv_bfloat16, 1>(pi, A, lik, alpha, T, B, K, C, st); break;
    case 3: launch_micro<CHUNKED, float, 8>(pi, A, lik, alpha, T, B, K, C, st); break;
    default: launch_micro<CHUNKED, float, 4>(pi, A, lik, alpha, T, B, K, C, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
