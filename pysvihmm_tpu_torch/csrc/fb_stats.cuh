// Fixed-order sums of the E-step statistics, shared by fused_fb.cu,
// split_fb.cu and duplex_fb.cu: acc (K, K) and eacc (K, F) are sums over
// every (t, b) of the batch, taken by many blocks, and the sums across
// blocks run in an order that depends on the shapes only, never on timing,
// so a call gives the same bits every time on one card.
//
// Two ways in:
//   * the kernels for K <= 64 keep a block's share in registers and write it
//     to a partial (one row of `part` a block); sum_partials_kernel then adds
//     the rows in block order;
//   * the kernels for K > 64 cannot hold a column of acc a thread (K floats
//     beside the rest), so they write the statistics' two operands a step
//     instead (the gated d_t n_t and w_t gamma_t), a window of time steps at
//     a time (WideStats), and outer_sum() forms sum_n X[n] (x) Y[n] over the
//     window's (t, b) rows as a tiled product: a chunk of rows a block, rows
//     in order inside it, the chunks' partials added in chunk order to what
//     the windows before gave. The windows and chunks follow from the shapes
//     alone, and the scratch from (B, K, F), not T.

#pragma once

#include <cuda_runtime.h>

namespace fbs {

constexpr int SUM_NT = 256;  // threads of sum_partials_kernel
constexpr int SUM_UNROLL = 16;  // loads a thread keeps in flight

// out[e] = part[0][e] + part[1][e] + ... + part[n-1][e], in that order, for
// e < len (0 when n = 0), added to out[e]'s own value first when `add`; part
// is (n, len) row-major.
__global__ void __launch_bounds__(SUM_NT)
sum_partials_kernel(const float* __restrict__ part, int n, int len, bool add,
                    float* __restrict__ out) {
  const int e = blockIdx.x * SUM_NT + threadIdx.x;
  if (e >= len) return;
  const float* p = part + e;
  float v = add ? out[e] : 0.f;
  int i = 0;
  for (; i + SUM_UNROLL <= n; i += SUM_UNROLL) {
    float x[SUM_UNROLL];
#pragma unroll
    for (int u = 0; u < SUM_UNROLL; ++u) x[u] = p[(size_t)(i + u) * len];
#pragma unroll
    for (int u = 0; u < SUM_UNROLL; ++u) v += x[u];
  }
  for (; i < n; ++i) v += p[(size_t)i * len];
  out[e] = v;
}

inline cudaError_t sum_partials(const float* part, int n, int len, float* out, cudaStream_t st,
                                bool add = false) {
  if (len <= 0) return cudaSuccess;
  sum_partials_kernel<<<(len + SUM_NT - 1) / SUM_NT, SUM_NT, 0, st>>>(part, n, len, add, out);
  return cudaGetLastError();
}

constexpr int OT = 64;   // edge of an output tile of outer_partial_kernel
constexpr int ON = 16;   // rows a stage
constexpr int OUTER_NT = 256;  // threads: 16 x 16, 4 x 4 outputs each
constexpr int OUTER_BLOCKS = 528;  // blocks a product aims at (4 x 132 SMs; a constant, so
                                   // the chunks do not depend on the card)

// part[c][i][j] = sum over the rows n of chunk c, in order, of X[n][i] Y[n][j],
// for X (N, I) and Y (N, J) row-major; one 64 x 64 tile of (i, j) a block.
__global__ void __launch_bounds__(OUTER_NT)
outer_partial_kernel(const float* __restrict__ X, const float* __restrict__ Y, long long N,
                     int I, int J, long long chunk, float* __restrict__ part) {
  __shared__ __align__(16) float xs[ON][OT];
  __shared__ __align__(16) float ys[ON][OT];
  const int i0 = blockIdx.x * OT, j0 = blockIdx.y * OT;
  const long long n0 = (long long)blockIdx.z * chunk;
  const long long n1 = n0 + chunk < N ? n0 + chunk : N;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[a][c] = 0.f;

  for (long long nb = n0; nb < n1; nb += ON) {
    for (int q = threadIdx.x; q < ON * OT; q += OUTER_NT) {
      const int r = q / OT, col = q % OT;
      const long long n = nb + r;
      xs[r][col] = (n < n1 && i0 + col < I) ? X[n * I + i0 + col] : 0.f;
      ys[r][col] = (n < n1 && j0 + col < J) ? Y[n * J + j0 + col] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < ON; ++r) {
      const float4 xv = *reinterpret_cast<const float4*>(&xs[r][ty * 4]);
      const float4 yv = *reinterpret_cast<const float4*>(&ys[r][tx * 4]);
      const float x[4] = {xv.x, xv.y, xv.z, xv.w};
      const float y[4] = {yv.x, yv.y, yv.z, yv.w};
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[a][c] = fmaf(x[a], y[c], acc[a][c]);
    }
    __syncthreads();
  }
  float* pc = part + (size_t)blockIdx.z * I * J;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty * 4 + a;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + tx * 4 + c;
      if (i < I && j < J) pc[(size_t)i * J + j] = acc[a][c];
    }
  }
}

// How outer_sum cuts N rows: `chunks` blocks of `chunk` rows along N for each
// output tile (0 chunks for N = 0). chunks <= want, the most the scratch
// holds: want * chunk >= stages * ON >= N.
struct OuterPlan {
  long long chunk;
  int chunks;
};

// Chunks wanted along N: OUTER_BLOCKS blocks over the output tiles, at most
// one a stage of ON rows.
inline long long outer_want(long long N, int I, int J) {
  const long long tiles = (long long)((I + OT - 1) / OT) * ((J + OT - 1) / OT);
  const long long stages = (N + ON - 1) / ON;
  long long want = (OUTER_BLOCKS + tiles - 1) / tiles;
  if (want > stages) want = stages;
  return want > 65535 ? 65535 : want;
}

inline OuterPlan outer_plan(long long N, int I, int J) {
  if (N <= 0) return {0, 0};
  const long long want = outer_want(N, I, J);
  const long long chunk = ((N + ON - 1) / ON + want - 1) / want * ON;
  return {chunk, static_cast<int>((N + chunk - 1) / chunk)};
}

// Floats of scratch outer_sum needs for any N' <= N rows (want grows with N).
inline long long outer_scratch(long long N, int I, int J) {
  return N <= 0 ? 0 : outer_want(N, I, J) * I * J;
}

// out (I, J) = sum_n X[n] (x) Y[n] over N rows, in the fixed order above,
// added to out's own value when `add`; part holds outer_scratch(N, I, J)
// floats.
inline cudaError_t outer_sum(const float* X, const float* Y, long long N, int I, int J,
                             float* part, float* out, bool add, cudaStream_t st) {
  const OuterPlan p = outer_plan(N, I, J);
  if (p.chunks > 0) {
    const dim3 grid((I + OT - 1) / OT, (J + OT - 1) / OT, p.chunks);
    outer_partial_kernel<<<grid, OUTER_NT, 0, st>>>(X, Y, N, I, J, p.chunk, part);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return sum_partials(part, p.chunks, I * J, out, st, add);
}

constexpr long long WIDE_ROWS = 1 << 17;  // (t, b) rows a window of the large-K statistics

// The large-K statistics, a window of time steps at a time. For the steps
// t0 <= t < t1 of a window the kernel (the backward or the duplex combine)
// writes dn_t (the gated d_t n_t, t >= 1) and, with emission statistics
// (F > 0), gw_t = w_t gamma_t, (t1 - t0, B, K) each, at the head of the
// scratch buffer; the window's outer products are then added to acc = sum
// over t >= 1 of outer(a_{t-1}, dn_t) and eacc = sum over t of outer(gw_t,
// f_t). The windows hold `steps` steps (WIDE_ROWS / B, at least 1), the last
// one first: the backward's order, and it carries b'_{t0-1} from a window to
// the next in `carry` (B, K). So the scratch takes 2 WIDE_ROWS K floats at
// most (2 B K where B > WIDE_ROWS) beside the carry and the partials,
// whatever T.
struct WideStats {
  int T, B, K, F, steps;
  float* dn;
  float* gw;
  float* carry;
  float* part_a;
  float* part_e;

  static int window(int T, int B) {
    const long long s = WIDE_ROWS / B;
    return s < 1 ? 1 : s > T ? T : static_cast<int>(s);
  }

  static long long floats(int T, int B, int K, int F) {
    const long long n = (long long)window(T, B) * B;
    return (F > 0 ? 2 : 1) * n * K + (long long)B * K + outer_scratch(n, K, K) +
           (F > 0 ? outer_scratch(n, K, F) : 0);
  }

  WideStats(float* scratch, int T_, int B_, int K_, int F_)
      : T(T_), B(B_), K(K_), F(F_), steps(window(T_, B_)) {
    const long long n = (long long)steps * B;
    dn = scratch;
    gw = F > 0 ? dn + n * K : nullptr;
    carry = dn + (F > 0 ? 2 : 1) * n * K;
    part_a = carry + (long long)B * K;
    part_e = part_a + outer_scratch(n, K, K);
  }

  // For each window [t0, t1), the last first: launch(t0, t1) writes its dn
  // and gw, then its sums go into stats: acc (K, K), then eacc (K, F) right
  // after it when F > 0.
  template <class Launch>
  cudaError_t run(const float* alpha, const float* feats, float* stats, cudaStream_t st,
                  Launch launch) const {
    const size_t step_k = (size_t)B * K;
    for (int t1 = T; t1 > 0; t1 -= steps) {
      const int t0 = t1 > steps ? t1 - steps : 0;
      const bool add = t1 < T;
      cudaError_t e = launch(t0, t1);
      if (e != cudaSuccess) return e;
      const int ta = t0 > 0 ? t0 : 1;  // acc's rows: t >= 1
      e = outer_sum(alpha + (ta - 1) * step_k, dn + (ta - t0) * step_k,
                    (long long)(t1 - ta) * B, K, K, part_a, stats, add, st);
      if (e == cudaSuccess && F > 0)
        e = outer_sum(gw, feats + (size_t)t0 * B * F, (long long)(t1 - t0) * B, K, F, part_e,
                      stats + K * K, add, st);
      if (e != cudaSuccess) return e;
    }
    return cudaSuccess;
  }
};

}  // namespace fbs
