// The fused pair's backward up to K = 64 at any feature width F (the
// instances fused_fb_wide*.cu build for F > fbc::FMAX; fb_seqs.cuh holds the
// layout this follows, and its instances for F <= FMAX). The fused forward
// at F > FMAX, like the duplex pair there, reads the likelihoods that
// fbs::ll_tile sums first (fb_seqs.cuh's seq_forward in its ll mode).
//
// What changes with the width. fb_seqs.cuh keeps row k of eacc (the
// backward) in registers and pads F to one of four compiled widths, which
// does not scale past 64 features. ll_t is summed in blocks of 64 features
// (BLK groups of four): the fmaf chain over the first block, then each
// further block's own chain from zero, added in order, over zero padding to
// a whole group of four, so that a built kind's rows give the array's bits
// and the sums are ll_tile's, the forward's lik_t.
//
// The backward has two tiers, chosen before launch from (S, F) alone
// (tiled_fits; the launchers count each):
//   * the tiled tier (seq_backward_tiled, up to about F = 310), the
//     counterpart of the TPU kernel's shape (pallas_fb.py:577
//     _bwd_kernel_fused: ll as one tile matmul, eacc a VMEM-resident sum
//     of (w gamma)^T feats a tile at a time). The serial chain keeps only
//     what is serial; both F-wide products are tile products on two more
//     warps that the chain does not wait for (four where a block has the SM
//     alone; beside two or four chain groups at S = 2: tiled_plan), in
//     float32 FFMA from shared memory, W held there too. A window of
//     rows / (S G) steps holds 16 (t, b) rows, or 8 where the rings of 16
//     do not fit beside W and eacc (tiled_plan). The tile warps
//     stage a window's feature rows in shared memory (cp.async, asked for a
//     window before they are needed; a built kind's raw rows, built there)
//     and compute its (rows x F) . (F x K) likelihood tile two windows ahead
//     of the chain, each element the forward's own sum (the fmaf chain over
//     each block of 64 features from zero, the blocks added in order), into
//     a ring of two slots. The chain reads ll_t from the ring, and writes
//     w_t gamma_t into the same place once it has read it; a window behind,
//     the tile warps add (w gamma)^T (K x rows) . feats (rows x F) to eacc,
//     held in shared memory across all of T, before they overwrite the slot
//     with the likelihoods two windows on. acc stays in the chain's
//     registers from T - 1 down to 0; one launch covers T; each chain group
//     writes a row of acc partials and each block one of eacc, which
//     fbs::sum_partials adds in order. The two roles meet at named barriers
//     only (bar.sync / bar.arrive): each chain group's own a step, the tile
//     warps' own, and for each ring slot "likelihoods ready" (tile to chain,
//     one a group, so that no group waits for another) and "w gamma ready"
//     (chains to tile). eacc's grouping then follows the block's S and
//     groups, as acc's follows S.
//   * the window tier (seq_backward_window, wider F, where W and eacc (KMAX x
//     F each) no longer fit beside the rings): both F-wide products leave
//     the chain, as in the large-K backward (fbs::WideStats). For each
//     window of 2^17 / B time steps, the last first, ll_tile_kernel sums the
//     window's likelihoods from its feature rows (a built kind's rows built
//     first by build_feats_kernel), the chain runs over the window reading
//     them, and writes w_t gamma_t, whose outer sums with the same rows
//     (3xTF32, fb_stats.cuh) add eacc in an order fixed by (T, B, K, F).
//     The chain holds neither W nor a feature row, so the tier takes any F.
//     acc stays in registers, a column a thread summed over the block's
//     sequences, and a window ends by writing it to the block's row of
//     partials, which the next window reads back and goes on summing into:
//     the same fmaf chain as in one launch. The windows carry b'_{t0-1} in
//     `carry`, as the large-K backward's do.
// Everything else -- the matvec, the sums and maxima, the modes -- is
// fb_seqs.cuh's arithmetic, line for line, so gamma, gamma0 and acc are the
// same bits in both tiers.

#pragma once

#include "fb_common.cuh"
#include "fb_seqs.cuh"
#include "fb_stats.cuh"

namespace fbwf {

using fbc::KMAX;
using fbc::NT;
using fbc::NWARP;
using fbc::SUM_FLOOR;
using fbseq::AST;
using fbseq::block_sum;
using fbseq::fma4;
using fbseq::ld4;
using fbseq::ld4s;

// Groups of four features.
__host__ __device__ constexpr int groups(int F) { return (F + 3) / 4; }

// The dynamic shared memory a WF block takes at most, in bytes: within the
// H100's 227 KB a block (opt-in) beside the backward's static arrays.
constexpr int SMEM_CAP = 220 * 1024;

// The groups of four features in a block of ll's sum (64 features).
constexpr int BLK = KMAX / 4;

// *p by a load the compiler may not repeat or move.
__device__ __forceinline__ float ld_once(const float* p) {
  return *reinterpret_cast<const volatile float*>(p);
}

// ---------------------------------------------------------------------------
// The window tier of the backward (the head of this file describes it).
//
// What bounds it on this card: the chain is fb_seqs.cuh's ll-mode backward
// (the split backward's) with one column of acc a thread in place of S, so
// a step runs S K FMAs a thread for b'_{t-1} from d_t broadcast from shared
// memory and S K for acc from a_{t-1}; a step's ll_t, a_{t-1} and w_t
// come through a ring that each thread fills with its own elements by
// cp.async WIN_AHEAD steps ahead (the split backward's depth), so no global
// load and no barrier but the step's own sits on the chain. Row k of A~
// lives in registers as far as S sequences' state leaves room beside acc
// (its first 48 entries at S = 2, 32 at S = 4), the rest read from shared
// memory: all 64 at S = 2 took 254 registers and spilled 152 bytes on the
// H100 (PERF.md).
constexpr int WIN_AHEAD = fbseq::BWD_AHEAD;

// The entries of row k of A~ a thread of the window tier keeps in registers.
template <int S>
__host__ __device__ constexpr int window_areg() {
  return S <= 2 ? 48 : 32;
}

// Bytes of the window tier's dynamic shared memory at S: A~'s rows, two
// slots each of d_t, a_{t-1} and the partial sums of g_t, and the ring of
// WIN_AHEAD slots of ll, alpha and kept-mask rows ([3][S][KMAX] a slot). It
// does not depend on F.
template <int S>
__host__ __device__ constexpr int window_smem() {
  return 4 * (KMAX * AST + 4 * S * KMAX + 2 * NWARP * S + 3 * WIN_AHEAD * S * KMAX);
}

// fbseq::seq_stats_backward at any F over the window t = t1-1 .. t0 of a
// launch (b'_{T-1} = 1 / s_{T-1} when t1 = T, else the carry the window
// above left), on the window's likelihoods ll (t1 - t0, B, K), which
// fbs::ll_tile summed from its feature rows: the same recursion, with ll_t,
// a_{t-1} and (gated) w_t read WIN_AHEAD steps ahead through the ring as
// the ll mode reads them. acc (column k, summed over the block's sequences)
// starts from zero at t1 = T, else from the block's row of partials `part`,
// and is written back there; w_t gamma_t goes to gw (t1 - t0, B, K) from
// t0, the window above 0 leaves b'_{t0-1} in carry (B, K). gamma0, gamma and
// the modes as seq_stats_backward's with FEATS: alpha16 (bf16 alpha, read
// through the ring as the aligned 32-bit word that holds each element) and
// sel, both run-time pointers under MODES, either null. Every thread of the
// block calls it.
template <int S, bool GATED, bool MODES>
__device__ __forceinline__ void seq_backward_window(
    const float* __restrict__ A, const float* __restrict__ ll, const float* __restrict__ alpha,
    const __nv_bfloat16* __restrict__ alpha16, const float* __restrict__ s_in,
    const float* __restrict__ sh_in, const float* __restrict__ w_in, const int* __restrict__ sel,
    float* __restrict__ gamma, float* __restrict__ gamma0, float* __restrict__ gw_out,
    float* __restrict__ carry, float* __restrict__ part, int T, int B, int K, int t0, int t1,
    int blk, float* smem) {
  constexpr int AREG = window_areg<S>();
  float* A_s = smem;                 // A~[k][j] at k * AST + j (j >= AREG read from here)
  float* d_s = A_s + KMAX * AST;     // d_t in slot t & 1, [S][KMAX] each
  float* a_s = d_s + 2 * S * KMAX;   // a_{t-1} in slot t & 1
  float* red = a_s + 2 * S * KMAX;  // partial sums of g_t in slot t & 1, [NWARP][S]
  float* q_s = red + 2 * NWARP * S;  // the ring, [3][S][KMAX] a slot

  const int b0 = blk * S;
  const int ns = min(S, B - b0);
  const int k = threadIdx.x;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;

  for (int idx = k; idx < KMAX * KMAX; idx += NT) {
    const int r = idx / KMAX, c = idx % KMAX;
    A_s[r * AST + c] = (r < K && c < K) ? A[r * K + c] : 0.f;
  }
  float Arow[AREG];  // row k of A~'s first AREG entries
#pragma unroll
  for (int j = 0; j < AREG; ++j) Arow[j] = (active && j < K) ? ld_once(A + k * K + j) : 0.f;

  float* pb = part + (size_t)blk * K * K;  // the block's row of partials
  float acc[KMAX];  // column k of sum_t outer(a_{t-1}, d_t n_t pg_t) over the block
#pragma unroll
  for (int i = 0; i < KMAX; ++i) acc[i] = (t1 < T && active && i < K) ? pb[i * K + k] : 0.f;

  const size_t step_k = (size_t)B * K;
  const bool a16 = MODES && alpha16 != nullptr;
  const float* ab = a16 ? nullptr : alpha + (size_t)b0 * K + k;
  const __nv_bfloat16* ab16 = a16 ? alpha16 + (size_t)b0 * K + k : nullptr;
  const size_t n_alpha = (size_t)T * step_k;  // alpha's elements (the ring's bf16 words)
  const float* lb = ll + (size_t)b0 * K + k;   // the window's row t at (t - t0) step_k
  auto a_at = [&](int t, int s) {
    const size_t o = (size_t)t * step_k + (size_t)s * K;
    if constexpr (MODES) return a16 ? __bfloat162float(ab16[o]) : ab[o];
    return ab[o];
  };

  float a_cur[S], a_prev[S], s_prev[S], sh_cur[S], beta[S], w_cur[S], lcur[S];
  int pick[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool ok = s < ns;
    const float* sb = s_in + (size_t)(b0 + s) * T;
    a_cur[s] = (ok && active) ? a_at(t1 - 1, s) : 0.f;
    a_prev[s] = (ok && active && t1 >= 2) ? a_at(t1 - 2, s) : 0.f;
    pick[s] = (MODES && sel != nullptr && ok) ? sel[b0 + s] : -1;
    s_prev[s] = (ok && t1 >= 2) ? sb[t1 - 2] : 1.f;
    sh_cur[s] = ok ? sh_in[(size_t)(b0 + s) * T + t1 - 1] : 0.f;
    beta[s] = t1 == T ? 1.f / fmaxf(ok ? sb[T - 1] : 1.f, SUM_FLOOR)
                      : ((ok && active) ? carry[(size_t)(b0 + s) * K + k] : 0.f);
    w_cur[s] = GATED ? (ok ? w_in[(size_t)(t1 - 1) * B + b0 + s] : 0.f) : 1.f;
    lcur[s] = (ok && active) ? lb[(size_t)(t1 - 1 - t0) * step_k + (size_t)s * K] : 0.f;
  }

  // the rows of step j = t1-2-i: ll_j (j >= t0), a_{j-1} (j >= 1) and (gated)
  // w_j (j >= 0: the pair gate at t0 takes w_{t0-1}), zero where missing; the
  // i-th group in slot i % WIN_AHEAD. Each thread copies its own elements.
  auto ask = [&](int i) {
    const int j = t1 - 2 - i;
    float* slot = q_s + (i % WIN_AHEAD) * 3 * S * KMAX + k;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool ok = s < ns && active;
      const bool in_l = ok && j >= t0, in_a = ok && j >= 1;
      fbs::cp_async<1>(slot + s * KMAX,
                       in_l ? lb + (size_t)(j - t0) * step_k + (size_t)s * K : ll, in_l);
      if (a16) {  // the word of a_{j-1}'s bf16 element
        const size_t o = (size_t)(j - 1) * step_k + (size_t)(b0 + s) * K + k;
        fbs::cp_async_n(slot + (S + s) * KMAX, in_a ? alpha16 + (o & ~(size_t)1) : alpha16,
                        !in_a ? 0 : (o | 1) < n_alpha ? 4 : 2);
      } else {
        fbs::cp_async<1>(slot + (S + s) * KMAX,
                         in_a ? ab + (size_t)(j - 1) * step_k + (size_t)s * K : ll, in_a);
      }
      if (GATED) {
        const bool in_w = s < ns && j >= 0;
        fbs::cp_async<1>(slot + (2 * S + s) * KMAX,
                         in_w ? w_in + (size_t)j * B + b0 + s : ll, in_w);
      }
    }
    fbs::cp_commit();
  };
  for (int i = 0; i < WIN_AHEAD; ++i) ask(i);
  __syncthreads();  // A~'s rows

  for (int t = t1 - 1; t >= t0; --t) {
    const int p = t & 1;
    const int i = t1 - 1 - t;  // the step's place
    float* dp = d_s + p * S * KMAX;
    float* ap = a_s + p * S * KMAX;
    float* rp = red + p * NWARP * S;

    // operands of step t-1, from the ring (asked for WIN_AHEAD steps ago),
    // so that their latency hides behind step t; s and sh from L1
    float a_n[S], s_n[S], sh_n[S], w_n[S], l_n[S];
    fbs::cp_wait<WIN_AHEAD - 1>();
    const float* slot = q_s + (i % WIN_AHEAD) * 3 * S * KMAX + k;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool ok = s < ns;
      l_n[s] = slot[s * KMAX];
      a_n[s] = slot[(S + s) * KMAX];
      if (a16) {  // a_{t-2}: its half of the word, widened
        const size_t o = (size_t)(t - 2) * step_k + (size_t)(b0 + s) * K + k;
        const unsigned u = __float_as_uint(a_n[s]);
        a_n[s] = __uint_as_float((o & 1) ? (u & 0xffff0000u) : (u << 16));
      }
      w_n[s] = GATED ? slot[(2 * S + s) * KMAX] : 1.f;
      s_n[s] = (ok && t >= 2) ? s_in[(size_t)(b0 + s) * T + t - 2] : 1.f;
      sh_n[s] = (ok && t >= 1) ? sh_in[(size_t)(b0 + s) * T + t - 1] : 0.f;
    }
    ask(i + WIN_AHEAD);

    float graw[S], d[S], gs[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float lik = active ? expf(lcur[s] - sh_cur[s]) : 0.f;
      graw[s] = a_cur[s] * beta[s];
      d[s] = t >= 1 ? (lik * (1.f / fmaxf(s_prev[s], SUM_FLOOR))) * beta[s] : 0.f;
      dp[s * KMAX + k] = d[s];
      ap[s * KMAX + k] = a_prev[s];
      gs[s] = graw[s];
    }
    fbc::warp_sums<S>(gs);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) rp[warp * S + s] = gs[s];
    }
    __syncthreads();  // d_t, a_{t-1} and the partial sums are complete

    float dn[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float n = s < ns ? 1.f / fmaxf(block_sum<S>(rp, s), SUM_FLOOR) : 0.f;
      const float gam = graw[s] * n;
      const float gw = GATED ? gam * w_cur[s] : gam;
      if (active && s < ns) {
        if (gamma != nullptr) gamma[((size_t)t * B + b0 + s) * K + k] = gam;
        gw_out[((size_t)(t - t0) * B + b0 + s) * K + k] = gw;
        float* g0 = gamma0 + (size_t)(b0 + s) * K + k;
        if (!MODES || sel == nullptr) {
          if (t == 0) *g0 = gw;
        } else if (t == pick[s]) {
          *g0 = gam;
        } else if (t == 0 && (pick[s] < 0 || pick[s] >= T)) {
          *g0 = 0.f;
        }
      }
      dn[s] = GATED ? (d[s] * n) * (w_n[s] * w_cur[s]) : d[s] * n;
    }

    // b'_{t-1} beside acc += outer(a_{t-1}, dn_t)
    float bn[S];
#pragma unroll
    for (int s = 0; s < S; ++s) bn[s] = 0.f;
#pragma unroll
    for (int i4 = 0; i4 < KMAX / 4; ++i4) {
      const int j = 4 * i4 % AREG;  // the registers' column, when 4 i4 < AREG
      const float4 av = 4 * i4 >= AREG
                            ? ld4(A_s + k * AST + 4 * i4)
                            : make_float4(Arow[j], Arow[j + 1], Arow[j + 2], Arow[j + 3]);
      float4 x[S];
      ld4s<S>(x, dp + 4 * i4, KMAX);
      fma4<S>(bn, x, av.x, av.y, av.z, av.w);
      float4 y[S];
      ld4s<S>(y, ap + 4 * i4, KMAX);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        acc[4 * i4] = fmaf(y[s].x, dn[s], acc[4 * i4]);
        acc[4 * i4 + 1] = fmaf(y[s].y, dn[s], acc[4 * i4 + 1]);
        acc[4 * i4 + 2] = fmaf(y[s].z, dn[s], acc[4 * i4 + 2]);
        acc[4 * i4 + 3] = fmaf(y[s].w, dn[s], acc[4 * i4 + 3]);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      beta[s] = bn[s];
      a_cur[s] = a_prev[s];
      a_prev[s] = a_n[s];
      s_prev[s] = s_n[s];
      sh_cur[s] = sh_n[s];
      w_cur[s] = w_n[s];
      lcur[s] = l_n[s];
    }
  }
  fbs::cp_wait<0>();  // the copies asked for past the window

  if (active) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < K) pb[i * K + k] = acc[i];
    if (t0 > 0) {
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (s < ns) carry[(size_t)(b0 + s) * K + k] = beta[s];  // b'_{t0-1}
    }
  }
}

// ---------------------------------------------------------------------------
// The tiled tier of the backward (the head of this file describes it).

// (t, b) rows a window, rows / (S G) steps: TILE_ROWS, or TILE_ROWS_MIN where
// the rings of TILE_ROWS do not fit beside W and eacc (tiled_plan)
constexpr int TILE_ROWS = 16, TILE_ROWS_MIN = 8;
constexpr int TILED_AREG = 16;  // entries of row k of A~ a chain thread keeps in registers
// feature slots, window j's in slot j % 3: eacc's (j), the next window's
// and the one whose rows are in flight or built for the likelihoods (j + 2)
constexpr int TILE_FEATS = 3;
// The tile warps: 2 where two blocks share an SM (a block's shared memory
// within TWO_BLOCK_SMEM), 4 where a block has the SM alone.
constexpr int TILE_NT_PAIR = 64, TILE_NT_ALONE = 128;
constexpr int TWO_BLOCK_SMEM = 113 * 1024;  // of the SM's 228 KB, 1 KB a block reserved
constexpr int MAX_GROUPS = 4;               // chain groups a block
// named barriers (0 is __syncthreads): the tile warps' own; for each ring
// slot "w gamma ready" (2, 3: every chain group arrives, the tile warps
// wait); each chain group's own (4 ..); for each group and ring slot
// "likelihoods ready" (8 + 2 g + slot: the tile warps arrive, the group
// waits), so that no group waits for another
constexpr int BAR_TILE = 1, BAR_GW = 2, BAR_CHAIN = 4, BAR_LL = 8;

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// The row stride of a feature slot: an odd number of 16-byte groups, so that
// the rows a warp reads at once fall in different banks.
__host__ __device__ constexpr int tiled_fpad(int F) { return 4 * (groups(F) | 1); }

// Floats of the tiled backward's dynamic shared memory at (S, F) with G
// chain groups and R rows a window, in the order of its regions: A~'s rows;
// each group's d, a and partial sums; the ring (2 slots of R x KMAX: ll_t,
// then w_t gamma_t); W and eacc (fpr rows of KMAX each, feature-major); the
// TILE_FEATS feature slots (R x tiled_fpad); a slot of raw rows (R x D
// floats for a built kind, D <= F / 2) and the feature table (F ints). Every
// kind takes the same, so that the tier, and with it eacc's bits, does not
// depend on the kind. Every region starts on 16 bytes.
template <int S>
__host__ __device__ inline int tiled_floats(int F, int G, int R) {
  const int fpr = 4 * groups(F);
  return KMAX * AST + G * (4 * S * KMAX + 2 * NWARP * S) + 2 * R * KMAX + 2 * KMAX * fpr +
         TILE_FEATS * R * tiled_fpad(F) + R * fpr / 2 + F;
}

// A tiled block at (S, F): G chain groups of KMAX threads, each running S
// sequences (S G a block), nt tile threads and windows of `rows` (t, b)
// rows. At S = 2 (the default up to B = 1,024) two groups where two blocks
// share an SM and four where one has it alone, so that 8 chain warps share
// each SM either way and B = 1,024 runs in one wave; at S = 4 one group.
// Windows of TILE_ROWS rows where they fit within SMEM_CAP, else of
// TILE_ROWS_MIN (F from 257 at S = 2, 261 at S = 4), whose smaller rings
// take the tier to about F = 310. The rows do not change a bit of any
// output: eacc's sums run over the rows in the same order whatever the
// window.
struct TiledPlan {
  int groups, nt, rows, floats;
  __host__ __device__ int threads() const { return groups * NT + nt; }
};

template <int S>
__host__ __device__ inline TiledPlan tiled_plan(int F) {
  const int pair = S == 2 ? 2 : 1;
  const bool two = 4 * tiled_floats<S>(F, pair, TILE_ROWS) <= TWO_BLOCK_SMEM;
  const int G = two ? pair : (S == 2 ? MAX_GROUPS : 1);
  const int R = 4 * tiled_floats<S>(F, G, TILE_ROWS) <= SMEM_CAP ? TILE_ROWS : TILE_ROWS_MIN;
  return {G, two ? TILE_NT_PAIR : TILE_NT_ALONE, R, tiled_floats<S>(F, G, R)};
}

template <int S>
__host__ __device__ constexpr int tiled_max_threads() {
  return (S == 2 ? MAX_GROUPS : 1) * NT + TILE_NT_ALONE;
}

template <int S>
__host__ __device__ inline int tiled_smem(int F) {
  return 4 * tiled_plan<S>(F).floats;
}

// The backward's tier at (S, F) up to K = 64, for every feature kind: tiled
// where its shared memory fits within SMEM_CAP (up to F = 316 at S = 4, 308
// at S = 2), else the window tier.
template <int S>
__host__ __device__ inline bool tiled_fits(int F) {
  return tiled_smem<S>(F) <= SMEM_CAP;
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// The tile warps' work on a block's windows, nt threads (tt in 0 .. nt -
// 1). In the likelihood tile a work item is RP rows by CC states (rows RP
// rp ..; states 4 kg .. 4 kg + 3, and 32 + 4 kg .. for CC = 8): two rows by
// 8 states for 64 tile threads, two by 4 for 128, one by 4 for 128 on
// windows of 8 rows; one item a thread, so that the
// threads of a quarter warp read consecutive bytes of a row of W; in
// eacc an item is eight states by four features (states 4 kg .. 4 kg + 3
// and 32 + 4 kg .. 32 + 4 kg + 3, kg = item % 8; features 4 (item / 8) ..),
// 8 nf4 items, eacc feature-major so that a warp's eight kg read eight
// different banks; each thread takes the items nt apart.
template <int KIND>
struct TileWarps {
  static constexpr bool BUILT = KIND != fbc::FEATS_ARRAY;

  const float* __restrict__ W;    // (F, K) in device memory
  const float* __restrict__ src;  // the block's first row: src + b0 D
  float* lg;    // the ring: 2 slots of rows x KMAX
  float* w_s;   // W, fpr rows of KMAX, zero outside (F, K)
  float* eacc;  // eacc^T, fpr rows of KMAX
  float* feat;  // TILE_FEATS slots of rows x fst
  float* raw;   // rows x D (built kinds)
  int* tab;     // F sources, (ia + 1) | (ja + 1) << 16 (built kinds; fbc::feat_src)
  size_t step;  // floats from one time step's rows to the next (B D)
  int T, K, F, D, fpr, fst, nf4, sg, ns, tw, rows, tt, nt;
  // D: the floats of an input row (F for the array); sg: the block's
  // sequences (S G), of which ns exist; tw: steps a window, rows = tw sg

  // Window j's steps: [hi(j) - steps(j), hi(j)), the last window first.
  __device__ __forceinline__ int hi(int j) const { return T - j * tw; }
  __device__ __forceinline__ int steps(int j) const { return min(tw, hi(j)); }

  // W into w_s; zero eacc, the feature slots (their padding stays zero) and
  // the raw slot; fill the table. The caller syncs the block after.
  __device__ void init() const {
    for (int i = tt; i < fpr * KMAX; i += nt) {
      const int f = i / KMAX, k = i % KMAX;
      w_s[i] = (f < F && k < K) ? W[(size_t)f * K + k] : 0.f;
      eacc[i] = 0.f;
    }
    for (int i = tt; i < TILE_FEATS * rows * fst; i += nt) feat[i] = 0.f;
    if constexpr (BUILT) {
      for (int i = tt; i < rows * D; i += nt) raw[i] = 0.f;
      for (int f = tt; f < F; f += nt) {
        int ia, ja;
        fbc::feat_src(KIND, D, f, ia, ja);
        tab[f] = (ia + 1) | ((ja + 1) << 16);
      }
    }
  }

  __device__ __forceinline__ float* slot(int j) const {
    return feat + (j % TILE_FEATS) * rows * fst;
  }

  // Ask for window j's feature rows: row i sg + q is time step hi(j) - 1 - i
  // of sequence b0 + q, zero for a missing step or sequence; the array's
  // straight into slot(j), a built kind's raw rows into the raw slot. One
  // cp.async group, committed even when j is past the last window, so that
  // every thread counts the same groups.
  __device__ void ask(int j, int nw) const {
    if (j < nw) {
      const int n = steps(j), t_hi = hi(j);
      float* fs = slot(j);
      for (int r = 0; r < rows; ++r) {
        const int i = r / sg, q = r - i * sg;
        const bool ok = i < n && q < ns;
        const float* row = src + (ok ? (size_t)(t_hi - 1 - i) * step + (size_t)q * D : 0);
        float* dst = BUILT ? raw + r * D : fs + r * fst;
        for (int f = tt; f < D; f += nt) fbs::cp_async<1>(dst + f, ok ? row + f : src, ok);
      }
    }
    fbs::cp_commit();
  }

  // Window j's rows in slot(j), seen by every tile thread: its copies landed
  // (all but the PENDING latest groups; a built kind waits for all, then
  // builds the features from the raw slot, each product one __fmul_rn, as
  // the forward's).
  template <int PENDING>
  __device__ void land(int j) const {
    fbs::cp_wait<BUILT ? 0 : PENDING>();
    bar_sync(BAR_TILE, nt);
    if constexpr (BUILT) {
      float* fs = slot(j);
      for (int r = 0; r < rows; ++r) {
        const float* y = raw + r * D;
        for (int f = tt; f < F; f += nt) {
          const int ia = (tab[f] & 0xffff) - 1, ja = (tab[f] >> 16) - 1;
          fs[r * fst + f] = ia < 0 ? 1.f : fbc::feat_of(y[ia], ja < 0 ? 0.f : y[ja], ja >= 0);
        }
      }
      bar_sync(BAR_TILE, nt);
    }
  }

  // The likelihood tile of window j into ring slot j & 1: ll[r][k] = row r
  // of slot(j) . column k of W, ll_tile's sum (each block of BLK
  // groups its own fmaf chain from zero, in feature order, the blocks added
  // in order), so lik_t is the forward's bits.
  template <int CC, int RP>
  __device__ void likelihoods_cc(int j) const {
    constexpr int NQ = CC / 4;        // float4 groups of states an item: 4 q kg + 32 q ..
    constexpr int KG = KMAX / CC;     // items along the states
    const float* fs = slot(j);
    float* ring = lg + (j & 1) * rows * KMAX;
    for (int item = tt; item < rows / RP * KG; item += nt) {
      const int rp = item / KG, kg = item % KG;
      const float* xp = fs + (RP * rp) * fst;
      const float* wp = w_s + 4 * kg;
      float tot[RP][CC];
      for (int b = 0; b < nf4; b += BLK) {
        float part[RP][CC];
#pragma unroll
        for (int q = 0; q < RP; ++q)
#pragma unroll
          for (int c = 0; c < CC; ++c) part[q][c] = 0.f;
        const int b1 = min(b + BLK, nf4);
#pragma unroll 2
        for (int f4 = b; f4 < b1; ++f4) {
          float4 x[RP];
#pragma unroll
          for (int q = 0; q < RP; ++q) x[q] = ld4(xp + q * fst + 4 * f4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            float w[CC];
#pragma unroll
            for (int h = 0; h < NQ; ++h) {
              const float4 wv = ld4(wp + (4 * f4 + i) * KMAX + 32 * h);
              w[4 * h] = wv.x;
              w[4 * h + 1] = wv.y;
              w[4 * h + 2] = wv.z;
              w[4 * h + 3] = wv.w;
            }
#pragma unroll
            for (int q = 0; q < RP; ++q) {
              const float y = comp(x[q], i);
#pragma unroll
              for (int c = 0; c < CC; ++c) part[q][c] = fmaf(y, w[c], part[q][c]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < RP; ++q)
#pragma unroll
          for (int c = 0; c < CC; ++c) tot[q][c] = b == 0 ? part[q][c] : tot[q][c] + part[q][c];
      }
#pragma unroll
      for (int q = 0; q < RP; ++q)
#pragma unroll
        for (int h = 0; h < NQ; ++h)
          *reinterpret_cast<float4*>(ring + (RP * rp + q) * KMAX + 4 * kg + 32 * h) =
              make_float4(tot[q][4 * h], tot[q][4 * h + 1], tot[q][4 * h + 2], tot[q][4 * h + 3]);
    }
  }

  __device__ void likelihoods(int j) const {
    if (nt >= rows * KMAX / 4)
      likelihoods_cc<4, 1>(j);
    else if (nt >= rows / 2 * KMAX / 4)
      likelihoods_cc<4, 2>(j);
    else
      likelihoods_cc<8, 2>(j);
  }

  // eacc += (w gamma)^T . feats over window j's rows, in row order: ring
  // slot j & 1 (which the chains filled with w_t gamma_t, zero for a
  // missing sequence or state) and slot(j).
  __device__ void emission(int j) const {
    const float* g = lg + (j & 1) * rows * KMAX;
    const float* fs = slot(j);
    const int n = steps(j) * sg;
    for (int item = tt; item < 8 * nf4; item += nt) {
      const int kg = item & 7, f0 = 4 * (item >> 3);
      float4 ea[4], eb[4];  // features f0 + c: states 4 kg .., 32 + 4 kg ..
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        ea[c] = ld4(eacc + (f0 + c) * KMAX + 4 * kg);
        eb[c] = ld4(eacc + (f0 + c) * KMAX + 32 + 4 * kg);
      }
#pragma unroll 4
      for (int r = 0; r < n; ++r) {
        const float4 ga = ld4(g + r * KMAX + 4 * kg), gb = ld4(g + r * KMAX + 32 + 4 * kg);
        const float4 x = ld4(fs + r * fst + f0);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float xc = comp(x, c);
          ea[c].x = fmaf(ga.x, xc, ea[c].x);
          ea[c].y = fmaf(ga.y, xc, ea[c].y);
          ea[c].z = fmaf(ga.z, xc, ea[c].z);
          ea[c].w = fmaf(ga.w, xc, ea[c].w);
          eb[c].x = fmaf(gb.x, xc, eb[c].x);
          eb[c].y = fmaf(gb.y, xc, eb[c].y);
          eb[c].z = fmaf(gb.z, xc, eb[c].z);
          eb[c].w = fmaf(gb.w, xc, eb[c].w);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        *reinterpret_cast<float4*>(eacc + (f0 + c) * KMAX + 4 * kg) = ea[c];
        *reinterpret_cast<float4*>(eacc + (f0 + c) * KMAX + 32 + 4 * kg) = eb[c];
      }
    }
  }

  // The tile warps' whole part: the rows and likelihoods of windows 0 and 1;
  // then for each window j, once the chains have written its w gamma,
  // eacc's sums of j, and the likelihoods of j + 2 into the ring slot j
  // freed, its rows asked for a window earlier (the array's: a built kind's
  // raw rows, one slot of them, are asked for as soon as the previous rows
  // are built), so that their latency passes while the chains run. Last,
  // eacc (K x F) into the block's row of partials pe. nb: the block's
  // threads, which "w gamma ready" counts; G: its chain groups.
  __device__ void ready(int j, int G) const {  // window j's likelihoods, to each group
    for (int g = 0; g < G; ++g) bar_arrive(BAR_LL + 2 * g + (j & 1), NT + nt);
  }

  __device__ void run(float* __restrict__ pe, int nb, int G) const {
    const int nw = (T + tw - 1) / tw;
    if constexpr (BUILT) {
      ask(0, nw);
      land<0>(0);
      ask(1, nw);
    } else {
      ask(0, nw);
      ask(1, nw);
      ask(2, nw);
      land<2>(0);
    }
    likelihoods(0);
    ready(0, G);
    if (nw > 1) {
      land<1>(1);
      if constexpr (BUILT) ask(2, nw);
      likelihoods(1);
      ready(1, G);
    }
    for (int j = 0; j < nw; ++j) {
      bar_sync(BAR_GW + (j & 1), nb);
      emission(j);
      if (j + 2 < nw) {
        bar_sync(BAR_TILE, nt);  // slot(j) read by every tile thread
        if constexpr (BUILT) {
          land<0>(j + 2);
          ask(j + 3, nw);
        } else {
          ask(j + 3, nw);  // into slot(j)
          land<1>(j + 2);
        }
        likelihoods(j + 2);
        ready(j + 2, G);
      }
    }
    bar_sync(BAR_TILE, nt);
    for (int e = tt; e < K * F; e += nt) {
      const int k = e / F, f = e - k * F;
      pe[e] = eacc[f * KMAX + k];
    }
  }
};

// fbseq::seq_stats_backward with FEATS at any F, the tiled tier, in blocks
// of tiled_plan<S>(F): G chain groups of KMAX threads, each the window
// tier's chain over S sequences with ll_t read from the ring and w_t gamma_t
// written back into its place, then the tile warps (TileWarps::run). One
// launch over t = T-1 .. 0 (b'_{T-1} = 1 / s_{T-1}). `part` holds, first,
// a row of acc (K K, column k a chain thread, summed over the group's
// sequences) for each group in block order, ceil(B / (S G)) G rows, so that
// the rows of the first ceil(B / S) groups are an S-sequence block's each
// as at F <= FMAX; then a row of eacc (K F) a block. gamma0, gamma and the
// modes (alpha16, sel) as seq_stats_backward's. Every thread of the block
// calls it.
template <int S, bool GATED, int KIND, bool MODES>
__device__ __forceinline__ void seq_backward_tiled(
    const float* __restrict__ A, const float* __restrict__ W, const float* __restrict__ src,
    const float* __restrict__ alpha, const __nv_bfloat16* __restrict__ alpha16,
    const float* __restrict__ s_in, const float* __restrict__ sh_in,
    const float* __restrict__ w_in, const int* __restrict__ sel, float* __restrict__ gamma,
    float* __restrict__ gamma0, float* __restrict__ part, int T, int B, int K, int F, int blk,
    float* smem) {
  const TiledPlan plan = tiled_plan<S>(F);
  const int G = plan.groups, sg = S * G, rows = plan.rows, tw = rows / sg, nb = plan.threads();
  const int nf4 = groups(F), fpr = 4 * nf4, fst = tiled_fpad(F);
  const int D = fbc::obs_dim(KIND, F);          // F for the array
  const int chain_floats = 4 * S * KMAX + 2 * NWARP * S;
  float* A_s = smem;                            // A~[k][j] at k * AST + j
  float* chains = A_s + KMAX * AST;             // each group's d, a and partial sums
  float* lg = chains + G * chain_floats;        // the ring: ll_t, then w_t gamma_t
  float* w_s = lg + 2 * rows * KMAX;            // W, fpr rows of KMAX
  float* eacc_s = w_s + fpr * KMAX;             // eacc^T, fpr rows of KMAX
  float* feat = eacc_s + fpr * KMAX;            // the feature slots
  float* raw = feat + TILE_FEATS * rows * fst;  // rows x D (built kinds)
  int* tab = reinterpret_cast<int*>(raw + rows * fpr / 2);
  const int nblocks = (B + sg - 1) / sg;

  if (threadIdx.x >= G * NT) {
    const int tt = static_cast<int>(threadIdx.x) - G * NT, nt = plan.nt;
    const TileWarps<KIND> tw_{W,   src + (size_t)blk * sg * D, lg, w_s, eacc_s, feat, raw, tab,
                              (size_t)B * D, T, K, F, D, fpr, fst, nf4, sg,
                              min(sg, B - blk * sg), tw, rows, tt, nt};
    tw_.init();
    for (int idx = tt; idx < KMAX * KMAX; idx += nt) {
      const int r = idx / KMAX, c = idx % KMAX;
      A_s[r * AST + c] = (r < K && c < K) ? A[r * K + c] : 0.f;
    }
    __syncthreads();  // A~, W, the zeroed slots and eacc, the table
    tw_.run(part + (size_t)nblocks * G * K * K + (size_t)blk * K * F, nb, G);
    return;
  }

  const int g = threadIdx.x / NT, k = threadIdx.x % NT;
  const int lane = k & 31, warp = k >> 5;
  const bool active = k < K;
  const int b0 = blk * sg + g * S;
  const int ns = min(S, B - b0);  // none in a trailing group past B
  float* d_s = chains + g * chain_floats;  // d_t in slot t & 1, [S][KMAX] each
  float* a_s = d_s + 2 * S * KMAX;         // a_{t-1} in slot t & 1
  float* red = a_s + 2 * S * KMAX;         // partial sums of g_t in slot t & 1, [NWARP][S]
  float* pb = part + (size_t)(blk * G + g) * K * K;  // the group's row of acc partials
  float acc[KMAX];  // column k of sum_t outer(a_{t-1}, d_t n_t pg_t) over the group
#pragma unroll
  for (int i = 0; i < KMAX; ++i) acc[i] = 0.f;
  // row k of A~'s first TILED_AREG entries in registers, the rest read from
  // A_s: the same words, so the same bits, with fewer shared loads a step
  float Arow[TILED_AREG];
#pragma unroll
  for (int i = 0; i < TILED_AREG; ++i) Arow[i] = (active && i < K) ? ld_once(A + k * K + i) : 0.f;

  const size_t step_k = (size_t)B * K;
  const float* ab = MODES && alpha16 != nullptr ? nullptr : alpha + (size_t)b0 * K + k;
  const __nv_bfloat16* ab16 = MODES && alpha16 != nullptr ? alpha16 + (size_t)b0 * K + k
                                                                   : nullptr;
  auto a_at = [&](int t, int s) {
    const size_t o = (size_t)t * step_k + (size_t)s * K;
    if constexpr (MODES) return ab16 != nullptr ? __bfloat162float(ab16[o]) : ab[o];
    return ab[o];
  };

  float a_cur[S], a_prev[S], s_prev[S], sh_cur[S], beta[S], w_cur[S];
  int pick[S];
#pragma unroll
  for (int s = 0; s < S; ++s) {
    const bool ok = s < ns;
    const float* sb = s_in + (size_t)(b0 + s) * T;
    a_cur[s] = (ok && active) ? a_at(T - 1, s) : 0.f;
    a_prev[s] = (ok && active && T >= 2) ? a_at(T - 2, s) : 0.f;
    pick[s] = (MODES && sel != nullptr && ok) ? sel[b0 + s] : -1;
    s_prev[s] = (ok && T >= 2) ? sb[T - 2] : 1.f;
    sh_cur[s] = ok ? sh_in[(size_t)(b0 + s) * T + T - 1] : 0.f;
    beta[s] = 1.f / fmaxf(ok ? sb[T - 1] : 1.f, SUM_FLOOR);
    w_cur[s] = GATED ? (ok ? w_in[(size_t)(T - 1) * B + b0 + s] : 0.f) : 1.f;
  }
  __syncthreads();  // A~, W, the zeroed slots and eacc, the table

  for (int t = T - 1; t >= 0; --t) {
    const int p = t & 1;
    const int q = T - 1 - t;               // the step's place
    const int j = q / tw, i = q - j * tw;  // its window, and its step there
    float* dp = d_s + p * S * KMAX;
    float* ap = a_s + p * S * KMAX;
    float* rp = red + p * NWARP * S;
    float* lrow = lg + (j & 1) * rows * KMAX + (i * sg + g * S) * KMAX + k;  // + s KMAX
    if (i == 0) bar_sync(BAR_LL + 2 * g + (j & 1), NT + plan.nt);  // the window's likelihoods

    float a_n[S], s_n[S], sh_n[S], w_n[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const bool ok = s < ns;
      a_n[s] = (ok && active && t >= 2) ? a_at(t - 2, s) : 0.f;
      w_n[s] = GATED ? ((ok && t >= 1) ? w_in[(size_t)(t - 1) * B + b0 + s] : 0.f) : 1.f;
      s_n[s] = (ok && t >= 2) ? s_in[(size_t)(b0 + s) * T + t - 2] : 1.f;
      sh_n[s] = (ok && t >= 1) ? sh_in[(size_t)(b0 + s) * T + t - 1] : 0.f;
    }

    float graw[S], d[S], gs[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float lik = active ? expf(lrow[s * KMAX] - sh_cur[s]) : 0.f;
      graw[s] = a_cur[s] * beta[s];
      d[s] = t >= 1 ? (lik * (1.f / fmaxf(s_prev[s], SUM_FLOOR))) * beta[s] : 0.f;
      dp[s * KMAX + k] = d[s];
      ap[s * KMAX + k] = a_prev[s];
      gs[s] = graw[s];
    }
    fbc::warp_sums<S>(gs);
    if (lane == 0) {
#pragma unroll
      for (int s = 0; s < S; ++s) rp[warp * S + s] = gs[s];
    }
    bar_sync(BAR_CHAIN + g, NT);  // d_t, a_{t-1} and the partial sums are complete

    float dn[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float n = s < ns ? 1.f / fmaxf(block_sum<S>(rp, s), SUM_FLOOR) : 0.f;
      const float gam = graw[s] * n;
      const float gw = GATED ? gam * w_cur[s] : gam;
      lrow[s * KMAX] = (active && s < ns) ? gw : 0.f;  // eacc's operand, in ll_t's place
      if (active && s < ns) {
        if (gamma != nullptr) gamma[((size_t)t * B + b0 + s) * K + k] = gam;
        float* g0 = gamma0 + (size_t)(b0 + s) * K + k;
        if (!MODES || sel == nullptr) {
          if (t == 0) *g0 = gw;
        } else if (t == pick[s]) {
          *g0 = gam;
        } else if (t == 0 && (pick[s] < 0 || pick[s] >= T)) {
          *g0 = 0.f;
        }
      }
      dn[s] = GATED ? (d[s] * n) * (w_n[s] * w_cur[s]) : d[s] * n;
    }
    if (i == tw - 1 || t == 0) bar_arrive(BAR_GW + (j & 1), nb);  // the window's w gamma

    // b'_{t-1} beside acc += outer(a_{t-1}, dn_t)
    float bn[S];
#pragma unroll
    for (int s = 0; s < S; ++s) bn[s] = 0.f;
#pragma unroll
    for (int i4 = 0; i4 < KMAX / 4; ++i4) {
      const float4 av = 4 * i4 < TILED_AREG ? make_float4(Arow[4 * i4], Arow[4 * i4 + 1],
                                                          Arow[4 * i4 + 2], Arow[4 * i4 + 3])
                                            : ld4(A_s + k * AST + 4 * i4);
      float4 x[S];
      ld4s<S>(x, dp + 4 * i4, KMAX);
      fma4<S>(bn, x, av.x, av.y, av.z, av.w);
      float4 y[S];
      ld4s<S>(y, ap + 4 * i4, KMAX);
#pragma unroll
      for (int s = 0; s < S; ++s) {
        acc[4 * i4] = fmaf(y[s].x, dn[s], acc[4 * i4]);
        acc[4 * i4 + 1] = fmaf(y[s].y, dn[s], acc[4 * i4 + 1]);
        acc[4 * i4 + 2] = fmaf(y[s].z, dn[s], acc[4 * i4 + 2]);
        acc[4 * i4 + 3] = fmaf(y[s].w, dn[s], acc[4 * i4 + 3]);
      }
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      beta[s] = bn[s];
      a_cur[s] = a_prev[s];
      a_prev[s] = a_n[s];
      s_prev[s] = s_n[s];
      sh_cur[s] = sh_n[s];
      w_cur[s] = w_n[s];
    }
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < KMAX; ++i)
      if (i < K) pb[i * K + k] = acc[i];
  }
}

}  // namespace fbwf
