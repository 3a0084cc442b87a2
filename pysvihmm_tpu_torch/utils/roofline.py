"""Least times of the port's CUDA kernels on one NVIDIA H100: the bytes and
operations each launch needs at given shapes, and the card's peaks.

``chip_smoke.py`` and ``scripts/debug_split.py`` read each kernel's share of
its bound from here, so both count the same work.
"""

from __future__ import annotations

# The card's peaks (NVIDIA H100 SXM data sheet, dense, at the 700 W limit):
# HBM bytes per second, float32 FLOP/s outside the tensor cores, and bf16
# and TF32 FLOP/s of the tensor cores (the peaks for those operands).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
# float32 products at 3xTF32 (csrc/fb_stats.cuh): three TF32 products each
TF32X3_FLOP_PER_S = TF32_FLOP_PER_S / 3

# the probe kernels of csrc/split_probe.cu, by the micro body they run
MICRO_KERNELS = {
    "dot_only": "probe_micro_kernel<DOT_ONLY>",
    "dot_store": "probe_micro_kernel<DOT_STORE>",
    "dot_bf16": "probe_micro_kernel<BF16>",
    "chunk8": "probe_micro_kernel<CHUNKED, 8>",
    "chunk4": "probe_micro_kernel<CHUNKED, 4>",
}


def bound(nbytes: float, flops: float, flop_rate: float = F32_FLOP_PER_S) -> tuple[float, str]:
    """The least time (ms) the card could take: the larger of the bytes over
    the HBM rate and the operations over ``flop_rate``, and which it is."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / flop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_work(name: str, B: int, T: int, K: int, F: int = 0, gated: bool = False,
                emit_gamma: bool = False, C: int = 8, D: int = 0,
                bf16_alpha: bool = False) -> tuple[float, float, float]:
    """(bytes, flops, peak FLOP/s) one launch needs at these shapes: each
    input read once and each output written once (float32, the BF16 probe's
    alpha bf16), and per (t, b) the flops of the recursion: a K-wide F-dot
    per state 2FK, a matvec 2K^2, an outer product 2K^2, the emission outer
    product 2KF, and the elementwise work (shift, exp, scalings, the
    reductions) counted per state. The forward probes renormalise at the
    steps t > 0 with (t % C) % 4 == 0 (debug_pallas_split.py:41-46), the
    micro probes scale their carry once a tile. Only the BF16 probe counts
    at the bf16 peak.

    "outer_sums" is the large-K statistics' outer sums of one backward
    (``csrc/fb_stats.cuh``): acc = sum over the (T - 1) B rows t >= 1 of
    outer(a_{t-1}, dn_t) and, when F > 0, eacc = sum over the T B rows of
    outer(gw_t, f_t): their operands read once, acc and eacc written once,
    2 K^2 + 2 K F flops a row, at the 3xTF32 rate (three TF32 products a
    float32 one).

    The fused and duplex kernels' modes: D > 0 (in-kernel features) reads
    the D-wide observation rows in place of the F-wide feature rows and adds
    the build's products, F - 1 - D a row in each kernel that builds them
    (both halves of the duplex chain); ``bf16_alpha`` (the fused and the
    split pair) moves alpha as 2-byte words, written by the forward and
    read by the backward. The fused pair's counts hold at any F: above F =
    64 its instances (WF) write w_t gamma_t to a scratch window and read it
    back for eacc's sums, traffic of the method and not of the function,
    which the bound does not count.

    The large-K statistics' operand kernels of those modes, over the B T
    rows (t, b) of one window: "build_feats_kernel" reads D floats a row,
    writes its F features and does their F - 1 - D products;
    "widen_kernel" reads K bf16 words a row and writes K float32 ones
    (no arithmetic)."""
    n, k2 = B * T, K * K
    if name == "build_feats_kernel":
        return 4.0 * n * (D + F), float(n * (F - 1 - D)), F32_FLOP_PER_S
    if name == "widen_kernel":
        return 6.0 * n * K, 0.0, F32_FLOP_PER_S
    if name == "outer_sums":
        rows_a, rows_e = (T - 1) * B, (T * B if F > 0 else 0)
        words = 2 * rows_a * K + rows_e * (K + F) + k2 + K * F
        flops = 2 * rows_a * k2 + 2 * rows_e * K * F
        return 4.0 * words, float(flops), TF32X3_FLOP_PER_S
    tiles = T // C
    renorms = tiles * ((C - 1) // 4 + 1) - 1  # per sequence: t > 0 with (t % C) % 4 == 0
    micro = {kernel: body for body, kernel in MICRO_KERNELS.items()}
    if name in micro:
        body = micro[name]
        stored = {"dot_only": B * tiles * K, "dot_bf16": n * K / 2}.get(body, n * K)
        # lik_0, pi, A in; alpha out (every C-th row for dot_only, bf16 halves)
        words = B * K + K + k2 + stored
        flops = n * 2 * k2 + B * K + B * tiles * K  # products, pi * lik_0, carries
        rate = BF16_FLOP_PER_S if body == "dot_bf16" else F32_FLOP_PER_S
        return 4.0 * words, float(flops), rate
    per_tb = {
        "fused_fwd_kernel": 2 * F * K + 2 * k2 + 6 * K,
        "fused_bwd_kernel": 4 * F * K + 4 * k2 + 8 * K + (2 * K if gated else 0),
        "split_fwd_kernel": 2 * k2 + 6 * K,
        "split_bwd_kernel": 4 * k2 + 8 * K + (K if gated else 0),
        # both recursions: an F-dot and a matvec each
        "duplex_chain_kernel": 4 * F * K + 4 * k2 + 12 * K,
        # the F-dot, the pairwise and the emission outer products
        "duplex_combine_kernel": 4 * F * K + 2 * k2 + 10 * K + (2 * K if gated else 0),
        # matvec, the likelihood product; the renormalisations below
        "probe_fwd_nos_kernel": 2 * k2 + K,
        # and each step's sum
        "probe_fwd_stack_kernel": 2 * k2 + 2 * K,
    }[name]
    words = {
        # feats in, W, A~, pi~; alpha, s, sh out
        "fused_fwd_kernel": n * F + F * K + k2 + K + n * K + 2 * n,
        # feats, alpha, s, sh, W, A~ (+ w, the pair gate formed in-kernel) in;
        # gamma0, acc, eacc (+ gamma) out
        "fused_bwd_kernel": n * F + n * K + 2 * n + F * K + k2 + (n if gated else 0)
        + B * K + k2 + K * F + (n * K if emit_gamma else 0),
        # ll, A~, pi~ in; alpha, s, sh out
        "split_fwd_kernel": n * K + k2 + K + n * K + 2 * n,
        # ll, alpha, s, sh, A~ (+ g) in; gamma, acc out
        "split_bwd_kernel": 2 * n * K + 2 * n + k2 + (n if gated else 0) + n * K + k2,
        # feats, W, A~, pi~ in; alpha, s, sh, beta out
        "duplex_chain_kernel": n * F + F * K + k2 + K + 2 * n * K + 2 * n,
        # feats, alpha, beta, sh, W (+ w) in; gamma0, acc, eacc (+ gamma) out
        "duplex_combine_kernel": n * F + 2 * n * K + n + F * K + (n if gated else 0)
        + B * K + k2 + K * F + (n * K if emit_gamma else 0),
        # lik, A, pi in; alpha out
        "probe_fwd_nos_kernel": n * K + k2 + K + n * K,
        # lik, A, pi in; alpha, s out
        "probe_fwd_stack_kernel": n * K + k2 + K + n * K + n,
    }[name]
    flops = n * per_tb
    nbytes = 4.0 * words
    if D > 0:  # observation rows in, the features built on the chip
        nbytes -= 4.0 * n * (F - D)
        flops += n * (F - 1 - D) * (2 if name == "duplex_chain_kernel" else 1)
    if bf16_alpha and name in ("fused_fwd_kernel", "fused_bwd_kernel", "split_fwd_kernel",
                               "split_bwd_kernel"):
        nbytes -= 2.0 * n * K
    if name == "probe_fwd_nos_kernel":
        flops += B * renorms * 2 * K  # a sum and a division per state
    elif name == "probe_fwd_stack_kernel":
        flops += B * renorms * K  # a division per state
    return nbytes, float(flops), F32_FLOP_PER_S
