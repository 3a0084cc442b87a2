"""The port's CUDA kernels against their plain PyTorch twins, on the card:
the fused pair (gated and not), the split pair (gated and not), the duplex
pair (gated and not), the split path's probes, and the engines' routes
through them (features wider than the fused kernels take included); the
trainer's kill-and-resume on the kernel routes, checkpoints of card state
and the loader's prefetched batches; the long-chain tiers' stored and
rematerialised alphas and their boundary recursions replayed as CUDA graphs;
the data-parallel VB step in spawned process groups on the card (NCCL in a
world of one, two gloo ranks); the fused and duplex kernels' modes (in-kernel
NIW and NIG features, the gamma pick, bf16-stored alpha) at one small shape
a tier, by chip_smoke.py phase 14's checks; the fused pair's instances at
features wider than 64 (F = 65 to 300) in every kind and mode, and the
split pair's bf16-stored alpha, by phase 15's.

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch for CUDA and nvcc:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test needs the card and skips without it (the ``cuda`` marker). The
inputs are chip_smoke.py's: overlapping states, so posteriors spread. The
kernels and twins compute the same float32 recursion in another summation
order, and acc and eacc are sums over all sequences in another grouping, so the
tolerances are those of tests/test_pallas.py:246-251, relative for those
sums. The kernels take K up to 256 (the large-K instances above 64); the
large-K statistics' outer sums run on the tensor cores at 3xTF32 and are
held to float64 beside float32 torch.matmul.
"""

import math

import numpy as np
import pytest
import torch

from chip_smoke import (
    WF_BS,
    WF_CASES,
    WF_KS,
    check_bf16_alpha,
    check_gamma_sel,
    check_mode_features,
    check_split_bf16,
    check_split_exact,
    check_wide_f,
    digest,
    random_problem,
    state_digests,
    store_remat_digests,
    svi_masks,
)
from pysvihmm_tpu_torch import messages
from pysvihmm_tpu_torch.data.loader import ShardedSequenceLoader
from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
from pysvihmm_tpu_torch.data.synthetic import gen_multinomial_dataset
from pysvihmm_tpu_torch.distributions import GaussianNIW, MultinomialDirichlet
from pysvihmm_tpu_torch.engines import batch_vb, svi, trainer
from pysvihmm_tpu_torch.engines.base import batch_local_step
from pysvihmm_tpu_torch.messages import duplex_fb, fused_fb, split_fb, split_probe
from pysvihmm_tpu_torch.models.hmm import init_params, make_prior
from pysvihmm_tpu_torch.parallel import make_dp_vb_step, make_mesh, shard_batch, spawn_local
from pysvihmm_tpu_torch.scripts.debug_split import make_inputs
from pysvihmm_tpu_torch.utils import checkpoint

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc: the CUDA kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("B,T,K,D", [(8, 50, 4, 2), (16, 200, 64, 8), (5, 64, 33, 9)])
@pytest.mark.parametrize("emit_gamma", [True, False])
def test_kernels_match_plain_twins(cuda_device, B, T, K, D, emit_gamma):
    gen = torch.Generator(device=cuda_device).manual_seed(B + T)
    log_pi, log_A, W, feats = random_problem(gen, B, T, K, D)
    before = (fused_fb.fused_forward.launches, fused_fb.fused_backward.launches)
    fk, Sk = fused_fb.estep_fused(log_pi, log_A, W, feats, emit_gamma=emit_gamma)
    torch.cuda.synchronize()
    assert (fused_fb.fused_forward.launches, fused_fb.fused_backward.launches) == (
        before[0] + 1, before[1] + 1)
    fr, Sr = fused_fb.estep_fused_reference(log_pi, log_A, W, feats, emit_gamma=emit_gamma)
    if emit_gamma:
        torch.testing.assert_close(fk.gamma, fr.gamma, rtol=0, atol=5e-5)
    else:
        assert fk.gamma is None
    torch.testing.assert_close(fk.init_stats, fr.init_stats, rtol=0, atol=5e-5)
    # per-step log c_t carries the likelihood dot's rounding (terms ~1e2)
    torch.testing.assert_close(fk.log_c, fr.log_c, rtol=2e-6, atol=1e-4)
    torch.testing.assert_close(fk.log_z, fr.log_z, rtol=2e-6, atol=0)
    torch.testing.assert_close(fk.trans_stats, fr.trans_stats, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(Sk, Sr, rtol=3e-3, atol=2e-3)


def _random_fused_inputs(gen, B, T, K, F):
    """pi~, A~ (rows summing to 0.9), W and features of any width F."""
    dev = gen.device
    pi = torch.rand(K, generator=gen, device=dev) + 0.1
    A = torch.rand((K, K), generator=gen, device=dev) + 0.1
    W = torch.randn((F, K), generator=gen, device=dev)
    feats = 0.5 * torch.randn((T, B, F), generator=gen, device=dev)
    return ((pi / pi.sum()).contiguous(), (0.9 * A / A.sum(1, keepdim=True)).contiguous(),
            W.contiguous(), feats.contiguous())


@pytest.mark.parametrize("B", [1, 3, 37, 1025])
@pytest.mark.parametrize("T", [1, 2])
@pytest.mark.parametrize("K,F", [(1, 1), (33, 64), (64, 1), (64, 64)])
def test_fused_block_layout_matches_twins(cuda_device, B, T, K, F):
    """Every built S (sequences a block; B = 1, 3, 37 and 1025 leave the
    last block short) against the twins, ungated and under random, all-zero
    and all-one kept-masks, emit_gamma both ways; alpha, s, sh, gamma and
    gamma0 equal the default S's bit for bit."""
    gen = torch.Generator(device=cuda_device).manual_seed(B * 7 + T * 3 + K + F)
    pi_t, A_t, W, feats = _random_fused_inputs(gen, B, T, K, F)
    a_r, s_r, sh_r = fused_fb.forward_reference(pi_t, A_t, W, feats)
    masks = [None, (torch.rand((T, B), generator=gen, device=cuda_device) < 0.6).float(),
             torch.zeros((T, B), device=cuda_device), torch.ones((T, B), device=cuda_device)]
    first = {}
    for S in fused_fb.SEQS:
        fwd = fused_fb._launch_forward(S, pi_t, A_t, W, feats)
        for x, r in zip(fwd, (a_r, s_r, sh_r)):
            torch.testing.assert_close(x, r, rtol=2e-6, atol=5e-5)
        first.setdefault("fwd", fwd)
        assert all(torch.equal(x, y) for x, y in zip(fwd, first["fwd"]))
        for i, w in enumerate(masks):
            for emit in (True, False):
                got = fused_fb._launch_backward(S, A_t, W, feats, a_r, s_r, sh_r, emit, w)
                ref = fused_fb.backward_reference(A_t, W, feats, a_r, s_r, sh_r, emit, w)
                if emit:
                    torch.testing.assert_close(got[0], ref[0], rtol=0, atol=5e-5)
                else:
                    assert got[0] is None
                torch.testing.assert_close(got[1], ref[1], rtol=0, atol=5e-5)
                torch.testing.assert_close(got[2], ref[2], rtol=1e-4, atol=1e-3)
                torch.testing.assert_close(got[3], ref[3], rtol=3e-3, atol=2e-3)
                key = (i, emit)
                first.setdefault(key, got)
                assert torch.equal(got[1], first[key][1])
                if emit:
                    assert torch.equal(got[0], first[key][0])


@pytest.mark.parametrize("B", [1, 3, 32, 1024, 2048])
@pytest.mark.parametrize("K", [33, 64, 65, 128, 129, 256])
def test_duplex_chain_is_the_fused_forward_bit_for_bit(cuda_device, B, K):
    """The chain at every built S (sequences a block; B = 1 and 3 leave the
    last block short, 2048 takes more than a wave; K = 65-256 the large-K
    instances) gives the fused forward's alpha, s and sh at that S bit for
    bit, and its beta agrees with the twin's; every S gives the same beta
    bits (each sequence's arithmetic does not depend on S)."""
    gen = torch.Generator(device=cuda_device).manual_seed(300 + K + B)
    log_pi, log_A, W, feats = random_problem(gen, B, 40, K, 8)
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    ref_beta = duplex_fb.duplex_chain_reference(pi_t, A_t, W, feats)[3]
    first = duplex_fb.duplex_chain(pi_t, A_t, W, feats)
    for S in duplex_fb.built_seqs(K):
        alpha, s, sh, beta = duplex_fb._launch_chain(S, pi_t, A_t, W, feats)
        for x, r in zip((alpha, s, sh), fused_fb._launch_forward(S, pi_t, A_t, W, feats)):
            assert torch.equal(x, r)
        assert torch.equal(beta, first[3])
        torch.testing.assert_close(beta, ref_beta, rtol=0, atol=5e-5)


@pytest.mark.parametrize("B,T,K", [(1, 1, 64), (3, 1, 8), (13, 19, 64), (9, 23, 33), (7, 9, 128),
                                   (1000, 300, 256), (2048, 150, 256)])
@pytest.mark.parametrize("gated", [False, True])
def test_duplex_combine_tile_edges(cuda_device, B, T, K, gated):
    """The combine against its twin at the edges of its tiles (8 sequences
    by chunks of time steps, stages of 8 steps up to K = 64): T = 1, T and B
    not multiples of 8, and at K = 256 windows of the large-K statistics
    whose edges fall inside a block's chunk (131 steps at B = 1000, 64 at
    2048); emit_gamma both ways."""
    gen = torch.Generator(device=cuda_device).manual_seed(600 + B + T + K)
    log_pi, log_A, W, feats = random_problem(gen, B, T, K, 3)
    w = svi_masks(gen, B, T, max(1, (3 * T) // 4)) if gated else None
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    a, s, sh, beta = duplex_fb.duplex_chain_reference(pi_t, A_t, W, feats)
    for emit in (True, False):
        before = duplex_fb.duplex_combine.launches
        got = duplex_fb.duplex_combine(W, feats, a, beta, sh, emit, w)
        torch.cuda.synchronize()
        assert duplex_fb.duplex_combine.launches == before + 1
        ref = duplex_fb.duplex_combine_reference(W, feats, a, beta, sh, emit, w)
        if emit:
            torch.testing.assert_close(got[0], ref[0], rtol=0, atol=5e-5)
        else:
            assert got[0] is None
        for x, r, rtol, atol in zip(got[1:], ref[1:], (0, 1e-4, 3e-3), (5e-5, 1e-3, 2e-3)):
            torch.testing.assert_close(x, r, rtol=rtol, atol=atol)


def test_duplex_chain_runs_several_sequences_a_block(cuda_device):
    """The chain's default S at the VB shape is one of the built S >= 2, by
    the library's occupancy query, and its 2 ceil(B/S) blocks run in one
    wave where some S allows it."""
    F = 45
    info = {S: duplex_fb.kernel_info("chain", S, F, cuda_device) for S in fused_fb.SEQS}
    S = duplex_fb.default_seqs(1024, F, cuda_device)
    assert S in fused_fb.SEQS and S >= 2
    fits = [x for x in fused_fb.SEQS
            if 2 * -(-1024 // x) <= info[x]["blocks_per_sm"] * info[x]["sms"]]
    assert S == (fits[0] if fits else fused_fb.SEQS[-1]), info


@pytest.mark.parametrize("K", [128, 256])
def test_large_k_duplex_chain_layout(cuda_device, K):
    """Above K = 64 the chain's default S at the VB shape (B=1024, F=45) is
    the one-wave rule's pick over the library's occupancy query (the
    smallest built S whose 2 ceil(B/S) blocks fit one wave, else the
    largest), and no built S takes fewer waves."""
    F, B = 45, 1024
    seqs = duplex_fb.built_seqs(K)
    info = {S: duplex_fb.kernel_info("chain", S, F, cuda_device, K=K) for S in seqs}
    waves = {S: 2 * -(-B // S) / (i["blocks_per_sm"] * i["sms"]) for S, i in info.items()}
    S = duplex_fb.default_seqs(B, F, cuda_device, K=K)
    fits = [x for x in seqs if waves[x] <= 1]
    assert S == (fits[0] if fits else seqs[-1]), info
    assert math.ceil(waves[S]) == min(math.ceil(w) for w in waves.values()), (waves, info)


def test_fused_pair_runs_b1024_in_one_wave(cuda_device):
    """At the VB shape (B=1024, F=45) each kernel's default S fits all
    ceil(B/S) blocks on the card at once, by the library's occupancy query."""
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for kind in ("forward", "backward", "gated backward"):
        S = fused_fb.default_seqs(kind, 1024, 45, cuda_device)
        info = fused_fb.kernel_info(kind, S, 45, cuda_device)
        assert info["sms"] == sms
        assert -(-1024 // S) <= info["blocks_per_sm"] * sms, (kind, S, info)


def test_wider_than_the_kernels_raises(cuda_device):
    """Just above the large-K instances' 256 states every launcher refuses
    (no fallback to "scan" or a twin)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    K = 257
    pi_t, A_t, W, feats = _random_fused_inputs(gen, 2, 8, K, 5)
    alpha = torch.rand((8, 2, K), generator=gen, device=cuda_device)
    s = torch.rand((2, 8), generator=gen, device=cuda_device)
    ll = torch.rand((8, 2, K), generator=gen, device=cuda_device)
    for call in (lambda: fused_fb.fused_forward(pi_t, A_t, W, feats),
                 lambda: fused_fb.fused_backward(A_t, W, feats, alpha, s, s),
                 lambda: split_fb.split_forward(pi_t, A_t, ll),
                 lambda: split_fb.split_backward(A_t, ll, alpha, s, s),
                 lambda: duplex_fb.duplex_chain(pi_t, A_t, W, feats),
                 lambda: duplex_fb.duplex_combine(W, feats, alpha, alpha, s),
                 lambda: split_probe.probe_fwd_nos(pi_t, A_t, ll, 4)):
        with pytest.raises(NotImplementedError, match="K <= 256"):
            call()


@pytest.mark.parametrize("B,T", [(5, 40), (2048, 150)])
@pytest.mark.parametrize("K", [65, 128, 256])
@pytest.mark.parametrize("gated", [False, True])
def test_large_k_kernels_match_plain_twins(cuda_device, B, T, K, gated):
    """The large-K instances of every route (fused, split, duplex) against
    their twins, emit_gamma both ways, each launch counted; the duplex
    chain's alpha, s and sh are the fused forward's bit for bit. At B = 2048
    the statistics take three windows of time steps (64, 64 and 22; the
    backward carries its beta from one to the next)."""
    D = 3
    gen = torch.Generator(device=cuda_device).manual_seed(400 + K)
    log_pi, log_A, W, feats = random_problem(gen, B, T, K, D)
    w = svi_masks(gen, B, T, (3 * T) // 4) if gated else None
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    a_r, s_r, sh_r = fused_fb.forward_reference(pi_t, A_t, W, feats)
    before = (fused_fb.fused_forward.launches, fused_fb.fused_backward.launches)
    fwd = fused_fb.fused_forward(pi_t, A_t, W, feats)
    for x, r in zip(fwd, (a_r, s_r)):
        torch.testing.assert_close(x, r, rtol=0, atol=5e-5)
    torch.testing.assert_close(fwd[2], sh_r, rtol=2e-6, atol=1e-4)
    for emit in (True, False):
        got = fused_fb.fused_backward(A_t, W, feats, a_r, s_r, sh_r, emit, w)
        ref = fused_fb.backward_reference(A_t, W, feats, a_r, s_r, sh_r, emit, w)
        if emit:
            torch.testing.assert_close(got[0], ref[0], rtol=0, atol=5e-5)
        else:
            assert got[0] is None
        torch.testing.assert_close(got[1], ref[1], rtol=0, atol=5e-5)
        torch.testing.assert_close(got[2], ref[2], rtol=1e-4, atol=1e-3)
        torch.testing.assert_close(got[3], ref[3], rtol=3e-3, atol=2e-3)
    torch.cuda.synchronize()
    assert (fused_fb.fused_forward.launches, fused_fb.fused_backward.launches) == (
        before[0] + 1, before[1] + 2)

    ll = (feats @ W).contiguous()
    fk = split_fb.estep_split(log_pi, log_A, ll, w)
    fr = split_fb.estep_split_reference(log_pi, log_A, ll, w)
    torch.testing.assert_close(fk.gamma, fr.gamma, rtol=0, atol=5e-5)
    torch.testing.assert_close(fk.log_c, fr.log_c, rtol=2e-6, atol=1e-4)
    torch.testing.assert_close(fk.trans_stats, fr.trans_stats, rtol=1e-4, atol=1e-3)

    alpha, s, sh, beta = duplex_fb.duplex_chain(pi_t, A_t, W, feats)
    ref = duplex_fb.duplex_chain_reference(pi_t, A_t, W, feats)
    torch.testing.assert_close(beta, ref[3], rtol=0, atol=5e-5)
    for x, r in zip((alpha, s, sh), fwd):
        assert torch.equal(x, r)
    got = duplex_fb.duplex_combine(W, feats, alpha, beta, sh, True, w)
    comb = duplex_fb.duplex_combine_reference(W, feats, alpha, beta, sh, True, w)
    for x, r, rtol, atol in zip(got, comb, (0, 0, 1e-4, 3e-3), (5e-5, 5e-5, 1e-3, 2e-3)):
        torch.testing.assert_close(x, r, rtol=rtol, atol=atol)


@pytest.mark.parametrize("B", [1, 3, 1024, 2048])
@pytest.mark.parametrize("K", [65, 128, 129, 256])
@pytest.mark.parametrize("gated", [False, True])
def test_large_k_pair_is_the_same_bits_at_every_s(cuda_device, B, K, gated):
    """Every built S of the large-K fused pair (sequences a block over one
    copy of A~; B = 1 and 3 leave the last block short, 2048 takes two waves
    at S = 8 and KP = 256) against the twins, emit_gamma both ways; alpha, s,
    sh, gamma, gamma0, acc and eacc are the same bits at every S (each
    sequence's arithmetic and the statistics' order do not depend on S), and
    the duplex chain's alpha, s and sh are the forward's. At B = 1024 and
    2048 the statistics take three windows of time steps."""
    T = 300 if B <= 1024 else 150
    gen = torch.Generator(device=cuda_device).manual_seed(700 + K + B)
    log_pi, log_A, W, feats = random_problem(gen, B, T, K, 3)
    w = svi_masks(gen, B, T, (3 * T) // 4) if gated else None
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    a_r, s_r, sh_r = fused_fb.forward_reference(pi_t, A_t, W, feats)
    ref = fused_fb.backward_reference(A_t, W, feats, a_r, s_r, sh_r, True, w)
    first = None
    for S in fused_fb.WIDE_SEQS:
        fwd = fused_fb._launch_forward(S, pi_t, A_t, W, feats)
        for x, r in zip(fwd, (a_r, s_r)):
            torch.testing.assert_close(x, r, rtol=0, atol=5e-5)
        torch.testing.assert_close(fwd[2], sh_r, rtol=2e-6, atol=1e-4)
        got = fused_fb._launch_backward(S, A_t, W, feats, a_r, s_r, sh_r, True, w)
        for x, r, rtol, atol in zip(got, ref, (0, 0, 1e-4, 3e-3), (5e-5, 5e-5, 1e-3, 2e-3)):
            torch.testing.assert_close(x, r, rtol=rtol, atol=atol)
        lean = fused_fb._launch_backward(S, A_t, W, feats, a_r, s_r, sh_r, False, w)
        assert lean[0] is None
        assert all(torch.equal(x, y) for x, y in zip(lean[1:], got[1:]))
        first = first or (fwd, got)
        assert all(torch.equal(x, y) for x, y in zip(fwd + got, first[0] + first[1])), S
    chain = duplex_fb.duplex_chain(pi_t, A_t, W, feats)
    assert all(torch.equal(x, y) for x, y in zip(chain[:3], first[0]))


@pytest.mark.parametrize("K", [128, 256])
def test_large_k_pair_runs_b1024_in_one_wave(cuda_device, K):
    """At the VB shape (B=1024, F=45) the large-K pair's default S fits all
    ceil(B/S) blocks on the card at once, by the library's occupancy query,
    and B=32 (the small SVI batch) keeps a block a sequence."""
    for kind in ("forward", "backward", "gated backward"):
        S = fused_fb.default_seqs(kind, 1024, 45, cuda_device, K=K)
        info = fused_fb.kernel_info(kind, S, 45, cuda_device, K=K)
        assert S in fused_fb.WIDE_SEQS and info["threads"] == K
        assert -(-1024 // S) <= info["blocks_per_sm"] * info["sms"], (kind, S, info)
        assert fused_fb.default_seqs(kind, 32, 45, cuda_device, K=K) == 1


@pytest.mark.parametrize("K", [64, 128, 256, 129])
@pytest.mark.parametrize("gated", [False, True])
def test_backward_statistics_repeat_bit_for_bit(cuda_device, K, gated):
    """acc and eacc of each backward kernel (fused, split, duplex combine)
    are the same bits over 5 calls on the same inputs: the sums across
    blocks run in an order fixed by the shapes. The fused backward at its
    default S and, above K = 64, at every built S, which all give the same
    bits there; the split backward at every built S, the same bits at every
    K (acc's sums do not depend on S)."""
    B, T, D = 2048, 150, 8  # three windows of the large-K statistics
    gen = torch.Generator(device=cuda_device).manual_seed(500 + K)
    log_pi, log_A, W, feats = random_problem(gen, B, T, K, D)
    w = svi_masks(gen, B, T, 100) if gated else None
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    a, s, sh, beta = duplex_fb.duplex_chain(pi_t, A_t, W, feats)
    ll = (feats @ W).contiguous()
    calls = {"fused": lambda: fused_fb.fused_backward(A_t, W, feats, a, s, sh, False, w)[2:],
             "split": lambda: split_fb.split_backward(A_t, ll, a, s, sh, w)[1:],
             "duplex": lambda: duplex_fb.duplex_combine(W, feats, a, beta, sh, False, w)[2:]}
    if K > 64:
        for S in fused_fb.WIDE_SEQS:
            calls[f"fused S={S}"] = lambda S=S: fused_fb._launch_backward(
                S, A_t, W, feats, a, s, sh, False, w)[2:]
    split_seqs = split_fb.built_seqs("backward" if w is None else "gated backward", K)
    for S in split_seqs:
        calls[f"split S={S}"] = lambda S=S: split_fb.split_backward(A_t, ll, a, s, sh, w, S=S)
    firsts = {}
    for name, call in calls.items():
        first = firsts[name] = call()
        for _ in range(4):
            assert all(torch.equal(x, y) for x, y in zip(call(), first)), name
    for S in fused_fb.WIDE_SEQS if K > 64 else ():
        assert all(torch.equal(x, y) for x, y in zip(firsts[f"fused S={S}"], firsts["fused"])), S
    for S in split_seqs:
        assert all(torch.equal(x, y) for x, y in zip(firsts[f"split S={S}"][1:], firsts["split"]))


@pytest.mark.parametrize("B", [1, 3, 37, 1024])
@pytest.mark.parametrize("K", [8, 64, 65, 129, 256])
@pytest.mark.parametrize("gated", [False, True])
def test_split_pair_at_every_s_matches_twins(cuda_device, B, K, gated):
    """Every built S of both split kernels (split_fb.built_seqs: up to K = 64
    the S-sequence instances, above the large-K ones; B = 1 and 3 leave the
    last block short) against the twins, gated and not, each launch counted;
    alpha, s, sh, gamma and acc are the same bits at every S, and the
    backward's five calls the same bits. At B = 1024 the large-K statistics
    take two windows of time steps."""
    T = 150 if B == 1024 else 90
    gen = torch.Generator(device=cuda_device).manual_seed(900 + K + B)
    log_pi, log_A, W, feats = random_problem(gen, B, T, K, 3)
    ll = (feats @ W).contiguous()
    w = svi_masks(gen, B, T, (3 * T) // 4) if gated else None
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    fr = split_fb.split_forward_reference(pi_t, A_t, ll)
    first = None
    for S in split_fb.built_seqs("forward", K):
        n = split_fb.split_forward.launches
        fwd = split_fb.split_forward(pi_t, A_t, ll, S=S)
        torch.cuda.synchronize()
        assert split_fb.split_forward.launches == n + 1
        for x, r in zip(fwd[:2], fr[:2]):
            torch.testing.assert_close(x, r, rtol=0, atol=5e-5)
        assert torch.equal(fwd[2], fr[2])
        first = first or fwd
        assert all(torch.equal(x, y) for x, y in zip(fwd, first)), S
    br = split_fb.split_backward_reference(A_t, ll, *fr, w)
    first = None
    for S in split_fb.built_seqs("backward" if w is None else "gated backward", K):
        n = split_fb.split_backward.launches
        got = [split_fb.split_backward(A_t, ll, *fr, w, S=S) for _ in range(5)]
        torch.cuda.synchronize()
        assert split_fb.split_backward.launches == n + 5
        torch.testing.assert_close(got[0][0], br[0], rtol=0, atol=5e-5)
        torch.testing.assert_close(got[0][1], br[1], rtol=1e-4, atol=1e-3)
        first = first or got[0]
        assert all(torch.equal(x, y) for c in got for x, y in zip(c, first)), S


@pytest.mark.parametrize("K", [64, 128, 256])
def test_split_pair_runs_b1024_in_one_wave(cuda_device, K):
    """At B=1024 each split kernel's default S (by the one-wave rule over the
    library's occupancy) fits all ceil(B/S) blocks on the card at once, and
    B=32 (the small SVI batch) takes the smallest S built."""
    for kind in ("forward", "backward", "gated backward"):
        S = split_fb.default_seqs(kind, 1024, cuda_device, K=K)
        info = split_fb.kernel_info(kind, S, cuda_device, K=K)
        assert S in split_fb.built_seqs(kind, K) and info["local_bytes"] == 0, (kind, info)
        assert info["threads"] == (64 if K <= 64 else K)
        assert -(-1024 // S) <= info["blocks_per_sm"] * info["sms"], (kind, S, info)
        assert split_fb.default_seqs(kind, 32, cuda_device, K=K) == split_fb.built_seqs(kind, K)[0]


# the row counts of the outer sums' checks: one row, under a stage, not a
# whole number of stages, the SVI window at W = 70 (B = 1024) and a full
# window of the large-K statistics (2^17 rows)
OUTER_ROWS = (1, 17, 1000, 71680, 1 << 17)
BACKWARD_ROWS = 71680  # from here on, rows as many as a backward's windows hold


@pytest.mark.parametrize("N", OUTER_ROWS)
@pytest.mark.parametrize("J", [1, 45, 64, 65, 256])
@pytest.mark.parametrize("I", [65, 128, 129, 256])
def test_outer_sum_against_float64(cuda_device, I, J, N):
    """The large-K statistics' outer sums (3xTF32 on the tensor cores)
    against float64 X^T Y, with operands like the backward's: X >= 0 (alpha
    rows, gamma rows), Y >= 0 where J > 64 (acc's d n) and signed up to 64
    columns (eacc's features). At the rows a backward's windows hold, the
    error relative to max |ref| is at most twice float32 torch.matmul's on
    the same operands (TF32 off): chip_smoke.py's gate. Below that the
    split's own error, up to about 3 x 2^-22 of each |x y|, can exceed
    twice float32's one rounding, so there the bound adds 2^-20 of the
    largest sum of |x y|. K = 65, 129 and F = 45
    rows are not 16-byte aligned and take the 4-byte copies. A second call
    gives the same bits."""
    gen = torch.Generator(device=cuda_device).manual_seed(I * 1000 + J + N)
    X = torch.rand((N, I), generator=gen, device=cuda_device)
    Y = (torch.rand if J > 64 else torch.randn)((N, J), generator=gen, device=cuda_device)
    before = fused_fb.outer_sum.launches
    got = fused_fb.outer_sum(X, Y)
    assert fused_fb.outer_sum.launches == before + 1
    assert torch.equal(fused_fb.outer_sum(X, Y), got)
    ref = X.double().T @ Y.double()
    scale = ref.abs().max().item()
    err = (got.double() - ref).abs().max().item() / scale
    err_mm = (torch.matmul(X.T, Y).double() - ref).abs().max().item() / scale
    allowed = 2 * err_mm
    if N < BACKWARD_ROWS:
        allowed += 2.0 ** -20 * (X.double().abs().T @ Y.double().abs()).max().item() / scale
    assert err <= allowed, (err, err_mm)


def test_outer_sum_copy_width_keeps_the_bits(cuda_device):
    """A base off 16 bytes takes the 4-byte copies where an aligned one
    takes 16-byte copies: the same bits either way."""
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    buf = torch.rand(5000 * 128 + 1, generator=gen, device=cuda_device)
    X, Y = buf[1:].view(5000, 128), torch.rand((5000, 128), generator=gen, device=cuda_device)
    assert torch.equal(fused_fb.outer_sum(X, Y), fused_fb.outer_sum(X.clone(), Y))
    Z = torch.randn((5000, 45), generator=gen, device=cuda_device)
    assert torch.equal(fused_fb.outer_sum(X, Z), fused_fb.outer_sum(X.clone(), Z))


@pytest.mark.parametrize("K", [128, 256])
def test_large_k_backward_launches_the_outer_sums_a_window(cuda_device, K):
    """Each large-K backward runs the outer sums once a window of its
    statistics for acc and once for eacc (acc only on the split backward):
    at B = 2048, T = 150 three windows; the libraries count the launches."""
    B, T, D = 2048, 150, 3
    gen = torch.Generator(device=cuda_device).manual_seed(600 + K)
    log_pi, log_A, W, feats = random_problem(gen, B, T, K, D)
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    a, s, sh, beta = duplex_fb.duplex_chain(pi_t, A_t, W, feats)
    ll = (feats @ W).contiguous()
    fused_fb.outer_launches(clear=True)
    fused_fb.fused_backward(A_t, W, feats, a, s, sh)
    assert fused_fb.outer_launches(clear=True) == 6
    split_fb.split_backward(A_t, ll, a, s, sh)
    assert fused_fb.outer_launches(clear=True) == 3
    duplex_fb.duplex_combine(W, feats, a, beta, sh)
    assert fused_fb.outer_launches(clear=True) == 6


def test_auto_runs_the_kernels_in_batch_vb(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    obs, _, _ = gen_gaussian_dataset(g, 4, 2, 16, 100)
    prior = make_prior(4, GaussianNIW, obs_dim=2, device=cuda_device)
    p0 = init_params(g, prior, GaussianNIW, obs)
    fused_fb.reset_launch_counts()
    params, elbos = batch_vb.fit(p0, prior, obs, GaussianNIW, num_iters=3)
    assert (fused_fb.fused_forward.launches, fused_fb.fused_backward.launches) == (3, 3)
    assert bool(torch.isfinite(elbos).all())
    # gated: the kernel route against the same call on CPU tensors (the twins)
    w = svi_masks(g, 16, 100, 60).T.contiguous()  # (B, T)
    sk, gk = batch_local_step(params, GaussianNIW, obs, weights=w)
    torch.cuda.synchronize()
    assert fused_fb.fused_backward.launches == 4
    cpu = params._replace(init=params.init.cpu(), trans=params.trans.cpu(),
                          emit=type(params.emit)(*(x.cpu() for x in params.emit)))
    sr, gr = batch_local_step(cpu, GaussianNIW, obs.cpu(), "fused", weights=w.cpu())
    torch.testing.assert_close(gk.cpu(), gr, rtol=0, atol=5e-5)
    torch.testing.assert_close(sk.init.cpu(), sr.init, rtol=0, atol=5e-5)
    torch.testing.assert_close(sk.trans.cpu(), sr.trans, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(sk.log_z.cpu(), sr.log_z, rtol=2e-6, atol=0)
    for a, b in zip(sk.emit, sr.emit):
        torch.testing.assert_close(a.cpu(), b, rtol=3e-3, atol=2e-3)


@pytest.mark.parametrize("K", [4, 33, 64])
@pytest.mark.parametrize("emit_gamma", [True, False])
def test_gated_fused_kernels_match_plain_twins(cuda_device, K, emit_gamma):
    B, T, D = 24, 70, 8
    gen = torch.Generator(device=cuda_device).manual_seed(K)
    log_pi, log_A, W, feats = random_problem(gen, B, T, K, D)
    w = svi_masks(gen, B, T, 50)
    before = fused_fb.fused_backward.launches
    fk, Sk = fused_fb.estep_fused(log_pi, log_A, W, feats, emit_gamma, weights=w)
    torch.cuda.synchronize()
    assert fused_fb.fused_backward.launches == before + 1
    fr, Sr = fused_fb.estep_fused_reference(log_pi, log_A, W, feats, emit_gamma, weights=w)
    if emit_gamma:
        torch.testing.assert_close(fk.gamma, fr.gamma, rtol=0, atol=5e-5)
    torch.testing.assert_close(fk.init_stats, fr.init_stats, rtol=0, atol=5e-5)
    torch.testing.assert_close(fk.log_c, fr.log_c, rtol=2e-6, atol=1e-4)
    torch.testing.assert_close(fk.trans_stats, fr.trans_stats, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(Sk, Sr, rtol=3e-3, atol=2e-3)


@pytest.mark.parametrize("K", [4, 33, 64])
@pytest.mark.parametrize("gated", [False, True])
def test_split_kernels_match_plain_twins(cuda_device, K, gated):
    B, T, D = 24, 70, 8
    gen = torch.Generator(device=cuda_device).manual_seed(100 + K)
    log_pi, log_A, W, feats = random_problem(gen, B, T, K, D)
    ll = (feats @ W).contiguous()
    w = svi_masks(gen, B, T, 50) if gated else None
    before = (split_fb.split_forward.launches, split_fb.split_backward.launches)
    fk = split_fb.estep_split(log_pi, log_A, ll, w)
    torch.cuda.synchronize()
    assert (split_fb.split_forward.launches, split_fb.split_backward.launches) == (
        before[0] + 1, before[1] + 1)
    fr = split_fb.estep_split_reference(log_pi, log_A, ll, w)
    torch.testing.assert_close(fk.gamma, fr.gamma, rtol=0, atol=5e-5)
    torch.testing.assert_close(fk.init_stats, fr.init_stats, rtol=0, atol=5e-5)
    torch.testing.assert_close(fk.log_c, fr.log_c, rtol=2e-6, atol=1e-4)
    torch.testing.assert_close(fk.log_z, fr.log_z, rtol=2e-6, atol=0)
    torch.testing.assert_close(fk.trans_stats, fr.trans_stats, rtol=1e-4, atol=1e-3)


def test_e_step_batched_launches_the_split_kernels(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    log_pi, log_A, W, feats = random_problem(gen, 8, 40, 6, 2)
    ll = (feats @ W).transpose(0, 1).contiguous()  # (B, T, K)
    split_fb.reset_launch_counts()
    fb = messages.e_step_batched(log_pi, log_A, ll)
    torch.cuda.synchronize()
    assert (split_fb.split_forward.launches, split_fb.split_backward.launches) == (1, 1)
    ref = messages.e_step_batched(log_pi.cpu(), log_A.cpu(), ll.cpu(), method="split")
    torch.testing.assert_close(fb.gamma.cpu(), ref.gamma, rtol=0, atol=5e-5)


def test_svi_step_on_auto_launches_each_fused_kernel_once(cuda_device):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    obs, _, _ = gen_gaussian_dataset(g, 4, 2, 1, 2000)
    chain = obs[0]
    prior = make_prior(4, GaussianNIW, obs_dim=2, device=cuda_device)
    p0 = init_params(g, prior, GaussianNIW, chain)
    cfg = svi.SVIConfig(batch_size=16, subchain_len=50, buffer=10)
    step = svi.make_step(GaussianNIW, cfg, chain.shape[0])
    fused_fb.reset_launch_counts()
    split_fb.reset_launch_counts()
    state, m = step(svi.init_state(p0, torch.Generator(device=cuda_device).manual_seed(2)),
                    prior, chain)
    torch.cuda.synchronize()
    assert (fused_fb.fused_forward.launches, fused_fb.fused_backward.launches) == (1, 1)
    assert (split_fb.split_forward.launches, split_fb.split_backward.launches) == (0, 0)
    assert bool(torch.isfinite(m["noisy_elbo"])) and int(state.step) == 1


@pytest.mark.parametrize("B,T,K,D", [(8, 50, 4, 2), (16, 200, 64, 8), (5, 64, 33, 9)])
@pytest.mark.parametrize("gated", [False, True])
def test_duplex_kernels_match_plain_twins(cuda_device, B, T, K, D, gated):
    """Each duplex kernel against its twin (the combine on the twin's chain
    outputs, in stages of 8 steps that divide T=64 and not T=50), the
    chain's forward against the fused forward kernel bit for bit, and the
    whole duplex E-step."""
    gen = torch.Generator(device=cuda_device).manual_seed(200 + B + K)
    log_pi, log_A, W, feats = random_problem(gen, B, T, K, D)
    w = svi_masks(gen, B, T, (5 * T) // 7) if gated else None
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    before = (duplex_fb.duplex_chain.launches, duplex_fb.duplex_combine.launches)
    alpha, s, sh, beta = duplex_fb.duplex_chain(pi_t, A_t, W, feats)
    got = duplex_fb.duplex_combine(W, feats, alpha, beta, sh, True, w)
    torch.cuda.synchronize()
    assert (duplex_fb.duplex_chain.launches, duplex_fb.duplex_combine.launches) == (
        before[0] + 1, before[1] + 1)
    ref = duplex_fb.duplex_chain_reference(pi_t, A_t, W, feats)
    for x, r in zip((alpha, s, beta), (ref[0], ref[1], ref[3])):
        torch.testing.assert_close(x, r, rtol=0, atol=5e-5)
    torch.testing.assert_close(sh, ref[2], rtol=2e-6, atol=1e-4)
    for x, r in zip((alpha, s, sh), fused_fb.fused_forward(pi_t, A_t, W, feats)):
        assert torch.equal(x, r)
    comb = duplex_fb.duplex_combine_reference(W, feats, alpha, beta, sh, True, w)
    for x, r, rtol, atol in zip(got, comb, (0, 0, 1e-4, 3e-3), (5e-5, 5e-5, 1e-3, 2e-3)):
        torch.testing.assert_close(x, r, rtol=rtol, atol=atol)
    fk, Sk = duplex_fb.estep_duplex(log_pi, log_A, W, feats, False, w)
    fr, Sr = duplex_fb.estep_duplex_reference(log_pi, log_A, W, feats, False, w)
    assert fk.gamma is None
    torch.testing.assert_close(fk.init_stats, fr.init_stats, rtol=0, atol=5e-5)
    torch.testing.assert_close(fk.log_c, fr.log_c, rtol=2e-6, atol=1e-4)
    torch.testing.assert_close(fk.trans_stats, fr.trans_stats, rtol=1e-4, atol=1e-3)
    torch.testing.assert_close(Sk, Sr, rtol=3e-3, atol=2e-3)


@pytest.mark.parametrize("K,F", [(257, 10), (8, 65)])
def test_duplex_wider_than_the_kernels_raises(cuda_device, K, F):
    gen = torch.Generator(device=cuda_device).manual_seed(K + F)
    A_t = torch.rand((K, K), generator=gen, device=cuda_device)
    W = torch.rand((F, K), generator=gen, device=cuda_device)
    feats = torch.rand((6, 2, F), generator=gen, device=cuda_device)
    with pytest.raises(NotImplementedError, match="K <= 256 and F <= 64"):
        duplex_fb.duplex_chain(torch.rand(K, generator=gen, device=cuda_device), A_t, W, feats)
    alpha = torch.rand((6, 2, K), generator=gen, device=cuda_device)
    sh = torch.rand((2, 6), generator=gen, device=cuda_device)
    with pytest.raises(NotImplementedError, match="K <= 256 and F <= 64"):
        duplex_fb.duplex_combine(W, feats, alpha, alpha, sh)


@pytest.mark.parametrize("route", ["fused", "duplex", "auto", "split"])
def test_wide_features_take_the_split_kernels(cuda_device, route):
    """Features wider than 64 (a multinomial of 100 and of 300 symbols, a
    Gaussian-NIW at D = 10, F = 66), routed as JAX routes them: on "fused"
    and "auto" (the card's "fused") the fused pair at F = 66 and 100 and
    the split kernels above 256 symbols; on "duplex" the split kernels at
    every such width (its kernels take F <= 64); on "split" the split
    kernels. One launch of each kernel of the route, no other E-step
    kernel, and the statistics those of "scan", gated and not."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    for fam, size in ((MultinomialDirichlet, 100), (MultinomialDirichlet, 300), (GaussianNIW, 10)):
        if fam is MultinomialDirichlet:
            obs, _, _ = gen_multinomial_dataset(g, 4, size, 4, 30)
            prior = make_prior(4, fam, num_symbols=size, device=cuda_device)
        else:
            obs, _, _ = gen_gaussian_dataset(g, 4, size, 4, 30)
            prior = make_prior(4, fam, obs_dim=size, device=cuda_device)
        p0 = init_params(g, prior, fam, obs)
        for w in (None, svi_masks(g, 4, 30, 20).T.contiguous()):
            for reset in (fused_fb, split_fb, duplex_fb):
                reset.reset_launch_counts()
            stats, _ = batch_local_step(p0, fam, obs, route, weights=w)
            torch.cuda.synchronize()
            fused = route in ("fused", "auto") and size != 300
            n = (1, 1) if fused else (0, 0)
            assert (fused_fb.fused_forward.launches, fused_fb.fused_backward.launches) == n
            n = (0, 0) if fused else (1, 1)
            assert (split_fb.split_forward.launches, split_fb.split_backward.launches) == n
            assert (duplex_fb.duplex_chain.launches, duplex_fb.duplex_combine.launches) == (0, 0)
            ref, _ = batch_local_step(p0, fam, obs, "scan", weights=w)
            emit = stats.emit if isinstance(stats.emit, tuple) else (stats.emit,)
            emit_ref = ref.emit if isinstance(ref.emit, tuple) else (ref.emit,)
            for a, b in zip(emit, emit_ref):
                torch.testing.assert_close(a, b, rtol=3e-3, atol=2e-3)
            torch.testing.assert_close(stats.trans, ref.trans, rtol=1e-4, atol=1e-3)
            torch.testing.assert_close(stats.log_z, ref.log_z, rtol=2e-6, atol=0)


def test_fmax_is_the_kernels_own(cuda_device):
    """The engines' routing constant for "duplex" is the width its library
    reports; the fused library reports none (it takes any F) and the fused
    launchers run F = 65 on the card."""
    assert duplex_fb._library().duplex_fb_fmax() == fused_fb.FMAX
    assert not hasattr(fused_fb._library(), "fused_fb_fmax")
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    pi_t, A_t, W, feats = _random_fused_inputs(gen, 3, 10, 8, fused_fb.FMAX + 1)
    alpha, s, sh = fused_fb.fused_forward(pi_t, A_t, W, feats)
    assert bool(torch.isfinite(fused_fb.fused_backward(A_t, W, feats, alpha, s, sh)[2]).all())


@pytest.mark.parametrize("T,B,K,C", [(16, 4, 8, 8), (24, 3, 33, 4), (16, 37, 64, 8),
                                     (16, 5, 65, 8), (24, 11, 128, 4), (16, 9, 256, 8)])
def test_split_probes_match_plain_twins(cuda_device, T, B, K, C):
    """Each probe kernel (every micro instance; B = 3 and 37 leave the
    chunked blocks ragged) against its twin, one counted launch each:
    float32 to rtol 1e-5 per element with atol 1e-30 (the micro bodies'
    third tile is subnormal), bf16 in its own dtype to two ulps, "dot_only"
    on its written rows only."""
    pi, A, lik = make_inputs(B, T, K, cuda_device)
    split_probe.reset_launch_counts()
    nos = split_probe.probe_fwd_nos(pi, A, lik, C)
    stack = split_probe.probe_fwd_stack(pi, A, lik, C)
    micro = {b: split_probe.probe_micro(pi, A, lik, C, b) for b in split_probe.MICRO_BODIES}
    torch.cuda.synchronize()
    assert split_probe.probe_fwd_nos.launches == split_probe.probe_fwd_stack.launches == 1
    assert split_probe.probe_micro.launches == dict.fromkeys(split_probe.MICRO_BODIES, 1)
    torch.testing.assert_close(nos, split_probe.probe_fwd_nos_reference(pi, A, lik, C),
                               rtol=1e-5, atol=1e-30)
    for x, r in zip(stack, split_probe.probe_fwd_stack_reference(pi, A, lik, C)):
        torch.testing.assert_close(x, r, rtol=1e-5, atol=1e-30)
    for body, got in micro.items():
        ref = split_probe.probe_micro_reference(pi, A, lik, C, body)
        rows = slice(None, None, C) if body == "dot_only" else slice(None)
        rtol = 1.6e-2 if body == "dot_bf16" else 1e-5
        assert got.dtype == ref.dtype == split_probe.micro_dtype(body)
        torch.testing.assert_close(got[rows], ref[rows], rtol=rtol, atol=1e-30)


def test_split_probes_refuse_k_above_256(cuda_device):
    pi, A, lik = make_inputs(2, 8, 257, cuda_device)
    for call in (lambda: split_probe.probe_fwd_nos(pi, A, lik, 4),
                 lambda: split_probe.probe_fwd_stack(pi, A, lik, 4),
                 lambda: split_probe.probe_micro(pi, A, lik, 4, "dot_store")):
        with pytest.raises(NotImplementedError, match="K <= 256"):
            call()


def test_duplex_route_runs_the_duplex_kernels(cuda_device):
    """batch VB and an SVI step on method="duplex": each duplex kernel once
    per call and no other E-step kernel."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    obs, _, _ = gen_gaussian_dataset(g, 4, 2, 16, 100)
    prior = make_prior(4, GaussianNIW, obs_dim=2, device=cuda_device)
    p0 = init_params(g, prior, GaussianNIW, obs)
    for reset in (fused_fb, split_fb, duplex_fb):
        reset.reset_launch_counts()
    _, elbos = batch_vb.fit(p0, prior, obs, GaussianNIW, num_iters=3, method="duplex")
    step = svi.make_step(GaussianNIW, svi.SVIConfig(batch_size=8, subchain_len=20, buffer=5),
                         obs.shape[1], method="duplex")
    state, m = step(svi.init_state(p0, torch.Generator(device=cuda_device).manual_seed(2)),
                    prior, obs[0])
    torch.cuda.synchronize()
    assert (duplex_fb.duplex_chain.launches, duplex_fb.duplex_combine.launches) == (4, 4)
    assert (fused_fb.fused_forward.launches, fused_fb.fused_backward.launches) == (0, 0)
    assert (split_fb.split_forward.launches, split_fb.split_backward.launches) == (0, 0)
    assert bool(torch.isfinite(elbos).all()) and bool(torch.isfinite(m["noisy_elbo"]))


def test_gibbs_sweep_on_cuda_matches_cpu(cuda_device):
    """A Gibbs sweep on the card: drawn on the card's generator (a CPU
    generator with card data raises), and fed the same draws it gives the
    paths and theta of the float64 sweep on the CPU."""
    from chip_smoke import cpu64, rel_max_err
    from pysvihmm_tpu_torch.distributions import dirichlet
    from pysvihmm_tpu_torch.engines import gibbs
    from pysvihmm_tpu_torch.messages.scan_fb import gumbel
    from pysvihmm_tpu_torch.models.hmm import emission_flat_stats

    K, B, T = 4, 16, 100
    g = torch.Generator(device=cuda_device).manual_seed(5)
    obs, _, _ = gen_gaussian_dataset(g, K, 2, B, T, mean_scale=4.0, cov_scale=0.3)
    prior = make_prior(K, GaussianNIW, obs_dim=2, device=cuda_device)
    with pytest.raises(ValueError, match="generator on cpu"):
        gibbs.init_state(torch.Generator(), prior, GaussianNIW, obs, K)
    state, _ = gibbs.run(gibbs.init_state(g, prior, GaussianNIW, obs, K), prior, obs,
                         GaussianNIW, K, 3)
    _, trans_c, oh = gibbs._count_stats(state.z, K, torch.float32)
    post = GaussianNIW.posterior(prior.emit, emission_flat_stats(GaussianNIW, prior.emit, oh, obs))
    draws = gibbs.GibbsDraws(gumbel(g, (B, T, K), torch.float32),
                             dirichlet.log_gamma(g, prior.init + oh[:, 0].sum(0)),
                             dirichlet.log_gamma(g, prior.trans + trans_c),
                             GaussianNIW.sample_draws(g, post))
    sweep = gibbs.make_sweep(GaussianNIW, K)
    card, _ = sweep.with_draws(state, prior, obs, draws)
    cpu, _ = sweep.with_draws(gibbs.GibbsState(state.z.cpu(), cpu64(state.theta), None),
                              cpu64(prior), cpu64(obs), cpu64(draws))
    assert card.z.device.type == "cuda"
    assert torch.equal(card.z.cpu(), cpu.z)
    assert rel_max_err(card.theta, cpu.theta) < 1e-4


def test_metaobs_step_on_cuda_matches_cpu(cuda_device):
    """A meta-observation step on the card's "auto" (the gated fused pair,
    once each) against the kernels' twins and "scan" on the CPU, on the
    same blocks; the step draws its blocks on the card's generator."""
    from pysvihmm_tpu_torch.convert import params_from_numpy, params_to_numpy
    from pysvihmm_tpu_torch.engines import metaobs

    def on_cpu(p):
        return params_from_numpy(params_to_numpy(p), device="cpu")

    def leaves(p):
        return [p.init, p.trans, *p.emit]

    K, D, T = 4, 2, 2000
    g = torch.Generator(device=cuda_device).manual_seed(6)
    chain = gen_gaussian_dataset(g, K, D, 1, T, mean_scale=0.5, cov_scale=1.0)[0][0]
    prior = make_prior(K, GaussianNIW, obs_dim=D, device=cuda_device)
    p0 = init_params(g, prior, GaussianNIW, chain)
    cfg = metaobs.MetaObsConfig(minibatch=12, block_len=50, buffer=10)
    ids = torch.randperm(T // 50, generator=g, device=cuda_device)[:12]
    fused_fb.reset_launch_counts()
    step = metaobs.make_step(GaussianNIW, cfg, T)
    card, m = step.with_blocks(svi.init_state(p0, g), prior, chain, ids)
    torch.cuda.synchronize()
    assert (fused_fb.fused_forward.launches, fused_fb.fused_backward.launches) == (1, 1)
    for route in ("fused", "scan"):
        ref, rm = metaobs.make_step(GaussianNIW, cfg, T, route).with_blocks(
            svi.init_state(on_cpu(p0), torch.Generator()), on_cpu(prior), chain.cpu(), ids.cpu())
        for a, b in zip(leaves(card.params), leaves(ref.params), strict=True):
            torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=1e-4)
        torch.testing.assert_close(m["noisy_elbo"].cpu(), rm["noisy_elbo"], rtol=2e-5, atol=0)
    state, _ = step(svi.init_state(p0, torch.Generator(device=cuda_device).manual_seed(7)), prior,
                    chain)
    assert int(state.step) == 1


@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize("adaptive", [False, True])
def test_trainer_kill_resume_is_bitexact_on_the_card(cuda_device, tmp_path, route, adaptive):
    """K=64 windowed SVI through the trainer: killed at 7 of 12 steps
    (checkpoints every 3) and resumed from a fresh state, the uninterrupted
    run's bits in every leaf, the CUDA generator's state included."""
    gen = torch.Generator(device=cuda_device).manual_seed(131)
    chain = gen_gaussian_dataset(gen, 64, 8, 1, 5000, mean_scale=0.5, cov_scale=1.0)[0][0]
    prior = make_prior(64, GaussianNIW, obs_dim=8, device=cuda_device)
    p0 = init_params(gen, prior, GaussianNIW, chain)
    cfg = svi.SVIConfig(batch_size=64, subchain_len=50, buffer=10, adaptive=adaptive)
    step = svi.make_step(GaussianNIW, cfg, chain.shape[0], method=route)

    def fresh():
        return svi.init_state(p0, torch.Generator(device=cuda_device).manual_seed(7), adaptive)

    ref = trainer.train(step, fresh(), prior, chain, 12)
    trainer.train(step, fresh(), prior, chain, 7, checkpoint_dir=str(tmp_path), checkpoint_every=3)
    resumed = trainer.train(step, fresh(), prior, chain, 12, checkpoint_dir=str(tmp_path),
                            checkpoint_every=3)
    assert int(resumed.step) == 12
    assert state_digests(ref) == state_digests(resumed)


def test_checkpoint_restores_on_the_card(cuda_device, tmp_path):
    """A state written from the card comes back on the card: every tensor on
    its target's device, the generator a new CUDA generator with the saved
    state, drawing what the saved one would."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    chain = gen_gaussian_dataset(gen, 4, 2, 1, 400)[0][0]
    prior = make_prior(4, GaussianNIW, obs_dim=2, device=cuda_device)
    p0 = init_params(gen, prior, GaussianNIW, chain)
    cfg = svi.SVIConfig(batch_size=8, subchain_len=20, buffer=5, adaptive=True)
    state, _ = svi.fit(svi.init_state(p0, torch.Generator(device=cuda_device).manual_seed(4),
                                      adaptive=True), prior, chain, GaussianNIW, cfg, 5)
    path = str(tmp_path / "c.pt")
    checkpoint.save(path, state)
    fresh = svi.init_state(p0, torch.Generator(device=cuda_device).manual_seed(9), adaptive=True)
    restored = checkpoint.restore(path, fresh)
    assert restored.params.emit.psi.device.type == "cuda" and restored.step.device.type == "cuda"
    assert restored.generator.device.type == "cuda" and restored.generator is not fresh.generator
    assert torch.equal(restored.generator.get_state(), state.generator.get_state())
    assert state_digests(restored) == state_digests(state)
    draw = torch.randint(0, 10**6, (16,), generator=restored.generator, device=cuda_device)
    assert torch.equal(draw, torch.randint(0, 10**6, (16,), generator=state.generator,
                                           device=cuda_device))
    with pytest.raises(ValueError, match="cuda generator"):  # into a CPU generator
        checkpoint.restore(path, svi.init_state(p0, torch.Generator(), adaptive=True))


def test_prefetched_batches_equal_the_resident_corpus(cuda_device, tmp_path):
    """The loader's stream on the card (pinned gathers copied on its own
    stream, each batch's copy ordered before its use) gives the bits of the
    same rows gathered from the corpus on the card, across epochs and from
    a resumed position."""
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    obs = torch.randn((512, 300, 8), generator=gen, device=cuda_device)
    path = str(tmp_path / "corpus.npy")
    np.save(path, obs.cpu().numpy())
    loader = ShardedSequenceLoader.from_npy(path, cuda_device, batch_per_host=128, seed=2)
    assert loader.batches_per_epoch() == 4
    for start in (0, 3):
        stream = loader.stream(start)
        for s in range(start, start + 9):
            rows = torch.from_numpy(loader.epoch_order(s // 4)[(s % 4) * 128:(s % 4 + 1) * 128])
            batch = next(stream)
            assert batch.device.type == "cuda"
            assert torch.equal(batch * 1.0, obs[rows.to(cuda_device)])
        stream.close()


def test_long_chain_store_and_remat_same_bits(cuda_device):
    """The fused streaming tier at T = 10^5 (K=64, D=8) with stored and with
    rematerialised alphas: statistics and decode the same sha256
    (chip_smoke.py phase 12 (b) at a tenth of its length)."""
    d = store_remat_digests(cuda_device, 10**5)
    assert d[0] == d[2] and d[1] == d[3]


@pytest.mark.parametrize("n_blocks", [1, 1023, 1024, 2500])
def test_boundary_seeds_graphs_match_the_eager_loop(cuda_device, n_blocks):
    """Phase 2's recursions replayed as CUDA graphs of GRAPH_STEPS steps (the
    tail eagerly) give the eager loop's bits, in both directions."""
    from pysvihmm_tpu_torch.messages import blocked

    gen = torch.Generator(device=cuda_device).manual_seed(n_blocks)
    Q = torch.rand((n_blocks, 64, 64), generator=gen, device=cuda_device)
    a0 = torch.rand(64, generator=gen, device=cuda_device)
    graphed = blocked.boundary_seeds(Q, a0 / a0.sum(), graphs=True)
    eager = blocked.boundary_seeds(Q, a0 / a0.sum(), graphs=False)
    assert digest(graphed) == digest(eager)


def _dp_vb_problem():
    """Phase 13's DP VB problem, small: B=64 sequences, T=200, K=16, D=4, on
    the card, with its single-process VB step's result."""
    gen = torch.Generator(device="cuda").manual_seed(1515)
    obs, _, _ = gen_gaussian_dataset(gen, 16, 4, 64, 200)
    prior = make_prior(16, GaussianNIW, obs_dim=4, device="cuda")
    p0 = init_params(gen, prior, GaussianNIW, obs)
    return obs, prior, p0


def _dp_vb_rank(rank, world):
    """One rank of a group on the card: one DP VB step on its B / world rows
    (a spawned process; the kernels are loaded, not built)."""
    torch.cuda.set_device(0)
    obs, prior, p0 = _dp_vb_problem()
    mesh = make_mesh(world, "cuda")
    fused_fb.reset_launch_counts()
    p1, elbo = make_dp_vb_step(GaussianNIW, mesh)(p0, prior, shard_batch(obs, mesh))
    torch.cuda.synchronize()
    launches = (fused_fb.fused_forward.launches, fused_fb.fused_backward.launches)
    return {"params": [x.cpu() for x in (p1.init, p1.trans, *p1.emit)], "elbo": elbo.cpu(),
            "digest": digest((p1, elbo)), "launches": launches}


def _single_vb():
    obs, prior, p0 = _dp_vb_problem()
    p1, elbo = batch_vb.make_step(GaussianNIW)(p0, prior, obs)
    return p1, elbo


def test_dp_vb_nccl_world_of_one_is_single_process(cuda_device):
    """NCCL in a world of one (a spawned process, so that no process group
    outlives the test): the DP VB step's bits are the single-process step's,
    the fused pair launched once."""
    p1, elbo = _single_vb()
    (got,) = spawn_local(_dp_vb_rank, 1, backend="nccl", timeout=120.0)
    assert got["launches"] == (1, 1)
    assert got["digest"] == digest((p1, elbo))


def test_dp_vb_two_gloo_ranks_on_the_card(cuda_device):
    """Two gloo ranks sharing the card, 32 sequences each: the ELBO and every
    parameter within the float32 data-parallel tolerance of the
    single-process step (rtol 2e-4, atol 1e-5; the NIW psi to 2e-4 of its
    largest entry, its update's float32 cancellation), the same bits on both
    ranks."""
    p1, elbo = _single_vb()
    ranks = spawn_local(_dp_vb_rank, 2, backend="gloo", timeout=120.0)
    assert ranks[0]["digest"] == ranks[1]["digest"]
    assert all(r["launches"] == (1, 1) for r in ranks)
    torch.testing.assert_close(ranks[0]["elbo"], elbo.cpu(), rtol=2e-4, atol=0)
    for a, b in zip(ranks[0]["params"], (p1.init, p1.trans, *p1.emit), strict=True):
        b = b.cpu()
        atol = 2e-4 * b.abs().max().item() if b.dim() == 3 else 1e-5
        torch.testing.assert_close(a, b, rtol=2e-4, atol=atol)


# (K, B, T) a tier for the modes: at K = 256, B = 2048 cuts T = 150 into three
# windows of the large-K statistics (64, 64 and 22 steps)
MODE_SHAPES = [(64, 3, 40), (128, 5, 24), (256, 2048, 150)]


@pytest.mark.parametrize("kind", ["niw", "nig"])
@pytest.mark.parametrize("K,B,T", MODE_SHAPES)
def test_in_kernel_features_are_the_array_modes_bits(cuda_device, kind, K, B, T):
    """chip_smoke.py phase 14 (a) at one shape a tier: the fused pair and the
    duplex chain at every built S and the combine, gated and not, on the raw
    observations, every output the array mode's by sha256; the default S
    within the twins' tolerances."""
    check_mode_features(torch.Generator(device=cuda_device).manual_seed(K + B), kind, K, B, T)


@pytest.mark.parametrize("K", [64, 128])
def test_gamma_pick_is_the_emitted_gamma(cuda_device, K):
    """Phase 14 (b): the gated backward's pick at W = 70 is the emit_gamma
    run's gamma at the offsets, bit for bit, acc and eacc unchanged."""
    check_gamma_sel(torch.Generator(device=cuda_device).manual_seed(K), 32, K)


@pytest.mark.parametrize("K", [64, 128])
def test_bf16_alpha_is_float32_alpha_rounded(cuda_device, K):
    """Phase 14 (c): the stored bf16 alpha is float32's rounded at every S,
    the statistics within JAX's band, exact=True float32's bits."""
    check_bf16_alpha(torch.Generator(device=cuda_device).manual_seed(K + 1), 16, 200, K)


def test_mode_launchers_refuse_bad_combinations(cuda_device):
    """The libraries refuse what JAX raises on and what no kernel takes: the
    pick together with gamma, a built kind's width no D gives, alpha in
    both dtypes or neither (cudaErrorInvalidValue)."""
    lib = fused_fb._library()
    T, B, K, F = 4, 2, 4, 45
    f = lambda *shape: torch.zeros(shape, device=cuda_device)  # noqa: E731
    A, W, obs, s, sh = f(K, K), f(F, K), f(T, B, 8), f(B, T), f(B, T)
    alpha, gamma, g0, st = f(T, B, K), f(T, B, K), f(B, K), f(K * K + K * F)
    sel = torch.zeros(B, dtype=torch.int32, device=cuda_device)
    work = f(1 << 16)
    p = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    idx, stream = cuda_device.index or 0, torch.cuda.current_stream().cuda_stream
    for a32, sl, gm, FF, kind in ((alpha, sel, gamma, F, 1), (alpha, None, None, 44, 1),
                                  (None, None, None, F, 1), (alpha, None, None, F, 3)):
        code = lib.fused_fb_backward(p(A), p(W), p(obs), p(a32), None, p(s), p(sh), None, p(sl),
                                     p(gm), p(g0), p(st), p(work), T, B, K, FF, 2, kind, idx,
                                     stream)
        assert code != 0
    assert lib.fused_fb_forward(p(A[0]), p(A), p(W), p(obs), p(alpha), p(alpha), p(s), p(sh),
                                T, B, K, F, 2, 1, idx, stream) != 0
    assert duplex_fb._library().duplex_fb_chain(p(A[0]), p(A), p(W), p(obs), p(alpha), p(s),
                                                p(sh), p(alpha), T, B, K, 44, 2, 1, idx,
                                                stream) != 0


@pytest.mark.parametrize("kernel", ["niw", "nig", "widen"])
def test_operand_kernels_are_their_twins_bits(cuda_device, kernel):
    """The large-K statistics' operand kernels alone: build_feats_kernel's
    rows are ``ell_features``' bits, widen_kernel's floats the bf16 values;
    each launch counted by its library."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    fused_fb.prep_launches("build_feats_kernel", clear=True)
    fused_fb.prep_launches("widen_kernel", clear=True)
    if kernel == "widen":
        a = torch.rand((1000, 130), generator=g, device=cuda_device).to(torch.bfloat16)
        got, want, name = fused_fb.widen_alpha(a), a.float(), "widen_kernel"
    else:
        y = torch.randn((3001, 8), generator=g, device=cuda_device)
        got, want = fused_fb.feature_rows(y, kernel), fused_fb.build_features(y, kernel)
        name = "build_feats_kernel"
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert fused_fb.prep_launches(name) == 1


def test_large_k_modes_launch_the_operand_kernels(cuda_device):
    """Above K = 64 the fused backward in a built kind with bf16 alpha
    builds each window's feature rows and widens its alpha (one launch each
    a window), the duplex combine builds the rows; the default instances'
    launches launch neither."""
    K, B, T = 128, 2048, 150  # windows of 64, 64 and 22 steps
    g = torch.Generator(device=cuda_device).manual_seed(6)
    log_pi = torch.log_softmax(torch.randn(K, generator=g, device=cuda_device), 0)
    log_A = torch.log_softmax(torch.randn((K, K), generator=g, device=cuda_device), 1)
    obs = torch.randn((T, B, 3), generator=g, device=cuda_device)
    W = 0.1 * torch.randn((10, K), generator=g, device=cuda_device)
    for name in fused_fb.PREP_KERNELS:
        fused_fb.prep_launches(name, clear=True)
    fused_fb.estep_fused(log_pi, log_A, W, fused_fb.build_features(obs, "niw"))
    assert [fused_fb.prep_launches(n) for n in fused_fb.PREP_KERNELS] == [0, 0]
    fused_fb.estep_fused(log_pi, log_A, W, obs, in_kernel_feats="niw",
                         alpha_dtype=torch.bfloat16)
    assert [fused_fb.prep_launches(n, clear=True) for n in fused_fb.PREP_KERNELS] == [3, 3]
    duplex_fb.estep_duplex(log_pi, log_A, W, obs, in_kernel_feats="niw")
    assert [fused_fb.prep_launches(n) for n in fused_fb.PREP_KERNELS] == [3, 0]


@pytest.mark.parametrize("K", [64, 128])
def test_modes_instances_report_their_own_occupancy(cuda_device, K):
    """kernel_info and default_seqs query the modes' instance (bf16 alpha,
    the pick) when asked, the default one otherwise: both built, each S a
    built one."""
    for kernel in ("forward", "backward", "gated backward"):
        for S in fused_fb.built_seqs(K):
            for modes in (False, True):
                info = fused_fb.kernel_info(kernel, S, 45, cuda_device, K=K, modes=modes)
                assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
        for modes in (False, True):
            S = fused_fb.default_seqs(kernel, 1024, 45, cuda_device, K=K, modes=modes)
            assert S in fused_fb.built_seqs(K)


@pytest.mark.parametrize("B", WF_BS)
@pytest.mark.parametrize("K", WF_KS)
@pytest.mark.parametrize("kind,size", WF_CASES)
def test_wide_f_instances_match_twins(cuda_device, kind, size, K, B):
    """chip_smoke.py phase 15 (a) at one shape: the fused pair's instances
    for features wider than 64 (F = 65, 66, 100, 153, 256, 300, 820) at every S
    that fits, every output bit for bit across S and over a second call
    (acc up to K = 64 excepted across S: summed a block at a time), a
    built kind's the array mode's, the pick emit_gamma's gamma, bf16 alpha
    float32's rounded; the default S against the twins."""
    check_wide_f(torch.Generator(device=cuda_device).manual_seed(K + B + size), K, kind, size, B)


@pytest.mark.parametrize("B", [3, 1024])
@pytest.mark.parametrize("K", [64, 128, 256])
def test_split_bf16_alpha_is_float32_alpha_rounded(cuda_device, K, B):
    """Phase 15 (b): the split pair's bf16 alpha is float32's rounded at
    every S, the backward the same bits at every S and over a second call,
    both within the bf16 twins' tolerances and JAX's band of float32."""
    check_split_bf16(torch.Generator(device=cuda_device).manual_seed(K + B), K, B, 150)


def test_split_bf16_exact_pins_float32(cuda_device):
    """Phase 15 (b): exact=True with bf16_alpha on "split", and on "fused"
    for a multinomial of 300 symbols (the split pair), is float32's bits."""
    check_split_exact(torch.Generator(device=cuda_device).manual_seed(15), cuda_device)
