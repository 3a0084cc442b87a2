"""The port's CUDA kernels against their plain PyTorch twins, on the card:
the fused pair (gated and not), the split pair (gated and not), the duplex
pair (gated and not), the split path's probes, and the engines' routes
through them (features wider than the fused kernels take included).

Imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch for CUDA and nvcc:

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Every test needs the card and skips without it (the ``cuda`` marker). The
inputs are chip_smoke.py's: overlapping states, so posteriors spread. The
kernels and twins compute the same float32 recursion in another summation
order, and the kernels add acc and eacc across sequences with atomics, so
the tolerances are those of tests/test_pallas.py:246-251, relative for the
sums over all sequences.
"""

import pytest
import torch

from chip_smoke import random_problem, svi_masks
from pysvihmm_tpu_torch import messages
from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
from pysvihmm_tpu_torch.data.synthetic import gen_multinomial_dataset
from pysvihmm_tpu_torch.distributions import GaussianNIW, MultinomialDirichlet
from pysvihmm_tpu_torch.engines import batch_vb, svi
from pysvihmm_tpu_torch.engines.base import batch_local_step
from pysvihmm_tpu_torch.messages import duplex_fb, fused_fb, split_fb, split_probe
from pysvihmm_tpu_torch.models.hmm import init_params, make_prior
from pysvihmm_tpu_torch.scripts.debug_split import make_inputs

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


@pytest.mark.parametrize("K", [33, 64])
def test_duplex_chain_is_the_fused_forward_bit_for_bit(cuda_device, K):
    gen = torch.Generator(device=cuda_device).manual_seed(300 + K)
    log_pi, log_A, W, feats = random_problem(gen, 37, 40, K, 8)
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    alpha, s, sh, _ = duplex_fb.duplex_chain(pi_t, A_t, W, feats)
    for S in fused_fb.SEQS:
        for x, r in zip((alpha, s, sh), fused_fb._launch_forward(S, pi_t, A_t, W, feats)):
            assert torch.equal(x, r)


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
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    log_pi, log_A, W, feats = random_problem(gen, 2, 8, 65, 2)
    with pytest.raises(NotImplementedError, match="K <= 64"):
        fused_fb.estep_fused(log_pi, log_A, W, feats)


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
    outputs, in chunks of 16 steps that divide T=64 and not T=50 or 200),
    the chain's forward against the fused forward kernel bit for bit, and
    the whole duplex E-step."""
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


@pytest.mark.parametrize("K,F", [(65, 10), (8, 65)])
def test_duplex_wider_than_the_kernels_raises(cuda_device, K, F):
    gen = torch.Generator(device=cuda_device).manual_seed(K + F)
    A_t = torch.rand((K, K), generator=gen, device=cuda_device)
    W = torch.rand((F, K), generator=gen, device=cuda_device)
    feats = torch.rand((6, 2, F), generator=gen, device=cuda_device)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        duplex_fb.duplex_chain(torch.rand(K, generator=gen, device=cuda_device), A_t, W, feats)
    alpha = torch.rand((6, 2, K), generator=gen, device=cuda_device)
    sh = torch.rand((2, 6), generator=gen, device=cuda_device)
    with pytest.raises(NotImplementedError, match="Queue 2"):
        duplex_fb.duplex_combine(W, feats, alpha, alpha, sh)


@pytest.mark.parametrize("route", ["fused", "duplex"])
def test_wide_features_take_the_split_kernels(cuda_device, route):
    """Features wider than the fused and duplex kernels take (F > FMAX): a
    multinomial of 100 and of 300 symbols and a Gaussian-NIW at D = 10
    (F = 66) run the split kernels once on "fused" and "duplex", and no
    other kernel, and agree with "scan", gated and not."""
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
            assert (split_fb.split_forward.launches, split_fb.split_backward.launches) == (1, 1)
            assert (fused_fb.fused_forward.launches, fused_fb.fused_backward.launches) == (0, 0)
            assert (duplex_fb.duplex_chain.launches, duplex_fb.duplex_combine.launches) == (0, 0)
            ref, _ = batch_local_step(p0, fam, obs, "scan", weights=w)
            emit = stats.emit if isinstance(stats.emit, tuple) else (stats.emit,)
            emit_ref = ref.emit if isinstance(ref.emit, tuple) else (ref.emit,)
            for a, b in zip(emit, emit_ref):
                torch.testing.assert_close(a, b, rtol=3e-3, atol=2e-3)
            torch.testing.assert_close(stats.trans, ref.trans, rtol=1e-4, atol=1e-3)
            torch.testing.assert_close(stats.log_z, ref.log_z, rtol=2e-6, atol=0)


def test_fmax_is_the_kernels_own(cuda_device):
    """The engines' routing constant is the width both libraries report."""
    fmax = (fused_fb._library().fused_fb_fmax(), duplex_fb._library().duplex_fb_fmax())
    assert fmax == (fused_fb.FMAX, fused_fb.FMAX)


@pytest.mark.parametrize("T,B,K,C", [(16, 4, 8, 8), (24, 3, 33, 4), (16, 37, 64, 8)])
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


def test_split_probes_refuse_k_above_64(cuda_device):
    pi, A, lik = make_inputs(2, 8, 65, cuda_device)
    for call in (lambda: split_probe.probe_fwd_nos(pi, A, lik, 4),
                 lambda: split_probe.probe_fwd_stack(pi, A, lik, 4),
                 lambda: split_probe.probe_micro(pi, A, lik, 4, "dot_store")):
        with pytest.raises(NotImplementedError, match="K <= 64"):
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
