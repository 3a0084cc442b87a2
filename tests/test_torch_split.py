"""The port's split E-step (messages/split_fb.py) against the JAX package.

``estep_split_reference`` (the plain PyTorch twin of the two split CUDA
kernels, float32) against
``pysvihmm_tpu.messages.pallas_fb.pallas_forward_backward_batched`` run in
Pallas interpret mode at its signature-default HIGHEST precision, on the
same NumPy log-likelihoods, with and without an SVI kept-mask. Both compute
the same float32 recursion in another summation order, so the tolerances are
those the JAX package holds its split kernels to against its scan path
(tests/test_pallas.py:39-78). Each twin is also held to the port's own scan
path in float64.

The CUDA kernels themselves are checked against the same twins on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pysvihmm_tpu.messages.pallas_fb import pallas_forward_backward_batched
from pysvihmm_tpu_torch import messages
from pysvihmm_tpu_torch.messages import fused_fb, split_fb

torch.set_num_threads(1)

# tests/test_pallas.py:45-54 (gamma, log_z, trans_stats, init_stats, log_c)
TOL = {"gamma": dict(atol=2e-6), "log_z": dict(rtol=2e-6), "trans_stats": dict(atol=2e-5),
       "init_stats": dict(atol=2e-6), "log_c": dict(atol=2e-5)}


def _problem(B, T, K, seed, gated):
    """float32 (log_pi (K,), log_A (K, K), ll (B, T, K), w (B, T) or None):
    raw log-likelihoods at scale 2, as tests/test_pallas.py::problem makes
    them; the mask keeps at least one and drops at least one chain start."""
    rng = np.random.default_rng(seed)
    log_pi = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    log_A = np.log(rng.dirichlet(np.ones(K), size=K)).astype(np.float32)
    ll = (rng.normal(size=(B, T, K)) * 2).astype(np.float32)
    w = None
    if gated:
        w = (rng.random((B, T)) > 0.3).astype(np.float32)
        w[0, 0], w[1, 0] = 0.0, 1.0
    return log_pi, log_A, ll, w


def _time_major(x):
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 0, 1)))


def _port(log_pi, log_A, ll, w, fn=split_fb.estep_split_reference):
    """The port's split E-step on (B, T)-major NumPy inputs; gamma back to (B, T, K)."""
    fb = fn(torch.from_numpy(log_pi), torch.from_numpy(log_A), _time_major(ll),
            None if w is None else _time_major(w))
    return fb._replace(gamma=fb.gamma.transpose(0, 1))


@pytest.mark.parametrize("B,T,K,gated", [
    (4, 64, 8, False), (3, 50, 5, False), (8, 33, 16, False),
    (4, 64, 8, True), (3, 40, 5, True),
    # odd B and T at both instance tiers' K (the S-sequence layouts' shapes):
    # one step, a last block short of S, K = 64 and 129
    (3, 1, 64, False), (3, 1, 129, True), (5, 9, 64, True), (7, 6, 129, False),
])
def test_reference_matches_jax_pallas(B, T, K, gated):
    log_pi, log_A, ll, w = _problem(B, T, K, seed=B * T + K, gated=gated)
    j = pallas_forward_backward_batched(
        jnp.asarray(log_pi), jnp.asarray(log_A), jnp.asarray(ll),
        weights=None if w is None else jnp.asarray(w), interpret=True,
    )
    t = _port(log_pi, log_A, ll, w)
    for name, tol in TOL.items():
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("gated", [False, True])
def test_twins_match_the_port_scan(gated):
    """Within the port: the float32 twins against scan_fb in float64."""
    log_pi, log_A, ll, w = _problem(5, 48, 6, seed=9, gated=gated)
    t = _port(log_pi, log_A, ll, w)
    s = messages.e_step_batched(
        *(torch.from_numpy(x).double() for x in (log_pi, log_A, ll)),
        weights=None if w is None else torch.from_numpy(w).double(), method="scan",
    )
    for name, tol in TOL.items():
        np.testing.assert_allclose(getattr(t, name).numpy(), getattr(s, name).numpy(),
                                   err_msg=name, **tol)


def test_e_step_batched_runs_the_split_route():
    """e_step_batched on "split" (and on "fused", which becomes "split" over
    materialised likelihoods) is the split E-step in the (B, T, K) contract."""
    log_pi, log_A, ll, w = _problem(3, 20, 4, seed=2, gated=True)
    ref = _port(log_pi, log_A, ll, w)
    for method in ("split", "fused"):
        got = messages.e_step_batched(*(torch.from_numpy(x) for x in (log_pi, log_A, ll)),
                                      weights=torch.from_numpy(w), method=method)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_launchers_run_the_plain_twins():
    """On CPU tensors the launchers are the twins (bit-identical) and no
    kernel launch is counted."""
    log_pi, log_A, ll, w = _problem(3, 16, 4, seed=7, gated=True)
    split_fb.reset_launch_counts()
    for ww in (None, w):
        a = _port(log_pi, log_A, ll, ww, fn=split_fb.estep_split)
        b = _port(log_pi, log_A, ll, ww)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert split_fb.split_forward.launches == 0
    assert split_fb.split_backward.launches == 0


def test_gates_touch_the_statistics_only():
    """Buffer steps still drive the chain: gated and ungated runs share gamma
    and log_c bit for bit; only init_stats and trans_stats differ."""
    log_pi, log_A, ll, w = _problem(4, 24, 5, seed=3, gated=True)
    gated, plain = _port(log_pi, log_A, ll, w), _port(log_pi, log_A, ll, None)
    torch.testing.assert_close(gated.gamma, plain.gamma, rtol=0, atol=0)
    torch.testing.assert_close(gated.log_c, plain.log_c, rtol=0, atol=0)
    assert not torch.equal(gated.trans_stats, plain.trans_stats)
    torch.testing.assert_close(gated.init_stats, plain.init_stats * torch.from_numpy(w[:, :1]))


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "device_mix", "gate_shape"])
def test_launchers_reject_what_the_kernels_do_not_take(bad):
    log_pi, log_A, ll, _ = _problem(3, 16, 4, seed=7, gated=False)
    pi_t, A_t = (torch.exp(torch.from_numpy(x)) for x in (log_pi, log_A))
    ll = _time_major(ll)
    alpha, s, sh = split_fb.split_forward(pi_t, A_t, ll)
    g = torch.ones(16, 3)
    if bad == "dtype":
        ll = ll.double()
    elif bad == "contiguity":
        ll = ll.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "shape":
        A_t = A_t[:, :-1]
    elif bad == "device_mix":
        ll = ll.to("meta")
    else:
        g = g[:-1]
    with pytest.raises(ValueError):
        split_fb.split_backward(A_t, ll, alpha, s, sh, g)


# resident blocks an SM of each split instance on the H100 (132 SMs), by
# kernel and instance tier, from split_fb_kernel_info (PERF.md): up to
# K = 64 the forward at S = 2 and 4, the backward at S = 2 (S K accumulators
# a thread: the only S built there); at KP = 128 three blocks an SM (two at
# S = 8), at KP = 256 one
H100_SMS = 132
SPLIT_BLOCKS = {
    ("forward", 64): {2: 8, 4: 6}, ("backward", 64): {2: 4}, ("gated backward", 64): {2: 4},
    **{(kind, 128): {1: 3, 2: 3, 4: 3, 8: 2} for kind in split_fb.SEQS},
    **{(kind, 256): {1: 1, 2: 1, 4: 1, 8: 1} for kind in split_fb.SEQS},
}
# the default S by (kind, K) for B = 1, 32, 1024, 2048: a small batch keeps
# the smallest built S; B = 1024 runs in one wave (S = 4 at KP = 128, 8 at
# 256); where no S fits one wave, the largest (the K = 64 backward's one S
# takes two waves at B = 2048)
SPLIT_DEFAULT = {
    ("forward", 64): (2, 2, 2, 2), ("backward", 64): (2, 2, 2, 2),
    ("gated backward", 64): (2, 2, 2, 2),
    **{(kind, 128): (1, 1, 4, 8) for kind in split_fb.SEQS},
    **{(kind, 256): (1, 1, 8, 8) for kind in split_fb.SEQS},
}


@pytest.mark.parametrize("kind", ["forward", "backward", "gated backward"])
@pytest.mark.parametrize("K", [64, 128, 256])
@pytest.mark.parametrize("B", [1, 32, 1024, 2048])
def test_default_seqs_is_the_one_wave_rule(monkeypatch, kind, K, B):
    """split_fb.default_seqs is fused_fb.seqs_per_block over the split
    library's own instances (built_seqs) and their resident blocks, which
    the test gives as the H100's (the library's occupancy query needs the
    card): the smallest built S whose ceil(B / S) blocks run in one wave."""
    blocks = SPLIT_BLOCKS[kind, K]
    assert tuple(blocks) == split_fb.built_seqs(kind, K)

    def info(kernel, S, K_, index, bf16=False):
        assert (kernel, K_, index, bf16) == (kind, K, 0, False) and S in blocks
        return (("blocks_per_sm", blocks[S]), ("sms", H100_SMS))

    monkeypatch.setattr(split_fb, "_kernel_info", info)
    split_fb._default_seqs.cache_clear()
    try:
        S = split_fb.default_seqs(kind, B, torch.device("cuda", 0), K=K)
    finally:
        split_fb._default_seqs.cache_clear()
    want = SPLIT_DEFAULT[kind, K][(1, 32, 1024, 2048).index(B)]
    assert S == want
    resident = {s: n * H100_SMS for s, n in blocks.items()}
    assert S == fused_fb.seqs_per_block(B, resident, seqs=split_fb.built_seqs(kind, K))


def test_built_seqs_follow_kernel_and_k():
    """Up to K = 64 the forward takes S = 2, 4 and the backward S = 2 (each
    sequence keeps its own acc); 65-256 every kernel S = 1, 2, 4, 8."""
    assert split_fb.built_seqs("forward", 64) == (2, 4)
    assert split_fb.built_seqs("backward", 1) == split_fb.built_seqs("gated backward", 64) == (2,)
    for kind in ("forward", "backward", "gated backward"):
        assert split_fb.built_seqs(kind, 65) == split_fb.built_seqs(kind, 256) == (1, 2, 4, 8)


@pytest.mark.parametrize("kind,S,K", [
    ("forward", 1, 64), ("forward", 8, 33), ("backward", 4, 64), ("gated backward", 1, 8),
    ("forward", 3, 128), ("backward", 16, 256), ("gated backward", 0, 129),
])
def test_launchers_refuse_an_s_not_built(kind, S, K):
    """An S the library holds no instance of raises ValueError on every
    device, before anything runs: no fallback to another S or to the twin."""
    log_pi, log_A, ll, w = _problem(3, 5, K, seed=K + S, gated=True)
    pi_t, A_t = (torch.exp(torch.from_numpy(x)) for x in (log_pi, log_A))
    ll, w = _time_major(ll), _time_major(w)
    alpha, s, sh = split_fb.split_forward(pi_t, A_t, ll)
    with pytest.raises(ValueError, match=f"S={S}"):
        if kind == "forward":
            split_fb.split_forward(pi_t, A_t, ll, S=S)
        else:
            split_fb.split_backward(A_t, ll, alpha, s, sh, w if kind == "gated backward" else None,
                                    S=S)


@pytest.mark.parametrize("K", [64, 129])
def test_cpu_launchers_take_every_built_s(K):
    """On CPU tensors a built S runs the plain twin: the same bits as the
    default, gated and not."""
    log_pi, log_A, ll, w = _problem(3, 6, K, seed=K, gated=True)
    pi_t, A_t = (torch.exp(torch.from_numpy(x)) for x in (log_pi, log_A))
    ll, w = _time_major(ll), _time_major(w)
    ref = split_fb.split_forward(pi_t, A_t, ll)
    for S in split_fb.built_seqs("forward", K):
        got = split_fb.split_forward(pi_t, A_t, ll, S=S)
        assert all(torch.equal(x, y) for x, y in zip(got, ref))
    for kind, ww in (("backward", None), ("gated backward", w)):
        want = split_fb.split_backward_reference(A_t, ll, *ref, ww)
        for S in split_fb.built_seqs(kind, K):
            got = split_fb.split_backward(A_t, ll, *ref, ww, S=S)
            assert all(torch.equal(x, y) for x, y in zip(got, want))


def test_backward_twin_forms_the_pair_gate():
    """split_backward_reference takes the kept-mask w and gates acc with
    pair_gate(w) = w_{t-1} w_t, as the kernels do: the product of the
    ungated sums' terms by that gate, term by term."""
    log_pi, log_A, ll, w = _problem(4, 12, 5, seed=11, gated=True)
    pi_t, A_t = (torch.exp(torch.from_numpy(x)) for x in (log_pi, log_A))
    ll, w = _time_major(ll), _time_major(w)
    a, s, sh = split_fb.split_forward_reference(pi_t, A_t, ll)
    g = split_fb.pair_gate(w)
    assert torch.equal(g[0], torch.zeros_like(g[0]))
    assert torch.equal(g[1:], w[:-1] * w[1:])
    gamma, acc = split_fb.split_backward_reference(A_t, ll, a, s, sh, w)
    plain = split_fb.split_backward_reference(A_t, ll, a, s, sh)
    assert torch.equal(gamma, plain[0])
    # every pair kept: the gate is all ones past t = 0, and acc is the ungated one
    ones = torch.ones_like(w)
    assert torch.equal(split_fb.split_backward_reference(A_t, ll, a, s, sh, ones)[1], plain[1])
    assert not torch.equal(acc, plain[1])
