"""The port's fused E-step (messages/fused_fb.py) against the JAX package.

``estep_fused_reference`` (the plain PyTorch twin of the two CUDA kernels,
float32) against ``pysvihmm_tpu.messages.pallas_fb.pallas_estep_fused`` run
in Pallas interpret mode with its signature-default HIGHEST precisions and
float32 alpha (the off-TPU storage). Both compute the same recursion in
float32; they differ in summation order (XLA's dot vs torch's matmul, one
loop over all of T vs JAX's time tiles with their tile-edge handover), so
the tolerances are the ones the JAX package holds its own kernels to
against its scan path (tests/test_pallas.py:246-251).

The CUDA kernels themselves are checked against the same twins on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pysvihmm_tpu.messages.pallas_fb import pallas_estep_fused
from pysvihmm_tpu_torch.distributions import niw as tniw
from pysvihmm_tpu_torch.messages import fused_fb

torch.set_num_threads(1)


def _problem(B, T, K, D, seed):
    """Gaussian HMM features and valid variational params, made with NumPy.

    Returns float32 arrays (log_pi (K,), log_A (K, K), W (F, K),
    feats (T, B, F)) that both packages consume unchanged."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=3.0, size=(K, D))
    A = np.full((K, K), 0.2 / max(K - 1, 1)) + 0.8 * np.eye(K) if K > 1 else np.ones((1, 1))
    z = np.empty((B, T), np.int64)
    z[:, 0] = rng.integers(0, K, size=B)
    for t in range(1, T):
        u = rng.random(B)[:, None]
        z[:, t] = np.minimum((u > np.cumsum(A[z[:, t - 1]], axis=1)).sum(1), K - 1)
    obs = centres[z] + 0.7 * rng.normal(size=(B, T, D))

    psi = np.stack([np.eye(D) * rng.uniform(0.5, 2.0) + 0.1 * np.ones((D, D))
                    for _ in range(K)]) * 5.0
    q = tniw.NIW(
        mean=torch.tensor(centres + 0.3 * rng.normal(size=(K, D))),
        kappa=torch.tensor(rng.uniform(2.0, 20.0, size=K)),
        nu=torch.tensor(D + 2.0 + rng.uniform(3.0, 20.0, size=K)),
        psi=torch.tensor(psi),
    )
    W = tniw.ell_feature_matrix(q).numpy().astype(np.float32)
    feats = tniw.ell_features(torch.tensor(obs)).numpy().astype(np.float32)
    feats = np.ascontiguousarray(np.swapaxes(feats, 0, 1))
    log_pi = np.log(rng.dirichlet(np.full(K, 2.0))).astype(np.float32)
    log_A = np.log(0.7 * A + 0.3 * rng.dirichlet(np.ones(K), size=K)).astype(np.float32)
    return log_pi, log_A, W, feats


def _jax_fused(log_pi, log_A, W, feats, emit_gamma, weights=None):
    fb, S = pallas_estep_fused(
        jnp.asarray(log_pi), jnp.asarray(log_A), jnp.asarray(W), jnp.asarray(feats),
        weights=None if weights is None else jnp.asarray(weights),
        interpret=True, emit_gamma=emit_gamma,
    )
    return jax.tree.map(np.asarray, fb), np.asarray(S)


def _svi_mask(T, B, L, seed):
    """(T, B) float32 kept-masks as SVI windows make them: one kept run of
    L steps per window at a random offset, buffer steps 0 on both sides;
    window 0 keeps its first step and window 1 drops it (init gating)."""
    offs = np.random.default_rng(seed).integers(0, T - L + 1, size=B)
    offs[0], offs[1] = 0, T - L
    t = np.arange(T)[:, None]
    return ((t >= offs) & (t < offs + L)).astype(np.float32)


# (B, T, K, D, emit_gamma): the last shapes are the slice's K and D; JAX
# tiles T=48 there as two 24-step tiles, so the port's single loop over T
# is checked against JAX's tile-edge handover.
CASES = [
    (4, 32, 4, 2, True),
    (4, 32, 4, 2, False),
    (6, 40, 8, 3, True),
    (2, 48, 64, 8, True),
    (2, 48, 64, 8, False),
]


@pytest.mark.parametrize("B,T,K,D,emit_gamma", CASES)
def test_reference_matches_jax_pallas(B, T, K, D, emit_gamma):
    log_pi, log_A, W, feats = _problem(B, T, K, D, seed=B * 100 + K)
    jfb, jS = _jax_fused(log_pi, log_A, W, feats, emit_gamma)
    tfb, tS = fused_fb.estep_fused_reference(
        torch.from_numpy(log_pi), torch.from_numpy(log_A), torch.from_numpy(W),
        torch.from_numpy(feats), emit_gamma=emit_gamma,
    )
    # float32 both sides, different summation order (see module docstring)
    if emit_gamma:
        np.testing.assert_allclose(
            tfb.gamma.numpy(), jfb.gamma.reshape(T, B, K), atol=5e-5
        )
    else:
        assert tfb.gamma is None and jfb.gamma is None
    np.testing.assert_allclose(tfb.init_stats.numpy(), jfb.init_stats, atol=5e-5)
    np.testing.assert_allclose(tfb.trans_stats.numpy(), jfb.trans_stats, atol=1e-3)
    np.testing.assert_allclose(tfb.log_z.numpy(), jfb.log_z, rtol=2e-6)
    # per-step log c_t = log s_t + max_k ll_t carries the likelihood
    # matmul's rounding one to one: |ll| sums terms up to ~1e2 at ~6e-8
    # relative each, so a few 1e-5 nats per step (measured 2.1e-5)
    np.testing.assert_allclose(tfb.log_c.numpy(), jfb.log_c, rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(tS.numpy(), jS, rtol=3e-3, atol=2e-3)


@pytest.mark.parametrize("emit_gamma", [True, False])
def test_gated_reference_matches_jax_pallas(emit_gamma):
    """The gated mode (SVI kept-mask w and pair gate w_{t-1} w_t) against
    pallas_estep_fused(weights=...), tolerances as above; and the gates
    touch the statistics only: the chain, log_c and the gamma written out
    are the ungated ones bit for bit (tests/test_pallas.py:284-309)."""
    B, T, K, D = 6, 40, 8, 3
    log_pi, log_A, W, feats = _problem(B, T, K, D, seed=11)
    w = _svi_mask(T, B, 25, seed=12)
    jfb, jS = _jax_fused(log_pi, log_A, W, feats, emit_gamma, weights=w)
    args = [torch.from_numpy(a) for a in (log_pi, log_A, W, feats)]
    tfb, tS = fused_fb.estep_fused_reference(*args, emit_gamma=emit_gamma,
                                             weights=torch.from_numpy(w))
    if emit_gamma:
        np.testing.assert_allclose(tfb.gamma.numpy(), jfb.gamma.reshape(T, B, K), atol=5e-5)
    np.testing.assert_allclose(tfb.init_stats.numpy(), jfb.init_stats, atol=5e-5)
    np.testing.assert_allclose(tfb.trans_stats.numpy(), jfb.trans_stats, atol=1e-3)
    np.testing.assert_allclose(tfb.log_z.numpy(), jfb.log_z, rtol=2e-6)
    np.testing.assert_allclose(tfb.log_c.numpy(), jfb.log_c, rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(tS.numpy(), jS, rtol=3e-3, atol=2e-3)

    ufb, uS = fused_fb.estep_fused_reference(*args, emit_gamma=emit_gamma)
    torch.testing.assert_close(tfb.log_c, ufb.log_c, rtol=0, atol=0)
    if emit_gamma:
        torch.testing.assert_close(tfb.gamma, ufb.gamma, rtol=0, atol=0)
    assert tfb.init_stats[1].abs().max() == 0 and tfb.init_stats[0].sum() > 0.99
    assert tfb.trans_stats.sum() < ufb.trans_stats.sum() and tS[:, 0].sum() < uS[:, 0].sum()


def test_cpu_launchers_run_the_plain_twins():
    """On CPU tensors the launchers are the twins (bit-identical) and no
    kernel launch is counted."""
    log_pi, log_A, W, feats = (torch.from_numpy(a) for a in _problem(3, 16, 4, 2, 7))
    fused_fb.reset_launch_counts()
    fb1, S1 = fused_fb.estep_fused(log_pi, log_A, W, feats, emit_gamma=True)
    fb2, S2 = fused_fb.estep_fused_reference(log_pi, log_A, W, feats, emit_gamma=True)
    for a, b in zip(list(fb1) + [S1], list(fb2) + [S2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert fused_fb.fused_forward.launches == 0
    assert fused_fb.fused_backward.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "device_mix", "weights"])
def test_launchers_reject_what_the_kernels_do_not_take(bad):
    log_pi, log_A, W, feats = (torch.from_numpy(a) for a in _problem(3, 16, 4, 2, 7))
    pi_t, A_t = torch.exp(log_pi), torch.exp(log_A)
    if bad == "weights":
        alpha, s, sh = fused_fb.fused_forward(pi_t, A_t, W, feats)
        with pytest.raises(ValueError):  # (B, T) where the kernel takes (T, B)
            fused_fb.fused_backward(A_t, W, feats, alpha, s, sh, weights=torch.ones(3, 16))
        return
    if bad == "dtype":
        feats = feats.double()
    elif bad == "contiguity":
        feats = feats.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "shape":
        W = W[:-1]
    else:
        feats = feats.to("meta")
    with pytest.raises(ValueError):
        fused_fb.fused_forward(pi_t, A_t, W, feats)


# resident blocks of the S = 2, 4 instances: 4 an SM on the H100's 132 SMs
# (PERF.md), and on a card of 114 SMs
H100 = {2: 4 * 132, 4: 4 * 132}
SMALL = {2: 4 * 114, 4: 4 * 114}


@pytest.mark.parametrize("B,resident,S", [(1, H100, 2), (2, H100, 2), (32, H100, 2),
                                          (256, H100, 2), (1024, H100, 2), (1056, H100, 2),
                                          (1057, H100, 4), (2112, H100, 4), (4096, H100, 4),
                                          (1024, SMALL, 4)])
def test_seqs_per_block_is_the_smallest_one_wave_s(B, resident, S):
    """The launchers' sequences a block: S = 2 (the fastest measured), down
    to a single sequence, growing only when ceil(B / S) blocks would need a
    second wave."""
    assert fused_fb.seqs_per_block(B, resident) == S
    assert S in fused_fb.SEQS


def test_gated_backward_reads_only_the_kept_mask():
    """The gated fused backward forms the pair gate in-kernel, so its bytes
    count one (T, B) float32 array more than the ungated one's, not two."""
    from pysvihmm_tpu_torch.utils.roofline import kernel_work

    B, T, K, F = 1024, 70, 64, 45
    gated = kernel_work("fused_bwd_kernel", B, T, K, F, gated=True)[0]
    plain = kernel_work("fused_bwd_kernel", B, T, K, F)[0]
    assert gated - plain == 4.0 * B * T
