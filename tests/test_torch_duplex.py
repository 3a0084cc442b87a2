"""The port's duplex E-step (messages/duplex_fb.py) against the JAX package.

``estep_duplex_reference`` (the plain PyTorch twins of the two CUDA kernels,
float32) against ``pysvihmm_tpu.messages.pallas_duplex.pallas_estep_duplex``
in Pallas interpret mode, at the K <= 64 shapes of tests/test_duplex.py and
under its parity measure: max |port - JAX| / max |JAX| below 2e-5 for log_c,
log_z, trans, init, emit and gamma (float32 both sides, another summation
order). The engine-level tests run JAX's ``"pallas_fused"`` route with
``PYSVIHMM_DUPLEX=1`` (its duplex route; the port's ``method="duplex"``) and
the kernel precision knobs at "highest", as tests/test_duplex.py:96-114 does.

The CUDA kernels themselves are checked against the same twins on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysvihmm_tpu.distributions.emissions import GaussianNIW as JGaussianNIW
from pysvihmm_tpu.engines import batch_vb as jbatch_vb
from pysvihmm_tpu.engines.base import batch_local_step as jbatch_local_step
from pysvihmm_tpu.engines.base import windowed_local_step as jwindowed_local_step
from pysvihmm_tpu.messages.pallas_duplex import pallas_estep_duplex
from pysvihmm_tpu.models import hmm as jhmm
from pysvihmm_tpu.oracle import numpy_ref as oracle
from pysvihmm_tpu_torch import convert
from pysvihmm_tpu_torch.distributions import GaussianNIW
from pysvihmm_tpu_torch.engines import batch_vb
from pysvihmm_tpu_torch.engines.base import batch_local_step, decode, lower_bound, windowed_local_step
from pysvihmm_tpu_torch.messages import duplex_fb, fused_fb

torch.set_num_threads(1)

PARITY = 2e-5  # tests/test_duplex.py:31-46


@pytest.fixture
def jax_duplex(monkeypatch):
    """JAX's duplex route at exact float32, with no trace of another route
    left in JAX's caches (the knob is read while tracing)."""
    for knob in ("PYSVIHMM_KERNEL_PREC", "PYSVIHMM_LL_PREC", "PYSVIHMM_STATS_PREC"):
        monkeypatch.setenv(knob, "highest")
    monkeypatch.setenv("PYSVIHMM_DUPLEX", "1")
    jax.clear_caches()
    yield
    jax.clear_caches()


def _problem(K, D, T, B, seed=0):
    """tests/test_duplex.py's inputs: (log_pi, log_A, W (F, K), feats (T, B, F))."""
    r = np.random.default_rng(seed)
    F = 1 + D + D * (D + 1) // 2
    return (
        np.log(r.dirichlet(np.ones(K))).astype(np.float32),
        np.log(r.dirichlet(np.ones(K), size=K)).astype(np.float32),
        (r.normal(size=(F, K)) * 0.1).astype(np.float32),
        r.normal(size=(T, B, F)).astype(np.float32),
    )


def _mask(T, B, seed=5):
    """tests/test_duplex.py:75's kept-mask, (T, B) float32."""
    return (np.random.default_rng(seed).random((T, B)) > 0.3).astype(np.float32)


def _assert_parity(port, ref):
    (tfb, tS), (jfb, jS) = port, ref
    pairs = [("log_c", tfb.log_c, jfb.log_c), ("log_z", tfb.log_z, jfb.log_z),
             ("trans", tfb.trans_stats, jfb.trans_stats), ("init", tfb.init_stats, jfb.init_stats),
             ("emit", tS, jS)]
    if jfb.gamma is not None:
        pairs.append(("gamma", tfb.gamma, np.asarray(jfb.gamma).reshape(tfb.gamma.shape)))
    else:
        assert tfb.gamma is None
    for name, a, b in pairs:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, name
        assert np.abs(a - b).max() / (np.abs(b).max() + 1e-12) < PARITY, name


def _both(args, emit_gamma=False, weights=None):
    jout = pallas_estep_duplex(*(jnp.asarray(a) for a in args), interpret=True,
                               emit_gamma=emit_gamma,
                               weights=None if weights is None else jnp.asarray(weights))
    tout = duplex_fb.estep_duplex_reference(
        *(torch.from_numpy(a) for a in args), emit_gamma=emit_gamma,
        weights=None if weights is None else torch.from_numpy(weights))
    return tout, jout


@pytest.mark.parametrize("K,D,T,B", [(64, 8, 64, 32), (16, 2, 33, 24), (32, 5, 200, 64)])
def test_reference_matches_jax_duplex(K, D, T, B):
    _assert_parity(*_both(_problem(K, D, T, B)))


@pytest.mark.parametrize("K,D,T,B", [(4, 2, 1, 1), (8, 2, 7, 5), (16, 3, 1, 9), (5, 2, 9, 1)])
def test_reference_matches_jax_duplex_at_edges(K, D, T, B):
    """T = 1, B = 1 and odd T B (the CUDA combine's tile edges), gated,
    gamma emitted."""
    _assert_parity(*_both(_problem(K, D, T, B, seed=11), emit_gamma=True, weights=_mask(T, B)))


def test_chain_and_combine_match_the_f64_oracle():
    """The twins' raw beta, normalised, and the combine's trans_stats = A~ *
    acc against the f64 oracle's normalised beta and summed xi, sequence by
    sequence: the backward's scale 1 / sum_k b_t, applied after the product,
    leaves beta and the xi identity exact up to float32 rounding."""
    log_pi, log_A, W, feats = _problem(6, 2, 40, 3, seed=4)
    W = 4.0 * W  # peaked likelihoods, so that the scales vary along the chain
    lp, lA, tW, tf = (torch.from_numpy(a) for a in (log_pi, log_A, W, feats))
    pi_t, A_t = torch.exp(lp), torch.exp(lA)
    a, s, sh, beta = duplex_fb.duplex_chain_reference(pi_t, A_t, tW, tf)
    _, _, acc, _ = duplex_fb.duplex_combine_reference(tW, tf, a, beta, sh)
    xi = np.zeros((6, 6))
    for b in range(feats.shape[1]):
        ll = feats[:, b].astype(np.float64) @ W.astype(np.float64)
        _, ob, _, oxi, _ = oracle.forward_backward(log_pi.astype(np.float64),
                                                   log_A.astype(np.float64), ll)
        pb = beta[:, b].double().numpy()
        assert (pb[-1] == 1).all()  # b_{T-1} = 1, as the oracle's
        pb = pb[:-1] / pb[:-1].sum(-1, keepdims=True)
        np.testing.assert_allclose(pb, ob[:-1], rtol=1e-4, atol=1e-6)
        xi += oxi
    np.testing.assert_allclose((A_t * acc).double().numpy(), xi, rtol=1e-4, atol=1e-5)


def test_reference_emit_gamma_matches_jax_duplex():
    _assert_parity(*_both(_problem(64, 8, 64, 32, seed=1), emit_gamma=True))


@pytest.mark.parametrize("emit_gamma", [False, True])
def test_gated_reference_matches_jax_duplex(emit_gamma):
    """Kept-mask gating (tests/test_duplex.py:73-80); the gates touch the
    statistics only, so log_c and the gamma written out are the ungated ones
    bit for bit."""
    args = _problem(64, 8, 64, 32, seed=2)
    w = _mask(64, 32)
    (tfb, tS), jout = _both(args, emit_gamma=emit_gamma, weights=w)
    _assert_parity((tfb, tS), jout)
    ufb, uS = duplex_fb.estep_duplex_reference(*(torch.from_numpy(a) for a in args),
                                               emit_gamma=emit_gamma)
    torch.testing.assert_close(tfb.log_c, ufb.log_c, rtol=0, atol=0)
    if emit_gamma:
        torch.testing.assert_close(tfb.gamma, ufb.gamma, rtol=0, atol=0)
        torch.testing.assert_close(tfb.init_stats, ufb.gamma[0] * torch.from_numpy(w[0])[:, None])
    assert tfb.trans_stats.sum() < ufb.trans_stats.sum()


def test_chain_forward_is_the_fused_forward():
    """The chain twin's alpha, s and sh are the fused forward twin's, bit for
    bit (the chain kernel runs the fused forward's recursion), and its raw
    beta gives the fused E-step's gamma."""
    lp, lA, W, feats = (torch.from_numpy(a) for a in _problem(16, 2, 33, 24, seed=3))
    pi_t, A_t = torch.exp(lp), torch.exp(lA)
    a, s, sh, beta = duplex_fb.duplex_chain_reference(pi_t, A_t, W, feats)
    fa, fs, fsh = fused_fb.forward_reference(pi_t, A_t, W, feats)
    for x, y in ((a, fa), (s, fs), (sh, fsh)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert beta.shape == a.shape and bool((beta[-1] == 1).all())
    fb, _ = fused_fb.estep_fused_reference(lp, lA, W, feats, emit_gamma=True)
    g = a * beta
    torch.testing.assert_close(g / g.sum(-1, keepdim=True), fb.gamma, rtol=0, atol=2e-6)


def test_cpu_launchers_run_the_plain_twins():
    """On CPU tensors the launchers are the twins (bit-identical) and no
    kernel launch is counted."""
    args = [torch.from_numpy(a) for a in _problem(4, 2, 16, 3, seed=7)]
    w = torch.from_numpy(_mask(16, 3))
    duplex_fb.reset_launch_counts()
    fb1, S1 = duplex_fb.estep_duplex(*args, emit_gamma=True, weights=w)
    fb2, S2 = duplex_fb.estep_duplex_reference(*args, emit_gamma=True, weights=w)
    for a, b in zip(list(fb1) + [S1], list(fb2) + [S2]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert duplex_fb.duplex_chain.launches == 0
    assert duplex_fb.duplex_combine.launches == 0


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "device_mix", "weights", "sh"])
def test_launchers_reject_what_the_kernels_do_not_take(bad):
    lp, lA, W, feats = (torch.from_numpy(a) for a in _problem(4, 2, 16, 3, seed=7))
    pi_t, A_t = torch.exp(lp), torch.exp(lA)
    if bad in ("weights", "sh"):
        alpha, s, sh, beta = duplex_fb.duplex_chain(pi_t, A_t, W, feats)
        with pytest.raises(ValueError):
            if bad == "weights":  # (B, T) where the kernel takes (T, B)
                duplex_fb.duplex_combine(W, feats, alpha, beta, sh, weights=torch.ones(3, 16))
            else:  # (T, B) where the kernel takes (B, T)
                duplex_fb.duplex_combine(W, feats, alpha, beta, sh.T.contiguous())
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
        duplex_fb.duplex_chain(pi_t, A_t, W, feats)


# resident blocks an SM of each chain instance on the H100 (132 SMs), by
# instance tier, from duplex_fb_kernel_info (PERF.md; chip_smoke.py phase 5):
# up to K = 64 S = 2 and 4; at KP = 128 three blocks an SM (two at S = 8, by
# shared memory), at KP = 256 one
H100_SMS = 132
CHAIN_BLOCKS = {64: {2: 4, 4: 4}, 128: {1: 3, 2: 3, 4: 3, 8: 2}, 256: {1: 1, 2: 1, 4: 1, 8: 1}}
# the default S by K for B = 1, 32, 1024, 2048: a small batch keeps the
# smallest built S; B = 1024 runs its 2 ceil(B / S) blocks in one wave at S =
# 4 (K = 64) and 8 (KP = 128); where no S fits one wave, the largest
CHAIN_DEFAULT = {64: (2, 2, 4, 4), 128: (1, 1, 8, 8), 256: (1, 1, 8, 8)}


@pytest.mark.parametrize("K", [64, 128, 256])
@pytest.mark.parametrize("B", [1, 32, 1024, 2048])
def test_chain_default_seqs_is_the_one_wave_rule(monkeypatch, K, B):
    """duplex_fb.default_seqs is fused_fb.seqs_per_block over the chain's
    instances (built_seqs) and their resident blocks, with a forward and a
    backward block a group of S, which the test gives as the H100's (the
    library's occupancy query needs the card): the smallest built S whose 2
    ceil(B / S) blocks run in one wave, else the largest."""
    blocks = CHAIN_BLOCKS[K]
    assert tuple(blocks) == duplex_fb.built_seqs(K)

    def info(kernel, S, F, K_, index, kind=0):
        assert (kernel, F, K_, index, kind) == ("chain", 45, K, 0, 0) and S in blocks
        return (("blocks_per_sm", blocks[S]), ("sms", H100_SMS))

    monkeypatch.setattr(duplex_fb, "_kernel_info", info)
    duplex_fb._default_seqs.cache_clear()
    try:
        S = duplex_fb.default_seqs(B, 45, torch.device("cuda", 0), K=K)
    finally:
        duplex_fb._default_seqs.cache_clear()
    assert S == CHAIN_DEFAULT[K][(1, 32, 1024, 2048).index(B)]
    resident = {s: n * H100_SMS for s, n in blocks.items()}
    assert S == fused_fb.seqs_per_block(B, resident, per_group=2, seqs=duplex_fb.built_seqs(K))


def test_chain_built_seqs_follow_k():
    """The chain is built for S = 2, 4 up to K = 64 and S = 1, 2, 4, 8 above
    (the large-K instances), at every K of each tier."""
    assert duplex_fb.built_seqs(1) == duplex_fb.built_seqs(64) == (2, 4)
    assert duplex_fb.built_seqs(65) == duplex_fb.built_seqs(128) == (1, 2, 4, 8)
    assert duplex_fb.built_seqs(129) == duplex_fb.built_seqs(256) == (1, 2, 4, 8)


@pytest.mark.parametrize("S,K", [(1, 64), (8, 33), (3, 129), (16, 129), (0, 256), (3, 65)])
def test_chain_launcher_refuses_an_s_not_built(S, K):
    """An S the library holds no chain instance of raises ValueError on
    every device, before anything runs: no fallback to another S or to the
    twin."""
    lp, lA, W, feats = (torch.from_numpy(a) for a in _problem(K, 2, 5, 3, seed=K + S))
    pi_t, A_t = torch.exp(lp), torch.exp(lA)
    with pytest.raises(ValueError, match=f"S={S}"):
        duplex_fb._launch_chain(S, pi_t, A_t, W, feats)


@pytest.mark.parametrize("K", [64, 129])
def test_cpu_chain_takes_every_built_s(K):
    """On CPU tensors every built S runs the plain twin: alpha, s, sh and
    beta the twin's bits, and no launch counted."""
    lp, lA, W, feats = (torch.from_numpy(a) for a in _problem(K, 2, 6, 5, seed=K))
    pi_t, A_t = torch.exp(lp), torch.exp(lA)
    want = duplex_fb.duplex_chain_reference(pi_t, A_t, W, feats)
    before = duplex_fb.duplex_chain.launches
    for S in duplex_fb.built_seqs(K):
        got = duplex_fb._launch_chain(S, pi_t, A_t, W, feats)
        assert all(torch.equal(x, y) for x, y in zip(got, want))
    assert duplex_fb.duplex_chain.launches == before


# ------------------------------------------------------------ the engines


def _obs(B, T, K, D, seed):
    """Gaussian HMM observations (B, T, D) float32, NumPy-made."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=4.0, size=(K, D))
    z = np.empty((B, T), np.int64)
    z[:, 0] = rng.integers(0, K, size=B)
    for t in range(1, T):
        stay = rng.random(B) < 0.8
        z[:, t] = np.where(stay, z[:, t - 1], rng.integers(0, K, size=B))
    return (centres[z] + 0.8 * rng.normal(size=(B, T, D))).astype(np.float32)


def _start(B, T, K, D, seed):
    obs = _obs(B, T, K, D, seed)
    jprior = jhmm.make_prior(K, JGaussianNIW, obs_dim=D)
    jp0 = jhmm.init_params(jax.random.PRNGKey(seed), jprior, JGaussianNIW, jnp.asarray(obs))
    return obs, jprior, jp0


@pytest.mark.parametrize("gated", [False, True])
def test_local_step_matches_jax_duplex_route(jax_duplex, gated):
    """batch_local_step(method="duplex") against JAX's duplex route, gamma
    included; tolerances of tests/test_pallas.py:246-251."""
    B, T, K, D = 6, 40, 8, 3
    obs, _, jp0 = _start(B, T, K, D, seed=3)
    w = _mask(T, B, seed=4).T.copy() if gated else None
    js, jg = jbatch_local_step(jp0, JGaussianNIW, jnp.asarray(obs), "pallas_fused",
                               weights=None if w is None else jnp.asarray(w))
    ts, tg = batch_local_step(convert.params_from_numpy(jp0, device="cpu"), GaussianNIW,
                              torch.from_numpy(obs), "duplex",
                              weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=5e-5)
    np.testing.assert_allclose(ts.init.numpy(), np.asarray(js.init), atol=5e-5)
    np.testing.assert_allclose(ts.trans.numpy(), np.asarray(js.trans), atol=1e-3)
    np.testing.assert_allclose(ts.log_z.item(), float(js.log_z), rtol=2e-6)
    for a, b in zip(ts.emit, js.emit):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-3, atol=2e-3)


def test_windowed_local_step_matches_jax_duplex_route(jax_duplex):
    """tests/test_torch_svi.py's windows (K=4, D=2, T=64, B=6, W=16, L=10)
    and tolerances (rtol 2e-4, atol 1e-5) on the duplex routes."""
    K, D, T, B, W, L = 4, 2, 64, 6, 16, 10
    chain = _obs(1, T, K, D, seed=0)[0]
    _, _, jparams = _start(1, T, K, D, seed=1)
    ws = np.random.default_rng(2).integers(0, T - W + 1, size=B)
    windows = chain[ws[:, None] + np.arange(W)]
    offs = np.arange(B) % (W - L + 1)
    pos = np.arange(W)[None, :]
    maskf = ((pos >= offs[:, None]) & (pos < offs[:, None] + L)).astype(np.float32)
    jout = jwindowed_local_step(jparams, JGaussianNIW, jnp.asarray(windows), jnp.asarray(maskf),
                                jnp.asarray(offs), "pallas_fused")
    tout = windowed_local_step(convert.params_from_numpy(jparams, device="cpu"), GaussianNIW,
                               torch.from_numpy(windows), torch.from_numpy(maskf),
                               torch.from_numpy(offs), "duplex")
    pairs = list(zip(tout[0], jout[0])) + list(zip(tout[1:], jout[1:]))
    assert len(pairs) == 6
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=1e-5)


def test_fit_matches_jax_duplex_route(jax_duplex):
    """Five VB iterations on "duplex" from the same converted init: the ELBO
    history to 1e-4 relative, the final params to 1e-3, the port's ELBO
    non-decreasing (tests/test_torch_engines.py's bounds); lower_bound and
    decode take the route too."""
    B, T, K, D = 4, 32, 4, 2
    obs, jprior, jp0 = _start(B, T, K, D, seed=0)
    jfinal, jelbos = jbatch_vb.fit(jp0, jprior, jnp.asarray(obs), JGaussianNIW,
                                   num_iters=5, method="pallas_fused")
    prior = convert.params_from_numpy(jprior, device="cpu")
    tfinal, telbos = batch_vb.fit(convert.params_from_numpy(jp0, device="cpu"), prior,
                                  torch.from_numpy(obs), GaussianNIW, num_iters=5,
                                  method="duplex")
    np.testing.assert_allclose(telbos.numpy(), np.asarray(jelbos), rtol=1e-4)
    for a, b in zip([tfinal.init, tfinal.trans, *tfinal.emit],
                    [jfinal.init, jfinal.trans, *jfinal.emit]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-5)
    e = telbos.double()
    assert bool(((e[1:] - e[:-1]) / e[:-1].abs() > -1e-5).all())
    o = torch.from_numpy(obs)
    torch.testing.assert_close(lower_bound(tfinal, prior, GaussianNIW, o, "duplex"),
                               lower_bound(tfinal, prior, GaussianNIW, o, "fused"),
                               rtol=2e-6, atol=0)
    assert torch.equal(decode(tfinal, GaussianNIW, o, "duplex"),
                       decode(tfinal, GaussianNIW, o, "fused"))
