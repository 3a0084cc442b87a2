"""The port's plain decoders and samplers (messages/scan_fb.py: forward,
log_normalizer, viterbi, forward_filter_log, FFBS; messages.e_step_grad and
e_step) against the JAX package, on CPU.

Both sides run in float64 (JAX under the ``enable_x64`` fixture) on the same
NumPy inputs, and agree to 1e-10. FFBS is fed the Gumbel noise JAX's
``categorical`` draws (``jax.random.split`` of the key into T, one
``gumbel(key_t, (K,))`` a step), so the port's path must be JAX's exactly.
"""

from itertools import product

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysvihmm_tpu import messages as jmessages
from pysvihmm_tpu_torch import messages
from pysvihmm_tpu_torch.utils.device import check_generator, restart_generators

torch.set_num_threads(1)


def _problem(B, T, K, seed, scale=2.0):
    """(log_pi (K,), log_A (K, K), log_lik (B, T, K)) float64, NumPy-made."""
    rng = np.random.default_rng(seed)
    log_pi = np.log(rng.dirichlet(np.ones(K)))
    log_A = np.log(rng.dirichlet(np.ones(K), size=K))
    return log_pi, log_A, rng.normal(size=(B, T, K)) * scale


def _both(log_pi, log_A, log_lik):
    return ([torch.from_numpy(x) for x in (log_pi, log_A, log_lik)],
            [jnp.asarray(x) for x in (log_pi, log_A, log_lik)])


def _vmap(fn, lp, lA, ll):
    return jax.vmap(lambda l: fn(lp, lA, l))(ll)


@pytest.mark.parametrize("B,T,K", [(1, 1, 3), (3, 40, 5), (2, 17, 8)])
def test_forward_and_log_normalizer_match_jax(enable_x64, B, T, K):
    (lp, lA, ll), (jlp, jlA, jll) = _both(*_problem(B, T, K, seed=T))
    alpha, log_z = messages.forward(lp, lA, ll)
    jalpha, jlog_z = _vmap(jmessages.forward, jlp, jlA, jll)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(log_z.numpy(), np.asarray(jlog_z), rtol=1e-10)
    np.testing.assert_allclose(messages.log_normalizer(lp, lA, ll).numpy(),
                               np.asarray(_vmap(jmessages.log_normalizer, jlp, jlA, jll)),
                               rtol=1e-10)


@pytest.mark.parametrize("B,T,K", [(1, 1, 3), (3, 40, 5), (4, 25, 8)])
def test_forward_filter_log_matches_jax(enable_x64, B, T, K):
    (lp, lA, ll), (jlp, jlA, jll) = _both(*_problem(B, T, K, seed=2 * T))
    la, lz = messages.forward_filter_log(lp, lA, ll)
    jla, jlz = _vmap(jmessages.forward_filter_log, jlp, jlA, jll)
    np.testing.assert_allclose(la.numpy(), np.asarray(jla), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(lz.numpy(), np.asarray(jlz), rtol=1e-10)
    # the log-space filter's log Z is the normalised-space forward's
    np.testing.assert_allclose(lz.numpy(), messages.forward(lp, lA, ll)[1].numpy(), rtol=1e-10)


@pytest.mark.parametrize("B,T,K", [(1, 1, 3), (5, 40, 5), (3, 60, 8)])
def test_viterbi_matches_jax(enable_x64, B, T, K):
    (lp, lA, ll), (jlp, jlA, jll) = _both(*_problem(B, T, K, seed=3 * T))
    path = messages.viterbi(lp, lA, ll)
    assert path.dtype == torch.int64 and path.shape == (B, T)
    np.testing.assert_array_equal(path.numpy(), np.asarray(_vmap(jmessages.viterbi, jlp, jlA, jll)))


def test_viterbi_brute_force(enable_x64):
    """tests/test_messages.py:148 in the port: every path of T=7, K=3."""
    log_pi, log_A, log_lik = _problem(2, 7, 3, seed=11)
    path = messages.viterbi(*(torch.from_numpy(x) for x in (log_pi, log_A, log_lik)))
    for b in range(2):
        best, bp = -np.inf, None
        for p in product(range(3), repeat=7):
            lp = log_pi[p[0]] + log_lik[b, 0, p[0]]
            for t in range(1, 7):
                lp += log_A[p[t - 1], p[t]] + log_lik[b, t, p[t]]
            if lp > best:
                best, bp = lp, p
        assert tuple(path[b].tolist()) == bp


def _jax_ffbs_noise(key, T, K):
    """The Gumbel noise (T, K) that JAX's ffbs_sample adds at each step."""
    keys = jax.random.split(key, T)
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (K,), jnp.float64))(keys))


@pytest.mark.parametrize("B,T,K", [(1, 1, 3), (4, 30, 5), (3, 20, 8)])
def test_ffbs_from_gumbel_gives_jax_path(enable_x64, B, T, K):
    (lp, lA, ll), (jlp, jlA, jll) = _both(*_problem(B, T, K, seed=5 * T, scale=1.0))
    keys = jax.random.split(jax.random.PRNGKey(T), B)
    jz = jax.vmap(lambda k, l: jmessages.ffbs_sample(k, jlp, jlA, l))(keys, jll)
    noise = torch.from_numpy(np.stack([_jax_ffbs_noise(k, T, K) for k in keys]))
    z = messages.ffbs_from_gumbel(lp, lA, ll, noise)
    assert z.dtype == torch.int64
    np.testing.assert_array_equal(z.numpy(), np.asarray(jz))


def test_ffbs_marginals_match_gamma(enable_x64):
    """tests/test_messages.py:162 in the port: 4000 draws of one problem,
    batched; their marginals match the smoothed gamma to 0.03."""
    log_pi, log_A, log_lik = _problem(1, 10, 3, seed=7, scale=1.0)
    lp, lA, ll = (torch.from_numpy(x) for x in (log_pi, log_A, log_lik))
    gamma = messages.forward_backward(lp, lA, ll).gamma[0]
    z = messages.ffbs_sample(torch.Generator().manual_seed(0), lp, lA, ll.expand(4000, -1, -1))
    emp = torch.stack([(z == k).double().mean(dim=0) for k in range(3)], dim=1)
    np.testing.assert_allclose(emp.numpy(), gamma.numpy(), atol=0.03)


@pytest.mark.parametrize("B,T,K", [(1, 1, 3), (3, 40, 5), (2, 17, 8)])
def test_e_step_grad_matches_jax(enable_x64, B, T, K):
    (lp, lA, ll), (jlp, jlA, jll) = _both(*_problem(B, T, K, seed=7 * T))
    fb = messages.e_step_grad(lp, lA, ll)
    jfb = jax.vmap(lambda l: jmessages.e_step_grad(jlp, jlA, l))(jll)
    np.testing.assert_allclose(fb.gamma.numpy(), np.asarray(jfb.gamma), atol=1e-10)
    np.testing.assert_allclose(fb.init_stats.numpy(), np.asarray(jfb.init_stats), atol=1e-10)
    np.testing.assert_allclose(fb.trans_stats.numpy(), np.asarray(jfb.trans_stats).sum(0),
                               rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(fb.log_z.numpy(), np.asarray(jfb.log_z), rtol=1e-10)
    # the generating-function identity against the port's own scan E-step
    ref = messages.e_step(lp, lA, ll, method="scan")
    for a, b in ((fb.gamma, ref.gamma), (fb.init_stats, ref.init_stats),
                 (fb.trans_stats, ref.trans_stats), (fb.log_c, ref.log_c)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-10)
    assert not lp.requires_grad and fb.gamma.grad_fn is None


def test_e_step_methods(enable_x64):
    """Every method of e_step; "assoc" and "blocked" (with weights) give JAX's
    vmapped e_step of the same name."""
    log_pi, log_A, log_lik = _problem(2, 6, 3, seed=1)
    lp, lA, ll = (torch.from_numpy(x) for x in (log_pi, log_A, log_lik))
    w = torch.ones(2, 6, dtype=ll.dtype)
    w[0, 2] = 0.0
    assert messages.e_step(lp, lA, ll, w, method="scan").gamma.shape == (2, 6, 3)
    with pytest.raises(ValueError, match="weights"):
        messages.e_step(lp, lA, ll, w, method="grad")
    for method in ("assoc", "blocked"):
        got = messages.e_step(lp, lA, ll, w, method=method)
        want = jax.vmap(lambda l, ww, m=method: jmessages.e_step(
            jnp.asarray(log_pi), jnp.asarray(log_A), l, ww, method=m))(
            jnp.asarray(log_lik), jnp.asarray(w.numpy()))
        for f in ("gamma", "log_z", "log_c", "init_stats"):
            np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                       rtol=1e-10, atol=1e-10)
        np.testing.assert_allclose(got.trans_stats.numpy(), np.asarray(want.trans_stats).sum(0),
                                   rtol=1e-10, atol=1e-10)
    with pytest.raises(ValueError, match="unknown"):
        messages.e_step(lp, lA, ll, method="pallas")


def test_generator_device_checks():
    """The stochastic entry points refuse a generator on another device than
    their tensors; restart generators stay on their parent's device and
    follow its seed."""
    check_generator(torch.Generator(), torch.device("cpu"))
    with pytest.raises(ValueError, match="generator on cpu"):
        check_generator(torch.Generator(), torch.device("cuda"))
    a = restart_generators(torch.Generator().manual_seed(3), 3)
    b = restart_generators(torch.Generator().manual_seed(3), 3)
    assert [g.initial_seed() for g in a] == [g.initial_seed() for g in b]
    assert len({g.initial_seed() for g in a}) == 3 and a[0].device.type == "cpu"
