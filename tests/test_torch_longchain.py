"""The port's long-chain tiers against the JAX package, on CPU: the blocked
forward-backward (messages/blocked.py), the streaming tiers (two-phase,
associative-scan and likelihood-fused, store and rematerialise, the
streaming decode, the feature-major layout), engines/base.py's
``long_chain_local_stats`` and ``long_chain_decode``, batch_vb's
``make_long_chain_step`` and ``fit`` with "assoc" and "blocked", and
data/synthetic.py's ``sample_states_fast``.

The cases mirror the JAX package's tests/test_longchain.py. The same NumPy
inputs (or JAX's own synthetic chain and ``init_params``, carried across by
``convert.py``) go through JAX's function and the port's; in float64 (JAX
under ``enable_x64``) they agree to 1e-9, and the float64 cases also hold
log Z and the statistics to the oracle (oracle/numpy_ref.py) or to the
port's "scan". float32 is held at the tolerance JAX's test states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysvihmm_tpu import messages as jmessages
from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset as jgen_gaussian
from pysvihmm_tpu.data.synthetic import gen_multinomial_dataset as jgen_multinomial
from pysvihmm_tpu.data.synthetic import make_gaussian_params as jmake_gaussian_params
from pysvihmm_tpu.data.synthetic import sample_states_fast as jsample_states_fast
from pysvihmm_tpu.distributions import GaussianNIW as JGaussianNIW
from pysvihmm_tpu.distributions import MultinomialDirichlet as JMultinomialDirichlet
from pysvihmm_tpu.engines import base as jbase
from pysvihmm_tpu.engines import batch_vb as jbatch_vb
from pysvihmm_tpu.messages import blocked as jblocked
from pysvihmm_tpu.messages import stream_fused as jstream_fused
from pysvihmm_tpu.models import hmm as jhmm
from pysvihmm_tpu.oracle import numpy_ref as oracle
from pysvihmm_tpu_torch import convert, messages
from pysvihmm_tpu_torch.data.synthetic import sample_states_fast
from pysvihmm_tpu_torch.distributions import GaussianNIW, MultinomialDirichlet
from pysvihmm_tpu_torch.engines import batch_vb
from pysvihmm_tpu_torch.engines.base import (
    _long_chain_ell_fn,
    batch_local_step,
    long_chain_decode,
    long_chain_local_stats,
)
from pysvihmm_tpu_torch.eval.metrics import hamming_error, hamming_error_long
from pysvihmm_tpu_torch.messages import blocked, stream_fused
from pysvihmm_tpu_torch.models.hmm import expected_log_params

torch.set_num_threads(1)

F64 = 1e-9  # float64 parity, as JAX's own tiers are held (tests/test_longchain.py)


def _problem(T, K, seed):
    """(log_pi (K,), log_A (K, K), log_lik (T, K)) float64, NumPy-made."""
    rng = np.random.default_rng(seed)
    return (np.log(rng.dirichlet(np.ones(K))), np.log(rng.dirichlet(np.ones(K), size=K)),
            rng.normal(size=(T, K)) * 2.0)


def _t(*xs):
    return [torch.from_numpy(np.asarray(x)) for x in xs]


def _j(*xs):
    return [jnp.asarray(x) for x in xs]


def _close(got, want, rtol=F64, atol=F64):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _leaves(x):
    return [x] if not isinstance(x, tuple) else [leaf for part in x for leaf in _leaves(part)]


def _tensors(x):
    return [leaf.numpy() for leaf in _leaves(x)]


# ---- the blocked forward-backward (JAX's TestBlockedFB, TestBlockedFBEdge)


@pytest.mark.parametrize("T,S", [(40, 8), (37, 8), (100, 256), (2, 4), (257, 64)])
def test_blocked_matches_jax_and_scan_all_shapes(enable_x64, T, S):
    lp, lA, ll = _problem(T, 5, seed=T)
    w = (np.random.default_rng(T + 1).uniform(size=T) > 0.3).astype(np.float64)
    got = messages.forward_backward_blocked(*_t(lp, lA, ll[None], w[None]), block_size=S)
    want = jax.jit(lambda *a: jblocked.forward_backward_blocked(*a, block_size=S))(
        *_j(lp, lA, ll, w))
    scan = messages.forward_backward(*_t(lp, lA, ll[None], w[None]))
    for f in ("gamma", "log_z", "log_c", "init_stats"):
        _close(getattr(got, f)[0], getattr(want, f))
        _close(getattr(got, f), getattr(scan, f))
    _close(got.trans_stats, want.trans_stats)
    _close(got.trans_stats, scan.trans_stats)
    _, _, gamma, xi, log_z = oracle.forward_backward(lp, lA, ll)
    plain = messages.forward_backward_blocked(*_t(lp, lA, ll[None]), block_size=S)
    _close(plain.gamma[0], gamma)
    _close(plain.log_z[0], log_z)
    _close(plain.trans_stats, xi)


def test_blocked_extreme_underflow(enable_x64):
    """Per-block renormalisation survives T=5000 of likelihoods whose raw
    product underflows any float."""
    lp, lA, ll = _problem(5000, 4, seed=9)
    ll = ll - 500.0
    got = messages.forward_backward_blocked(*_t(lp, lA, ll[None]), block_size=128)
    assert np.isfinite(got.log_z.item())
    _close(got.log_z[0], oracle.forward_backward(lp, lA, ll)[4], atol=0)
    want = jax.jit(lambda *a: jblocked.forward_backward_blocked(*a, block_size=128))(
        *_j(lp, lA, ll))
    _close(got.log_z[0], want.log_z, atol=0)


def test_e_step_methods_batched(enable_x64):
    """e_step "assoc" and "blocked" over a batch: every sequence is JAX's
    vmapped e_step, trans_stats summed over the batch."""
    rng = np.random.default_rng(4)
    lp, lA, _ = _problem(1, 4, seed=4)
    ll = rng.normal(size=(3, 30, 4)) * 2.0
    w = (rng.uniform(size=(3, 30)) > 0.2).astype(np.float64)
    for method in ("assoc", "blocked"):
        got = messages.e_step(*_t(lp, lA, ll, w), method=method)
        want = jax.jit(jax.vmap(lambda l, ww, m=method: jmessages.e_step(
            jnp.asarray(lp), jnp.asarray(lA), l, ww, method=m)))(*_j(ll, w))
        for f in ("gamma", "log_z", "log_c", "init_stats"):
            _close(getattr(got, f), getattr(want, f))
        _close(got.trans_stats, np.asarray(want.trans_stats).sum(0))


# ---- the streaming tiers (JAX's TestBlockedStream)


def _stats_problem(T, K, D, seed):
    lp, lA, ll = _problem(T, K, seed)
    return lp, lA, ll, np.random.default_rng(seed + 7).normal(size=(T, D))


def _sf_t(g, y):
    return (g.T @ y, g.sum(dim=0))


def _sf_j(g, y):
    return (g.T @ y, jnp.sum(g, axis=0))


def _identity(y):
    return y


@pytest.mark.parametrize("tier", ["twophase", "stream", "fused"])
@pytest.mark.parametrize("T,S", [(210, 64), (129, 64), (65, 64), (2, 8), (40, 8), (1, 8)])
def test_stream_tiers_match_jax(enable_x64, tier, T, S):
    """The three tiers over a (T, K) log-likelihood (the fused one through
    an identity ell_fn, its stat operand another array), with a stat_fn,
    against JAX's same tier and the oracle's gamma."""
    K, D = 5, 3
    lp, lA, ll, xs = _stats_problem(T, K, D, seed=T + S)
    port = {"twophase": blocked.forward_backward_blocked_twophase,
            "stream": blocked.forward_backward_blocked_stream,
            "fused": lambda *a, **k: stream_fused.forward_backward_fused_twophase(
                *a, _identity, **k)}[tier]
    jfn = {"twophase": jblocked.forward_backward_blocked_twophase,
           "stream": jblocked.forward_backward_blocked_stream,
           "fused": lambda *a, **k: jstream_fused.forward_backward_fused_twophase(
               *a, _identity, **k)}[tier]
    got = port(*_t(lp, lA, ll), block_size=S, stat_xs=torch.from_numpy(xs), stat_fn=_sf_t,
               stat_init=tuple(_t(np.zeros((K, D)), np.zeros(K))))
    want = jax.jit(lambda a, b, c, x: jfn(a, b, c, block_size=S, stat_xs=x, stat_fn=_sf_j,
                                          stat_init=(jnp.zeros((K, D)), jnp.zeros(K))))(
        *_j(lp, lA, ll, xs))
    for f in ("log_z", "init_stats", "trans_stats"):
        _close(getattr(got, f), getattr(want, f))
    for a, b in zip(_tensors(got.acc), want.acc):
        _close(a, b)
    _, _, gamma, xi, log_z = oracle.forward_backward(lp, lA, ll)
    _close(got.log_z, log_z)
    _close(got.trans_stats, xi)
    _close(got.acc[0], gamma.T @ xs)


def _jax_params(key, jprior, jfam, chain):
    p = jhmm.init_params(jax.random.PRNGKey(key), jprior, jfam, chain)
    return jax.tree.map(lambda x: x.astype(jnp.float64), p)


def _check_long_chain(jfam, fam, chain, K, S, impl, tol, **prior_kw):
    """long_chain_local_stats(impl) against JAX's same tier and the port's
    "scan" batch_local_step, from JAX's init params."""
    jprior = jhmm.make_prior(K, jfam, **prior_kw)
    jp = _jax_params(3, jprior, jfam, jnp.asarray(chain))
    p = convert.params_from_numpy(jp, device="cpu", dtype=torch.float64)
    c = torch.from_numpy(np.array(chain))
    got = long_chain_local_stats(p, fam, c, block_size=S, impl=impl)
    ref, _ = batch_local_step(p, fam, c[None], method="scan", need_gamma=False)
    want = jax.jit(lambda q, x: jbase.long_chain_local_stats(q, jfam, x, block_size=S,
                                                             impl=impl))(jp, jnp.asarray(chain))
    _close(got.log_z, ref.log_z, rtol=tol, atol=0)
    _close(got.log_z, want.log_z, rtol=tol, atol=0)
    for a, b, r in ((got.init, want.init, ref.init), (got.trans, want.trans, ref.trans)):
        _close(a, b, rtol=50 * tol, atol=50 * tol)
        _close(a, r, rtol=50 * tol, atol=50 * tol)
    for a, b, r in zip(_tensors(got.emit), jax.tree.leaves(want.emit), _tensors(ref.emit)):
        _close(a, b, rtol=50 * tol, atol=50 * tol)
        _close(a, r, rtol=50 * tol, atol=50 * tol)


@pytest.mark.parametrize("impl", ["twophase", "assoc", "fused"])
@pytest.mark.parametrize("T,S", [(210, 64), (129, 64), (65, 64), (2, 8), (40, 8)])
def test_gaussian_matches_scan(enable_x64, T, S, impl):
    K, D = 5, 3
    obs, _, _ = jgen_gaussian(jax.random.PRNGKey(0), K, D, 1, T)
    chain = np.array(obs[0], np.float64)
    _check_long_chain(JGaussianNIW, GaussianNIW, chain, K, S, impl, F64, obs_dim=D)


@pytest.mark.parametrize("impl", ["twophase", "assoc", "fused"])
def test_multinomial_matches_scan(enable_x64, impl):
    K, V, T = 4, 11, 137
    obs, _, _ = jgen_multinomial(jax.random.PRNGKey(1), K, V, 1, T)
    _check_long_chain(JMultinomialDirichlet, MultinomialDirichlet, np.asarray(obs[0]), K, 32,
                      impl, F64, num_symbols=V)


def test_f32_long():
    """T=20,000 in float32: the two-phase tier's statistics agree with
    "scan" to JAX's float tolerance (2e-4)."""
    K, D, T = 8, 4, 20_000
    obs, _, _ = jgen_gaussian(jax.random.PRNGKey(2), K, D, 1, T)
    jprior = jhmm.make_prior(K, JGaussianNIW, obs_dim=D)
    jp = jhmm.init_params(jax.random.PRNGKey(3), jprior, JGaussianNIW, obs[0])
    p = convert.params_from_numpy(jp, device="cpu")
    c = torch.from_numpy(np.array(obs[0]))
    got = long_chain_local_stats(p, GaussianNIW, c, block_size=512, impl="twophase")
    ref, _ = batch_local_step(p, GaussianNIW, c[None], method="scan", need_gamma=False)
    tol = 2e-4
    _close(got.log_z, ref.log_z, rtol=tol, atol=0)
    _close(got.init, ref.init, rtol=0, atol=10 * tol)
    _close(got.trans, ref.trans, rtol=50 * tol, atol=50 * tol)
    for a, b in zip(_tensors(got.emit), _tensors(ref.emit)):
        _close(a, b, rtol=50 * tol, atol=50 * tol)


def test_long_chain_refusals():
    p = convert.params_from_numpy(
        jhmm.init_params(jax.random.PRNGKey(0), jhmm.make_prior(3, JGaussianNIW, obs_dim=2),
                         JGaussianNIW), device="cpu")
    chain = torch.zeros((2, 50))
    for impl in ("twophase", "assoc"):
        with pytest.raises(ValueError, match="time_minor=True requires impl='fused'"):
            long_chain_local_stats(p, GaussianNIW, chain, impl=impl, time_minor=True)
    with pytest.raises(ValueError, match="unknown long-chain impl"):
        long_chain_local_stats(p, GaussianNIW, chain.T, impl="scan")
    with pytest.raises(ValueError, match="stat_xs"):
        blocked.forward_backward_blocked_twophase(
            *_t(*_problem(9, 3, seed=0)), stat_fn=_sf_t)


# ---- the likelihood-fused tier: store and rematerialise, layouts, decode


def _fused(lp, lA, obs, W, store, time_minor=False, module=stream_fused):
    if module is stream_fused:
        Wt = torch.from_numpy(W)
        return stream_fused.forward_backward_fused_twophase(
            *_t(lp, lA, obs), lambda y: y @ Wt, block_size=32, chunks=4, store_alphas=store,
            stat_fn=_sf_t, stat_init=tuple(_t(np.zeros(W.shape[::-1]), np.zeros(W.shape[1]))),
            emit_argmax=True, time_minor=time_minor)
    Wj = jnp.asarray(W)
    return jax.jit(lambda a, b, o: jstream_fused.forward_backward_fused_twophase(
        a, b, o, lambda y: y @ Wj, block_size=32, chunks=4, store_alphas=store,
        stat_fn=_sf_j, stat_init=(jnp.zeros(W.shape[::-1]), jnp.zeros(W.shape[1])),
        emit_argmax=True, time_minor=time_minor))(*_j(lp, lA, obs))


def _fused_problem(seed):
    T, K, D = 333, 5, 3
    lp, lA, _ = _problem(T, K, seed)
    rng = np.random.default_rng(seed + 1)
    return lp, lA, rng.normal(size=(T, D)), rng.normal(size=(D, K))


def test_fused_remat_equals_store(enable_x64):
    """The rematerialising backward (alpha checkpoints, per-chunk recompute)
    gives the stored-alpha path's bits, and JAX's results."""
    lp, lA, obs, W = _fused_problem(1)
    a, b = _fused(lp, lA, obs, W, True), _fused(lp, lA, obs, W, False)
    for x, y in zip((a.log_z, a.init_stats, a.trans_stats, *a.acc, a.z),
                    (b.log_z, b.init_stats, b.trans_stats, *b.acc, b.z)):
        assert torch.equal(x, y)
    want = _fused(lp, lA, obs, W, False, module=None)
    _close(a.log_z, want.log_z)
    _close(a.trans_stats, want.trans_stats)
    for x, y in zip(_tensors(a.acc), want.acc):
        _close(x, y)
    assert a.z.dtype == torch.int32 and np.array_equal(a.z.numpy(), np.asarray(want.z))


@pytest.mark.parametrize("store", [True, False])
def test_time_minor_layout_parity(enable_x64, store):
    """The feature-major (D, T) chain reproduces the time-major results bit
    for bit (stats, log Z, decode), and JAX's time-minor results."""
    lp, lA, obs, W = _fused_problem(2)
    ref = _fused(lp, lA, obs, W, store)
    got = _fused(lp, lA, np.ascontiguousarray(obs.T), W, store, time_minor=True)
    for x, y in zip((ref.log_z, ref.trans_stats, *ref.acc, ref.z),
                    (got.log_z, got.trans_stats, *got.acc, got.z)):
        assert torch.equal(x, y)
    want = _fused(lp, lA, np.ascontiguousarray(obs.T), W, store, time_minor=True, module=None)
    _close(got.log_z, want.log_z)
    for x, y in zip(_tensors(got.acc), want.acc):
        _close(x, y)
    assert np.array_equal(got.z.numpy(), np.asarray(want.z))
    with pytest.raises(ValueError, match="time_minor"):
        stream_fused.forward_backward_fused_twophase(
            *_t(lp, lA, obs.T), lambda y: y, stat_xs=torch.zeros(3), time_minor=True)


@pytest.mark.parametrize("store", [True, False])
def test_streaming_decode_matches_argmax_gamma(enable_x64, store):
    """long_chain_decode and the fused tier's emit_argmax are the argmax of
    the materialising E-step's gamma (the decode rule), in both modes, and
    JAX's decode."""
    K, D, T = 5, 3, 451
    obs, _, _ = jgen_gaussian(jax.random.PRNGKey(7), K, D, 1, T)
    chain = np.array(obs[0], np.float64)
    jp = _jax_params(8, jhmm.make_prior(K, JGaussianNIW, obs_dim=D), JGaussianNIW,
                     jnp.asarray(chain))
    p = convert.params_from_numpy(jp, device="cpu", dtype=torch.float64)
    c = torch.from_numpy(chain)
    _, gamma = batch_local_step(p, GaussianNIW, c[None], method="scan")
    z_ref = gamma[0].argmax(dim=-1)
    tl_pi, tl_A = expected_log_params(p)
    z = stream_fused.forward_backward_fused_twophase(
        tl_pi, tl_A, c, _long_chain_ell_fn(p, GaussianNIW), block_size=64, chunks=4,
        store_alphas=store, emit_argmax=True).z
    assert z.shape == (T,) and z.dtype == torch.int32
    assert torch.equal(z.long(), z_ref)
    z2 = long_chain_decode(p, GaussianNIW, c, block_size=64)
    assert torch.equal(z2.long(), z_ref)
    jz = jax.jit(lambda q, x: jbase.long_chain_decode(q, JGaussianNIW, x, block_size=64))(
        jp, jnp.asarray(chain))
    assert np.array_equal(z2.numpy(), np.asarray(jz))


def test_streaming_decode_multinomial(enable_x64):
    """Int-token chains decode to argmax gamma, and to JAX's decode."""
    K, V, T = 4, 11, 261
    obs, _, _ = jgen_multinomial(jax.random.PRNGKey(9), K, V, 1, T)
    chain = np.array(obs[0])
    jp = _jax_params(10, jhmm.make_prior(K, JMultinomialDirichlet, num_symbols=V),
                     JMultinomialDirichlet, jnp.asarray(chain))
    p = convert.params_from_numpy(jp, device="cpu", dtype=torch.float64)
    c = torch.from_numpy(chain)
    _, gamma = batch_local_step(p, MultinomialDirichlet, c[None], method="scan")
    z = long_chain_decode(p, MultinomialDirichlet, c, block_size=32)
    assert torch.equal(z.long(), gamma[0].argmax(dim=-1))
    jz = jax.jit(lambda q, x: jbase.long_chain_decode(q, JMultinomialDirichlet, x,
                                                      block_size=32))(jp, jnp.asarray(chain))
    assert np.array_equal(z.numpy(), np.asarray(jz))


# ---- the long-chain VB step and batch VB on "assoc" and "blocked"


def test_vb_step_matches_batch_vb(enable_x64):
    """One long-chain VB step is one batch-VB step on the same chain, and
    JAX's long-chain step."""
    K, D, T = 4, 2, 333
    obs, _, _ = jgen_gaussian(jax.random.PRNGKey(4), K, D, 1, T)
    chain = np.array(obs[0], np.float64)
    jprior = jhmm.make_prior(K, JGaussianNIW, obs_dim=D)
    jp0 = jhmm.init_params(jax.random.PRNGKey(5), jprior, JGaussianNIW, jnp.asarray(chain))
    p0 = convert.params_from_numpy(jp0, device="cpu", dtype=torch.float64)
    prior = convert.params_from_numpy(jprior, device="cpu", dtype=torch.float64)
    c = torch.from_numpy(chain)
    ref_p, ref_elbo = batch_vb.make_step(GaussianNIW, method="scan")(p0, prior, c[None])
    lc_p, lc_elbo = batch_vb.make_long_chain_step(GaussianNIW, block_size=64)(p0, prior, c)
    j_p, j_elbo = jbatch_vb.make_long_chain_step(JGaussianNIW, block_size=64)(
        jp0, jprior, jnp.asarray(chain))
    _close(lc_elbo, ref_elbo, rtol=1e-10, atol=0)
    _close(lc_elbo, j_elbo, rtol=1e-10, atol=0)
    for a, b, r in zip(_tensors(lc_p), jax.tree.leaves(j_p), _tensors(ref_p)):
        _close(a, r, rtol=1e-8, atol=1e-10)
        _close(a, b, rtol=1e-8, atol=1e-10)


@pytest.mark.parametrize("method", ["assoc", "blocked"])
def test_batch_vb_fit_assoc_and_blocked(enable_x64, method):
    """batch_vb.fit on "assoc" and "blocked" gives JAX's ELBO history and
    the port's "scan" fit (JAX's tests/test_batch_vb.py runs these methods)."""
    K, D = 3, 2
    obs, _, _ = jgen_gaussian(jax.random.PRNGKey(6), K, D, 4, 40)
    obs = np.array(obs, np.float64)
    jprior = jhmm.make_prior(K, JGaussianNIW, obs_dim=D)
    jp0 = jhmm.init_params(jax.random.PRNGKey(7), jprior, JGaussianNIW, jnp.asarray(obs))
    p0 = convert.params_from_numpy(jp0, device="cpu", dtype=torch.float64)
    prior = convert.params_from_numpy(jprior, device="cpu", dtype=torch.float64)
    o = torch.from_numpy(obs)
    got_p, got = batch_vb.fit(p0, prior, o, GaussianNIW, num_iters=4, method=method)
    _, scan = batch_vb.fit(p0, prior, o, GaussianNIW, num_iters=4, method="scan")
    _, want = jbatch_vb.fit(jp0, jprior, jnp.asarray(obs), JGaussianNIW, num_iters=4,
                            method=method)
    _close(got, want, rtol=1e-10, atol=0)
    _close(got, scan, rtol=1e-10, atol=0)
    assert bool((got[1:] >= got[:-1] - 1e-9 * got.abs()[:-1]).all())


# ---- the host sampler of long chains


def test_fast_state_sampler():
    """sample_states_fast gives JAX's path bit for bit from the same NumPy
    Generator (at any group size, so the groups of maps change nothing), its
    empirical transitions match A, and the matched-Hamming helpers agree."""
    tp = jmake_gaussian_params(jax.random.PRNGKey(0), 4, 2, self_prob=0.8)
    pi, A = np.asarray(tp.pi), np.asarray(tp.A)
    z = sample_states_fast(pi, A, 400_000, np.random.default_rng(0), block=512)
    assert np.array_equal(z, jsample_states_fast(pi, A, 400_000, np.random.default_rng(0),
                                                 block=512))
    C = np.zeros((4, 4))
    np.add.at(C, (z[:-1], z[1:]), 1)
    assert np.abs(C / C.sum(1, keepdims=True) - A).max() < 0.01
    for T in (1, 2, 5, 513, 4097):
        for group in (8, 64, 1 << 24):
            zz = sample_states_fast(pi, A, T, np.random.default_rng(T), block=8,
                                    group_steps=group)
            assert zz.dtype == np.int32 and zz.shape == (T,)
            assert np.array_equal(zz, jsample_states_fast(pi, A, T, np.random.default_rng(T),
                                                          block=8))
    # a sparse, non-sticky A with zero entries and K = 33
    rng = np.random.default_rng(3)
    A33 = rng.dirichlet(np.full(33, 0.2), size=33)
    A33[:, 5] = 0.0
    A33 /= A33.sum(1, keepdims=True)
    pi33 = np.full(33, 1 / 33)
    assert np.array_equal(sample_states_fast(pi33, A33, 50_000, np.random.default_rng(4)),
                          jsample_states_fast(pi33, A33, 50_000, np.random.default_rng(4)))
    with pytest.raises(ValueError, match="int8"):
        sample_states_fast(np.ones(128) / 128, np.eye(128), 10, np.random.default_rng(0))
    est = np.random.default_rng(2).integers(0, 4, size=5000)
    true = np.array([2, 0, 3, 1])[est]
    true[:500] = (true[:500] + 1) % 4  # a tenth mismatched
    assert hamming_error_long(torch.from_numpy(est), torch.from_numpy(true), 4) == \
        hamming_error(est, true, 4)


@pytest.mark.parametrize("dtype, T, K, stores", [
    # float64 at 2^28 < T K <= 2^29 takes 2-4 GiB: rematerialise (JAX's
    # 4-byte rule would store it)
    (torch.float64, 2**22, 64 + 1, False),
    (torch.float64, 2**23, 64, False),
    (torch.float32, 2**22, 64 + 1, True),
    (torch.float32, 2**23, 64, True),
    # either side of each dtype's boundary
    (torch.float64, 2**22, 64, True),
    (torch.float32, 2**23, 64 + 1, False),
    (torch.float64, 2**28, 1, True),
    (torch.float64, 2**28 + 1, 1, False),
])
def test_store_alphas_rule_counts_the_dtype(dtype, T, K, stores):
    """The default of ``store_alphas`` counts the likelihoods' element size,
    checked without allocating: the stored messages stay within 2 GiB in
    every dtype."""
    assert stream_fused.stores_alphas(T, K, dtype) is stores
    assert (T * K * dtype.itemsize <= stream_fused.STORE_ALPHAS_BYTES) is stores
