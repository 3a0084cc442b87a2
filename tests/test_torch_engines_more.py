"""The engines of the port beyond batch VB and SVI (engines/batch_sgd.py,
metaobs.py, gibbs.py, the restarts and the adaptive buffer) against the JAX
package, and their recovery tests, on CPU.

Every comparison feeds the port the draws JAX made with its own key layout:
the meta-observation block ids (``jax.random.choice`` without replacement),
the Gibbs sweep's Gumbel, log-gamma and emission draws, the restarts' inits,
the buffer probes' starts. The "scan" route runs in float64 on both sides;
the port's "fused" route (its kernels' plain twins on CPU tensors) runs in
float32 against JAX's float32 "scan", at the tolerances of
tests/test_torch_svi.py. No Pallas kernel runs in interpret mode here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysvihmm_tpu import messages as jmessages
from pysvihmm_tpu.distributions import emissions as jem
from pysvihmm_tpu.distributions import niw as jniw
from pysvihmm_tpu.engines import base as jbase
from pysvihmm_tpu.engines import batch_sgd as jbatch_sgd
from pysvihmm_tpu.engines import batch_vb as jbatch_vb
from pysvihmm_tpu.engines import gibbs as jgibbs
from pysvihmm_tpu.engines import metaobs as jmetaobs
from pysvihmm_tpu.engines import svi as jsvi
from pysvihmm_tpu.models import hmm as jhmm
from pysvihmm_tpu_torch import convert
from pysvihmm_tpu_torch.data.synthetic import (
    gen_diag_gaussian_dataset,
    gen_gaussian_dataset,
    gen_multinomial_dataset,
)
from pysvihmm_tpu_torch.distributions import emissions
from pysvihmm_tpu_torch.engines import batch_sgd, batch_vb, gibbs, metaobs, svi
from pysvihmm_tpu_torch.engines.base import decode, lower_bound
from pysvihmm_tpu_torch.eval.metrics import best_permutation, hamming_error
from pysvihmm_tpu_torch.models.hmm import init_params, make_prior
from pysvihmm_tpu_torch.utils.device import restart_generators
from test_torch_sampling import _jax_draws

torch.set_num_threads(1)

# port family, JAX family, the name _jax_draws knows it by
FAMILIES = {
    "gaussian": (emissions.GaussianNIW, jem.GaussianNIW),
    "diag_gaussian": (emissions.DiagonalGaussianNIG, jem.DiagonalGaussianNIG),
    "poisson": (emissions.PoissonGamma, jem.PoissonGamma),
    "multinomial": (emissions.MultinomialDirichlet, jem.MultinomialDirichlet),
}
F64 = dict(rtol=1e-9, atol=1e-9)
F32 = dict(rtol=2e-4, atol=1e-4)  # tests/test_torch_svi.py's STEP_TOL for the kernel routes


def _obs(name, N, T, K, D, seed, dtype=np.float64):
    """N sticky-state sequences of the family, NumPy-made: (N, T, D) floats
    or counts, or (N, T) ints < D for the multinomial."""
    rng = np.random.default_rng(seed)
    z = np.empty((N, T), np.int64)
    z[:, 0] = rng.integers(0, K, size=N)
    for t in range(1, T):
        stay = rng.random(N) < 0.8
        z[:, t] = np.where(stay, z[:, t - 1], rng.integers(0, K, size=N))
    if name == "multinomial":
        return (z * (D // K) + rng.integers(0, 2, size=z.shape)) % D
    centres = rng.uniform(1.0, 8.0, size=(K, D)) if name == "poisson" else rng.normal(
        scale=4.0, size=(K, D))
    if name == "poisson":
        return rng.poisson(centres[z]).astype(dtype)
    return (centres[z] + 0.8 * rng.normal(size=(N, T, D))).astype(dtype)


def _jax_start(name, obs, K, seed, dtype, V=None):
    """JAX prior and init params of the family for obs (V symbols for the
    multinomial)."""
    jfam = FAMILIES[name][1]
    if name == "multinomial":
        jprior = jhmm.make_prior(K, jfam, num_symbols=V, dtype=dtype)
    else:
        jprior = jhmm.make_prior(K, jfam, obs_dim=obs.shape[-1], dtype=dtype)
    return jprior, jhmm.init_params(jax.random.PRNGKey(seed), jprior, jfam, jnp.asarray(obs))


def _leaves(p):
    emit = list(p.emit) if isinstance(p.emit, tuple) else [p.emit]
    return [p.init, p.trans, *emit]


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **(tol or F64))


def _params_close(p, jp, **tol):
    for a, b in zip(_leaves(p), _leaves(jp), strict=True):
        _close(a, b, **tol)


# ---------------------------------------------------------------- batch SGD


@pytest.mark.parametrize("name", ["gaussian", "multinomial"])
def test_batch_sgd_trajectory_matches_jax(enable_x64, name):
    """Six natural-gradient iterations from JAX's init on "scan", float64:
    the ELBO history and the final params to 1e-6 (they agree to rounding)."""
    K, D = 4, 8 if name == "multinomial" else 2
    obs = _obs(name, 5, 30, K, D, seed=1)
    jprior, jp0 = _jax_start(name, obs, K, seed=2, dtype=jnp.float64, V=D)
    jfinal, jelbos = jbatch_sgd.fit(jp0, jprior, jnp.asarray(obs), FAMILIES[name][1],
                                    num_iters=6, tau=1.0, kappa=0.6, method="scan")
    tp0, tprior = (convert.params_from_numpy(p, device="cpu", dtype=torch.float64)
                   for p in (jp0, jprior))
    final, elbos = batch_sgd.fit(tp0, tprior, torch.from_numpy(obs), FAMILIES[name][0],
                                 num_iters=6, tau=1.0, kappa=0.6, method="scan")
    _close(elbos, jelbos, rtol=1e-6)
    _params_close(final, jfinal, rtol=1e-6, atol=1e-8)


def test_batch_sgd_state_and_first_step():
    """At step 0 rho = 1, so the first step is batch VB's; the step count
    rides in the state, and two segments make one fit. The "fused" route
    (the kernels' twins) against "scan" in float32."""
    K, D = 3, 2
    obs = torch.from_numpy(_obs("gaussian", 4, 25, K, D, seed=3, dtype=np.float32))
    prior = make_prior(K, emissions.GaussianNIW, obs_dim=D, device="cpu", dtype=torch.float32)
    p0 = init_params(torch.Generator().manual_seed(1), prior, emissions.GaussianNIW, obs)
    for route in ("scan", "fused"):
        st, elbo = batch_sgd.make_step(emissions.GaussianNIW, method=route)(
            batch_sgd.init_state(p0), prior, obs)
        vb, vb_elbo = batch_vb.make_step(emissions.GaussianNIW, method=route)(p0, prior, obs)
        assert int(st.step) == 1 and st.step.dtype == torch.int32
        _close(elbo, vb_elbo, rtol=1e-6)
        _params_close(st.params, vb, rtol=1e-5, atol=1e-5)
    whole, e_whole = batch_sgd.fit_state(batch_sgd.init_state(p0), prior, obs,
                                         emissions.GaussianNIW, 4, method="fused")
    half, e1 = batch_sgd.fit_state(batch_sgd.init_state(p0), prior, obs, emissions.GaussianNIW,
                                   2, method="fused")
    half, e2 = batch_sgd.fit_state(half, prior, obs, emissions.GaussianNIW, 2, method="fused")
    assert int(half.step) == 4
    _close(torch.cat([e1, e2]), e_whole, rtol=0, atol=0)
    _params_close(half.params, whole.params, rtol=0, atol=0)
    scan_final, e_scan = batch_sgd.fit(p0, prior, obs, emissions.GaussianNIW, 4, method="scan")
    _close(e_whole, e_scan, rtol=1e-5)
    _params_close(whole.params, scan_final, **F32)


# ------------------------------------------------------ meta-observation SVI


def _jax_block_ids(key, num_blocks, M):
    """The block ids JAX's metaobs step draws from state.key."""
    _, k = jax.random.split(key)
    return np.array(jax.random.choice(k, num_blocks, (M,), replace=False))


@pytest.mark.parametrize("route", ["scan", "fused"])
def test_metaobs_steps_match_jax(enable_x64, route):
    """One with_blocks step and then three chained ones from JAX's state, on
    JAX's block ids (including block 0, whose window the chain edge clips):
    params, rho and noisy ELBO. JAX runs "scan", unpadded W = Lm + 2b."""
    K, D, T = 3, 2, 240
    cfg = metaobs.MetaObsConfig(minibatch=5, block_len=20, buffer=4, tau=1.0, kappa=0.6)
    x64 = route == "scan"
    dtype, tdt = (np.float64, torch.float64) if x64 else (np.float32, torch.float32)
    chain = _obs("gaussian", 1, T, K, D, seed=4, dtype=dtype)[0]
    with jax.enable_x64(x64):
        jprior, jp0 = _jax_start("gaussian", chain[None], K, seed=5, dtype=dtype)
        jstate = jsvi.init_state(jp0, jax.random.PRNGKey(6))._replace(
            step=jnp.asarray(2, jnp.int32))
        jstep = jmetaobs.make_step(jem.GaussianNIW, cfg, T, method="scan")
        jids, jstates = [], [jstate]
        for _ in range(4):
            jids.append(_jax_block_ids(jstates[-1].key, T // cfg.block_len, cfg.minibatch))
            jstates.append(jstep(jstates[-1], jprior, jnp.asarray(chain))[0])
        jm = jstep(jstate, jprior, jnp.asarray(chain))[1]
    tol = F64 if x64 else F32
    prior = convert.params_from_numpy(jprior, device="cpu", dtype=tdt)
    state = convert.svi_state_from_numpy(jstate, torch.Generator(), device="cpu", dtype=tdt)
    step = metaobs.make_step(emissions.GaussianNIW, cfg, T, method=route)
    first, m = step.with_blocks(state, prior, torch.from_numpy(chain), torch.from_numpy(jids[0]))
    _params_close(first.params, jstates[1].params, **tol)
    for k in ("rho", "noisy_elbo"):
        _close(m[k], jm[k], **tol)
    st = first
    for ids in jids[1:]:
        st, _ = step.with_blocks(st, prior, torch.from_numpy(chain), torch.from_numpy(ids))
    assert int(st.step) == 6
    _params_close(st.params, jstates[-1].params, **tol)


def test_metaobs_step_draws_from_the_state_generator():
    K, D, T = 3, 2, 200
    chain = torch.from_numpy(_obs("gaussian", 1, T, K, D, seed=7)[0])
    prior = make_prior(K, emissions.GaussianNIW, obs_dim=D, device="cpu", dtype=torch.float64)
    p0 = init_params(torch.Generator().manual_seed(1), prior, emissions.GaussianNIW, chain)
    cfg = metaobs.MetaObsConfig(minibatch=4, block_len=20, buffer=5)
    step = metaobs.make_step(emissions.GaussianNIW, cfg, T, method="scan")
    s1, m1 = step(svi.init_state(p0, torch.Generator().manual_seed(4)), prior, chain)
    ids = torch.randperm(T // 20, generator=torch.Generator().manual_seed(4))[:4]
    s2, m2 = step.with_blocks(svi.init_state(p0, torch.Generator()), prior, chain, ids)
    _params_close(s1.params, s2.params, rtol=0, atol=0)
    _close(m1["noisy_elbo"], m2["noisy_elbo"], rtol=0, atol=0)
    stats = step.block_stats(p0, chain, ids)
    assert float(stats.emit.n.sum()) == pytest.approx(4 * 20)
    with pytest.raises(ValueError, match="multiple"):
        metaobs.make_step(emissions.GaussianNIW, cfg, chain_len=210)
    with pytest.raises(ValueError, match="minibatch"):
        metaobs.make_step(emissions.GaussianNIW, cfg._replace(minibatch=11), chain_len=200)


def test_metaobs_block_svi_convergence():
    """tests/test_svi.py:250 in the port, on "scan": K=4, D=2, T=3000, M=6,
    Lm=100, b=10, tau=10, kappa=0.6, 250 steps, Hamming error < 0.05."""
    K, D, T = 4, 2, 3000
    obs, z, _ = gen_gaussian_dataset(torch.Generator().manual_seed(11), K, D, 1, T,
                                     mean_scale=6.0, cov_scale=0.3)
    chain = obs[0]
    prior = make_prior(K, emissions.GaussianNIW, obs_dim=D, device="cpu")
    p0 = init_params(torch.Generator().manual_seed(12), prior, emissions.GaussianNIW, chain)
    cfg = metaobs.MetaObsConfig(minibatch=6, block_len=100, buffer=10, tau=10.0, kappa=0.6)
    state, metrics = metaobs.fit(svi.init_state(p0, torch.Generator().manual_seed(13)), prior,
                                 chain, emissions.GaussianNIW, cfg, num_steps=250, method="scan")
    assert int(state.step) == 250 and bool(torch.isfinite(metrics["noisy_elbo"]).all())
    err = hamming_error(decode(state.params, emissions.GaussianNIW, chain[None], "scan"), z, K)
    assert err < 0.05, f"hamming {err}"


# -------------------------------------------------------------------- Gibbs


def _jax_gibbs_draws(name, jstate, jprior, jobs, jnew, K):
    """The draws JAX's sweep made from jstate.key, given its new paths."""
    jfam = FAMILIES[name][1]
    _, k_pi, k_A, k_emit, k_z = jax.random.split(jstate.key, 5)
    B, T = jnew.z.shape
    noise = jax.vmap(lambda kb: jax.vmap(lambda kt: jax.random.gumbel(kt, (K,), jnp.float64))(
        jax.random.split(kb, T)))(jax.random.split(k_z, B))
    init_c, trans_c, oh = jgibbs._count_stats(jnew.z, K, jnp.float64)
    post = jfam.posterior(jprior.emit, jhmm.emission_flat_stats(jfam, jprior.emit, oh, jobs))
    draws = (noise, jax.random.loggamma(k_pi, jprior.init + init_c),
             jax.random.loggamma(k_A, jprior.trans + trans_c))
    t = [torch.from_numpy(np.array(x)) for x in draws]
    emit = tuple(torch.from_numpy(np.array(x)) for x in _jax_draws(name, k_emit, post))
    return gibbs.GibbsDraws(*t, emit)


def _theta_leaves(theta):
    pi, A, emit = theta
    return [pi, A, *(emit if isinstance(emit, tuple) else (emit,))]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_gibbs_sweep_with_jax_draws(enable_x64, name):
    """One sweep from JAX's initial state, fed JAX's draws: the same paths,
    theta to 1e-8 and the same marginal log-likelihood; then a second sweep
    from the first's state."""
    fam, jfam = FAMILIES[name]
    K, D, B, T = 3, 6 if name == "multinomial" else 2, 4, 25
    obs = _obs(name, B, T, K, D, seed=8)
    jobs = jnp.asarray(obs)
    jprior = _jax_start(name, obs, K, seed=9, dtype=jnp.float64, V=D)[0]
    jsweep = jgibbs.make_sweep(jfam, K)
    jstate = jgibbs.init_state(jax.random.PRNGKey(10), jprior, jfam, jobs, K)
    prior = convert.params_from_numpy(jprior, device="cpu", dtype=torch.float64)
    pi, A, emit = (torch.from_numpy(np.array(x)) if not isinstance(x, tuple)
                   else tuple(torch.from_numpy(np.array(a)) for a in x) for x in jstate.theta)
    state = gibbs.GibbsState(z=torch.from_numpy(np.array(jstate.z)).long(), theta=(pi, A, emit),
                             generator=torch.Generator())
    sweep = gibbs.make_sweep(fam, K)
    for _ in range(2):
        jnew, jm = jsweep(jstate, jprior, jobs)
        draws = _jax_gibbs_draws(name, jstate, jprior, jobs, jnew, K)
        state, m = sweep.with_draws(state, prior, torch.from_numpy(obs), draws)
        np.testing.assert_array_equal(state.z.numpy(), np.asarray(jnew.z))
        for a, b in zip(_theta_leaves(state.theta), _theta_leaves(jnew.theta), strict=True):
            _close(a, b, rtol=1e-8, atol=1e-10)
        _close(m["marginal_loglik"], jm["marginal_loglik"], rtol=1e-10)
        jstate = jnew


def test_gibbs_sweep_draws_from_the_state_generator():
    K, D = 3, 2
    obs = torch.from_numpy(_obs("gaussian", 3, 20, K, D, seed=12))
    prior = make_prior(K, emissions.GaussianNIW, obs_dim=D, device="cpu", dtype=torch.float64)
    sweep = gibbs.make_sweep(emissions.GaussianNIW, K)
    a = sweep(gibbs.init_state(torch.Generator().manual_seed(1), prior, emissions.GaussianNIW,
                               obs, K), prior, obs)[0]
    b = sweep(gibbs.init_state(torch.Generator().manual_seed(1), prior, emissions.GaussianNIW,
                               obs, K), prior, obs)[0]
    assert torch.equal(a.z, b.z) and a.z.shape == (3, 20)
    for x, y in zip(_theta_leaves(a.theta), _theta_leaves(b.theta)):
        assert torch.equal(x, y)


@pytest.mark.parametrize("name", ["gaussian", "multinomial", "diag_gaussian"])
def test_gibbs_recovery(name):
    """tests/test_gibbs.py in the port at its shapes and bounds: Gaussian
    K=4, D=2, 10 x 200, 60 sweeps (Hamming < 0.05, the marginal
    log-likelihood improves, the relabelled A draw within 0.15 of the
    truth); multinomial K=3, V=12, 10 x 300, 80 sweeps (< 0.15); diagonal
    Gaussian K=4, D=2, 10 x 200, 60 sweeps (< 0.05)."""
    g = torch.Generator().manual_seed(2)
    if name == "gaussian":
        K, fam, sweeps, bound = 4, emissions.GaussianNIW, 60, 0.05
        obs, z, true = gen_gaussian_dataset(g, K, 2, 10, 200, mean_scale=6.0, cov_scale=0.3)
        prior = make_prior(K, fam, obs_dim=2, device="cpu")
    elif name == "diag_gaussian":
        K, fam, sweeps, bound = 4, emissions.DiagonalGaussianNIG, 60, 0.05
        obs, z, true = gen_diag_gaussian_dataset(g, K, 2, 10, 200, mean_scale=6.0,
                                                 var_scale=0.3)
        prior = make_prior(K, fam, obs_dim=2, device="cpu")
    else:
        K, fam, sweeps, bound = 3, emissions.MultinomialDirichlet, 80, 0.15
        obs, z, true = gen_multinomial_dataset(g, K, 12, 10, 300, concentration=0.2)
        prior = make_prior(K, fam, num_symbols=12, device="cpu")
    state = gibbs.init_state(torch.Generator().manual_seed(3), prior, fam, obs, K)
    state, metrics = gibbs.run(state, prior, obs, fam, K, num_sweeps=sweeps)
    mll = metrics["marginal_loglik"]
    assert mll.shape == (sweeps,) and bool(torch.isfinite(mll).all())
    err = hamming_error(state.z, z, K)
    assert err < bound, f"hamming {err}"
    if name != "multinomial":
        assert mll[-10:].mean() > mll[:5].mean()
    if name == "gaussian":
        inv = np.argsort(best_permutation(state.z, z, K))
        A = state.theta[1].numpy()[inv][:, inv]
        assert np.abs(A - true.A.numpy()).max() < 0.15


# ----------------------------------------------------------------- restarts


def test_batch_vb_restarts_match_jax(enable_x64):
    """fit_restarts_from on JAX's own restart inits (vmapped init_params over
    split keys) against JAX's fit_restarts: the ELBO histories, the best
    index and the best params, float64 on "scan"."""
    K, D, R = 3, 2, 3
    obs = _obs("gaussian", 4, 30, K, D, seed=13)
    jprior = _jax_start("gaussian", obs, K, seed=0, dtype=jnp.float64)[0]
    key = jax.random.PRNGKey(14)
    jbest, jelbos, jidx = jbatch_vb.fit_restarts(key, jprior, jnp.asarray(obs), jem.GaussianNIW,
                                                 num_iters=6, num_restarts=R, method="scan")
    jinits = jax.vmap(lambda k: jhmm.init_params(k, jprior, jem.GaussianNIW,
                                                 jnp.asarray(obs)))(jax.random.split(key, R))
    inits = [convert.params_from_numpy(jax.tree.map(lambda x, r=r: x[r], jinits), device="cpu",
                                       dtype=torch.float64) for r in range(R)]
    prior = convert.params_from_numpy(jprior, device="cpu", dtype=torch.float64)
    best, elbos, idx = batch_vb.fit_restarts_from(inits, prior, torch.from_numpy(obs),
                                                  emissions.GaussianNIW, 6, method="scan")
    assert elbos.shape == (R, 6) and idx == int(jidx) == int(torch.argmax(elbos[:, -1]))
    _close(elbos, jelbos, rtol=1e-9)
    _params_close(best, jbest)


def test_restarts_pick_the_best_exact_elbo(enable_x64):
    """batch_vb.fit_restarts and svi.fit_restarts draw one generator a restart
    from theirs; each restart is the plain fit from its init and generator,
    and the winner is the argmax. The SVI winner's exact lower bound is
    JAX's lower_bound at the same params."""
    K, D, T = 3, 2, 300
    chain = torch.from_numpy(_obs("gaussian", 1, T, K, D, seed=15)[0])
    prior = make_prior(K, emissions.GaussianNIW, obs_dim=D, device="cpu", dtype=torch.float64)
    best, elbos, idx = batch_vb.fit_restarts(torch.Generator().manual_seed(1), prior,
                                             chain[None], emissions.GaussianNIW, 5,
                                             num_restarts=3, method="scan")
    assert elbos.shape == (3, 5) and idx == int(torch.argmax(elbos[:, -1]))

    cfg = svi.SVIConfig(batch_size=4, subchain_len=20, buffer=4, tau=1.0, kappa=0.6)
    st, ex, idx = svi.fit_restarts(torch.Generator().manual_seed(2), prior, chain,
                                   emissions.GaussianNIW, cfg, 5, num_restarts=3, method="scan")
    assert ex.shape == (3,) and idx == int(torch.argmax(ex)) and int(st.step) == 5
    gens = restart_generators(torch.Generator().manual_seed(2), 3)
    inits = [init_params(g, prior, emissions.GaussianNIW, chain) for g in gens]
    ref, _ = svi.fit(svi.init_state(inits[idx], gens[idx]), prior, chain, emissions.GaussianNIW,
                     cfg, 5, method="scan")
    _params_close(st.params, ref.params, rtol=0, atol=0)
    n = convert.params_to_numpy(st.params)
    jparams = jhmm.HMMParams(jnp.asarray(n.init), jnp.asarray(n.trans),
                             jniw.NIW(*(jnp.asarray(x) for x in n.emit)))
    jprior = jhmm.make_prior(K, jem.GaussianNIW, obs_dim=D, dtype=jnp.float64)
    _close(ex[idx], jbase.lower_bound(jparams, jprior, jem.GaussianNIW,
                                      jnp.asarray(chain.numpy())[None], "scan"))
    _close(ex[idx], lower_bound(st.params, prior, emissions.GaussianNIW, chain[None], "scan"))


# ------------------------------------------------------------ adaptive buffer


def _jax_gap(jparams, jchain, jfam, L, b, starts):
    """JAX's select_buffer comparison (engines/svi.py:322-334) at fixed starts."""
    b2 = 2 * b
    log_pi, log_A = jhmm.expected_log_params(jparams)
    wins = jsvi._gather_windows(jchain, jnp.asarray(starts), L + 2 * b2)
    ll2 = jfam.expected_log_likelihood(jparams.emit, wins)
    fb2 = jax.vmap(lambda l: jmessages.e_step(log_pi, log_A, l))(ll2)
    fb1 = jax.vmap(lambda l: jmessages.e_step(log_pi, log_A, l))(ll2[:, b2 - b: b2 + b + L])
    return float(jnp.max(jnp.abs(fb1.gamma[:, b: b + L] - fb2.gamma[:, b2: b2 + L])))


def test_buffer_gap_and_select_buffer(enable_x64):
    """_buffer_gap against JAX's gap on the same starts (b = 1 and 2, on a
    chain of overlapping states under sticky transitions, where the gaps
    are well above tol);
    select_buffer is the doubling over the gaps at the starts its generator
    draws, and it doubles here before the gap falls under tol."""
    K, D, T, L = 3, 2, 600, 30
    rng = np.random.default_rng(16)
    chain = _obs("gaussian", 1, T, K, D, seed=16)[0] * 0.15 + rng.normal(size=(T, D))
    jparams = _jax_start("gaussian", chain[None], K, seed=17, dtype=jnp.float64)[1]
    jparams = jparams._replace(trans=jparams.trans + 60.0 * jnp.eye(K))  # sticky: slow forgetting
    params = convert.params_from_numpy(jparams, device="cpu", dtype=torch.float64)
    tchain = torch.from_numpy(chain)
    for b in (1, 2):
        starts = rng.integers(0, T - L - 4 * b + 1, size=8)
        gap = svi._buffer_gap(params, tchain, emissions.GaussianNIW, L, b, torch.from_numpy(starts))
        _close(gap, _jax_gap(jparams, jnp.asarray(chain), jem.GaussianNIW, L, b, starts),
               rtol=1e-9, atol=1e-12)

    tol = 1e-6
    b_sel = svi.select_buffer(params, tchain, emissions.GaussianNIW, L,
                              torch.Generator().manual_seed(3), tol=tol)
    g, b, gaps = torch.Generator().manual_seed(3), 1, []
    while 2 * b <= min(L, (T - L) // 4, 64):
        starts = torch.randint(0, T - L - 4 * b + 1, (8,), generator=g)
        gaps.append(float(svi._buffer_gap(params, tchain, emissions.GaussianNIW, L, b, starts)))
        if gaps[-1] < tol:
            break
        b *= 2
    assert b_sel == b >= 2 and gaps[0] > 10 * tol > gaps[-1]
