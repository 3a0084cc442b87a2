"""Windowed subchain SVI (engines/svi.py, engines/base.py::windowed_local_step)
against the JAX package, and the estimator's own properties, on CPU.

The JAX side runs its kernel routes ("pallas_fused", "pallas") in Pallas
interpret mode with the kernel precision knobs at "highest", so both sides
are exact float32 there; the port's "fused" and "split" routes run their
kernels' plain twins on CPU tensors. JAX pads the window to a multiple of 8
on its kernel routes and the port does not, so every comparison uses a
window that already is one: L=10, b=3, W=16. Inputs are NumPy arrays (or
JAX's own init params and draws, carried across by ``convert.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysvihmm_tpu.distributions.emissions import GaussianNIW as JGaussianNIW
from pysvihmm_tpu.engines import svi as jsvi
from pysvihmm_tpu.engines.base import windowed_local_step as jwindowed_local_step
from pysvihmm_tpu.models import hmm as jhmm
from pysvihmm_tpu_torch import convert
from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
from pysvihmm_tpu_torch.distributions import GaussianNIW
from pysvihmm_tpu_torch.engines import svi
from pysvihmm_tpu_torch.engines.base import batch_local_step, decode, windowed_local_step
from pysvihmm_tpu_torch.eval.metrics import hamming_error
from pysvihmm_tpu_torch.models.hmm import init_params, make_prior

torch.set_num_threads(1)

# (port route, JAX route)
ROUTES = [("fused", "pallas_fused"), ("split", "pallas"), ("scan", "scan")]


@pytest.fixture
def highest_kernel_precision(monkeypatch):
    for knob in ("PYSVIHMM_KERNEL_PREC", "PYSVIHMM_LL_PREC", "PYSVIHMM_STATS_PREC"):
        monkeypatch.setenv(knob, "highest")


def _seqs(N, T, K, D, seed, dtype=np.float32):
    """N Gaussian HMM sequences (N, T, D), sticky states, NumPy-made."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=4.0, size=(K, D))
    z = np.empty((N, T), np.int64)
    z[:, 0] = rng.integers(0, K, size=N)
    for t in range(1, T):
        stay = rng.random(N) < 0.8
        z[:, t] = np.where(stay, z[:, t - 1], rng.integers(0, K, size=N))
    return (centres[z] + 0.8 * rng.normal(size=(N, T, D))).astype(dtype)


def _jax_start(obs, K, seed, dtype):
    """JAX prior and init params for obs (N, T, D), in dtype."""
    jprior = jhmm.make_prior(K, JGaussianNIW, obs_dim=obs.shape[-1], dtype=dtype)
    jp0 = jhmm.init_params(jax.random.PRNGKey(seed), jprior, JGaussianNIW, jnp.asarray(obs))
    return jprior, jp0


def _leaves(p):
    return [p.init, p.trans, *p.emit]


@pytest.mark.parametrize("route,jroute", ROUTES)
def test_windowed_local_step_matches_jax(highest_kernel_precision, route, jroute):
    """Same windows, masks and offsets as tests/test_pallas.py:193-223
    (K=4, D=2, T=64, B=6, W=16, L=10), and its tolerances: rtol 2e-4,
    atol 1e-5 on every output."""
    K, D, T, B, W, L = 4, 2, 64, 6, 16, 10
    chain = _seqs(1, T, K, D, seed=0)[0]
    _, jparams = _jax_start(chain[None], K, seed=1, dtype=jnp.float32)
    ws = np.random.default_rng(2).integers(0, T - W + 1, size=B)
    windows = chain[ws[:, None] + np.arange(W)]
    offs = np.arange(B) % (W - L + 1)
    pos = np.arange(W)[None, :]
    maskf = ((pos >= offs[:, None]) & (pos < offs[:, None] + L)).astype(np.float32)

    jout = jwindowed_local_step(jparams, JGaussianNIW, jnp.asarray(windows),
                                jnp.asarray(maskf), jnp.asarray(offs), jroute)
    tout = windowed_local_step(convert.params_from_numpy(jparams, device="cpu"), GaussianNIW,
                               torch.from_numpy(windows), torch.from_numpy(maskf),
                               torch.from_numpy(offs), route)
    emit, jemit = tout[0], jout[0]
    pairs = list(zip(emit, jemit)) + list(zip(tout[1:], jout[1:]))
    assert len(pairs) == 6
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=1e-5)


# One step from the same state, starts or indices drawn by JAX. Scan runs
# in float64 on both sides (same formulas: agreement to rounding); the
# kernel routes in float32, where the E-step's other summation order
# (~1e-6 relative) passes through the scaled natural-gradient blend and the
# cancellation in psi = eta3 - kappa m m^T.
STEP_TOL = {"scan": dict(rtol=1e-9, atol=1e-9), "fused": dict(rtol=2e-4, atol=1e-4),
            "split": dict(rtol=2e-4, atol=1e-4)}


def _jax_draw(key, shape, high):
    """What JAX's step draws from state.key: split, then randint."""
    _, k = jax.random.split(key)
    return np.array(jax.random.randint(k, shape, 0, high))


def _compare_step(tnew, tm, jnew, jm, route):
    tol = STEP_TOL[route]
    for a, b in zip(_leaves(tnew.params), _leaves(jnew.params)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    for name in ("rho", "noisy_elbo"):
        np.testing.assert_allclose(tm[name].numpy(), np.asarray(jm[name]), err_msg=name, **tol)
    assert int(tnew.step) == int(jnew.step) == 4


def _x64(route):
    """float64 for the scan route, float32 for the kernel routes."""
    return route == "scan"


@pytest.mark.parametrize("route,jroute", ROUTES)
def test_svi_step_matches_jax(highest_kernel_precision, route, jroute):
    K, D, T = 4, 2, 64
    cfg = svi.SVIConfig(batch_size=6, subchain_len=10, buffer=3, tau=1.0, kappa=0.6)
    with jax.enable_x64(_x64(route)):
        dtype = np.float64 if _x64(route) else np.float32
        chain = _seqs(1, T, K, D, seed=4, dtype=dtype)[0]
        jprior, jp0 = _jax_start(chain[None], K, seed=5, dtype=dtype)
        # step 3: rho = 4^-0.6 < 1, so the blend with the old params counts
        jstate = jsvi.init_state(jp0, jax.random.PRNGKey(6))._replace(step=jnp.asarray(3, jnp.int32))
        jnew, jm = jsvi.make_step(JGaussianNIW, cfg, T, method=jroute)(
            jstate, jprior, jnp.asarray(chain))
        starts = _jax_draw(jstate.key, (cfg.batch_size,), T - cfg.subchain_len + 1)
    tdt = torch.float64 if _x64(route) else torch.float32
    state = convert.svi_state_from_numpy(jstate, torch.Generator().manual_seed(0),
                                         device="cpu", dtype=tdt)
    step = svi.make_step(GaussianNIW, cfg, T, method=route)
    tnew, tm = step.with_starts(state, convert.params_from_numpy(jprior, device="cpu", dtype=tdt),
                                torch.from_numpy(chain), torch.from_numpy(starts))
    _compare_step(tnew, tm, jnew, jm, route)


@pytest.mark.parametrize("route,jroute", ROUTES)
def test_minibatch_step_matches_jax(highest_kernel_precision, route, jroute):
    K, D, N, T = 4, 2, 6, 32
    cfg = svi.SVIConfig(batch_size=4, tau=1.0, kappa=0.6)
    with jax.enable_x64(_x64(route)):
        dtype = np.float64 if _x64(route) else np.float32
        obs = _seqs(N, T, K, D, seed=7, dtype=dtype)
        jprior, jp0 = _jax_start(obs, K, seed=8, dtype=dtype)
        jstate = jsvi.init_state(jp0, jax.random.PRNGKey(9))._replace(step=jnp.asarray(3, jnp.int32))
        jnew, jm = jsvi.make_minibatch_step(JGaussianNIW, cfg, N, method=jroute)(
            jstate, jprior, jnp.asarray(obs))
        idx = _jax_draw(jstate.key, (cfg.batch_size,), N)
    tdt = torch.float64 if _x64(route) else torch.float32
    state = convert.svi_state_from_numpy(jstate, torch.Generator().manual_seed(0),
                                         device="cpu", dtype=tdt)
    step = svi.make_minibatch_step(GaussianNIW, cfg, N, method=route)
    tnew, tm = step.with_indices(state, convert.params_from_numpy(jprior, device="cpu", dtype=tdt),
                                 torch.from_numpy(obs), torch.from_numpy(idx))
    _compare_step(tnew, tm, jnew, jm, route)


def test_adaptive_svi_step_matches_jax(enable_x64):
    """The elastic step size (SVIConfig.adaptive): two chained steps on
    JAX's draws, scan route, float64 on both sides, the adaptive state
    carried across by convert.py."""
    K, D, T = 3, 2, 60
    cfg = svi.SVIConfig(batch_size=4, subchain_len=10, buffer=3, adaptive=True)
    chain = _seqs(1, T, K, D, seed=10, dtype=np.float64)[0]
    jprior, jp0 = _jax_start(chain[None], K, seed=11, dtype=np.float64)
    jstate = jsvi.init_state(jp0, jax.random.PRNGKey(12), adaptive=True)
    state = convert.svi_state_from_numpy(jstate, torch.Generator(), device="cpu",
                                         dtype=torch.float64)
    prior = convert.params_from_numpy(jprior, device="cpu", dtype=torch.float64)
    jstep = jsvi.make_step(JGaussianNIW, cfg, T, method="scan")
    step = svi.make_step(GaussianNIW, cfg, T, method="scan")
    for _ in range(2):
        starts = _jax_draw(jstate.key, (cfg.batch_size,), T - cfg.subchain_len + 1)
        jstate, jm = jstep(jstate, jprior, jnp.asarray(chain))
        state, tm = step.with_starts(state, prior, torch.from_numpy(chain),
                                     torch.from_numpy(starts))
    for a, b in zip(_leaves(state.params) + list(state.adapt) + [tm["rho"]],
                    _leaves(jstate.params) + list(jstate.adapt) + [jm["rho"]]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9, atol=1e-9)
    assert 0 < float(tm["rho"]) <= 1


def test_svi_state_round_trips():
    _, jp0 = _jax_start(_seqs(2, 8, 3, 2, seed=1), 3, seed=1, dtype=jnp.float32)
    jstate = jsvi.init_state(jp0, jax.random.PRNGKey(0), adaptive=True)
    jstate = jstate._replace(step=jnp.asarray(7, jnp.int32))
    gen = torch.Generator().manual_seed(3)
    state = convert.svi_state_from_numpy(jstate, gen, device="cpu")
    assert state.generator is gen and int(state.step) == 7 and state.step.dtype == torch.int32
    back = convert.svi_state_to_numpy(state)
    for a, b in zip(_leaves(back.params) + list(back.adapt) + [back.step],
                    _leaves(jstate.params) + list(jstate.adapt) + [jstate.step]):
        np.testing.assert_array_equal(a, np.asarray(b))


def test_step_draws_from_the_state_generator():
    """step() is with_starts() on the starts the state's generator draws;
    the same seed gives the same step, and the generator advances."""
    K, D, T = 3, 2, 120
    obs = torch.from_numpy(_seqs(1, T, K, D, seed=2)[0])
    prior = make_prior(K, GaussianNIW, obs_dim=D, device="cpu")
    p0 = init_params(torch.Generator().manual_seed(1), prior, GaussianNIW, obs)
    cfg = svi.SVIConfig(batch_size=5, subchain_len=20, buffer=4)
    step = svi.make_step(GaussianNIW, cfg, T, method="split")
    s1, m1 = step(svi.init_state(p0, torch.Generator().manual_seed(4)), prior, obs)
    starts = torch.randint(0, T - 20 + 1, (5,), generator=torch.Generator().manual_seed(4))
    s2, m2 = step.with_starts(svi.init_state(p0, torch.Generator()), prior, obs, starts)
    for a, b in zip(_leaves(s1.params) + [m1["noisy_elbo"]], _leaves(s2.params) + [m2["noisy_elbo"]]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    s3, _ = step(s1, prior, obs)
    assert int(s3.step) == 2 and not torch.equal(s3.params.trans, s1.params.trans)


def test_subchain_stats_unbiased():
    """tests/test_svi.py:85-143 in the port, through "scan" in float64:
    averaged over many minibatches at fixed params, the scaled subchain
    stats converge to the full-chain stats, at that test's tolerances."""
    K, D, T = 3, 2, 400
    g = torch.Generator().manual_seed(0)
    obs, _, _ = gen_gaussian_dataset(g, K, D, 1, T, dtype=torch.float64)
    chain = obs[0]
    prior = make_prior(K, GaussianNIW, obs_dim=D, dtype=torch.float64, device="cpu")
    params = init_params(torch.Generator().manual_seed(1), prior, GaussianNIW, chain)
    full, _ = batch_local_step(params, GaussianNIW, chain[None], "scan")

    B, L, b, reps = 8, 50, 20, 150
    scale_trans, scale_emit = (T - 1.0) / (B * (L - 1)), T / (B * L)
    W = L + 2 * b
    starts = torch.from_numpy(np.random.default_rng(0).integers(0, T - L + 1, size=reps * B))
    ws = torch.clamp(starts - b, 0, T - W)
    offs = starts - ws
    wins = svi._gather_windows(chain, ws, W)
    pos = torch.arange(W)[None, :]
    maskf = ((pos >= offs[:, None]) & (pos < offs[:, None] + L)).double()
    es, trans, _, _ = windowed_local_step(params, GaussianNIW, wins, maskf, offs, "scan")
    acc_trans = (scale_trans * trans / reps).numpy()
    acc_n = (scale_emit * es.n / reps).numpy()

    np.testing.assert_allclose(acc_trans.sum(), full.trans.sum().item(), rtol=0.05)
    np.testing.assert_allclose(acc_n, full.emit.n.numpy(), rtol=0.1)
    np.testing.assert_allclose(acc_trans, full.trans.numpy(), rtol=0.15, atol=0.5)


def test_single_chain_convergence():
    """tests/test_svi.py:170-185 in the port, through "scan" on the CPU:
    K=4, D=2, T=3000, B=16, L=50, b=10, tau=10, kappa=0.6, 300 steps,
    decoding at Hamming error < 0.05; the noisy ELBO finite and improving."""
    K, D, T = 4, 2, 3000
    obs, z, _ = gen_gaussian_dataset(torch.Generator().manual_seed(5), K, D, 1, T,
                                     mean_scale=6.0, cov_scale=0.3)
    chain = obs[0]
    prior = make_prior(K, GaussianNIW, obs_dim=D, device="cpu")
    p0 = init_params(torch.Generator().manual_seed(6), prior, GaussianNIW, chain)
    cfg = svi.SVIConfig(batch_size=16, subchain_len=50, buffer=10, tau=10.0, kappa=0.6)
    state = svi.init_state(p0, torch.Generator().manual_seed(7))
    state, metrics = svi.fit(state, prior, chain, GaussianNIW, cfg, num_steps=300, method="scan")
    assert int(state.step) == 300 and metrics["noisy_elbo"].shape == (300,)
    ne = metrics["noisy_elbo"]
    assert bool(torch.isfinite(ne).all()) and ne[-50:].mean() > ne[:20].mean()
    err = hamming_error(decode(state.params, GaussianNIW, chain[None], "scan"), z, K)
    assert err < 0.05, f"hamming {err}"
