"""The diagonal-Gaussian, Poisson and multinomial families of the port against
the JAX package, on CPU.

The distribution functions run in float64 on both sides (JAX under the
``enable_x64`` fixture), so agreement is to 1e-10 relative with a 1e-12
floor, as in tests/test_torch_distributions.py. The engine tests run every
route of the port ("scan", "fused", "split", "duplex") against JAX's
("scan", "pallas_fused", "pallas", "pallas_fused" with ``PYSVIHMM_DUPLEX``),
JAX's kernels in Pallas interpret mode with the precision knobs at
"highest", in float32 on both sides: the tolerances are those of
tests/test_pallas.py:246-251 and :523-553. Inputs are NumPy-made; JAX's
``init_params`` is carried across by ``convert.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysvihmm_tpu.distributions import diag_gaussian as jdiag
from pysvihmm_tpu.distributions import emissions as jem
from pysvihmm_tpu.distributions import poisson as jpois
from pysvihmm_tpu.engines import batch_vb as jbatch_vb
from pysvihmm_tpu.engines import svi as jsvi
from pysvihmm_tpu.engines.base import batch_local_step as jbatch_local_step
from pysvihmm_tpu.models import hmm as jhmm
from pysvihmm_tpu_torch import convert
from pysvihmm_tpu_torch.distributions import (
    DiagonalGaussianNIG,
    MultinomialDirichlet,
    PoissonGamma,
    diag_gaussian,
    poisson,
)
from pysvihmm_tpu_torch.engines import batch_vb, svi
from pysvihmm_tpu_torch.engines.base import batch_local_step
from pysvihmm_tpu_torch.models import hmm

torch.set_num_threads(1)

RTOL, ATOL = 1e-10, 1e-12
PORT = {"diag": DiagonalGaussianNIG, "poisson": PoissonGamma, "multinomial": MultinomialDirichlet}
JAX = {"diag": jem.DiagonalGaussianNIG, "poisson": jem.PoissonGamma,
       "multinomial": jem.MultinomialDirichlet}
# port route -> (JAX route, PYSVIHMM_DUPLEX set)
ROUTES = {"scan": ("scan", False), "fused": ("pallas_fused", False), "split": ("pallas", False),
          "duplex": ("pallas_fused", True)}


def close(port, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=rtol, atol=atol)


def leaves(x):
    """A family's params or statistics as a list of arrays."""
    return list(x) if hasattr(x, "_fields") else [x]


def _nig(K, D, seed):
    r = np.random.default_rng(seed)
    return dict(mean=r.normal(scale=2.0, size=(K, D)), kappa=r.uniform(0.5, 30.0, (K, D)),
                a=r.uniform(1.5, 20.0, (K, D)), b=r.uniform(0.3, 10.0, (K, D)))


def _gamma(K, D, seed):
    r = np.random.default_rng(seed)
    return dict(a=r.uniform(0.5, 8.0, (K, D)), b=r.uniform(0.2, 4.0, (K, D)))


# ------------------------------------------------------ distributions, f64


@pytest.mark.parametrize("K,D", [(3, 2), (5, 8)])
def test_diag_gaussian_matches_jax(enable_x64, K, D):
    """ell, its feature form, suff_stats, posterior, natural coordinates,
    nat_grad_step, kl, mean_params, make_prior and unpack_flat_stats."""
    rng = np.random.default_rng(K + D)
    p, pp = _nig(K, D, 1), _nig(K, D, 2)
    tq, jq = diag_gaussian.NIG(**{k: torch.tensor(v) for k, v in p.items()}), jdiag.NIG(**p)
    tp, jp = diag_gaussian.NIG(**{k: torch.tensor(v) for k, v in pp.items()}), jdiag.NIG(**pp)
    y = rng.normal(scale=2.0, size=(7, D))
    g = rng.dirichlet(np.ones(K), size=7)
    ell = diag_gaussian.expected_log_likelihood(tq, torch.tensor(y))
    close(ell, jdiag.expected_log_likelihood(jq, jnp.asarray(y)))
    close(diag_gaussian.ell_features(torch.tensor(y)) @ diag_gaussian.ell_feature_matrix(tq), ell)
    close(diag_gaussian.ell_feature_matrix(tq), jdiag.ell_feature_matrix(jq))
    ts = diag_gaussian.suff_stats(torch.tensor(g), torch.tensor(y))
    js = jdiag.suff_stats(jnp.asarray(g), jnp.asarray(y))
    for a, b in zip(ts, js):
        close(a, b)
    for a, b in zip(diag_gaussian.posterior(tp, ts), jdiag.posterior(jp, js)):
        close(a, b)
    for a, b in zip(diag_gaussian.to_natural(tq), jdiag.to_natural(jq)):
        close(a, b)
    for a, b in zip(diag_gaussian.from_natural(diag_gaussian.to_natural(tq)), tq):
        close(a, b)
    for a, b in zip(diag_gaussian.nat_grad_step(tq, tp, ts, 3.0, 0.4),
                    jdiag.nat_grad_step(jq, jp, js, 3.0, 0.4)):
        close(a, b)
    for a, b in zip(diag_gaussian.nat_grad_step(tq, tp, ts, 1.0, 1.0), diag_gaussian.posterior(tp, ts)):
        close(a, b)
    close(diag_gaussian.kl(tq, tp), jdiag.kl(jq, jp))
    close(DiagonalGaussianNIG.kl(tq, tp), jem.DiagonalGaussianNIG.kl(jq, jp))
    for a, b in zip(diag_gaussian.mean_params(tq), jdiag.mean_params(jq)):
        close(a, b)
    tpr = DiagonalGaussianNIG.make_prior(K, D, dtype=torch.float64, device="cpu", kappa=2.0, a=3.0)
    jpr = jem.DiagonalGaussianNIG.make_prior(K, D, dtype=jnp.float64, kappa=2.0, a=3.0)
    for a, b in zip(tpr, jpr):
        close(a, b)
    S = rng.normal(size=(K, 1 + 2 * D))
    for a, b in zip(DiagonalGaussianNIG.unpack_flat_stats(tq, torch.tensor(S)),
                    jem.DiagonalGaussianNIG.unpack_flat_stats(jq, jnp.asarray(S))):
        close(a, b)


@pytest.mark.parametrize("K,D", [(3, 2), (5, 8)])
def test_poisson_matches_jax(enable_x64, K, D):
    """ell with its -sum log y! term, the feature form (last W row -1),
    suff_stats, posterior, nat_grad_step, kl, mean_params, make_prior and
    unpack_flat_stats (the log-factorial column dropped)."""
    rng = np.random.default_rng(10 + K + D)
    p, pp = _gamma(K, D, 3), _gamma(K, D, 4)
    tq, jq = poisson.GammaP(**{k: torch.tensor(v) for k, v in p.items()}), jpois.GammaP(**p)
    tp, jp = poisson.GammaP(**{k: torch.tensor(v) for k, v in pp.items()}), jpois.GammaP(**pp)
    y = rng.poisson(6.0, size=(7, D)).astype(np.float64)  # sum log y! runs to tens
    g = rng.dirichlet(np.ones(K), size=7)
    ell = poisson.expected_log_likelihood(tq, torch.tensor(y))
    close(ell, jpois.expected_log_likelihood(jq, jnp.asarray(y)))
    W = poisson.ell_feature_matrix(tq)
    close(poisson.ell_features(torch.tensor(y)) @ W, ell)
    close(W, jpois.ell_feature_matrix(jq))
    assert bool((W[-1] == -1).all())
    close(poisson.ell_features(torch.tensor(y)), jpois.ell_features(jnp.asarray(y)))
    ts = poisson.suff_stats(torch.tensor(g), torch.tensor(y))
    js = jpois.suff_stats(jnp.asarray(g), jnp.asarray(y))
    for a, b in zip(ts, js):
        close(a, b)
    for a, b in zip(poisson.posterior(tp, ts), jpois.posterior(jp, js)):
        close(a, b)
    for a, b in zip(poisson.nat_grad_step(tq, tp, ts, 3.0, 0.4), jpois.nat_grad_step(jq, jp, js, 3.0, 0.4)):
        close(a, b)
    for a, b in zip(poisson.nat_grad_step(tq, tp, ts, 1.0, 1.0), poisson.posterior(tp, ts)):
        close(a, b)
    close(poisson.kl(tq, tp), jpois.kl(jq, jp))
    close(PoissonGamma.kl(tq, tp), jem.PoissonGamma.kl(jq, jp))
    close(poisson.mean_params(tq), jpois.mean_params(jq))
    tpr = PoissonGamma.make_prior(K, D, dtype=torch.float64, device="cpu", a=2.0, b=0.5)
    jpr = jem.PoissonGamma.make_prior(K, D, dtype=jnp.float64, a=2.0, b=0.5)
    for a, b in zip(tpr, jpr):
        close(a, b)
    S = rng.normal(size=(K, 2 + D))
    for a, b in zip(PoissonGamma.unpack_flat_stats(tq, torch.tensor(S)),
                    jem.PoissonGamma.unpack_flat_stats(jq, jnp.asarray(S))):
        close(a, b)


@pytest.mark.parametrize("V", [6, hmm.ONE_HOT_MAX_V + 44])
def test_multinomial_matches_jax(enable_x64, V):
    """The gathered ell, posterior, nat_grad_step, kl, mean_params,
    make_prior, unpack_flat_stats, and emission_flat_stats: the one-hot
    product at V <= ONE_HOT_MAX_V, the segment-sum (index_add_) above."""
    K = 4
    rng = np.random.default_rng(V)
    q, p = rng.uniform(0.3, 5.0, (K, V)), rng.uniform(0.3, 5.0, (K, V))
    tq, tp = torch.tensor(q), torch.tensor(p)
    y = rng.integers(0, V, size=(3, 9))
    g = rng.dirichlet(np.ones(K), size=(3, 9))
    close(MultinomialDirichlet.expected_log_likelihood(tq, torch.tensor(y)),
          jem.MultinomialDirichlet.expected_log_likelihood(jnp.asarray(q), jnp.asarray(y)))
    stats = hmm.emission_flat_stats(MultinomialDirichlet, tq, torch.tensor(g), torch.tensor(y))
    jstats = jhmm.emission_flat_stats(jem.MultinomialDirichlet, jnp.asarray(q), jnp.asarray(g),
                                      jnp.asarray(y))
    close(stats, jstats)
    close(MultinomialDirichlet.posterior(tp, stats), jem.MultinomialDirichlet.posterior(p, jstats))
    close(MultinomialDirichlet.nat_grad_step(tq, tp, stats, 3.0, 0.4),
          jem.MultinomialDirichlet.nat_grad_step(q, p, jstats, 3.0, 0.4))
    close(MultinomialDirichlet.kl(tq, tp), jem.MultinomialDirichlet.kl(jnp.asarray(q), jnp.asarray(p)))
    close(MultinomialDirichlet.mean_params(tq), jem.MultinomialDirichlet.mean_params(jnp.asarray(q)))
    close(MultinomialDirichlet.make_prior(K, V, dtype=torch.float64, device="cpu"),
          jem.MultinomialDirichlet.make_prior(K, V, dtype=jnp.float64))
    assert MultinomialDirichlet.unpack_flat_stats(tq, stats) is stats


@pytest.mark.parametrize("name", ["diag", "poisson", "multinomial"])
def test_model_helpers_dispatch_on_the_family(enable_x64, name):
    """make_prior per family against JAX's, and init_params' per-family
    branches (models/hmm.py:133-143 of the JAX package): farthest-point
    means, U(0, 1) noise on the Dirichlet rows, Poisson rates at
    farthest-point count vectors."""
    K, D, V = 4, 3, 7
    kw = dict(num_symbols=V) if name == "multinomial" else dict(obs_dim=D)
    tpr = hmm.make_prior(K, PORT[name], dtype=torch.float64, device="cpu", **kw)
    jpr = jhmm.make_prior(K, JAX[name], **kw)
    for a, b in zip([tpr.init, tpr.trans, *leaves(tpr.emit)], [jpr.init, jpr.trans, *leaves(jpr.emit)]):
        close(a, b)
    g = torch.Generator().manual_seed(0)
    if name == "multinomial":
        obs = torch.randint(0, V, (5, 20), generator=g)
    else:
        obs = torch.rand((5, 20, D), generator=g, dtype=torch.float64) * 9.0
    p0 = hmm.init_params(g, tpr, PORT[name], obs)
    assert bool((p0.init > tpr.init).all()) and bool((p0.trans > tpr.trans).all())
    flat = obs.reshape(-1, D) if name != "multinomial" else None
    if name == "diag":
        assert all(bool((flat == m).all(-1).any()) for m in p0.emit.mean)
        torch.testing.assert_close(p0.emit.a, tpr.emit.a)
    elif name == "poisson":
        rates = p0.emit.a / p0.emit.b
        assert all(bool((torch.clamp_min(flat, 0.1) == r).all(-1).any()) for r in rates)
    else:
        noise = p0.emit - tpr.emit
        assert bool((noise >= 0).all()) and bool((noise < 1).all()) and noise.std() > 0.1
    stats = hmm.global_kl(p0, tpr, PORT[name])
    assert stats.shape == () and bool(torch.isfinite(stats))


# ------------------------------------------------------- engines, float32


@pytest.fixture
def highest_kernel_precision(monkeypatch):
    for knob in ("PYSVIHMM_KERNEL_PREC", "PYSVIHMM_LL_PREC", "PYSVIHMM_STATS_PREC"):
        monkeypatch.setenv(knob, "highest")


def _states(rng, B, T, K, stay=0.85):
    z = np.empty((B, T), np.int64)
    z[:, 0] = rng.integers(0, K, size=B)
    for t in range(1, T):
        keep = rng.random(B) < stay
        z[:, t] = np.where(keep, z[:, t - 1], rng.integers(0, K, size=B))
    return z


def _data(name, B, T, K, seed, D=3, V=6):
    """NumPy-made observations: (B, T, D) float32 for the diagonal Gaussian
    and Poisson counts, (B, T) int32 symbols for the multinomial."""
    rng = np.random.default_rng(seed)
    z = _states(rng, B, T, K)
    if name == "diag":
        mu, sd = rng.normal(scale=3.0, size=(K, D)), rng.uniform(0.5, 1.5, size=(K, D))
        return (mu[z] + sd[z] * rng.normal(size=(B, T, D))).astype(np.float32)
    if name == "poisson":
        return rng.poisson(rng.uniform(1.0, 20.0, size=(K, D))[z]).astype(np.float32)
    cum = np.cumsum(rng.dirichlet(np.full(V, 0.3), size=K), axis=-1)
    y = (rng.random((B, T))[..., None] > cum[z]).sum(-1)
    return np.minimum(y, V - 1).astype(np.int32)


def _start(name, obs, K, seed, V=6):
    kw = dict(num_symbols=V) if name == "multinomial" else dict(obs_dim=obs.shape[-1])
    jprior = jhmm.make_prior(K, JAX[name], dtype=jnp.float32, **kw)
    jp0 = jhmm.init_params(jax.random.PRNGKey(seed), jprior, JAX[name], jnp.asarray(obs))
    return jprior, jp0


@pytest.fixture
def jax_route(monkeypatch):
    """use(route) -> the JAX route of a port route. For "duplex" it sets
    PYSVIHMM_DUPLEX, which JAX reads while tracing, so JAX's caches are
    cleared then and again when the test ends: no trace of one route is
    reused by the other."""
    used = []

    def use(route):
        jroute, knob = ROUTES[route]
        monkeypatch.delenv("PYSVIHMM_DUPLEX", raising=False)
        if knob:
            monkeypatch.setenv("PYSVIHMM_DUPLEX", "1")
            jax.clear_caches()
            used.append(route)
        return jroute

    yield use
    if used:
        jax.clear_caches()


def _compare_local(ts, tg, js, jg):
    """tests/test_pallas.py:246-251's tolerances, float32 both sides."""
    if jg is not None:
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=5e-5)
    np.testing.assert_allclose(ts.init.numpy(), np.asarray(js.init), atol=5e-5)
    np.testing.assert_allclose(ts.trans.numpy(), np.asarray(js.trans), atol=1e-3)
    np.testing.assert_allclose(ts.log_z.item(), float(js.log_z), rtol=2e-6)
    for a, b in zip(leaves(ts.emit), leaves(js.emit)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-3, atol=2e-3)


@pytest.mark.parametrize("route", list(ROUTES))
@pytest.mark.parametrize("name", ["diag", "poisson", "multinomial"])
def test_local_step_matches_jax(highest_kernel_precision, jax_route, name, route):
    """Every route of the port against JAX's, ungated (gamma included) and
    gated by a kept-mask (tests/test_pallas.py:266, :523)."""
    B, T, K = 3, 16, 3
    obs = _data(name, B, T, K, seed=1)
    _, jp0 = _start(name, obs, K, seed=2)
    params = convert.params_from_numpy(jp0, device="cpu")
    w = (np.random.default_rng(3).random((B, T)) > 0.3).astype(np.float32)
    jroute = jax_route(route)
    for weights in (None, w):
        js, jg = jbatch_local_step(jp0, JAX[name], jnp.asarray(obs), jroute,
                                   weights=None if weights is None else jnp.asarray(weights))
        ts, tg = batch_local_step(params, PORT[name], torch.from_numpy(obs), route,
                                  weights=None if weights is None else torch.from_numpy(weights))
        _compare_local(ts, tg, js, jg)


LARGE_V = hmm.ONE_HOT_MAX_V + 44


@functools.lru_cache(maxsize=1)
def _large_vocab_problem():
    """(obs, JAX init params, kept-mask, JAX's statistics) at V = LARGE_V.
    Above ONE_HOT_MAX_V JAX's "pallas_fused" route, with or without
    PYSVIHMM_DUPLEX, runs its "pallas" route (engines/base.py:547-548), so
    one JAX run is the reference of all three kernel routes of the port."""
    B, T, K = 4, 32, 4
    obs = _data("multinomial", B, T, K, seed=6, V=LARGE_V)
    _, jp0 = _start("multinomial", obs, K, seed=7, V=LARGE_V)
    w = (np.random.default_rng(8).random((B, T)) > 0.3).astype(np.float32)
    js, _ = jbatch_local_step(jp0, jem.MultinomialDirichlet, jnp.asarray(obs), "pallas",
                              weights=jnp.asarray(w), need_gamma=False)
    return obs, jp0, w, jax.tree.map(np.asarray, js)


@pytest.mark.parametrize("route", ["fused", "split", "duplex"])
def test_large_vocab_multinomial_segment_sum(highest_kernel_precision, route):
    """V = ONE_HOT_MAX_V + 44 (tests/test_pallas.py:409): every kernel route
    runs the split kernels over gathered likelihoods with segment-sum
    statistics, against JAX's route and against the port's "scan"."""
    obs, jp0, w, js = _large_vocab_problem()
    params = convert.params_from_numpy(jp0, device="cpu")
    ts, tg = batch_local_step(params, MultinomialDirichlet, torch.from_numpy(obs), route,
                              weights=torch.from_numpy(w), need_gamma=False)
    assert tg is None and ts.emit.shape == (4, LARGE_V)
    _compare_local(ts, None, js, None)
    ss, _ = batch_local_step(params, MultinomialDirichlet, torch.from_numpy(obs), "scan",
                             weights=torch.from_numpy(w))
    np.testing.assert_allclose(ts.emit.numpy(), ss.emit.numpy(), atol=2e-3)
    np.testing.assert_allclose(ts.init.numpy(), ss.init.numpy(), atol=1e-5)


# (family, route): each family's five VB iterations and one SVI step on one
# kernel route, the three routes spread over the families
VB_ROUTE = {"diag": "duplex", "poisson": "fused", "multinomial": "split"}
SVI_ROUTE = {"diag": "fused", "poisson": "split", "multinomial": "duplex"}


@pytest.mark.parametrize("name", ["diag", "poisson", "multinomial"])
def test_fit_matches_jax(highest_kernel_precision, jax_route, name):
    """Five VB iterations from the same converted init: the ELBO history to
    1e-4 relative, the final params to 1e-3, the port's ELBO non-decreasing
    (tests/test_torch_engines.py's bounds)."""
    B, T, K = 4, 32, 3
    obs = _data(name, B, T, K, seed=11)
    jprior, jp0 = _start(name, obs, K, seed=12)
    route = VB_ROUTE[name]
    jroute = jax_route(route)
    jfinal, jelbos = jbatch_vb.fit(jp0, jprior, jnp.asarray(obs), JAX[name], num_iters=5,
                                   method=jroute)
    tfinal, telbos = batch_vb.fit(convert.params_from_numpy(jp0, device="cpu"),
                                  convert.params_from_numpy(jprior, device="cpu"),
                                  torch.from_numpy(obs), PORT[name], num_iters=5, method=route)
    np.testing.assert_allclose(telbos.numpy(), np.asarray(jelbos), rtol=1e-4)
    for a, b in zip([tfinal.init, tfinal.trans, *leaves(tfinal.emit)],
                    [jfinal.init, jfinal.trans, *leaves(jfinal.emit)]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-5)
    e = telbos.double()
    assert bool(((e[1:] - e[:-1]) / e[:-1].abs() > -1e-5).all())


@pytest.mark.parametrize("name", ["diag", "poisson", "multinomial"])
def test_svi_step_matches_jax(highest_kernel_precision, jax_route, name):
    """One windowed SVI step from the same state with JAX's own subchain
    draws (tests/test_torch_svi.py:121-140), W = 16 so that JAX pads
    nothing; the multinomial's chain is (T,) int."""
    K, T = 3, 64
    cfg = svi.SVIConfig(batch_size=6, subchain_len=10, buffer=3, tau=1.0, kappa=0.6)
    chain = _data(name, 1, T, K, seed=21)[0]
    jprior, jp0 = _start(name, chain[None], K, seed=22)
    route = SVI_ROUTE[name]
    jroute = jax_route(route)
    jstate = jsvi.init_state(jp0, jax.random.PRNGKey(6))._replace(step=jnp.asarray(3, jnp.int32))
    jnew, jm = jsvi.make_step(JAX[name], cfg, T, method=jroute)(jstate, jprior, jnp.asarray(chain))
    _, k = jax.random.split(jstate.key)
    starts = np.array(jax.random.randint(k, (cfg.batch_size,), 0, T - cfg.subchain_len + 1))
    state = convert.svi_state_from_numpy(jstate, torch.Generator().manual_seed(0), device="cpu")
    step = svi.make_step(PORT[name], cfg, T, method=route)
    tnew, tm = step.with_starts(state, convert.params_from_numpy(jprior, device="cpu"),
                                torch.from_numpy(chain), torch.from_numpy(starts))
    tol = dict(rtol=2e-4, atol=1e-4)  # tests/test_torch_svi.py:97-98, kernel routes
    for a, b in zip([tnew.params.init, tnew.params.trans, *leaves(tnew.params.emit)],
                    [jnew.params.init, jnew.params.trans, *leaves(jnew.params.emit)]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)
    for key in ("rho", "noisy_elbo"):
        np.testing.assert_allclose(tm[key].numpy(), np.asarray(jm[key]), err_msg=key, **tol)
    assert int(tnew.step) == int(jnew.step) == 4


@pytest.mark.parametrize("name", ["diag", "poisson", "multinomial"])
def test_convert_round_trips_exactly(name):
    obs = _data(name, 2, 8, 3, seed=31)
    _, jp0 = _start(name, obs, 3, seed=32)
    for dtype in (torch.float32, torch.float64):
        port = convert.params_from_numpy(jp0, device="cpu", dtype=dtype)
        assert type(port.emit).__name__ == type(jp0.emit).__name__ or name == "multinomial"
        back = convert.params_to_numpy(port)
        again = convert.params_from_numpy(back, device="cpu", dtype=dtype)
        for a, b in zip([back.init, back.trans, *leaves(back.emit)],
                        [jp0.init, jp0.trans, *leaves(jp0.emit)]):
            np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))
        for a, b in zip([again.init, again.trans, *leaves(again.emit)],
                        [port.init, port.trans, *leaves(port.emit)]):
            assert a.dtype == dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0)
