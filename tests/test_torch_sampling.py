"""The families' point and predictive scoring and posterior draws, the
Dirichlet draws, and the evaluation entry points (engines/base.py:
viterbi_decode, predictive_log_likelihood) against the JAX package, on CPU.

Both sides run in float64 (JAX under the ``enable_x64`` fixture) on the
same NumPy parameters and observations. The draws are fed: JAX's own
gamma, log-gamma and normal draws, made with JAX's key layout (NIW: split
into (chi2, normals, mean); NIG: (gamma, normals)), go into the port's
``params_from_draws`` and must give JAX's ``sample_params`` to 1e-8. The
port's own samplers are held to the posterior moments they draw from.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysvihmm_tpu.distributions import diag_gaussian as jdiag
from pysvihmm_tpu.distributions import emissions as jem
from pysvihmm_tpu.distributions import niw as jniw
from pysvihmm_tpu.distributions import poisson as jpoisson
from pysvihmm_tpu.engines import base as jbase
from pysvihmm_tpu.models import hmm as jhmm
from pysvihmm_tpu_torch.distributions import diag_gaussian, dirichlet, emissions, niw, poisson
from pysvihmm_tpu_torch.engines.base import predictive_log_likelihood, viterbi_decode
from pysvihmm_tpu_torch.models.hmm import (
    EMISSION_FAMILIES,
    HMMParams,
    check_family,
    resolve_emission,
)

torch.set_num_threads(1)

FED = dict(rtol=1e-8, atol=1e-10)  # fed draws, float64
F64 = dict(rtol=1e-10, atol=1e-10)  # the same formulas, float64


def close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **(tol or F64))


def _niw(K, D, seed):
    """An NIW posterior at small nu (D + 1 to D + 3) with a random SPD psi."""
    r = np.random.default_rng(seed)
    L = r.normal(size=(K, D, D))
    return dict(mean=r.normal(scale=3.0, size=(K, D)), kappa=r.uniform(0.5, 20.0, K),
                nu=D + r.uniform(1.0, 3.0, K), psi=L @ L.transpose(0, 2, 1) + 0.5 * np.eye(D))


def _nig(K, D, seed):
    r = np.random.default_rng(seed)
    return dict(mean=r.normal(scale=2.0, size=(K, D)), kappa=r.uniform(0.5, 30.0, (K, D)),
                a=r.uniform(0.3, 20.0, (K, D)), b=r.uniform(0.3, 10.0, (K, D)))


def _gamma(K, D, seed):
    r = np.random.default_rng(seed)
    return dict(a=r.uniform(0.3, 8.0, (K, D)), b=r.uniform(0.2, 4.0, (K, D)))


def _dirichlet(K, V, seed):
    return np.random.default_rng(seed).uniform(0.05, 5.0, (K, V))


# (port family, JAX family, port param type, JAX param type, param maker)
FAMILIES = {
    "gaussian": (emissions.GaussianNIW, jem.GaussianNIW, niw.NIW, jniw.NIW, _niw),
    "diag_gaussian": (emissions.DiagonalGaussianNIG, jem.DiagonalGaussianNIG,
                      diag_gaussian.NIG, jdiag.NIG, _nig),
    "poisson": (emissions.PoissonGamma, jem.PoissonGamma, poisson.GammaP, jpoisson.GammaP,
                _gamma),
    "multinomial": (emissions.MultinomialDirichlet, jem.MultinomialDirichlet, None, None,
                    _dirichlet),
}


def _params(name, K, D, seed):
    """(port params, JAX params) of one family from the same NumPy arrays."""
    _, _, tcls, jcls, make = FAMILIES[name]
    p = make(K, D, seed)
    if tcls is None:
        return torch.tensor(p), jnp.asarray(p)
    return (tcls(**{k: torch.tensor(v) for k, v in p.items()}),
            jcls(**{k: jnp.asarray(v) for k, v in p.items()}))


def _obs(name, shape, D, seed):
    """Observations of the family: (..., D) floats, counts, or (...,) ints < D."""
    r = np.random.default_rng(seed)
    if name == "multinomial":
        return r.integers(0, D, size=shape)
    if name == "poisson":
        return r.poisson(3.0, size=shape + (D,)).astype(np.float64)
    return r.normal(scale=3.0, size=shape + (D,))


def _jax_draws(name, key, q):
    """The draws JAX's ``sample_params(key, q)`` makes, as NumPy arrays."""
    if name == "gaussian":
        k_chi, k_norm, k_mu = jax.random.split(key, 3)
        D = q.mean.shape[-1]
        df = q.nu[..., None] - jnp.arange(D, dtype=q.nu.dtype)
        chi2 = 2.0 * jax.random.gamma(k_chi, df / 2.0, shape=q.kappa.shape + (D,),
                                      dtype=q.nu.dtype)
        normals = jax.random.normal(k_norm, q.psi.shape, dtype=q.mean.dtype)
        eps = jax.random.normal(k_mu, q.mean.shape, dtype=q.mean.dtype)
        return chi2, normals, eps
    if name == "diag_gaussian":
        k_gam, k_mu = jax.random.split(key)
        return (jax.random.gamma(k_gam, q.a, dtype=q.a.dtype),
                jax.random.normal(k_mu, q.mean.shape, q.mean.dtype))
    if name == "poisson":
        return (jax.random.gamma(key, q.a, dtype=q.a.dtype),)
    return (jax.random.loggamma(key, q),)


def _leaves(x):
    return list(x) if isinstance(x, tuple) else [x]


@pytest.mark.parametrize("name", list(FAMILIES))
def test_sample_params_from_jax_draws(enable_x64, name):
    fam, jfam = FAMILIES[name][:2]
    tq, jq = _params(name, 4, 3, seed=1)
    key = jax.random.PRNGKey(5)
    draws = tuple(torch.from_numpy(np.array(d)) for d in _jax_draws(name, key, jq))
    got, want = fam.params_from_draws(tq, draws), jfam.sample_params(key, jq)
    for a, b in zip(_leaves(got), _leaves(want), strict=True):
        close(a, b, **FED)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_point_and_predictive_scores_match_jax(enable_x64, name):
    fam, jfam = FAMILIES[name][:2]
    K, D = 5, 4
    tq, jq = _params(name, K, D, seed=2)
    y = _obs(name, (3, 7), D, seed=3)
    ty, jy = torch.from_numpy(y), jnp.asarray(y)
    theta, jtheta = fam.mean_params(tq), jfam.mean_params(jq)
    for a, b in zip(_leaves(theta), _leaves(jtheta), strict=True):
        close(a, b)
    close(fam.point_log_likelihood(theta, ty), jfam.point_log_likelihood(jtheta, jy))
    close(fam.predictive_log_likelihood(tq, ty), jfam.predictive_log_likelihood(jq, jy))
    assert fam.predictive_log_likelihood(tq, ty).shape == (3, 7, K)


def test_dirichlet_from_jax_log_gamma(enable_x64):
    alpha = _dirichlet(3, 6, seed=4)
    alpha[0, :2] = 1e-3  # small concentrations: log space keeps them finite
    key = jax.random.PRNGKey(9)
    log_g = torch.from_numpy(np.array(jax.random.loggamma(key, jnp.asarray(alpha))))
    close(dirichlet.from_log_gamma(log_g), jax.random.dirichlet(key, jnp.asarray(alpha)), **FED)


def test_samplers_draw_their_posterior_moments():
    """The port's own draws (on the generator) against the means they sample:
    E[Dir] = alpha / alpha_0, E[Sigma] = psi / (nu - D - 1), E[mu] = m,
    E[sigma2] = b / (a - 1), E[lambda] = a / b; 20,000 draws, float64."""
    n, g = 20_000, torch.Generator().manual_seed(0)
    alpha = torch.tensor([[0.3, 2.0, 5.0], [1e-3, 1.0, 1e-3]], dtype=torch.float64)
    lg = dirichlet.log_gamma(g, alpha.expand(n, 2, 3))
    assert bool(torch.isfinite(lg).all())
    close(dirichlet.from_log_gamma(lg).mean(0), alpha / alpha.sum(-1, keepdim=True), atol=0.01)

    q = niw.NIW(mean=torch.tensor([[1.0, -2.0]], dtype=torch.float64).expand(n, 2),
                kappa=torch.full((n,), 4.0, dtype=torch.float64),
                nu=torch.full((n,), 9.0, dtype=torch.float64),
                psi=torch.tensor([[2.0, 0.5], [0.5, 1.0]], dtype=torch.float64).expand(n, 2, 2))
    mu, sigma = niw.sample_params(g, q)
    close(sigma.mean(0), q.psi[0] / (9.0 - 2 - 1), rtol=0.03, atol=0.01)
    close(mu.mean(0), q.mean[0], atol=0.02)

    nig = diag_gaussian.NIG(*(torch.tensor(v, dtype=torch.float64).expand(n, 2)
                              for v in ([1.0, -1.0], [2.0, 3.0], [6.0, 9.0], [5.0, 2.0])))
    mu, s2 = diag_gaussian.sample_params(g, nig)
    close(s2.mean(0), nig.b[0] / (nig.a[0] - 1.0), rtol=0.03)
    close(mu.mean(0), nig.mean[0], atol=0.02)

    gp = poisson.GammaP(*(torch.tensor(v, dtype=torch.float64).expand(n, 2)
                          for v in ([0.5, 7.0], [2.0, 0.5])))
    close(poisson.sample_params(g, gp).mean(0), gp.a[0] / gp.b[0], rtol=0.03)


def test_emission_registry():
    for name, fam in EMISSION_FAMILIES.items():
        assert resolve_emission(name) is fam and fam is getattr(
            emissions, jhmm.EMISSION_FAMILIES[name].__name__)
        check_family(fam)
    assert sorted(EMISSION_FAMILIES) == sorted(jhmm.EMISSION_FAMILIES)
    with pytest.raises(ValueError, match="unknown emission family"):
        resolve_emission("gamma")


def _hmm(name, K, D, seed):
    r = np.random.default_rng(seed)
    init, trans = r.uniform(0.5, 5.0, K), r.uniform(0.5, 5.0, (K, K)) + 10.0 * np.eye(K)
    temit, jemit = _params(name, K, D, seed)
    return (HMMParams(torch.tensor(init), torch.tensor(trans), temit),
            jhmm.HMMParams(jnp.asarray(init), jnp.asarray(trans), jemit))


@pytest.mark.parametrize("name", list(FAMILIES))
def test_viterbi_decode_and_predictive_match_jax(enable_x64, name):
    fam, jfam = FAMILIES[name][:2]
    K, D, B, T = 4, 3, 3, 30
    params, jparams = _hmm(name, K, D, seed=6)
    y = _obs(name, (B, T), D, seed=7)
    ty, jy = torch.from_numpy(y), jnp.asarray(y)
    path = viterbi_decode(params, fam, ty)
    assert path.shape == (B, T) and path.dtype == torch.int64
    np.testing.assert_array_equal(path.numpy(), np.asarray(jbase.viterbi_decode(jparams, jfam, jy)))
    for exact in (False, True):
        got = predictive_log_likelihood(params, fam, ty, exact=exact)
        assert got.shape == ()
        close(got, jbase.predictive_log_likelihood(jparams, jfam, jy, exact=exact))
