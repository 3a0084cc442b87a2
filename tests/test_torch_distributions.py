"""The port's distributions and model helpers against the JAX package, in f64.

Same formulas on both sides in float64 (JAX under the ``enable_x64``
fixture), so agreement is to 1e-10 relative; values that may sit near zero
get a 1e-12 absolute floor. The NIW expected log-likelihood is also held
against the NumPy oracle (pysvihmm_tpu/oracle/numpy_ref.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pysvihmm_tpu.distributions import dirichlet as jdir
from pysvihmm_tpu.distributions import niw as jniw
from pysvihmm_tpu.distributions.emissions import GaussianNIW as JGaussianNIW
from pysvihmm_tpu.models import hmm as jhmm
from pysvihmm_tpu.oracle import numpy_ref as oracle
from pysvihmm_tpu_torch import convert
from pysvihmm_tpu_torch.distributions import GaussianNIW, dirichlet, niw
from pysvihmm_tpu_torch.engines import svi
from pysvihmm_tpu_torch.models import hmm
from pysvihmm_tpu_torch.utils import schedules

torch.set_num_threads(1)

RTOL, ATOL = 1e-10, 1e-12


def close(port, ref):
    np.testing.assert_allclose(np.asarray(port), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _niw(K, D, seed):
    """Random valid NIW params (K states) as NumPy f64."""
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(K, D, D)) * 0.3
    psi = L @ np.swapaxes(L, 1, 2) + np.eye(D) * rng.uniform(0.5, 3.0, size=(K, 1, 1))
    return dict(
        mean=rng.normal(scale=2.0, size=(K, D)),
        kappa=rng.uniform(0.5, 30.0, size=K),
        nu=D + 1.0 + rng.uniform(0.5, 40.0, size=K),
        psi=psi,
    )


def _both(p):
    return (
        niw.NIW(**{k: torch.tensor(v) for k, v in p.items()}),
        jniw.NIW(**{k: jnp.asarray(v) for k, v in p.items()}),
    )


SHAPES = [(3, 2), (5, 4), (4, 8)]


@pytest.mark.parametrize("K", [3, 7])
def test_dirichlet(enable_x64, K):
    rng = np.random.default_rng(K)
    q = rng.uniform(0.2, 30.0, size=(K, K))
    p = rng.uniform(0.5, 2.0, size=(K, K))
    s = rng.uniform(0.0, 50.0, size=(K, K))
    tq, tp, ts = (torch.tensor(x) for x in (q, p, s))
    close(dirichlet.expected_log_probs(tq), jdir.expected_log_probs(jnp.asarray(q)))
    close(dirichlet.log_normalizer(tq), jdir.log_normalizer(jnp.asarray(q)))
    close(dirichlet.kl(tq, tp), jdir.kl(jnp.asarray(q), jnp.asarray(p)))
    close(dirichlet.kl(tq, tp), oracle.dir_kl(q, p))
    close(dirichlet.posterior(tp, ts), jdir.posterior(jnp.asarray(p), jnp.asarray(s)))


@pytest.mark.parametrize("K,D", SHAPES)
def test_niw_likelihood_features(enable_x64, K, D):
    p = _niw(K, D, seed=K * 10 + D)
    tq, jq = _both(p)
    y = np.random.default_rng(D).normal(scale=2.0, size=(2, 7, D))
    ty, jy = torch.tensor(y), jnp.asarray(y)

    close(niw._mvdigamma_half(tq.nu, D), jniw._mvdigamma_half(jq.nu, D))
    close(niw._mv_gammaln(tq.nu, D), jniw._mv_gammaln(jq.nu, D))
    tp, jp = niw.ell_params(tq), jniw.ell_params(jq)
    for a, b in zip(tp, jp):
        close(a, b)
    feats = niw.ell_features(ty)
    assert feats.shape[-1] == 1 + D + D * (D + 1) // 2
    close(feats, jniw.ell_features(jy))
    W = niw.ell_feature_matrix(tq)
    close(W, jniw.ell_feature_matrix(jq))
    ell = niw.expected_log_likelihood(tq, ty)
    close(ell, jniw.expected_log_likelihood(jq, jy))
    close(feats @ W, ell)
    for b in range(y.shape[0]):
        close(ell[b], oracle.niw_expected_log_likelihood(p["mean"], p["kappa"],
                                                         p["nu"], p["psi"], y[b]))


@pytest.mark.parametrize("K,D", SHAPES)
def test_niw_stats_posterior_kl(enable_x64, K, D):
    rng = np.random.default_rng(K + D)
    q, pr = _niw(K, D, seed=1), _niw(K, D, seed=2)
    tq, jq = _both(q)
    tp, jp = _both(pr)
    y = rng.normal(scale=2.0, size=(50, D))
    g = rng.dirichlet(np.ones(K), size=50)
    ts = niw.suff_stats(torch.tensor(g), torch.tensor(y))
    js = jniw.suff_stats(jnp.asarray(g), jnp.asarray(y))
    for a, b in zip(ts, js):
        close(a, b)
    for a, b in zip(niw.posterior(tp, ts), jniw.posterior(jp, js)):
        close(a, b)
    close(niw.kl(tq, tp), jniw.kl(jq, jp))
    close(niw.kl(tq, tp).sum(), oracle.niw_kl(*q.values(), *pr.values()))
    close(GaussianNIW.kl(tq, tp), JGaussianNIW.kl(jq, jp))
    for a, b in zip(niw.make_prior(K, D, kappa=0.5, psi_scale=2.0, dtype=torch.float64,
                                   device="cpu"),
                    jniw.make_prior(K, D, kappa=0.5, psi_scale=2.0, dtype=jnp.float64)):
        close(a, b)


@pytest.mark.parametrize("K,D", SHAPES)
def test_unpack_flat_stats_inverts_the_feature_sums(enable_x64, K, D):
    """The (K, F) accumulator gamma^T @ ell_features(y) unpacks to the same
    GaussianStats as the JAX family and as suff_stats itself."""
    rng = np.random.default_rng(3)
    p = _niw(K, D, seed=4)
    tq, jq = _both(p)
    y = rng.normal(size=(40, D))
    g = rng.dirichlet(np.ones(K), size=40)
    S = torch.tensor(g).T @ niw.ell_features(torch.tensor(y))
    ts = GaussianNIW.unpack_flat_stats(tq, S)
    js = JGaussianNIW.unpack_flat_stats(jq, jnp.asarray(S.numpy()))
    ref = niw.suff_stats(torch.tensor(g), torch.tensor(y))
    for a, b, c in zip(ts, js, ref):
        close(a, b)
        close(a, c)


def test_hmm_params_helpers(enable_x64):
    K, D = 5, 3
    rng = np.random.default_rng(11)
    q, pr = _niw(K, D, seed=5), _niw(K, D, seed=6)
    init, trans = rng.uniform(1, 9, size=K), rng.uniform(1, 9, size=(K, K))
    pinit, ptrans = np.ones(K), np.ones((K, K))
    tq, jq = _both(q)
    tp, jp = _both(pr)
    tparams = hmm.HMMParams(torch.tensor(init), torch.tensor(trans), tq)
    jparams = jhmm.HMMParams(jnp.asarray(init), jnp.asarray(trans), jq)
    tprior = hmm.HMMParams(torch.tensor(pinit), torch.tensor(ptrans), tp)
    jprior = jhmm.HMMParams(jnp.asarray(pinit), jnp.asarray(ptrans), jp)
    for a, b in zip(hmm.expected_log_params(tparams), jhmm.expected_log_params(jparams)):
        close(a, b)
    close(hmm.global_kl(tparams, tprior, GaussianNIW),
          jhmm.global_kl(jparams, jprior, JGaussianNIW))
    g = rng.dirichlet(np.ones(K), size=(2, 9))
    y = rng.normal(size=(2, 9, D))
    ts = hmm.emission_flat_stats(GaussianNIW, tq, torch.tensor(g), torch.tensor(y))
    js = jhmm.emission_flat_stats(JGaussianNIW, jq, jnp.asarray(g), jnp.asarray(y))
    for a, b in zip(ts, js):
        close(a, b)
    tpr = hmm.make_prior(K, GaussianNIW, obs_dim=D, alpha_tran=2.0, dtype=torch.float64,
                         device="cpu")
    jpr = jhmm.make_prior(K, JGaussianNIW, obs_dim=D, alpha_tran=2.0)
    for a, b in zip((tpr.init, tpr.trans, *tpr.emit), (jpr.init, jpr.trans, *jpr.emit)):
        close(a, b)


def test_other_families_raise():
    """A family the package does not have raises JAX's ValueError."""

    class Multinomial:
        name = "multinomial_dirichlet"

    with pytest.raises(ValueError, match="unknown emission family"):
        hmm.make_prior(3, Multinomial, obs_dim=2, device="cpu")


@pytest.mark.parametrize("K,D", SHAPES)
def test_natural_gradient_steps(enable_x64, K, D):
    """to_natural / from_natural / nat_grad_step of the NIW and the Dirichlet
    against JAX in f64, and the identity that rho=1 with scale 1 and
    full-data stats is the exact conjugate posterior (niw.py:280-286)."""
    rng = np.random.default_rng(30 + K + D)
    tq, jq = _both(_niw(K, D, seed=7))
    tp, jp = _both(_niw(K, D, seed=8))
    y = rng.normal(scale=2.0, size=(60, D))
    g = rng.dirichlet(np.ones(K), size=60)
    ts = niw.suff_stats(torch.tensor(g), torch.tensor(y))
    js = jniw.suff_stats(jnp.asarray(g), jnp.asarray(y))
    for a, b in zip(niw.to_natural(tq), jniw.to_natural(jq)):
        close(a, b)
    for a, b, c in zip(niw.from_natural(niw.to_natural(tq)),
                       jniw.from_natural(jniw.to_natural(jq)), tq):
        close(a, b)
        close(a, c)
    for scale, rho in ((3.5, 0.3), (1.0, 1.0)):
        for a, b in zip(GaussianNIW.nat_grad_step(tq, tp, ts, scale, rho),
                        JGaussianNIW.nat_grad_step(jq, jp, js, scale, rho)):
            close(a, b)
    for a, b in zip(niw.nat_grad_step(tq, tp, ts, 1.0, 1.0), niw.posterior(tp, ts)):
        close(a, b)

    q, p, s = (rng.uniform(lo, hi, size=(K, K)) for lo, hi in ((0.2, 30), (0.5, 2), (0, 50)))
    tq_, tp_, ts_ = (torch.tensor(x) for x in (q, p, s))
    jq_, jp_, js_ = (jnp.asarray(x) for x in (q, p, s))
    close(dirichlet.nat_grad_step(tq_, tp_, ts_, 2.5, 0.4),
          jdir.nat_grad_step(jq_, jp_, js_, 2.5, 0.4))
    close(dirichlet.nat_grad_step(tq_, tp_, ts_, 1.0, 1.0), dirichlet.posterior(tp_, ts_))
    close(dirichlet.mean(tq_), jdir.mean(jq_))


def test_step_size_schedules(enable_x64):
    """power_schedule and three elastic adaptive_update steps against JAX."""
    from pysvihmm_tpu.utils import schedules as jsched

    steps = np.arange(5.0)
    close(schedules.power_schedule(torch.tensor(steps), 10.0, 0.6),
          jsched.power_schedule(jnp.asarray(steps), 10.0, 0.6))
    rng = np.random.default_rng(4)
    ts = schedules.adaptive_init(6, torch.float64, device="cpu")
    js = jsched.adaptive_init(6, jnp.float64)
    for _ in range(3):
        grad = rng.normal(size=6)
        ts, trho = schedules.adaptive_update(ts, torch.tensor(grad))
        js, jrho = jsched.adaptive_update(js, jnp.asarray(grad))
        close(trho, jrho)
        for a, b in zip(ts, js):
            close(a, b)


def _numpy_svi_state(K=3, D=2):
    """A NumPy-leaved SVI state with an adaptive state, as convert.py reads it."""
    p = convert.params_to_numpy(hmm.make_prior(K, GaussianNIW, obs_dim=D, device="cpu",
                                               dtype=torch.float64))
    adapt = tuple(x.numpy() for x in schedules.adaptive_init(4, torch.float64, device="cpu"))
    return svi.SVIState(params=p, step=np.int32(2), generator=None,
                        adapt=schedules.AdaptiveState(*adapt))


def _devices(x) -> set[str]:
    """The device types of the tensors in a (nested) tuple of tensors."""
    if isinstance(x, torch.Tensor):
        return {x.device.type}
    if isinstance(x, (tuple, list)):
        return set().union(*(_devices(y) for y in x))
    return set()  # a generator, a missing adaptive state


# Each entry point that builds state; the test calls it with and without a device.
_BUILDERS = {
    "hmm.make_prior": lambda **kw: hmm.make_prior(3, GaussianNIW, obs_dim=2, **kw),
    "niw.make_prior": lambda **kw: niw.make_prior(3, 2, **kw),
    "adaptive_init": lambda **kw: schedules.adaptive_init(4, **kw),
    "params_from_numpy": lambda **kw: convert.params_from_numpy(_numpy_svi_state().params, **kw),
    "svi_state_from_numpy": lambda **kw: convert.svi_state_from_numpy(
        _numpy_svi_state(), torch.Generator(), **kw),
}


def test_default_device_is_the_card():
    from pysvihmm_tpu_torch.utils.device import resolve_device

    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


@pytest.mark.parametrize("name", sorted(_BUILDERS))
def test_state_lands_on_the_card_unless_asked(name):
    """The priors, the adaptive step-size state and the converters put their
    tensors on the card ("cuda") when no device is given; without one they
    raise instead of falling back to the CPU. Given device="cpu", they stay
    on the CPU."""
    build = _BUILDERS[name]
    if torch.cuda.is_available():
        assert _devices(build()) == {"cuda"}
    else:
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            build()
    assert _devices(build(device="cpu")) == {"cpu"}
