"""The slice as a whole: the port's batch_local_step and batch-VB fit against
the JAX package's fused-kernel route, on CPU.

JAX runs ``method="pallas_fused"`` (its kernels in Pallas interpret mode off
the TPU) with the kernel precision knobs at "highest", so both sides are
exact float32; the port runs ``method="fused"``, whose launchers take their
plain twins on CPU tensors. Both start from the same JAX ``init_params``,
carried across by ``convert.py``. Observations are made with NumPy.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysvihmm_tpu.distributions.emissions import GaussianNIW as JGaussianNIW
from pysvihmm_tpu.engines import batch_vb as jbatch_vb
from pysvihmm_tpu.engines.base import batch_local_step as jbatch_local_step
from pysvihmm_tpu.models import hmm as jhmm
from pysvihmm_tpu_torch import convert
from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
from pysvihmm_tpu_torch.distributions import GaussianNIW
from pysvihmm_tpu_torch.engines import batch_vb
from pysvihmm_tpu_torch.engines.base import batch_local_step, decode, lower_bound
from pysvihmm_tpu_torch.eval.metrics import hamming_error
from pysvihmm_tpu_torch.models.hmm import init_params, make_prior

torch.set_num_threads(1)


@pytest.fixture
def highest_kernel_precision(monkeypatch):
    for knob in ("PYSVIHMM_KERNEL_PREC", "PYSVIHMM_LL_PREC", "PYSVIHMM_STATS_PREC"):
        monkeypatch.setenv(knob, "highest")


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
    """(numpy obs, JAX prior, JAX init params) for the shape."""
    obs = _obs(B, T, K, D, seed)
    jprior = jhmm.make_prior(K, JGaussianNIW, obs_dim=D)
    jp0 = jhmm.init_params(jax.random.PRNGKey(seed), jprior, JGaussianNIW, jnp.asarray(obs))
    return obs, jprior, jp0


def _leaves(p):
    return [p.init, p.trans, *p.emit]


def test_local_step_matches_jax_fused(highest_kernel_precision):
    """Port fused route vs JAX pallas_fused, gamma included. Tolerances of
    tests/test_pallas.py:246-251: float32 both sides, another summation
    order."""
    B, T, K, D = 6, 40, 8, 3
    obs, _, jp0 = _start(B, T, K, D, seed=3)
    js, jg = jbatch_local_step(jp0, JGaussianNIW, jnp.asarray(obs), "pallas_fused")
    ts, tg = batch_local_step(convert.params_from_numpy(jp0, device="cpu"), GaussianNIW,
                              torch.from_numpy(obs), "fused")
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=5e-5)
    np.testing.assert_allclose(ts.init.numpy(), np.asarray(js.init), atol=5e-5)
    np.testing.assert_allclose(ts.trans.numpy(), np.asarray(js.trans), atol=1e-3)
    np.testing.assert_allclose(ts.log_z.item(), float(js.log_z), rtol=2e-6)
    for a, b in zip(ts.emit, js.emit):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-3, atol=2e-3)


def test_fit_matches_jax_fused(highest_kernel_precision):
    """Five VB iterations from the same converted init: the ELBO history to
    1e-4 relative, the final params to 1e-3 (float32 both sides; the
    differences of one E-step compound through the conjugate updates), and
    the port's ELBO non-decreasing."""
    B, T, K, D = 4, 32, 4, 2
    obs, jprior, jp0 = _start(B, T, K, D, seed=0)
    jfinal, jelbos = jbatch_vb.fit(jp0, jprior, jnp.asarray(obs), JGaussianNIW,
                                   num_iters=5, method="pallas_fused")
    tfinal, telbos = batch_vb.fit(convert.params_from_numpy(jp0, device="cpu"),
                                  convert.params_from_numpy(jprior, device="cpu"),
                                  torch.from_numpy(obs), GaussianNIW, num_iters=5,
                                  method="fused")
    np.testing.assert_allclose(telbos.numpy(), np.asarray(jelbos), rtol=1e-4)
    for a, b in zip(_leaves(tfinal), _leaves(jfinal)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1e-5)
    e = telbos.double()
    assert bool(((e[1:] - e[:-1]) / e[:-1].abs() > -1e-5).all())


def test_convert_round_trips_exactly():
    _, jprior, jp0 = _start(2, 8, 3, 2, seed=1)
    for dtype in (torch.float32, torch.float64):
        port = convert.params_from_numpy(jp0, device="cpu", dtype=dtype)
        back = convert.params_to_numpy(port)
        again = convert.params_from_numpy(back, device="cpu", dtype=dtype)
        for a, b in zip(_leaves(back), _leaves(jp0)):
            np.testing.assert_array_equal(a, np.asarray(b).astype(a.dtype))
        for a, b in zip(_leaves(again), _leaves(port)):
            assert a.dtype == dtype
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("method", ["fused", "scan"])
def test_canonical_small_fit_recovers_states(method):
    """The verify drive (K=4, D=2, 20 x 200, mean_scale=6, cov_scale=0.3, 50
    iterations): ELBO non-decreasing, decode at Hamming error <= 0.05, and
    lower_bound equal to the step's ELBO at the same params."""
    g = torch.Generator().manual_seed(0)
    obs, z, _ = gen_gaussian_dataset(g, 4, 2, 20, 200, mean_scale=6.0, cov_scale=0.3)
    prior = make_prior(4, GaussianNIW, obs_dim=2, device="cpu")
    p0 = init_params(torch.Generator().manual_seed(0), prior, GaussianNIW, obs)
    params, elbos = batch_vb.fit(p0, prior, obs, GaussianNIW, num_iters=50, method=method)
    e = elbos.double()
    assert bool(((e[1:] - e[:-1]) / e[:-1].abs() > -1e-5).all())
    assert hamming_error(decode(params, GaussianNIW, obs, method), z, 4) <= 0.05
    _, elbo_here = batch_vb.make_step(GaussianNIW, method)(params, prior, obs)
    torch.testing.assert_close(lower_bound(params, prior, GaussianNIW, obs, method), elbo_here)
