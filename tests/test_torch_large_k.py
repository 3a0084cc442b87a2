"""The port's kernel routes at K = 128 and 256 against the JAX package.

The CUDA kernels take K up to 256 (the large-K instances above 64); here, on
the CPU, the launchers run their plain PyTorch twins, and those are held to
JAX at JAX's own large-K shapes: ``pallas_fused`` at (B, T, K, D) =
(2, 16, 128, 2) and (2, 16, 256, 2) and ``pallas`` at (2, 16, 256, 2)
(tests/test_pallas.py:325-362), and the duplex route
(``PYSVIHMM_DUPLEX=1``) at K=128, D=3, T=70, B=16 (tests/test_duplex.py:54).
JAX runs its Pallas kernels in interpret mode with every precision knob at
"highest". The inputs come from one NumPy seed per test.

Tolerances: tests/test_pallas.py:246-251's (gamma and init 5e-5, trans atol
1e-3, log_z rtol 2e-6, emit rtol 3e-3 atol 2e-3), tighter than the large-K
JAX tests' own (trans atol 2e-3, log_z rtol 3e-6, emit 4e-3): float32 on
both sides, another summation order. trans is also held to 1e-4 of its
largest entry, since most of its K^2 entries lie below 1e-3.

The fused E-step's launchers at (2, 16, 128, 2), gated and not, are
tests/test_torch_fused.py's cases. The kernels themselves are checked against the same twins on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysvihmm_tpu.distributions.emissions import GaussianNIW as JGaussianNIW
from pysvihmm_tpu.engines.base import batch_local_step as jbatch_local_step
from pysvihmm_tpu.models import hmm as jhmm
from pysvihmm_tpu_torch import convert
from pysvihmm_tpu_torch.distributions import GaussianNIW
from pysvihmm_tpu_torch.engines.base import batch_local_step
from pysvihmm_tpu_torch.messages import duplex_fb, fused_fb, split_fb

torch.set_num_threads(1)

PRECISION_KNOBS = ("PYSVIHMM_KERNEL_PREC", "PYSVIHMM_LL_PREC", "PYSVIHMM_STATS_PREC")


@pytest.fixture(scope="module")
def jax_highest():
    """JAX's kernels at exact float32 and its duplex knob off for the whole
    module (JAX reads the knobs while tracing, so its caches are cleared on
    the way in and out)."""
    with pytest.MonkeyPatch.context() as mp:
        for knob in PRECISION_KNOBS:
            mp.setenv(knob, "highest")
        mp.delenv("PYSVIHMM_DUPLEX", raising=False)
        jax.clear_caches()
        yield
    jax.clear_caches()


@pytest.fixture
def jax_route(jax_highest, monkeypatch):
    """Sets JAX's duplex knob for one test when asked (``jax_route(True)``),
    clearing the caches around it."""
    def use(duplex: bool):
        if duplex:
            monkeypatch.setenv("PYSVIHMM_DUPLEX", "1")
            jax.clear_caches()
    yield use
    if "PYSVIHMM_DUPLEX" in __import__("os").environ:
        monkeypatch.delenv("PYSVIHMM_DUPLEX")
        jax.clear_caches()


def _obs(B, T, K, D, seed):
    """Gaussian HMM observations (B, T, D) float32 from a NumPy seed."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=4.0, size=(K, D))
    z = np.empty((B, T), np.int64)
    z[:, 0] = rng.integers(0, K, size=B)
    for t in range(1, T):
        stay = rng.random(B) < 0.8
        z[:, t] = np.where(stay, z[:, t - 1], rng.integers(0, K, size=B))
    return (centres[z] + 0.8 * rng.normal(size=(B, T, D))).astype(np.float32)


def _mask(B, T, seed):
    """(B, T) float32 kept-mask."""
    return (np.random.default_rng(seed).random((B, T)) > 0.3).astype(np.float32)


def _assert_trans(got, ref):
    """trans_stats within 1e-3 absolute and within 1e-4 of its largest entry
    (at K = 256 its mean entry is about 5e-4, so an absolute bound alone
    would pass almost anything)."""
    np.testing.assert_allclose(got, ref, atol=min(1e-3, 1e-4 * np.abs(ref).max()))


# (port route, JAX method, duplex knob, (B, T, K, D), gated): each JAX
# large-K shape once, half of them under a kept-mask
LOCAL_CASES = [
    ("fused", "pallas_fused", False, (2, 16, 128, 2), False),
    ("fused", "pallas_fused", False, (2, 16, 256, 2), True),
    ("split", "pallas", False, (2, 16, 256, 2), True),
    ("duplex", "pallas_fused", True, (16, 70, 128, 3), True),
]


@pytest.mark.parametrize("route,jmethod,duplex,shape,gated", LOCAL_CASES)
def test_local_step_matches_jax_at_large_k(jax_route, route, jmethod, duplex, shape, gated):
    """batch_local_step on the port's kernel routes against JAX's, from the
    same NumPy observations and JAX's own init_params."""
    jax_route(duplex)
    B, T, K, D = shape
    obs = _obs(B, T, K, D, seed=K + D)
    jprior = jhmm.make_prior(K, JGaussianNIW, obs_dim=D)
    jp = jhmm.init_params(jax.random.PRNGKey(K), jprior, JGaussianNIW, jnp.asarray(obs))
    w = _mask(B, T, seed=7) if gated else None
    js, jg = jbatch_local_step(jp, JGaussianNIW, jnp.asarray(obs), jmethod,
                               weights=None if w is None else jnp.asarray(w))
    launches = (fused_fb.fused_backward.launches, split_fb.split_backward.launches,
                duplex_fb.duplex_combine.launches)
    ts, tg = batch_local_step(convert.params_from_numpy(jp, device="cpu"), GaussianNIW,
                              torch.from_numpy(obs), route,
                              weights=None if w is None else torch.from_numpy(w))
    # the CPU runs the twins: no kernel launch is counted
    assert (fused_fb.fused_backward.launches, split_fb.split_backward.launches,
            duplex_fb.duplex_combine.launches) == launches
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=5e-5)
    np.testing.assert_allclose(ts.init.numpy(), np.asarray(js.init), atol=5e-5)
    _assert_trans(ts.trans.numpy(), np.asarray(js.trans))
    np.testing.assert_allclose(ts.log_z.item(), float(js.log_z), rtol=2e-6)
    for a, b in zip(ts.emit, js.emit):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-3, atol=2e-3)
