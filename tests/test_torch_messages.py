"""The port's message-passing layer: scan_fb against the JAX package and the
f64 oracle, method resolution, and the fused route's refusals.

``scan_fb.forward_backward`` is the port's exact plain path: in float64 it
matches JAX's ``e_step_batched(method="scan")`` (same formulas, float64)
and the NumPy oracle (same math, per-sequence loops) to 1e-9.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pysvihmm_tpu import messages as jmessages
from pysvihmm_tpu.oracle import numpy_ref as oracle
from pysvihmm_tpu_torch import messages
from pysvihmm_tpu_torch.distributions import GaussianNIW
from pysvihmm_tpu_torch.engines.base import batch_local_step
from pysvihmm_tpu_torch.messages import fused_fb, scan_fb
from pysvihmm_tpu_torch.models.hmm import init_params, make_prior

torch.set_num_threads(1)

TOL = dict(rtol=1e-9, atol=1e-12)


def _lik_problem(B, T, K, seed):
    rng = np.random.default_rng(seed)
    log_pi = np.log(rng.dirichlet(np.ones(K)))
    log_A = np.log(rng.dirichlet(np.ones(K) * 2.0, size=K))
    log_lik = rng.normal(scale=3.0, size=(B, T, K))
    return log_pi, log_A, log_lik


@pytest.mark.parametrize("B,T,K", [(3, 20, 4), (2, 33, 6)])
def test_scan_matches_jax_and_oracle(enable_x64, B, T, K):
    log_pi, log_A, log_lik = _lik_problem(B, T, K, seed=T)
    t = scan_fb.forward_backward(*(torch.tensor(x) for x in (log_pi, log_A, log_lik)))
    j = jmessages.e_step_batched(
        jnp.asarray(log_pi), jnp.asarray(log_A), jnp.asarray(log_lik), method="scan"
    )
    for name in ("gamma", "log_z", "trans_stats", "init_stats", "log_c"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   err_msg=name, **TOL)
    xi = np.zeros((K, K))
    for b in range(B):
        alpha, beta, gamma, xi_b, log_z = oracle.forward_backward(log_pi, log_A, log_lik[b])
        np.testing.assert_allclose(t.gamma[b].numpy(), gamma, **TOL)
        np.testing.assert_allclose(t.log_z[b].item(), log_z, **TOL)
        xi += xi_b
    np.testing.assert_allclose(t.trans_stats.numpy(), xi, **TOL)
    alpha_t, _, _ = scan_fb.forward_with_logc(*(torch.tensor(x) for x in (log_pi, log_A, log_lik)))
    np.testing.assert_allclose(alpha_t[-1].numpy(), alpha, **TOL)
    beta_t = scan_fb.backward(torch.tensor(log_A), torch.tensor(log_lik))
    np.testing.assert_allclose(beta_t[-1].numpy(), beta, **TOL)


def test_scan_with_weights_matches_jax(enable_x64):
    B, T, K = 3, 24, 4
    log_pi, log_A, log_lik = _lik_problem(B, T, K, seed=5)
    w = (np.random.default_rng(6).random((B, T)) > 0.3).astype(np.float64)
    t = messages.e_step_batched(*(torch.tensor(x) for x in (log_pi, log_A, log_lik)),
                                weights=torch.tensor(w))
    j = jmessages.e_step_batched(jnp.asarray(log_pi), jnp.asarray(log_A),
                                 jnp.asarray(log_lik), weights=jnp.asarray(w), method="scan")
    for name in ("gamma", "log_z", "trans_stats", "init_stats", "log_c"):
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   err_msg=name, **TOL)


def test_resolve_method():
    assert messages.resolve_method("auto", torch.device("cpu")) == "scan"
    assert messages.resolve_method("auto", "cuda:0") == "fused"
    assert messages.resolve_method("fused", "cpu") == "fused"
    assert messages.resolve_method("split", "cuda") == "split"
    assert messages.resolve_method("duplex", "cuda") == "duplex"
    assert messages.resolve_method("scan", "cuda") == "scan"
    with pytest.raises(ValueError):
        messages.resolve_method("pallas_fused", "cpu")
    with pytest.raises(ValueError):
        messages.resolve_method("auto", "meta")


def test_plan_window_never_pads():
    """W = L + 2b on every route: JAX pads 70 to 72 for Mosaic's time tiles
    (tests/test_svi.py:25-34), the CUDA kernels need no padding."""
    for method in ("auto", "fused", "split", "duplex", "scan"):
        assert messages.plan_window(method, 50, 10, 10_000) == (method, 70, 10)
    assert messages.plan_window("split", 10, 3, 16) == ("split", 16, 3)
    with pytest.raises(ValueError, match="longer than chain"):
        messages.plan_window("auto", 50, 10, 69)
    with pytest.raises(ValueError, match="unknown"):
        messages.plan_window("pallas", 50, 10, 10_000)


def _gauss(B, T, K, D, seed):
    g = torch.Generator().manual_seed(seed)
    obs = torch.randn((B, T, D), generator=g) * 2.0
    prior = make_prior(K, GaussianNIW, obs_dim=D, device="cpu")
    return init_params(g, prior, GaussianNIW, obs), obs


def test_fused_route_refuses_what_it_does_not_port():
    """An emission family the package does not have raises JAX's ValueError
    on every kernel route; gating and the E-step over materialised
    likelihoods run ("fused" and "duplex" become "split" there)."""
    params, obs = _gauss(2, 16, 3, 2, seed=0)

    class Multinomial:
        name = "multinomial_dirichlet"

    for method in ("fused", "split", "duplex"):
        with pytest.raises(ValueError, match="unknown emission family"):
            batch_local_step(params, Multinomial, obs, method)
        stats, _ = batch_local_step(params, GaussianNIW, obs, method, weights=torch.ones(2, 16))
        assert bool(torch.isfinite(stats.log_z))
    lp, lA = torch.zeros(3), torch.zeros(3, 3)
    for method in ("fused", "duplex"):
        fb = messages.e_step_batched(lp, lA, torch.zeros(1, 4, 3), method=method)
        assert fb.gamma.shape == (1, 4, 3)


@pytest.mark.parametrize("need_gamma", [True, False])
def test_fused_twins_match_scan_in_the_port(need_gamma):
    """Within the port, on CPU: the fused route (the kernels' plain twins,
    float32) against the scan route (float64) on the same params. Tolerances
    of tests/test_pallas.py:246-251 (float32 against float64 here)."""
    params, obs = _gauss(4, 30, 5, 3, seed=1)
    p64 = params._replace(
        init=params.init.double(), trans=params.trans.double(),
        emit=type(params.emit)(*(x.double() for x in params.emit)),
    )
    sf, gf = batch_local_step(params, GaussianNIW, obs, "fused", need_gamma=need_gamma)
    ss, gs = batch_local_step(p64, GaussianNIW, obs.double(), "scan")
    if need_gamma:
        np.testing.assert_allclose(gf.numpy(), gs.numpy(), atol=5e-5)
    else:
        assert gf is None
    np.testing.assert_allclose(sf.init.numpy(), ss.init.numpy(), atol=5e-5)
    np.testing.assert_allclose(sf.trans.numpy(), ss.trans.numpy(), atol=1e-3)
    np.testing.assert_allclose(sf.log_z.item(), ss.log_z.item(), rtol=2e-6)
    for a, b in zip(sf.emit, ss.emit):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=3e-3, atol=2e-3)


def test_fused_reference_gamma_is_the_kernel_layout():
    """estep_fused gives gamma time-major (T, B, K), init_stats = gamma[0]."""
    params, obs = _gauss(3, 12, 4, 2, seed=2)
    from pysvihmm_tpu_torch.engines.base import _fused_W, prepare_fused_obs
    from pysvihmm_tpu_torch.models.hmm import expected_log_params

    feats = prepare_fused_obs(params, GaussianNIW, obs)
    assert feats.shape == (12, 3, 1 + 2 + 3) and feats.is_contiguous()
    log_pi, log_A = expected_log_params(params)
    fb, S = fused_fb.estep_fused(log_pi, log_A, _fused_W(GaussianNIW, params.emit), feats,
                                 emit_gamma=True)
    assert fb.gamma.shape == (12, 3, 4) and S.shape == (4, 6)
    torch.testing.assert_close(fb.init_stats, fb.gamma[0], rtol=0, atol=0)
    torch.testing.assert_close(fb.log_z, fb.log_c.sum(-1))
