"""The port's split E-step (messages/split_fb.py) against the JAX package.

``estep_split_reference`` (the plain PyTorch twin of the two split CUDA
kernels, float32) against
``pysvihmm_tpu.messages.pallas_fb.pallas_forward_backward_batched`` run in
Pallas interpret mode at its signature-default HIGHEST precision, on the
same NumPy log-likelihoods, with and without an SVI kept-mask. Both compute
the same float32 recursion in another summation order, so the tolerances are
those the JAX package holds its split kernels to against its scan path
(tests/test_pallas.py:39-78). Each twin is also held to the port's own scan
path in float64.

The CUDA kernels themselves are checked against the same twins on the card
by tests/test_torch_cuda.py and chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pysvihmm_tpu.messages.pallas_fb import pallas_forward_backward_batched
from pysvihmm_tpu_torch import messages
from pysvihmm_tpu_torch.messages import split_fb

torch.set_num_threads(1)

# tests/test_pallas.py:45-54 (gamma, log_z, trans_stats, init_stats, log_c)
TOL = {"gamma": dict(atol=2e-6), "log_z": dict(rtol=2e-6), "trans_stats": dict(atol=2e-5),
       "init_stats": dict(atol=2e-6), "log_c": dict(atol=2e-5)}


def _problem(B, T, K, seed, gated):
    """float32 (log_pi (K,), log_A (K, K), ll (B, T, K), w (B, T) or None):
    raw log-likelihoods at scale 2, as tests/test_pallas.py::problem makes
    them; the mask keeps at least one and drops at least one chain start."""
    rng = np.random.default_rng(seed)
    log_pi = np.log(rng.dirichlet(np.ones(K))).astype(np.float32)
    log_A = np.log(rng.dirichlet(np.ones(K), size=K)).astype(np.float32)
    ll = (rng.normal(size=(B, T, K)) * 2).astype(np.float32)
    w = None
    if gated:
        w = (rng.random((B, T)) > 0.3).astype(np.float32)
        w[0, 0], w[1, 0] = 0.0, 1.0
    return log_pi, log_A, ll, w


def _time_major(x):
    return torch.from_numpy(np.ascontiguousarray(np.swapaxes(x, 0, 1)))


def _port(log_pi, log_A, ll, w, fn=split_fb.estep_split_reference):
    """The port's split E-step on (B, T)-major NumPy inputs; gamma back to (B, T, K)."""
    fb = fn(torch.from_numpy(log_pi), torch.from_numpy(log_A), _time_major(ll),
            None if w is None else _time_major(w))
    return fb._replace(gamma=fb.gamma.transpose(0, 1))


@pytest.mark.parametrize("B,T,K,gated", [
    (4, 64, 8, False), (3, 50, 5, False), (8, 33, 16, False),
    (4, 64, 8, True), (3, 40, 5, True),
])
def test_reference_matches_jax_pallas(B, T, K, gated):
    log_pi, log_A, ll, w = _problem(B, T, K, seed=B * T + K, gated=gated)
    j = pallas_forward_backward_batched(
        jnp.asarray(log_pi), jnp.asarray(log_A), jnp.asarray(ll),
        weights=None if w is None else jnp.asarray(w), interpret=True,
    )
    t = _port(log_pi, log_A, ll, w)
    for name, tol in TOL.items():
        np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("gated", [False, True])
def test_twins_match_the_port_scan(gated):
    """Within the port: the float32 twins against scan_fb in float64."""
    log_pi, log_A, ll, w = _problem(5, 48, 6, seed=9, gated=gated)
    t = _port(log_pi, log_A, ll, w)
    s = messages.e_step_batched(
        *(torch.from_numpy(x).double() for x in (log_pi, log_A, ll)),
        weights=None if w is None else torch.from_numpy(w).double(), method="scan",
    )
    for name, tol in TOL.items():
        np.testing.assert_allclose(getattr(t, name).numpy(), getattr(s, name).numpy(),
                                   err_msg=name, **tol)


def test_e_step_batched_runs_the_split_route():
    """e_step_batched on "split" (and on "fused", which becomes "split" over
    materialised likelihoods) is the split E-step in the (B, T, K) contract."""
    log_pi, log_A, ll, w = _problem(3, 20, 4, seed=2, gated=True)
    ref = _port(log_pi, log_A, ll, w)
    for method in ("split", "fused"):
        got = messages.e_step_batched(*(torch.from_numpy(x) for x in (log_pi, log_A, ll)),
                                      weights=torch.from_numpy(w), method=method)
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_cpu_launchers_run_the_plain_twins():
    """On CPU tensors the launchers are the twins (bit-identical) and no
    kernel launch is counted."""
    log_pi, log_A, ll, w = _problem(3, 16, 4, seed=7, gated=True)
    split_fb.reset_launch_counts()
    for ww in (None, w):
        a = _port(log_pi, log_A, ll, ww, fn=split_fb.estep_split)
        b = _port(log_pi, log_A, ll, ww)
        for x, y in zip(a, b):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert split_fb.split_forward.launches == 0
    assert split_fb.split_backward.launches == 0


def test_gates_touch_the_statistics_only():
    """Buffer steps still drive the chain: gated and ungated runs share gamma
    and log_c bit for bit; only init_stats and trans_stats differ."""
    log_pi, log_A, ll, w = _problem(4, 24, 5, seed=3, gated=True)
    gated, plain = _port(log_pi, log_A, ll, w), _port(log_pi, log_A, ll, None)
    torch.testing.assert_close(gated.gamma, plain.gamma, rtol=0, atol=0)
    torch.testing.assert_close(gated.log_c, plain.log_c, rtol=0, atol=0)
    assert not torch.equal(gated.trans_stats, plain.trans_stats)
    torch.testing.assert_close(gated.init_stats, plain.init_stats * torch.from_numpy(w[:, :1]))


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "device_mix", "gate_shape"])
def test_launchers_reject_what_the_kernels_do_not_take(bad):
    log_pi, log_A, ll, _ = _problem(3, 16, 4, seed=7, gated=False)
    pi_t, A_t = (torch.exp(torch.from_numpy(x)) for x in (log_pi, log_A))
    ll = _time_major(ll)
    alpha, s, sh = split_fb.split_forward(pi_t, A_t, ll)
    g = torch.ones(16, 3)
    if bad == "dtype":
        ll = ll.double()
    elif bad == "contiguity":
        ll = ll.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "shape":
        A_t = A_t[:, :-1]
    elif bad == "device_mix":
        ll = ll.to("meta")
    else:
        g = g[:-1]
    with pytest.raises(ValueError):
        split_fb.split_backward(A_t, ll, alpha, s, sh, g)
