"""The port's associative-scan forward-backward (messages/assoc_fb.py) against
the JAX package and the float64 oracle, on CPU.

The scan itself is the port's own (PyTorch has no ``lax.associative_scan``):
it is held to a sequential fold of non-commutative 3 x 3 matrices, forward
and reversed, and, bit for bit, to JAX's bracketing through subtraction, a combine that
is not associative (one IEEE operation rounds the same in both packages, so
only the tree can differ). The forward-backward and the
log-normaliser run on both sides in float64 (JAX under ``enable_x64``) from
the same NumPy inputs and agree to 1e-9; float32 is held to the stated
tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from pysvihmm_tpu import messages as jmessages
from pysvihmm_tpu.messages import assoc_fb as jassoc
from pysvihmm_tpu.oracle import numpy_ref as oracle
from pysvihmm_tpu_torch import messages
from pysvihmm_tpu_torch.messages import assoc_fb

torch.set_num_threads(1)


def _problem(B, T, K, seed, scale=2.0):
    rng = np.random.default_rng(seed)
    log_pi = np.log(rng.dirichlet(np.ones(K)))
    log_A = np.log(rng.dirichlet(np.ones(K), size=K))
    w = (rng.uniform(size=(B, T)) > 0.3).astype(np.float64)
    return log_pi, log_A, rng.normal(size=(B, T, K)) * scale, w


def _fold(mats, reverse):
    """The scan by a plain loop: prefix products, or with reverse the
    products e_{T-1} ... e_t composed in reversed order."""
    order = range(len(mats) - 1, -1, -1) if reverse else range(len(mats))
    out, acc = [None] * len(mats), None
    for t in order:
        acc = mats[t] if acc is None else acc @ mats[t]
        out[t] = acc
    return np.stack(out)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
def test_associative_scan_matches_sequential_fold(n, reverse):
    """Small integer matrices keep every product exact in float64, so the
    scan must equal the fold exactly: the order of the factors is right."""
    rng = np.random.default_rng(n)
    mats = rng.integers(-2, 3, size=(n, 3, 3)).astype(np.float64)
    assert not np.array_equal(mats[0] @ mats[-1], mats[-1] @ mats[0]) or n == 1
    (got,) = assoc_fb._associative_scan(lambda a, b: [a[0] @ b[0]], [torch.from_numpy(mats)],
                                        reverse=reverse)
    np.testing.assert_array_equal(got.numpy(), _fold(mats, reverse))


@pytest.mark.parametrize("reverse", [False, True])
def test_associative_scan_brackets_as_jax(enable_x64, reverse):
    def fn(a, b):  # one operation, and (a - b) - c is not a - (b - c)
        return a - b

    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 5, 8, 13, 64, 100):
        x = rng.normal(size=(n, 2, 3))
        want = np.asarray(jax.jit(lambda v: lax.associative_scan(fn, v, reverse=reverse))(
            jnp.asarray(x)))
        (got,) = assoc_fb._associative_scan(lambda a, b: [fn(a[0], b[0])],
                                            [torch.from_numpy(x)], reverse=reverse)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("B,T,K", [(1, 1, 3), (2, 2, 4), (3, 37, 5), (2, 64, 8)])
def test_forward_backward_assoc_matches_jax_and_oracle(enable_x64, B, T, K):
    lp, lA, ll, w = _problem(B, T, K, seed=T + K)
    got = messages.forward_backward_assoc(*map(torch.from_numpy, (lp, lA, ll, w)))
    want = jax.jit(jax.vmap(lambda l, ww: jassoc.forward_backward_assoc(
        jnp.asarray(lp), jnp.asarray(lA), l, ww)))(jnp.asarray(ll), jnp.asarray(w))
    for f in ("gamma", "log_z", "init_stats", "log_c"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)),
                                   rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.trans_stats.numpy(), np.asarray(want.trans_stats).sum(0),
                               rtol=1e-9, atol=1e-9)
    unweighted = messages.forward_backward_assoc(*map(torch.from_numpy, (lp, lA, ll)))
    xi = 0.0
    for b in range(B):
        _, _, gamma, xi_b, log_z = oracle.forward_backward(lp, lA, ll[b])
        np.testing.assert_allclose(unweighted.gamma[b].numpy(), gamma, atol=1e-9)
        np.testing.assert_allclose(unweighted.log_z[b].item(), log_z, rtol=1e-9)
        xi = xi + xi_b
    np.testing.assert_allclose(unweighted.trans_stats.numpy(), xi, rtol=1e-9, atol=1e-9)


def test_forward_backward_assoc_float32():
    """float32 against the port's float64 scan: the log-depth products round
    otherwise than the sequential recursion."""
    lp, lA, ll, _ = _problem(2, 2000, 8, seed=5)
    ref = messages.forward_backward(*map(torch.from_numpy, (lp, lA, ll)))
    got = messages.forward_backward_assoc(*(torch.from_numpy(x).float() for x in (lp, lA, ll)))
    np.testing.assert_allclose(got.log_z.numpy(), ref.log_z.numpy(), rtol=3e-6)
    np.testing.assert_allclose(got.gamma.numpy(), ref.gamma.numpy(), atol=3e-4)
    np.testing.assert_allclose(got.trans_stats.numpy(), ref.trans_stats.numpy(),
                               rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("B,T,K", [(1, 1, 3), (3, 40, 5), (2, 17, 8)])
def test_log_normalizer_assoc_matches_jax(enable_x64, B, T, K):
    lp, lA, ll, _ = _problem(B, T, K, seed=2 * T)
    got = messages.log_normalizer_assoc(*map(torch.from_numpy, (lp, lA, ll)))
    want = jax.jit(jax.vmap(lambda l: jassoc.log_normalizer_assoc(
        jnp.asarray(lp), jnp.asarray(lA), l)))(jnp.asarray(ll))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9)
    np.testing.assert_allclose(got.numpy(), messages.log_normalizer(
        *map(torch.from_numpy, (lp, lA, ll))).numpy(), rtol=1e-9)


@pytest.mark.parametrize("B,T,K", [(1, 1, 3), (3, 25, 5), (2, 16, 4)])
def test_e_step_grad_assoc_matches_jax(enable_x64, B, T, K):
    """Autograd through the port's associative scan gives JAX's gradients of
    its log-normaliser, and the scan E-step's statistics."""
    lp, lA, ll, _ = _problem(B, T, K, seed=3 * T + K)
    got = messages.e_step_grad(*map(torch.from_numpy, (lp, lA, ll)), method="assoc")
    want = jax.jit(jax.vmap(lambda l: jmessages.e_step_grad(
        jnp.asarray(lp), jnp.asarray(lA), l, method="assoc")))(jnp.asarray(ll))
    np.testing.assert_allclose(got.gamma.numpy(), np.asarray(want.gamma), atol=1e-9)
    np.testing.assert_allclose(got.init_stats.numpy(), np.asarray(want.init_stats), atol=1e-9)
    np.testing.assert_allclose(got.trans_stats.numpy(), np.asarray(want.trans_stats).sum(0),
                               rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.log_z.numpy(), np.asarray(want.log_z), rtol=1e-9)
    assert got.log_c is None and want.log_c is None
    ref = messages.e_step(*map(torch.from_numpy, (lp, lA, ll)), method="scan")
    for a, b in ((got.gamma, ref.gamma), (got.init_stats, ref.init_stats),
                 (got.trans_stats, ref.trans_stats)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-9, atol=1e-9)
    with pytest.raises(ValueError, match="scan.*assoc"):
        messages.e_step_grad(*map(torch.from_numpy, (lp, lA, ll)), method="blocked")
