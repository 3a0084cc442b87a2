"""Feature arrays wider than 64 (F > FMAX, the widest of the fused and duplex
pairs' first instances): routed as JAX routes them. The port's "fused" and
"duplex" routes run their own pair at any F (the WF instances above 64), as
JAX's fused and duplex kernels do, and only a multinomial above
ONE_HOT_MAX_V = 256 symbols leaves them for the split kernels (JAX's
engines/base.py:547). Each agrees with JAX's route of the same name (the
duplex one ``"pallas_fused"`` with ``PYSVIHMM_DUPLEX=1``).

Two shapes: a Gaussian-NIW at D = 10 (F = 1 + D + D(D+1)/2 = 66) and a
multinomial of V = 100 symbols (its one-hot, F = 100; above 256 symbols both
packages take the split path with a segment-sum, tested in
tests/test_torch_families.py). JAX runs ``method="pallas_fused"`` in Pallas
interpret mode with the kernel precision knobs at "highest", once a shape,
mask and route; float32 on both sides, so the
tolerances are those of tests/test_pallas.py:246-251, as in
tests/test_torch_families.py. The rule itself is checked on every family at
the widths on both sides of FMAX and of ONE_HOT_MAX_V.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysvihmm_tpu.distributions import emissions as jem
from pysvihmm_tpu.engines.base import batch_local_step as jbatch_local_step
from pysvihmm_tpu.models import hmm as jhmm
from pysvihmm_tpu_torch import convert
from pysvihmm_tpu_torch.distributions import (
    DiagonalGaussianNIG,
    GaussianNIW,
    MultinomialDirichlet,
    PoissonGamma,
)
from pysvihmm_tpu_torch.engines import base
from pysvihmm_tpu_torch.messages.fused_fb import FMAX
from pysvihmm_tpu_torch.models import hmm

torch.set_num_threads(1)

# name -> (port family, JAX family, D or V)
WIDE = {"niw_d10": (GaussianNIW, jem.GaussianNIW, 10),
        "multinomial_v100": (MultinomialDirichlet, jem.MultinomialDirichlet, 100)}
# a width of the fused WF backward's window tier on the card (F above about
# 310): the Gaussian-NIW at D = 24, F = 325
WINDOW_WIDE = {"niw_d24": (GaussianNIW, jem.GaussianNIW, 24)}


# JAX's E-step by (shape name, gated, route): its interpret-mode compile is
# most of the test's time.
_JAX_RUNS = {}


@pytest.fixture
def jax_fused(monkeypatch):
    """JAX's fused or duplex route at exact float32 (the knobs, the duplex
    one too, are read while tracing, so JAX's caches are cleared around a
    run), each run once."""
    for knob in ("PYSVIHMM_KERNEL_PREC", "PYSVIHMM_LL_PREC", "PYSVIHMM_STATS_PREC"):
        monkeypatch.setenv(knob, "highest")

    def run(key, jp0, jfam, obs, w):
        if key not in _JAX_RUNS:
            if key[-1] == "duplex":
                monkeypatch.setenv("PYSVIHMM_DUPLEX", "1")
            else:
                monkeypatch.delenv("PYSVIHMM_DUPLEX", raising=False)
            jax.clear_caches()
            _JAX_RUNS[key] = jbatch_local_step(jp0, jfam, jnp.asarray(obs), "pallas_fused",
                                               weights=None if w is None else jnp.asarray(w))
        return _JAX_RUNS[key]

    yield run
    jax.clear_caches()


def _data(name, B, T, K, seed):
    """NumPy-made sticky-state observations: (B, T, D) float32 Gaussians or
    (B, T) int32 symbols."""
    rng = np.random.default_rng(seed)
    z = np.empty((B, T), np.int64)
    z[:, 0] = rng.integers(0, K, size=B)
    for t in range(1, T):
        z[:, t] = np.where(rng.random(B) < 0.85, z[:, t - 1], rng.integers(0, K, size=B))
    fam, _, size = {**WIDE, **WINDOW_WIDE}[name]
    if fam is GaussianNIW:
        return (rng.normal(scale=3.0, size=(K, size))[z]
                + rng.normal(size=(B, T, size))).astype(np.float32)
    probs = rng.dirichlet(np.full(size, 0.3), size=K)
    return np.array([[rng.choice(size, p=probs[k]) for k in row] for row in z], np.int32)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("route", ["fused", "duplex"])
@pytest.mark.parametrize("name", list(WIDE))
def test_wide_features_match_jax_fused(jax_fused, name, route, gated):
    """batch_local_step on the port's route against JAX's route of the same
    name (the fused one, or the duplex one under ``PYSVIHMM_DUPLEX=1``),
    gamma included, ungated and gated by a kept-mask."""
    _check_against_jax(jax_fused, name, route, gated)


@pytest.mark.parametrize("gated", [False, True])
def test_window_tier_width_matches_jax_fused(jax_fused, gated):
    """The fused route at a width of the WF backward's window tier (the
    Gaussian-NIW at D = 24, F = 325, where on the card each window of 2^17 /
    B steps runs a likelihood tile, the chain on it and eacc's outer sums)
    against JAX's fused route, ungated and gated, at the tolerances above:
    the twin the card holds the window tier's kernels to."""
    _check_against_jax(jax_fused, "niw_d24", "fused", gated)


def _check_against_jax(jax_fused, name, route, gated):
    """batch_local_step on ``route`` against JAX's route of that name at
    B = 3, T = 8, K = 4, float32 on both sides."""
    B, T, K = 3, 8, 4
    fam, jfam, size = {**WIDE, **WINDOW_WIDE}[name]
    obs = _data(name, B, T, K, seed=size)
    kw = dict(num_symbols=size) if fam is MultinomialDirichlet else dict(obs_dim=size)
    jprior = jhmm.make_prior(K, jfam, dtype=jnp.float32, **kw)
    jp0 = jhmm.init_params(jax.random.PRNGKey(size), jprior, jfam, jnp.asarray(obs))
    params = convert.params_from_numpy(jp0, device="cpu")
    assert base.feature_width(fam, params.emit, torch.from_numpy(obs)) > FMAX
    assert not base.wider_than_fused_kernels(fam, params.emit, torch.from_numpy(obs))
    w = (np.random.default_rng(3).random((B, T)) > 0.3).astype(np.float32) if gated else None
    js, jg = jax_fused((name, gated, route), jp0, jfam, obs, w)
    ts, tg = base.batch_local_step(params, fam, torch.from_numpy(obs), route,
                                   weights=None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=5e-5)
    np.testing.assert_allclose(ts.init.numpy(), np.asarray(js.init), atol=5e-5)
    np.testing.assert_allclose(ts.trans.numpy(), np.asarray(js.trans), atol=1e-3)
    np.testing.assert_allclose(ts.log_z.item(), float(js.log_z), rtol=2e-6)
    emit_t = ts.emit if isinstance(ts.emit, tuple) else (ts.emit,)
    emit_j = js.emit if isinstance(js.emit, tuple) else (js.emit,)
    for a, b in zip(emit_t, emit_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-3, atol=2e-3)



def test_wide_features_above_k64_match_jax_fused(jax_fused):
    """The wide path above K = 64: batch_local_step on "fused" at K = 128
    for the Gaussian-NIW at D = 10 (F = 66; on the card the likelihood
    tiles and the large-K chains a window at a time) against JAX's fused
    route, at the tolerances of the test above."""
    B, T, K = 2, 6, 128
    fam, jfam, size = WIDE["niw_d10"]
    obs = _data("niw_d10", B, T, K, seed=K)
    jprior = jhmm.make_prior(K, jfam, dtype=jnp.float32, obs_dim=size)
    jp0 = jhmm.init_params(jax.random.PRNGKey(K), jprior, jfam, jnp.asarray(obs))
    params = convert.params_from_numpy(jp0, device="cpu")
    assert base.feature_width(fam, params.emit, torch.from_numpy(obs)) > FMAX
    js, jg = jax_fused(("niw_d10", K, False, "fused"), jp0, jfam, obs, None)
    ts, tg = base.batch_local_step(params, fam, torch.from_numpy(obs), "fused")
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=5e-5)
    np.testing.assert_allclose(ts.init.numpy(), np.asarray(js.init), atol=5e-5)
    np.testing.assert_allclose(ts.trans.numpy(), np.asarray(js.trans), atol=1e-3)
    np.testing.assert_allclose(ts.log_z.item(), float(js.log_z), rtol=2e-6)
    for a, b in zip(ts.emit, js.emit):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-3, atol=2e-3)


# family, size (D, or V for the multinomial), F at that size
WIDTHS = [(GaussianNIW, 9, 55), (GaussianNIW, 10, 66),
          (DiagonalGaussianNIG, 31, 63), (DiagonalGaussianNIG, 32, 65),
          (PoissonGamma, 62, FMAX), (PoissonGamma, 63, FMAX + 1),
          (MultinomialDirichlet, FMAX, FMAX), (MultinomialDirichlet, FMAX + 1, FMAX + 1),
          (MultinomialDirichlet, hmm.ONE_HOT_MAX_V + 1, hmm.ONE_HOT_MAX_V + 1),
          (MultinomialDirichlet, hmm.ONE_HOT_MAX_V, hmm.ONE_HOT_MAX_V),
          (GaussianNIW, 23, 300), (GaussianNIW, 39, 820)]


@pytest.mark.parametrize("fam,size,F", WIDTHS, ids=lambda x: getattr(x, "__name__", str(x)))
def test_the_route_follows_the_feature_width(monkeypatch, fam, size, F):
    """JAX's rule: "fused" and "duplex" run their own pair at every F (the
    prepared features F wide, F = 66 and 300 among them), and the split
    E-step only for a multinomial above ONE_HOT_MAX_V symbols (no feature
    array prepared)."""
    K, B, T = 3, 2, 5
    kw = dict(num_symbols=size) if fam is MultinomialDirichlet else dict(obs_dim=size)
    prior = hmm.make_prior(K, fam, device="cpu", **kw)
    g = torch.Generator().manual_seed(size)
    if fam is MultinomialDirichlet:
        obs = torch.randint(0, size, (B, T), generator=g)
    else:
        obs = torch.poisson(torch.full((B, T, size), 3.0), generator=g)
    params = hmm.init_params(g, prior, fam, obs)
    assert base.feature_width(fam, params.emit, obs) == F
    large_v = fam is MultinomialDirichlet and size > hmm.ONE_HOT_MAX_V
    to_split = {"fused": large_v, "duplex": large_v}
    assert base.wider_than_fused_kernels(fam, params.emit, obs) == large_v
    feats = base.prepare_fused_obs(params, fam, obs)
    assert (feats is None) == large_v and (large_v or feats.shape == (T, B, F))
    calls, split = [], base._split_estep
    monkeypatch.setattr(base, "_split_estep",
                        lambda *a, **k: calls.append("split") or split(*a, **k))
    for route in ("fused", "duplex"):
        est = base._FUSED_ESTEPS[route]
        monkeypatch.setitem(base._FUSED_ESTEPS, route,
                            lambda *a, _e=est, _r=route, **k: calls.append(_r) or _e(*a, **k))
        calls.clear()
        stats, gamma = base.batch_local_step(params, fam, obs, route)
        assert calls == ["split" if to_split[route] else route]
        assert gamma.shape == (B, T, K) and bool(torch.isfinite(stats.log_z))


@pytest.mark.parametrize("name", ["fused_fwd_kernel", "fused_bwd_kernel", "split_fwd_kernel",
                                  "split_bwd_kernel"])
def test_the_bound_counts_bf16_alpha(name):
    """``roofline.kernel_work`` counts bf16 alpha as 2-byte words on the
    fused and the split pair: two bytes fewer a (t, b, k), written by the
    forward and read by the backward, and the same operations."""
    from pysvihmm_tpu_torch.utils.roofline import kernel_work

    B, T, K = 1024, 1000, 64
    F = 66 if name.startswith("fused") else 0
    f32, b16 = kernel_work(name, B, T, K, F), kernel_work(name, B, T, K, F, bf16_alpha=True)
    assert f32[0] - b16[0] == 2.0 * B * T * K and f32[1:] == b16[1:]


@pytest.mark.parametrize("name", ["fused_fwd_kernel", "fused_bwd_kernel"])
def test_the_bound_counts_any_feature_width(name):
    """The fused pair's bytes and operations grow by the same amount a
    feature on both sides of F = 64, up to F = 300: the WF instances'
    bound counts the function's inputs and outputs, as at F <= 64."""
    from pysvihmm_tpu_torch.utils.roofline import kernel_work

    B, T, K = 1024, 1000, 64
    work = {F: np.array(kernel_work(name, B, T, K, F)[:2]) for F in (45, 64, 65, 66, 300)}
    step = work[65] - work[64]
    assert (step > 0).all()
    for lo, hi in ((45, 64), (65, 66), (66, 300)):
        np.testing.assert_allclose(work[hi] - work[lo], (hi - lo) * step, rtol=1e-12)


def _niw_problem(D, K, N, seed):
    """NumPy-made NIW parameters (K states, near unit-scale observations)
    and N observations of D dimensions, float32."""
    rng = np.random.default_rng(seed)
    psi = 5.0 * (rng.uniform(0.5, 2.0, (K, 1, 1)) * np.eye(D) + 0.1)
    q = dict(mean=rng.normal(scale=0.5, size=(K, D)), kappa=rng.uniform(2.0, 20.0, K),
             nu=D + 2.0 + rng.uniform(3.0, 20.0, K), psi=psi)
    q = {k: v.astype(np.float32) for k, v in q.items()}
    return q, rng.normal(size=(N, D)).astype(np.float32)


@pytest.mark.parametrize("D", [10, 13])
def test_likelihood_tile_twin_is_jax_expected_log_likelihood(D):
    """The large-K WF backward's likelihoods (``fused_fb.likelihood_tile``'s
    plain twin, which the CPU runs: the port's ``ell_features`` times
    ``ell_feature_matrix`` summed in blocks of 64 features) against JAX's
    ``niw.expected_log_likelihood`` (const - quad / 2 + lin, the quadratic
    form on the full D^2 products) on the same NumPy inputs, NIW at D = 10
    (F = 66) and 13 (F = 105), K = 128, float32 on both sides. Two float32
    evaluations of one sum of about F terms of magnitude up to max |ll|:
    within 1e-5 of the largest |ll| and 1e-4 absolute (a few float32 ulps of
    it; the largest difference seen is about 6e-7 of it)."""
    from pysvihmm_tpu.distributions import niw as jniw
    from pysvihmm_tpu_torch.distributions import niw as tniw
    from pysvihmm_tpu_torch.messages import fused_fb

    K, N = 128, 400
    q, y = _niw_problem(D, K, N, 900 + D)
    ref = np.asarray(jniw.expected_log_likelihood(
        jniw.NIW(**{k: jnp.asarray(v) for k, v in q.items()}), jnp.asarray(y)))
    tq = tniw.NIW(**{k: torch.from_numpy(v) for k, v in q.items()})
    X = tniw.ell_features(torch.from_numpy(y)).contiguous()
    W = tniw.ell_feature_matrix(tq).to(torch.float32).contiguous()
    assert X.shape == (N, 1 + D + D * (D + 1) // 2) and W.shape == (X.shape[1], K)
    got = fused_fb.likelihood_tile(X, W)
    assert got.dtype == torch.float32 and got.shape == (N, K)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 + 1e-5 * np.abs(ref).max())


def test_likelihood_tile_refuses_bad_shapes():
    """``fused_fb.likelihood_tile`` takes X (N, F) and W (F, K), float32 and
    contiguous, N >= 1: mismatched widths, another dtype, a strided X and
    no rows raise ValueError on the CPU as on the card."""
    from pysvihmm_tpu_torch.messages import fused_fb

    X, W = torch.ones((5, 70)), torch.ones((70, 3))
    for x, w in ((X, torch.ones((69, 3))), (X.double(), W), (torch.ones((70, 5)).T, W),
                 (torch.ones((0, 70)), W), (X[None], W)):
        with pytest.raises(ValueError):
            fused_fb.likelihood_tile(x, w)
    torch.testing.assert_close(fused_fb.likelihood_tile(X, W), X @ W)
