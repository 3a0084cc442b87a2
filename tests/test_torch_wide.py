"""Feature arrays wider than the fused and duplex kernels take (F > FMAX = 64):
the port's "fused" and "duplex" routes run the split kernels for them, and
agree with JAX's fused route, whose Pallas kernels take any F.

Two shapes: a Gaussian-NIW at D = 10 (F = 1 + D + D(D+1)/2 = 66) and a
multinomial of V = 100 symbols (its one-hot, F = 100; above 256 symbols both
packages take the split path with a segment-sum, tested in
tests/test_torch_families.py). JAX runs ``method="pallas_fused"`` (with
``PYSVIHMM_DUPLEX=1`` for the port's "duplex") in Pallas interpret mode with
the kernel precision knobs at "highest"; float32 on both sides, so the
tolerances are those of tests/test_pallas.py:246-251, as in
tests/test_torch_families.py. The rule itself is checked on every family at
the widths on both sides of FMAX.
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


@pytest.fixture
def jax_route(monkeypatch):
    """JAX's fused route at exact float32, its duplex variant for "duplex";
    PYSVIHMM_DUPLEX is read while tracing, so JAX's caches are cleared
    around it."""
    for knob in ("PYSVIHMM_KERNEL_PREC", "PYSVIHMM_LL_PREC", "PYSVIHMM_STATS_PREC"):
        monkeypatch.setenv(knob, "highest")

    def use(route):
        monkeypatch.delenv("PYSVIHMM_DUPLEX", raising=False)
        if route == "duplex":
            monkeypatch.setenv("PYSVIHMM_DUPLEX", "1")
        jax.clear_caches()
        return "pallas_fused"

    yield use
    jax.clear_caches()


def _data(name, B, T, K, seed):
    """NumPy-made sticky-state observations: (B, T, D) float32 Gaussians or
    (B, T) int32 symbols."""
    rng = np.random.default_rng(seed)
    z = np.empty((B, T), np.int64)
    z[:, 0] = rng.integers(0, K, size=B)
    for t in range(1, T):
        z[:, t] = np.where(rng.random(B) < 0.85, z[:, t - 1], rng.integers(0, K, size=B))
    size = WIDE[name][2]
    if name == "niw_d10":
        return (rng.normal(scale=3.0, size=(K, size))[z]
                + rng.normal(size=(B, T, size))).astype(np.float32)
    probs = rng.dirichlet(np.full(size, 0.3), size=K)
    return np.array([[rng.choice(size, p=probs[k]) for k in row] for row in z], np.int32)


@pytest.mark.parametrize("gated", [False, True])
@pytest.mark.parametrize("route", ["fused", "duplex"])
@pytest.mark.parametrize("name", list(WIDE))
def test_wide_features_match_jax_fused(jax_route, name, route, gated):
    """batch_local_step on the port's route against JAX's fused route, gamma
    included, ungated and gated by a kept-mask."""
    B, T, K = 3, 16, 4
    fam, jfam, size = WIDE[name]
    obs = _data(name, B, T, K, seed=size)
    kw = dict(num_symbols=size) if fam is MultinomialDirichlet else dict(obs_dim=size)
    jprior = jhmm.make_prior(K, jfam, dtype=jnp.float32, **kw)
    jp0 = jhmm.init_params(jax.random.PRNGKey(size), jprior, jfam, jnp.asarray(obs))
    params = convert.params_from_numpy(jp0, device="cpu")
    assert base.wider_than_fused_kernels(fam, params.emit, torch.from_numpy(obs))
    w = (np.random.default_rng(3).random((B, T)) > 0.3).astype(np.float32) if gated else None
    js, jg = jbatch_local_step(jp0, jfam, jnp.asarray(obs), jax_route(route),
                               weights=None if w is None else jnp.asarray(w))
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


# family, size (D, or V for the multinomial), F at that size
WIDTHS = [(GaussianNIW, 9, 55), (GaussianNIW, 10, 66),
          (DiagonalGaussianNIG, 31, 63), (DiagonalGaussianNIG, 32, 65),
          (PoissonGamma, 62, FMAX), (PoissonGamma, 63, FMAX + 1),
          (MultinomialDirichlet, FMAX, FMAX), (MultinomialDirichlet, FMAX + 1, FMAX + 1),
          (MultinomialDirichlet, hmm.ONE_HOT_MAX_V + 1, hmm.ONE_HOT_MAX_V + 1)]


@pytest.mark.parametrize("fam,size,F", WIDTHS, ids=lambda x: getattr(x, "__name__", str(x)))
def test_the_route_follows_the_feature_width(monkeypatch, fam, size, F):
    """F > FMAX runs the split E-step on "fused" and "duplex" (and no
    feature array is prepared); F <= FMAX runs the route's own kernels on
    the prepared features."""
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
    wide = F > FMAX
    assert base.wider_than_fused_kernels(fam, params.emit, obs) == wide
    feats = base.prepare_fused_obs(params, fam, obs)
    assert (feats is None) == wide and (wide or feats.shape == (T, B, F))
    calls, split = [], base._split_estep
    monkeypatch.setattr(base, "_split_estep",
                        lambda *a, **k: calls.append("split") or split(*a, **k))
    for route in ("fused", "duplex"):
        est = base._FUSED_ESTEPS[route]
        monkeypatch.setitem(base._FUSED_ESTEPS, route,
                            lambda *a, _e=est, _r=route, **k: calls.append(_r) or _e(*a, **k))
        calls.clear()
        stats, gamma = base.batch_local_step(params, fam, obs, route)
        assert calls == ["split" if wide else route]
        assert gamma.shape == (B, T, K) and bool(torch.isfinite(stats.log_z))
