"""The fused and duplex kernels' three modes (messages/fused_fb.py,
messages/duplex_fb.py, engines/base.py) against the JAX package.

* In-kernel features: the raw observations (T, B, D) with
  ``in_kernel_feats`` "niw" / "nig", against ``pallas_estep_fused`` and
  ``pallas_estep_duplex`` given the same observations and kind (interpret
  mode, HIGHEST precisions), at ``tests/test_torch_fused.py``'s tolerances;
  and the port's twins in that mode against its array mode on
  ``ell_features(obs)``, bit for bit.
* The in-kernel gamma pick (``gamma_sel``) against JAX's ``gamma_sel=`` and
  against JAX's ``windowed_local_step`` under ``PYSVIHMM_GAMMA_SEL``
  (tests/test_pallas.py:310-323's tolerances).
* bf16-stored alpha against JAX under ``PYSVIHMM_BF16_ALPHA=1``, within
  JAX's own band against float32 (tests/test_precision.py:251-270), and
  ``exact=True`` pinning float32; on the fused pair and on the split pair
  (JAX's packed path above 256 symbols).
* The three modes at features wider than 64 (the fused pair's WF
  instances), each against JAX's knob.
* Every ``ValueError`` the modes raise.

The twins are the CUDA kernels' plain versions; the kernels are held to
them on the card by tests/test_torch_cuda.py and chip_smoke.py phase 14.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysvihmm_tpu.distributions.emissions import GaussianNIW as JGaussianNIW
from pysvihmm_tpu.distributions.emissions import MultinomialDirichlet as JMultinomialDirichlet
from pysvihmm_tpu.engines.base import windowed_local_step as jwindowed_local_step
from pysvihmm_tpu.messages.pallas_duplex import pallas_estep_duplex
from pysvihmm_tpu.messages.pallas_fb import pallas_estep_fused
from pysvihmm_tpu.models import hmm as jhmm
from pysvihmm_tpu_torch import convert
from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
from pysvihmm_tpu_torch.distributions import (
    DiagonalGaussianNIG,
    GaussianNIW,
    MultinomialDirichlet,
    PoissonGamma,
)
from pysvihmm_tpu_torch.distributions import niw as tniw
from pysvihmm_tpu_torch.engines import batch_vb, svi
from pysvihmm_tpu_torch.engines.base import (
    batch_local_step,
    prepare_fused_obs,
    windowed_local_step,
)
from pysvihmm_tpu_torch.messages import duplex_fb, fused_fb, split_fb
from pysvihmm_tpu_torch.models.hmm import init_params, make_prior

torch.set_num_threads(1)


def _problem(kind, B, T, K, D, seed):
    """Raw observations and weights of one feature kind, NumPy-made.

    Returns float32 (log_pi (K,), log_A (K, K), W (F, K), obs (T, B, D)):
    W the NIW's ``ell_feature_matrix`` of a valid posterior for "niw"; for
    "nig" a constant, linear and negative quadratic weight a state, so
    that ll = [1, y, y * y] @ W is a proper diagonal Gaussian's."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=3.0, size=(K, D))
    z = rng.integers(0, K, size=(B, T))
    obs = centres[z] + 0.7 * rng.normal(size=(B, T, D))
    if kind == "niw":
        psi = np.stack([np.eye(D) * rng.uniform(0.5, 2.0) + 0.1 * np.ones((D, D))
                        for _ in range(K)]) * 5.0
        q = tniw.NIW(
            mean=torch.tensor(centres + 0.3 * rng.normal(size=(K, D))),
            kappa=torch.tensor(rng.uniform(2.0, 20.0, size=K)),
            nu=torch.tensor(D + 2.0 + rng.uniform(3.0, 20.0, size=K)),
            psi=torch.tensor(psi),
        )
        W = tniw.ell_feature_matrix(q).numpy()
    else:
        prec = rng.uniform(0.5, 2.0, size=(K, D))
        W = np.concatenate([
            -0.5 * (prec * centres ** 2).sum(-1)[None] + rng.normal(size=(1, K)),
            (prec * centres).T, -0.5 * prec.T,
        ])
    log_pi = np.log(rng.dirichlet(np.full(K, 2.0)))
    A = 0.7 * (np.full((K, K), 0.2 / (K - 1)) + 0.8 * np.eye(K)) + 0.3 * rng.dirichlet(
        np.ones(K), size=K)
    obs_tm = np.ascontiguousarray(np.swapaxes(obs, 0, 1))
    return tuple(np.asarray(x, np.float32) for x in (log_pi, np.log(A), W, obs_tm))


def _kept(T, B, L, seed):
    """(T, B) float32 kept-masks of SVI windows: one kept run of L steps."""
    offs = np.random.default_rng(seed).integers(0, T - L + 1, size=B)
    t = np.arange(T)[:, None]
    return ((t >= offs) & (t < offs + L)).astype(np.float32)


def _t(*xs):
    return [None if x is None else torch.from_numpy(np.asarray(x)) for x in xs]


def _jax(estep, log_pi, log_A, W, obs, emit_gamma, weights=None, **kw):
    fb, S = estep(jnp.asarray(log_pi), jnp.asarray(log_A), jnp.asarray(W), jnp.asarray(obs),
                  weights=None if weights is None else jnp.asarray(weights), interpret=True,
                  emit_gamma=emit_gamma, **kw)
    return jax.tree.map(np.asarray, fb), np.asarray(S)


def _assert_matches_jax(tfb, tS, jfb, jS, T, B, K, emit_gamma):
    """tests/test_torch_fused.py's tolerances: float32 on both sides, other
    summation orders."""
    if emit_gamma:
        np.testing.assert_allclose(tfb.gamma.numpy(), jfb.gamma.reshape(T, B, K), atol=5e-5)
    np.testing.assert_allclose(tfb.init_stats.numpy(), jfb.init_stats.reshape(B, K), atol=5e-5)
    np.testing.assert_allclose(tfb.trans_stats.numpy(), jfb.trans_stats,
                               atol=min(1e-3, 1e-4 * np.abs(jfb.trans_stats).max()))
    np.testing.assert_allclose(tfb.log_z.numpy(), jfb.log_z, rtol=2e-6)
    np.testing.assert_allclose(tfb.log_c.numpy(), jfb.log_c, rtol=2e-6, atol=1e-4)
    np.testing.assert_allclose(tS.numpy(), jS, rtol=3e-3, atol=2e-3)


ESTEPS = {"fused": (fused_fb.estep_fused_reference, pallas_estep_fused),
          "duplex": (duplex_fb.estep_duplex_reference, pallas_estep_duplex)}


# (route, kind, emit_gamma, gated): B, T, K, D = 4, 32, 8, 3 (F = 10 NIW, 7 NIG)
@pytest.mark.parametrize("route,kind,emit_gamma,gated", [
    ("fused", "niw", True, False),
    ("fused", "nig", False, True),
    ("duplex", "niw", False, True),
    ("duplex", "nig", True, False),
])
def test_in_kernel_features_match_jax(route, kind, emit_gamma, gated):
    B, T, K, D = 4, 32, 8, 3
    log_pi, log_A, W, obs = _problem(kind, B, T, K, D, seed=7)
    w = _kept(T, B, 20, seed=3) if gated else None
    port, jestep = ESTEPS[route]
    jfb, jS = _jax(jestep, log_pi, log_A, W, obs, emit_gamma, w, in_kernel_feats=kind)
    tfb, tS = port(*_t(log_pi, log_A, W, obs), emit_gamma=emit_gamma,
                   weights=None if w is None else torch.from_numpy(w), in_kernel_feats=kind)
    assert W.shape[0] == fused_fb.feature_width(kind, D) == jS.shape[1]
    _assert_matches_jax(tfb, tS, jfb, jS, T, B, K, emit_gamma)


@pytest.mark.parametrize("route", ["fused", "duplex"])
@pytest.mark.parametrize("kind", ["niw", "nig"])
@pytest.mark.parametrize("gated", [False, True])
def test_in_kernel_twin_is_the_array_twin_bit_for_bit(route, kind, gated):
    """The built rows are ``ell_features(obs)``'s float32 bits, so every
    output of the mode equals the array mode's on those features."""
    B, T, K, D = 3, 24, 6, 3
    log_pi, log_A, W, obs = _problem(kind, B, T, K, D, seed=11)
    w = torch.from_numpy(_kept(T, B, 12, seed=5)) if gated else None
    feats = fused_fb.build_features(torch.from_numpy(obs), kind)
    port = ESTEPS[route][0]
    a = port(*_t(log_pi, log_A, W, obs), emit_gamma=True, weights=w, in_kernel_feats=kind)
    b = port(*_t(log_pi, log_A, W), feats, emit_gamma=True, weights=w)
    for x, y in zip(jax.tree.leaves(a, is_leaf=torch.is_tensor),
                    jax.tree.leaves(b, is_leaf=torch.is_tensor)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("kind", [None, "niw"])
def test_gamma_sel_matches_jax(kind):
    """The backward's in-kernel pick against JAX's ``gamma_sel=`` (one pick
    past T: zeros on both sides), gated as the windowed engines run it."""
    B, T, K, D = 5, 24, 8, 3
    log_pi, log_A, W, obs = _problem("niw", B, T, K, D, seed=13)
    feats = obs if kind else fused_fb.build_features(torch.from_numpy(obs), "niw").numpy()
    w = _kept(T, B, 14, seed=2)
    sel = np.array([0, 3, T - 1, 9, T], np.int32)
    jfb, jS = _jax(pallas_estep_fused, log_pi, log_A, W, feats, False, w,
                   gamma_sel=jnp.asarray(sel), in_kernel_feats=kind)
    tfb, tS = fused_fb.estep_fused_reference(
        *_t(log_pi, log_A, W, feats), weights=torch.from_numpy(w),
        gamma_sel=torch.from_numpy(sel), in_kernel_feats=kind)
    _assert_matches_jax(tfb, tS, jfb, jS, T, B, K, False)
    assert tfb.gamma is None and not tfb.init_stats[-1].any()
    full, _ = fused_fb.estep_fused_reference(*_t(log_pi, log_A, W, feats), emit_gamma=True,
                                             weights=torch.from_numpy(w), in_kernel_feats=kind)
    rows = torch.arange(B - 1)
    torch.testing.assert_close(tfb.init_stats[:-1], full.gamma[sel[:-1], rows], rtol=0, atol=0)


def _windows(K, D, T, B, W, L, seed):
    chain = gen_gaussian_dataset(torch.Generator().manual_seed(seed), K, D, 1, T)[0][0]
    chain = chain.numpy().astype(np.float32)
    ws = np.random.default_rng(seed + 1).integers(0, T - W + 1, size=B)
    offs = np.arange(B) % (W - L + 1)
    pos = np.arange(W)[None, :]
    maskf = ((pos >= offs[:, None]) & (pos < offs[:, None] + L)).astype(np.float32)
    return chain, chain[ws[:, None] + np.arange(W)], maskf, offs


def test_windowed_gamma_sel_matches_jax(monkeypatch):
    """``windowed_local_step(gamma_sel=True)`` against JAX's in-kernel pick
    (``PYSVIHMM_GAMMA_SEL``, read while tracing) at tests/test_pallas.py:
    310-323's tolerances, and against the port's gather."""
    K, D, T, B, W, L = 4, 3, 64, 6, 16, 10
    chain, windows, maskf, offs = _windows(K, D, T, B, W, L, seed=0)
    jprior = jhmm.make_prior(K, JGaussianNIW, obs_dim=D)
    jparams = jhmm.init_params(jax.random.PRNGKey(1), jprior, JGaussianNIW,
                               jnp.asarray(chain[None]))
    for knob in ("PYSVIHMM_KERNEL_PREC", "PYSVIHMM_LL_PREC", "PYSVIHMM_STATS_PREC"):
        monkeypatch.setenv(knob, "highest")
    monkeypatch.setenv("PYSVIHMM_GAMMA_SEL", "1")
    jax.clear_caches()
    try:
        jout = jwindowed_local_step(jparams, JGaussianNIW, jnp.asarray(windows),
                                    jnp.asarray(maskf), jnp.asarray(offs), "pallas_fused")
    finally:
        jax.clear_caches()
    params = convert.params_from_numpy(jparams, device="cpu")
    args = (params, GaussianNIW, torch.from_numpy(windows), torch.from_numpy(maskf),
            torch.from_numpy(offs), "fused")
    tout = windowed_local_step(*args, gamma_sel=True)
    gather = windowed_local_step(*args)
    pairs = list(zip(tout[0], jout[0])) + list(zip(tout[1:], jout[1:]))
    for a, b in pairs:
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(tout[2], gather[2], rtol=0, atol=0)


def _gaps(a, aS, b, bS) -> dict[str, float]:
    """How far two E-steps' outputs lie apart: log c (max abs), log Z summed
    (relative), trans and emission statistics and init_stats (max abs over
    the largest, for the statistics)."""
    a, b = (jax.tree.map(np.asarray, x, is_leaf=torch.is_tensor) for x in (a, b))
    aS, bS = np.asarray(aS), np.asarray(bS)
    za, zb = (float(np.asarray(x.log_z, np.float64).sum()) for x in (a, b))
    return {"log_c": float(np.abs(a.log_c - b.log_c).max()), "log_z": abs(za - zb) / abs(zb),
            "trans": float(np.abs(a.trans_stats - b.trans_stats).max()
                           / np.abs(b.trans_stats).max()),
            "emit": float(np.abs(aS - bS).max() / np.abs(bS).max()),
            "init": float(np.abs(a.init_stats - b.init_stats.reshape(a.init_stats.shape)).max())}


def _assert_bf16_band(bf, bS, ref, rS, jfb, jS, jf32, jS32, noise=0.0):
    """bf16 alpha's E-step (bf, bS) against JAX's under
    ``PYSVIHMM_BF16_ALPHA=1`` (jfb, jS) and against the port's float32 (ref,
    rS): within JAX's band of each (tests/test_precision.py:251-270), and
    within 8 times the two sides' own float32 disagreement (ref against
    jf32) of JAX's, a tolerance below every bf16-against-float32 gap, so
    that storing float32, or rounding at another point, fails. An output
    that bf16 moves by less than ``noise`` (relative: float32's own rounding
    of a saturated posterior's sums) carries no sign of the mode; there
    both gaps must stay below ``noise``."""
    for got, want, wS in ((bf, jfb, jS), (bf, ref, np.asarray(rS))):
        want_z = np.asarray(want.log_z, np.float64).sum()
        assert abs(float(got.log_z.sum()) - want_z) / abs(want_z) < 1e-3
        assert np.abs(np.asarray(bS) - wS).max() / np.abs(wS).max() < 2e-2
        wt = np.asarray(want.trans_stats)
        np.testing.assert_allclose(got.trans_stats.numpy(), wt, rtol=2e-2,
                                   atol=2e-2 * np.abs(wt).max())
    dz = abs(float(bf.log_z.sum() - ref.log_z.sum())) / abs(float(ref.log_z.sum()))
    assert 0.0 < dz < 1e-3  # the mode is live
    tol = {k: 8.0 * v for k, v in _gaps(ref, rS, jf32, jS32).items()}
    near, live = _gaps(bf, bS, jfb, jS), _gaps(bf, bS, ref, rS)
    for k in tol:
        if live[k] < noise:
            assert near[k] < noise, (k, near[k], noise)
        else:
            assert near[k] <= tol[k] < live[k], (k, near[k], tol[k], live[k])


def _jax_bf16(monkeypatch, run):
    """``run()`` in JAX at float32, then under ``PYSVIHMM_BF16_ALPHA=1`` (read
    while tracing: JAX's caches cleared around it)."""
    jax.clear_caches()
    f32 = run()
    monkeypatch.setenv("PYSVIHMM_BF16_ALPHA", "1")
    jax.clear_caches()
    try:
        return f32, run()
    finally:
        monkeypatch.delenv("PYSVIHMM_BF16_ALPHA")
        jax.clear_caches()


def test_bf16_alpha_matches_jax_band(monkeypatch):
    """bf16-stored alpha (``PYSVIHMM_BF16_ALPHA=1`` in JAX, read while
    tracing, at a shape nothing else here traces): the port's and JAX's
    within JAX's band of each other and of float32, 8 times the float32
    gap (:func:`_assert_bf16_band`); the stored alpha is float32's rounded,
    s the rounded sums."""
    B, T, K, D = 7, 40, 12, 3
    log_pi, log_A, W, obs = _problem("niw", B, T, K, D, seed=17)
    (jf32, jS32), (jfb, jS) = _jax_bf16(monkeypatch, lambda: _jax(
        pallas_estep_fused, log_pi, log_A, W, obs, False, in_kernel_feats="niw"))
    args = (*_t(log_pi, log_A, W, obs),)
    bf, bS = fused_fb.estep_fused_reference(*args, in_kernel_feats="niw",
                                            alpha_dtype=torch.bfloat16)
    ref, rS = fused_fb.estep_fused_reference(*args, in_kernel_feats="niw")
    _assert_bf16_band(bf, bS, ref, rS, jfb, jS, jf32, jS32)
    # the chain carries float32: alpha is float32's rounded, s its rounded sums
    pi_t, A_t = fused_fb.exp_params(*_t(log_pi, log_A))
    a32, _, sh32 = fused_fb.forward_reference(pi_t, A_t, *_t(W, obs), "niw")
    a16, s16, sh16 = fused_fb.forward_reference(pi_t, A_t, *_t(W, obs), "niw", torch.bfloat16)
    assert a16.dtype == torch.bfloat16
    torch.testing.assert_close(a16, a32.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(s16, a16.float().sum(-1).T, rtol=0, atol=0)
    torch.testing.assert_close(sh16, sh32, rtol=0, atol=0)


@pytest.mark.parametrize("route", ["fused", "duplex"])
def test_engine_modes_on_the_local_steps(route):
    """batch_local_step, batch_vb.make_step and svi.make_step in the modes:
    in-kernel features give the array mode's bits; ``exact=True`` pins
    float32 alpha, so bf16_alpha then changes nothing."""
    K, D = 4, 3
    obs, _, _ = gen_gaussian_dataset(torch.Generator().manual_seed(0), K, D, 5, 30)
    obs = obs.to(torch.float32)
    prior = make_prior(K, GaussianNIW, obs_dim=D, device="cpu")
    p = init_params(torch.Generator().manual_seed(1), prior, GaussianNIW, obs)
    arr, _ = batch_local_step(p, GaussianNIW, obs, route, need_gamma=False)
    ink, _ = batch_local_step(p, GaussianNIW, obs, route, need_gamma=False, in_kernel_feats=True)
    for x, y in zip(jax.tree.leaves(arr, is_leaf=torch.is_tensor),
                    jax.tree.leaves(ink, is_leaf=torch.is_tensor)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    prepared = prepare_fused_obs(p, GaussianNIW, obs, in_kernel_feats=True)
    assert prepared.shape == (30, 5, D)
    step = batch_vb.make_step(GaussianNIW, route, in_kernel_feats=True)
    p1, elbo = step(p, prior, obs, prepared)
    p0, elbo0 = batch_vb.make_step(GaussianNIW, route)(p, prior, obs)
    torch.testing.assert_close(elbo, elbo0, rtol=0, atol=0)
    if route == "fused":
        ex, _ = batch_local_step(p, GaussianNIW, obs, route, need_gamma=False, exact=True,
                                 bf16_alpha=True)
        f32, _ = batch_local_step(p, GaussianNIW, obs, route, need_gamma=False, exact=True)
        bf, _ = batch_local_step(p, GaussianNIW, obs, route, need_gamma=False, bf16_alpha=True)
        torch.testing.assert_close(ex.log_z, f32.log_z, rtol=0, atol=0)
        assert bf.log_z != f32.log_z
        cfg = svi.SVIConfig(batch_size=4, subchain_len=8, buffer=2)
        chain = obs.reshape(-1, D)
        state = svi.init_state(p, torch.Generator().manual_seed(3))
        starts = torch.tensor([0, 17, 40, 100])
        outs = [svi.make_step(GaussianNIW, cfg, chain.shape[0], route, **kw).with_starts(
            state, prior, chain, starts)[0].params for kw in
            ({}, {"in_kernel_feats": True, "gamma_sel": True})]
        for x, y in zip(jax.tree.leaves(outs[0], is_leaf=torch.is_tensor),
                        jax.tree.leaves(outs[1], is_leaf=torch.is_tensor)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)


def _raises(fn, match):
    with pytest.raises(ValueError, match=match):
        fn()


def test_modes_raise_where_they_do_not_run():
    """``ValueError`` where JAX raises (gamma_sel with emit_gamma or on the
    duplex, W rows not the kind's width) and where the port's kernels take
    no such mode (another family, another route or alpha dtype, an unknown
    kind); never a silent fall-back to the array or the split route. The
    fused and the duplex pair build features at any width: above 64 their
    outputs are the array mode's bits."""
    B, T, K, D = 2, 8, 4, 3
    log_pi, log_A, W, obs = _t(*_problem("niw", B, T, K, D, seed=1))
    sel = torch.zeros(B, dtype=torch.int32)
    _raises(lambda: fused_fb.estep_fused(log_pi, log_A, W, obs, emit_gamma=True,
                                         gamma_sel=sel, in_kernel_feats="niw"), "emit_gamma")
    _raises(lambda: duplex_fb.estep_duplex(log_pi, log_A, W, obs, gamma_sel=sel,
                                           in_kernel_feats="niw"), "fused kernels")
    _raises(lambda: fused_fb.estep_fused(log_pi, log_A, W, obs, in_kernel_feats="nig"),
            "W rows")
    _raises(lambda: fused_fb.estep_fused(log_pi, log_A, W, obs, in_kernel_feats="xyz"),
            "unknown in-kernel")
    _raises(lambda: fused_fb.estep_fused(log_pi, log_A, W, obs, in_kernel_feats="niw",
                                         alpha_dtype=torch.float16), "alpha is stored")
    wide = torch.zeros((T, B, 10))
    fb, S = fused_fb.estep_fused(log_pi, log_A, torch.zeros((66, K)), wide, in_kernel_feats="niw")
    assert S.shape == (K, 66) and bool(torch.isfinite(fb.log_z).all())
    fb, S = duplex_fb.estep_duplex(log_pi, log_A, torch.zeros((66, K)), wide,
                                   in_kernel_feats="niw")
    fa, Sa = duplex_fb.estep_duplex(log_pi, log_A, torch.zeros((66, K)),
                                    fused_fb.build_features(wide, "niw"))
    assert S.shape == (K, 66) and torch.equal(S, Sa) and torch.equal(fb.log_z, fa.log_z)

    prior = make_prior(K, GaussianNIW, obs_dim=10, device="cpu")
    y = torch.randn(B, T, 10, generator=torch.Generator().manual_seed(0))
    p = init_params(torch.Generator().manual_seed(1), prior, GaussianNIW, y)
    built, gamma = batch_local_step(p, GaussianNIW, y, "duplex", in_kernel_feats=True)
    array, _ = batch_local_step(p, GaussianNIW, y, "duplex")
    assert gamma.shape == (B, T, K) and torch.equal(built.log_z, array.log_z)
    assert torch.equal(built.trans, array.trans)
    assert batch_local_step(p, GaussianNIW, y, "fused", in_kernel_feats=True)[1].shape == (
        B, T, K)
    for fam, data, kw in ((PoissonGamma, torch.ones(B, T, 3), {"obs_dim": 3}),
                          (MultinomialDirichlet, torch.zeros(B, T, dtype=torch.long),
                           {"num_symbols": 5})):
        pr = make_prior(K, fam, device="cpu", **kw)
        pp = init_params(torch.Generator().manual_seed(1), pr, fam, data)
        _raises(lambda: batch_local_step(pp, fam, data, "fused", in_kernel_feats=True),
                "Gaussian-NIW or the diagonal")
    y3 = torch.randn(B, T, 3, generator=torch.Generator().manual_seed(0))
    p3 = init_params(torch.Generator().manual_seed(1),
                     make_prior(K, GaussianNIW, obs_dim=3, device="cpu"), GaussianNIW, y3)
    for route in ("scan", "split"):
        _raises(lambda: batch_local_step(p3, GaussianNIW, y3, route, in_kernel_feats=True),
                "in_kernel_feats runs on")
    _raises(lambda: batch_local_step(p3, GaussianNIW, y3, "duplex", bf16_alpha=True),
            "bf16_alpha requires")
    maskf, offs = torch.ones(B, T), torch.zeros(B, dtype=torch.long)
    for route in ("duplex", "split", "scan"):
        _raises(lambda: windowed_local_step(p3, GaussianNIW, y3, maskf, offs, route,
                                            gamma_sel=True), "gamma_sel requires")
    pn = init_params(torch.Generator().manual_seed(1),
                     make_prior(K, DiagonalGaussianNIG, obs_dim=3, device="cpu"),
                     DiagonalGaussianNIG, y3)
    assert prepare_fused_obs(pn, DiagonalGaussianNIG, y3, in_kernel_feats=True).shape == (T, B, 3)


# the modes at features wider than 64 (the fused pair's WF instances): the
# NIW at D = 10 (F = 66), the multinomial at V = 100 (its one-hot, F = 100)
WIDE_MODES = ["in_kernel_niw_d10", "gamma_sel_niw_d10", "gamma_sel_v100", "bf16_alpha_niw_d10"]


def _wide_windows(fam, size, B, W, L, seed):
    """SVI-like windows of one NumPy-made chain: (JAX params, windows,
    maskf, offs) for the NIW at D = size or the multinomial at V = size."""
    rng = np.random.default_rng(seed)
    K, T = 4, 200
    z = np.empty(T, np.int64)
    z[0] = 0
    for t in range(1, T):
        z[t] = z[t - 1] if rng.random() < 0.9 else rng.integers(0, K)
    if fam is GaussianNIW:
        chain = (rng.normal(scale=3.0, size=(K, size))[z]
                 + rng.normal(size=(T, size))).astype(np.float32)
        jfam, kw = JGaussianNIW, {"obs_dim": size}
    else:
        probs = rng.dirichlet(np.full(size, 0.3), size=K)
        chain = np.array([rng.choice(size, p=probs[k]) for k in z], np.int32)
        jfam, kw = JMultinomialDirichlet, {"num_symbols": size}
    jprior = jhmm.make_prior(K, jfam, **kw)
    jparams = jhmm.init_params(jax.random.PRNGKey(seed), jprior, jfam, jnp.asarray(chain[None]))
    ws = rng.integers(0, T - W + 1, size=B)
    offs = np.arange(B) % (W - L + 1)
    pos = np.arange(W)[None, :]
    maskf = ((pos >= offs[:, None]) & (pos < offs[:, None] + L)).astype(np.float32)
    return jparams, chain[ws[:, None] + np.arange(W)], maskf, offs


@pytest.mark.parametrize("mode", WIDE_MODES)
def test_modes_at_features_wider_than_64(monkeypatch, mode):
    """Each mode at F > 64, where the port's fused pair runs its WF
    instances, against JAX's knob: in-kernel NIW features at D = 10
    (``in_kernel_feats="niw"``, tests/test_torch_fused.py's tolerances, and
    the array mode's bits on the port's side); the pick
    (``PYSVIHMM_GAMMA_SEL``) at D = 10 and at V = 100 (tests/test_pallas.py:
    310-323's tolerances, and the gather's bits on the port's side); bf16
    alpha at D = 10 (``PYSVIHMM_BF16_ALPHA=1``) within the band of
    :func:`test_bf16_alpha_matches_jax_band`."""
    if mode == "in_kernel_niw_d10":
        B, T, K, D = 3, 16, 4, 10
        log_pi, log_A, W, obs = _problem("niw", B, T, K, D, seed=29)
        w = _kept(T, B, 10, seed=4)
        jfb, jS = _jax(pallas_estep_fused, log_pi, log_A, W, obs, True, w, in_kernel_feats="niw")
        tfb, tS = fused_fb.estep_fused_reference(*_t(log_pi, log_A, W, obs), emit_gamma=True,
                                                 weights=torch.from_numpy(w),
                                                 in_kernel_feats="niw")
        assert W.shape[0] == 66 > fused_fb.FMAX
        _assert_matches_jax(tfb, tS, jfb, jS, T, B, K, True)
        feats = fused_fb.build_features(torch.from_numpy(obs), "niw")
        arr = fused_fb.estep_fused_reference(*_t(log_pi, log_A, W), feats, emit_gamma=True,
                                             weights=torch.from_numpy(w))
        for x, y in zip(jax.tree.leaves((tfb, tS), is_leaf=torch.is_tensor),
                        jax.tree.leaves(arr, is_leaf=torch.is_tensor)):
            torch.testing.assert_close(x, y, rtol=0, atol=0)
        return
    if mode == "bf16_alpha_niw_d10":
        B, T, K, D = 5, 30, 6, 10
        log_pi, log_A, W, obs = _problem("niw", B, T, K, D, seed=31)
        (jf32, jS32), (jfb, jS) = _jax_bf16(monkeypatch, lambda: _jax(
            pallas_estep_fused, log_pi, log_A, W, obs, False, in_kernel_feats="niw"))
        args = (*_t(log_pi, log_A, W, obs),)
        bf, bS = fused_fb.estep_fused_reference(*args, in_kernel_feats="niw",
                                                alpha_dtype=torch.bfloat16)
        ref, rS = fused_fb.estep_fused_reference(*args, in_kernel_feats="niw")
        # the clusters lie apart in 10 dims: gamma is near one-hot and the
        # emission sums move by a float32 ulp or two with bf16 alpha
        _assert_bf16_band(bf, bS, ref, rS, jfb, jS, jf32, jS32, noise=1e-6)
        return
    fam, size = (GaussianNIW, 10) if mode == "gamma_sel_niw_d10" else (MultinomialDirichlet, 100)
    jparams, windows, maskf, offs = _wide_windows(fam, size, 6, 16, 10, seed=size)
    jfam = JGaussianNIW if fam is GaussianNIW else JMultinomialDirichlet
    for knob in ("PYSVIHMM_KERNEL_PREC", "PYSVIHMM_LL_PREC", "PYSVIHMM_STATS_PREC"):
        monkeypatch.setenv(knob, "highest")
    monkeypatch.setenv("PYSVIHMM_GAMMA_SEL", "1")
    jax.clear_caches()
    try:
        jout = jwindowed_local_step(jparams, jfam, jnp.asarray(windows), jnp.asarray(maskf),
                                    jnp.asarray(offs), "pallas_fused")
    finally:
        jax.clear_caches()
    params = convert.params_from_numpy(jparams, device="cpu")
    args = (params, fam, torch.from_numpy(windows), torch.from_numpy(maskf),
            torch.from_numpy(offs), "fused")
    tout = windowed_local_step(*args, gamma_sel=True)
    gather = windowed_local_step(*args)
    emit_t = tout[0] if isinstance(tout[0], tuple) else (tout[0],)
    emit_j = jout[0] if isinstance(jout[0], tuple) else (jout[0],)
    for a, b in list(zip(emit_t, emit_j)) + list(zip(tout[1:], jout[1:])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(tout[2], gather[2], rtol=0, atol=0)


def test_split_bf16_alpha_matches_jax_packed_path(monkeypatch):
    """The split pair's bf16 alpha: a multinomial of 300 symbols (above
    ONE_HOT_MAX_V, so both packages run the split pair: JAX's
    ``_pallas_packed_estep``) with ``bf16_alpha`` against JAX's
    batch_local_step under ``PYSVIHMM_BF16_ALPHA=1`` (its
    ``_alpha_store_dtype()``, pallas_fb.py:1213), within JAX's band and 8
    times the two sides' float32 gap; the port's split twin stores float32's
    alpha rounded, s the rounded sums."""
    from pysvihmm_tpu.engines.base import batch_local_step as jbatch_local_step

    for knob in ("PYSVIHMM_KERNEL_PREC", "PYSVIHMM_LL_PREC", "PYSVIHMM_STATS_PREC"):
        monkeypatch.setenv(knob, "highest")
    B, T, K, V = 4, 40, 6, 300
    rng = np.random.default_rng(37)
    z = np.cumsum(rng.random((B, T)) < 0.1, axis=1) % K
    probs = rng.dirichlet(np.full(V, 0.2), size=K)
    obs = np.array([[rng.choice(V, p=probs[k]) for k in row] for row in z], np.int32)
    jprior = jhmm.make_prior(K, JMultinomialDirichlet, num_symbols=V)
    jp = jhmm.init_params(jax.random.PRNGKey(3), jprior, JMultinomialDirichlet, jnp.asarray(obs))
    (j32, _), (j16, _) = _jax_bf16(monkeypatch, lambda: jbatch_local_step(
        jp, JMultinomialDirichlet, jnp.asarray(obs), "pallas_fused", need_gamma=False))
    params = convert.params_from_numpy(jp, device="cpu")
    y = torch.from_numpy(obs)
    t16, _ = batch_local_step(params, MultinomialDirichlet, y, "fused", need_gamma=False,
                              bf16_alpha=True)
    t32, _ = batch_local_step(params, MultinomialDirichlet, y, "fused", need_gamma=False)

    def gaps(a, b):  # summed statistics: log Z relative, the rest max abs over the largest
        a, b = (jax.tree.map(lambda x: np.asarray(x, np.float64), x, is_leaf=torch.is_tensor)
                for x in (a, b))
        return {"log_z": abs(float(a.log_z - b.log_z)) / abs(float(b.log_z)),
                **{k: float(np.abs(getattr(a, k) - getattr(b, k)).max()
                            / np.abs(getattr(b, k)).max()) for k in ("trans", "emit", "init")}}

    band = {"log_z": 1e-3, "trans": 2e-2, "emit": 2e-2, "init": 2e-2}
    for k, v in gaps(t16, j16).items():
        assert v < band[k], (k, v)
    tol = {k: 8.0 * v for k, v in gaps(t32, j32).items()}
    near, live = gaps(t16, j16), gaps(t16, t32)
    assert 0.0 < live["log_z"] < 1e-3  # the mode is live
    for k in ("log_z", "trans", "emit"):
        assert near[k] <= tol[k] < live[k], (k, near[k], tol[k], live[k])
    ll = torch.randn((T, B, K), generator=torch.Generator().manual_seed(5))
    pi_t, A_t = fused_fb.exp_params(torch.log_softmax(torch.zeros(K), 0),
                                    torch.log_softmax(torch.randn(K, K), 1))
    a32, _, sh32 = split_fb.split_forward(pi_t, A_t, ll)
    a16, s16, sh16 = split_fb.split_forward(pi_t, A_t, ll, alpha_dtype=torch.bfloat16)
    assert a16.dtype == torch.bfloat16
    torch.testing.assert_close(a16, a32.to(torch.bfloat16), rtol=0, atol=0)
    torch.testing.assert_close(s16, a16.float().sum(-1).T, rtol=0, atol=0)
    torch.testing.assert_close(sh16, sh32, rtol=0, atol=0)


@pytest.mark.parametrize("route,family", [("split", "niw"), ("fused", "multinomial_v300")])
def test_exact_pins_float32_on_the_split_pair(route, family):
    """``exact=True`` with ``bf16_alpha=True`` on the split route, and on
    "fused" where a multinomial of 300 symbols runs the split pair, gives
    float32's bits; without ``exact`` the split pair stores bf16 alpha."""
    B, T, K = 3, 12, 4
    g = torch.Generator().manual_seed(0)
    if family == "niw":
        fam, prior = GaussianNIW, make_prior(K, GaussianNIW, obs_dim=10, device="cpu")
        y = torch.randn(B, T, 10, generator=g)
    else:
        fam = MultinomialDirichlet
        prior = make_prior(K, fam, num_symbols=300, device="cpu")
        y = torch.randint(0, 300, (B, T), generator=g)
    p = init_params(torch.Generator().manual_seed(1), prior, fam, y)
    ex, _ = batch_local_step(p, fam, y, route, exact=True, bf16_alpha=True)
    f32, _ = batch_local_step(p, fam, y, route)
    bf, _ = batch_local_step(p, fam, y, route, bf16_alpha=True)
    for x, z in zip(jax.tree.leaves(ex, is_leaf=torch.is_tensor),
                    jax.tree.leaves(f32, is_leaf=torch.is_tensor)):
        torch.testing.assert_close(x, z, rtol=0, atol=0)
    assert bf.log_z != f32.log_z
    maskf, offs = torch.ones(B, T), torch.tensor([0, 5, 11])
    if route == "fused":  # the split pair has no pick
        _raises(lambda: windowed_local_step(p, fam, y, maskf, offs, route, gamma_sel=True),
                "more than 256 symbols")


@pytest.mark.parametrize("kernel", ["niw", "nig", "widen"])
def test_operand_launchers_run_their_twins(kernel):
    """The large-K statistics' operand launchers (``feature_rows``,
    ``widen_alpha``) run their twins on CPU tensors: the built rows are the
    JAX family's ``ell_features`` of the same observations (float32, the
    same products) at D = 4 and at D = 24 and 39, the widths of the WF
    backward's window tier that the build serves (NIW F = 325 and 820); the
    widened alpha the bf16 values as float32. Each refuses what its kernel
    does not take."""
    from pysvihmm_tpu.distributions import diag_gaussian as jdiag
    from pysvihmm_tpu.distributions import niw as jniw

    rng = np.random.default_rng(23)
    if kernel == "widen":
        a = torch.from_numpy(rng.uniform(size=(40, 12)).astype(np.float32)).to(torch.bfloat16)
        torch.testing.assert_close(fused_fb.widen_alpha(a), a.float(), rtol=0, atol=0)
        _raises(lambda: fused_fb.widen_alpha(a.float()), "bf16")
        return
    for D in (4, 24, 39):
        y = rng.normal(size=(50, D)).astype(np.float32)
        got = fused_fb.feature_rows(torch.from_numpy(y), kernel)
        want = (jniw if kernel == "niw" else jdiag).ell_features(jnp.asarray(y))
        assert got.shape == (50, fused_fb.feature_width(kernel, D))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=0)
    _raises(lambda: fused_fb.feature_rows(torch.from_numpy(y), None), "built kind")
    _raises(lambda: fused_fb.feature_rows(torch.from_numpy(y[None]), kernel), "built kind")
