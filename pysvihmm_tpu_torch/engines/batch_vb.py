"""Batch mean-field VB by coordinate ascent (port of
``pysvihmm_tpu/engines/batch_vb.py``).

Per iteration: a full local step over all sequences, then the exact
conjugate global update (the Dirichlet posteriors and the emission family's). The ELBO sequence
is non-decreasing, a real invariant of coordinate-ascent VB. ``lax.scan``
over iterations becomes a Python loop.
"""

from __future__ import annotations

from collections.abc import Callable

import torch

from .. import messages
from ..distributions import dirichlet
from ..models.hmm import HMMParams, init_params
from ..utils.device import check_generator, restart_generators
from .base import (
    FEATURE_ROUTES,
    batch_local_step,
    elbo_from_stats,
    long_chain_local_stats,
    prepare_fused_obs,
)

Step = Callable[..., tuple[HMMParams, torch.Tensor]]


def conjugate_update(emission, prior: HMMParams, stats) -> HMMParams:
    """The exact conjugate global update from summed :class:`~.base.LocalStats`
    (the Dirichlet posteriors and the emission family's); every batch-VB
    step ends with it, the sharded ones of ``parallel`` too."""
    return HMMParams(
        init=dirichlet.posterior(prior.init, stats.init),
        trans=dirichlet.posterior(prior.trans, stats.trans),
        emit=emission.posterior(prior.emit, stats.emit),
    )


def make_step(emission, method: str = "auto", in_kernel_feats: bool = False,
              bf16_alpha: bool = False) -> Step:
    """The coordinate-ascent step: (params, prior, obs, prepared=None) ->
    (params', ELBO at params). ``prepared`` is the fused and duplex routes'
    feature array (:func:`prepare_fused_obs`, with ``in_kernel_feats`` its
    raw observations), built once outside the loop. ``in_kernel_feats`` and
    ``bf16_alpha`` are the kernel modes of ``base.batch_local_step``, passed
    down as ``method`` is."""

    def step(params: HMMParams, prior: HMMParams, obs: torch.Tensor, prepared=None):
        stats, _ = batch_local_step(
            params, emission, obs, method, need_gamma=False, prepared=prepared,
            in_kernel_feats=in_kernel_feats, bf16_alpha=bf16_alpha,
        )
        elbo = elbo_from_stats(params, prior, emission, stats.log_z)
        return conjugate_update(emission, prior, stats), elbo

    return step


def make_long_chain_step(emission, block_size: int = 256, impl: str = "fused",
                         time_minor: bool = False) -> Step:
    """The coordinate-ascent step on ONE very long chain: (params, prior,
    chain) -> (params', ELBO at params), chain (T, D), (T,) int tokens or,
    time_minor, (D, T). The E-step streams through
    :func:`engines.base.long_chain_local_stats` (default the
    likelihood-fused tier), so neither gamma nor a (T, K) array exists."""

    def step(params: HMMParams, prior: HMMParams, chain: torch.Tensor):
        stats = long_chain_local_stats(params, emission, chain, block_size, impl=impl,
                                       time_minor=time_minor)
        elbo = elbo_from_stats(params, prior, emission, stats.log_z)
        return conjugate_update(emission, prior, stats), elbo

    return step


def fit(
    params: HMMParams,
    prior: HMMParams,
    obs: torch.Tensor,
    emission,
    num_iters: int = 100,
    method: str = "auto",
) -> tuple[HMMParams, torch.Tensor]:
    """Run ``num_iters`` coordinate-ascent iterations.

    Returns (final params, ELBO history (num_iters,) on obs' device). On the
    fused and duplex routes the data-only feature array is built once,
    outside the loop.
    """
    method = messages.resolve_method(method, obs.device)
    prepared = (prepare_fused_obs(params, emission, obs, method=method)
                if method in FEATURE_ROUTES else None)
    step = make_step(emission, method)
    elbos = []
    for _ in range(num_iters):
        params, elbo = step(params, prior, obs, prepared=prepared)
        elbos.append(elbo)
    return params, torch.stack(elbos)


def fit_restarts_from(
    inits: list[HMMParams],
    prior: HMMParams,
    obs: torch.Tensor,
    emission,
    num_iters: int = 100,
    method: str = "auto",
) -> tuple[HMMParams, torch.Tensor, int]:
    """One :func:`fit` from each initial params, one after another (JAX vmaps
    them); the winner by final ELBO. Returns (best params, ELBO histories
    (R, num_iters), best index); ``elbos[best, -1]`` is the winning ELBO."""
    finals, elbos = [], []
    for p0 in inits:
        p, e = fit(p0, prior, obs, emission, num_iters, method)
        finals.append(p)
        elbos.append(e)
    elbos = torch.stack(elbos)
    best = int(torch.argmax(elbos[:, -1]))
    return finals[best], elbos, best


def fit_restarts(
    generator: torch.Generator,
    prior: HMMParams,
    obs: torch.Tensor,
    emission,
    num_iters: int = 100,
    num_restarts: int = 8,
    method: str = "auto",
) -> tuple[HMMParams, torch.Tensor, int]:
    """Best-of-N-seeds batch VB. Coordinate ascent is deterministic given its
    init, and a single seed can stop in a merged-state optimum; each restart
    draws its init from its own generator
    (:func:`utils.device.restart_generators`) on ``generator``'s device,
    which must be obs'. See :func:`fit_restarts_from`."""
    check_generator(generator, obs.device)
    inits = [init_params(g, prior, emission, obs)
             for g in restart_generators(generator, num_restarts)]
    return fit_restarts_from(inits, prior, obs, emission, num_iters, method)
