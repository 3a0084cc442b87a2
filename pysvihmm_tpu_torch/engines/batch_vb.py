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
from ..models.hmm import HMMParams
from .base import FEATURE_ROUTES, batch_local_step, elbo_from_stats, prepare_fused_obs

Step = Callable[..., tuple[HMMParams, torch.Tensor]]


def make_step(emission, method: str = "auto") -> Step:
    """The coordinate-ascent step: (params, prior, obs, prepared=None) ->
    (params', ELBO at params). ``prepared`` is the fused and duplex routes'
    feature array (:func:`prepare_fused_obs`), built once outside the loop."""

    def step(params: HMMParams, prior: HMMParams, obs: torch.Tensor, prepared=None):
        stats, _ = batch_local_step(
            params, emission, obs, method, need_gamma=False, prepared=prepared
        )
        elbo = elbo_from_stats(params, prior, emission, stats.log_z)
        new_params = HMMParams(
            init=dirichlet.posterior(prior.init, stats.init),
            trans=dirichlet.posterior(prior.trans, stats.trans),
            emit=emission.posterior(prior.emit, stats.emit),
        )
        return new_params, elbo

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
    prepared = prepare_fused_obs(params, emission, obs) if method in FEATURE_ROUTES else None
    step = make_step(emission, method)
    elbos = []
    for _ in range(num_iters):
        params, elbo = step(params, prior, obs, prepared=prepared)
        elbos.append(elbo)
    return params, torch.stack(elbos)
