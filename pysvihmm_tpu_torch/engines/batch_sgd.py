"""Batch VB by natural-gradient SGD (port of
``pysvihmm_tpu/engines/batch_sgd.py``; reference ``hmmbatchsgd.py``).

The same full-data local step as coordinate ascent (engines/batch_vb.py),
but the global update is the damped natural-gradient blend
lambda <- (1 - rho_t) lambda + rho_t (prior + full-data stats) with
rho_t = (t + tau)^(-kappa): the bridge between batch VB and SVI. With
rho = 1 it is batch VB's step. The step count rides in the state, so a fit
can run in segments without restarting the schedule.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import messages
from ..models.hmm import HMMParams
from ..utils.schedules import power_schedule
from .base import FEATURE_ROUTES, batch_local_step, elbo_from_stats, prepare_fused_obs
from .svi import _natural_update


class BatchSGDState(NamedTuple):
    params: HMMParams
    step: torch.Tensor  # () int32 on the params' device


def make_step(emission, tau: float = 1.0, kappa: float = 0.6, method: str = "auto"):
    """The natural-gradient step: (state, prior, obs, prepared=None) ->
    (state', ELBO at state.params). ``prepared`` is the fused and duplex
    routes' feature array (:func:`prepare_fused_obs`), built once outside
    the loop."""

    def step(state: BatchSGDState, prior: HMMParams, obs: torch.Tensor, prepared=None):
        params = state.params
        stats, _ = batch_local_step(
            params, emission, obs, method, need_gamma=False, prepared=prepared
        )
        elbo = elbo_from_stats(params, prior, emission, stats.log_z)
        rho = power_schedule(state.step.to(params.init.dtype), tau, kappa)
        local = (stats.init, stats.trans, stats.emit)
        new_params = _natural_update(emission, params, prior, local, (1.0, 1.0, 1.0), rho)
        return BatchSGDState(params=new_params, step=state.step + 1), elbo

    return step


def init_state(params: HMMParams) -> BatchSGDState:
    return BatchSGDState(
        params=params, step=torch.zeros((), dtype=torch.int32, device=params.init.device)
    )


def fit_state(
    state: BatchSGDState,
    prior: HMMParams,
    obs: torch.Tensor,
    emission,
    num_iters: int = 100,
    tau: float = 1.0,
    kappa: float = 0.6,
    method: str = "auto",
) -> tuple[BatchSGDState, torch.Tensor]:
    """``num_iters`` steps from ``state``; returns (final state, ELBO history
    (num_iters,) on obs' device). On the fused and duplex routes the
    data-only feature array is built once, outside the loop."""
    method = messages.resolve_method(method, obs.device)
    prepared = (prepare_fused_obs(state.params, emission, obs, method=method)
                if method in FEATURE_ROUTES else None)
    step = make_step(emission, tau, kappa, method)
    elbos = []
    for _ in range(num_iters):
        state, elbo = step(state, prior, obs, prepared=prepared)
        elbos.append(elbo)
    return state, torch.stack(elbos)


def fit(
    params: HMMParams,
    prior: HMMParams,
    obs: torch.Tensor,
    emission,
    num_iters: int = 100,
    tau: float = 1.0,
    kappa: float = 0.6,
    method: str = "auto",
) -> tuple[HMMParams, torch.Tensor]:
    """:func:`fit_state` from step 0; returns (final params, ELBO history)."""
    final, elbos = fit_state(
        init_state(params), prior, obs, emission, num_iters, tau, kappa, method
    )
    return final.params, elbos
