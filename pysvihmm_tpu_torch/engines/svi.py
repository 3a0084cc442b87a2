"""Stochastic variational inference over minibatched, buffered subchains
(port of ``pysvihmm_tpu/engines/svi.py``).

Foti, Xu, Laird, Fox (NIPS 2014) Algorithm 1: sample B length-L subchains
from one long chain, extend each by a buffer of b steps per side, run
forward-backward on the L+2b window, keep only the middle-L expected
sufficient statistics, scale them to be unbiased for the full chain, and
take a natural-gradient step with rho_t = (t + tau)^(-kappa).

Design notes:
  * Subchain windows have a fixed shape (B, L+2b): starts are drawn on the
    state's generator, windows gathered with one index gather, and
    chain-edge clipping is expressed through a per-window 0/1 kept-mask.
  * The step count and the adaptive step-size state are tensors on the
    parameters' device, and nothing in a step reads a value back to the
    host, so :func:`fit` is a Python loop that the host runs ahead of the
    card.
  * ``step(state, prior, obs)`` draws the starts from the state's
    ``torch.Generator`` and calls ``step.with_starts(state, prior, obs,
    starts)``, which does the rest; the minibatch step has the same split
    (``with_indices``). Tests feed both the draws JAX made.
  * Scaling factors (the estimator's unbiasedness constants): transitions
    (T-1)/(B(L-1)), emissions T/(BL), initial state (T-L+1)/B gated on a
    window actually starting at t=0. Convention note (audited): each
    window contributes EXACTLY L-1 units of pairwise mass (every xi_t
    sums to 1), so (T-1)/(B(L-1)) makes the TOTAL transition pseudo-count
    mass exactly unbiased (E = T-1); per-position it runs (T-1)/(T-L+1)
    hot in the interior and cool at the chain edges (positions covered by
    fewer uniform starts) — an O(L/T) distortion matching the paper's
    convention and the reference's sampler [MED]. The alternative
    (T-L+1)/(B(L-1)) would be interior-position-unbiased but undercount
    total mass; do not "fix" one into the other without moving the
    tests/test_svi.py unbiasedness assertions deliberately.

Multi-sequence datasets (minibatches over sequences) are handled by
:func:`make_minibatch_step`. ``fit_restarts`` and ``select_buffer`` are
still to be ported (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import messages
from ..distributions import diag_gaussian, dirichlet, niw
from ..models.hmm import HMMParams, global_kl
from ..utils.schedules import AdaptiveState, adaptive_init, adaptive_update, power_schedule
from .base import batch_local_step, windowed_local_step


class SVIConfig(NamedTuple):
    """Hyperparameters of the subchain-SVI estimator (reference ctor kwargs)."""

    batch_size: int = 32  # B subchains per step
    subchain_len: int = 50  # L kept positions per subchain
    buffer: int = 10  # b buffer steps on each side (paper §3.2)
    tau: float = 1.0  # step-size delay
    kappa: float = 0.6  # forgetting rate, in (0.5, 1]
    adaptive: bool = False  # elastic step-size adaptation (Ranganath et al.)


class SVIState(NamedTuple):
    params: HMMParams
    step: torch.Tensor  # () int32 on the params' device
    generator: torch.Generator  # draws the subchain starts (JAX: the PRNG key)
    adapt: AdaptiveState | None = None  # when cfg.adaptive


def _emit_leaves(emit) -> list[torch.Tensor]:
    """The emission params' tensors: the fields of an NIW, NIG or GammaP, or
    the multinomial's (K, V) tensor itself."""
    return [emit] if isinstance(emit, torch.Tensor) else list(emit)


def init_state(
    params: HMMParams, generator: torch.Generator, adaptive: bool = False
) -> SVIState:
    dev = params.init.device
    adapt = None
    if adaptive:
        dim = sum(x.numel() for x in (params.init, params.trans, *_emit_leaves(params.emit)))
        adapt = adaptive_init(dim, params.init.dtype, device=dev)
    return SVIState(
        params=params,
        step=torch.zeros((), dtype=torch.int32, device=dev),
        generator=generator,
        adapt=adapt,
    )


def _nat_flat(params: HMMParams) -> torch.Tensor:
    """Flatten global params in NATURAL coordinates (where the conjugate SVI
    update is linear) for the adaptive-step moment estimates."""
    emit = params.emit
    if isinstance(emit, niw.NIW):
        emit = niw.to_natural(emit)
    elif isinstance(emit, diag_gaussian.NIG):
        emit = diag_gaussian.to_natural(emit)
    leaves = [params.init, params.trans, *_emit_leaves(emit)]
    return torch.cat([x.reshape(-1) for x in leaves])


def _resolve_rho(state: SVIState, cfg: SVIConfig, target: HMMParams | None):
    """rho_t from the power schedule, or the elastic adaptive rule driven by
    the natural-gradient (target - params) moments. Returns (rho,
    new_adapt_state)."""
    if not cfg.adaptive:
        rho = power_schedule(state.step.to(state.params.init.dtype), cfg.tau, cfg.kappa)
        return rho, state.adapt
    grad = _nat_flat(target) - _nat_flat(state.params)
    new_adapt, rho = adaptive_update(state.adapt, grad)
    return rho, new_adapt


def _gather_windows(obs: torch.Tensor, window_starts: torch.Tensor, W: int) -> torch.Tensor:
    """B windows obs[s : s+W] of a (T, D) float chain, or of a (T,) int chain
    (the multinomial: windows (B, W)), as ONE gather over (B, W) row
    indices, clipped into the chain so that even a bad caller stays in
    bounds (JAX's ``mode="clip"``). Starts are pre-clipped to [0, T-W] by
    the callers."""
    idx = window_starts[:, None] + torch.arange(W, device=window_starts.device)
    return obs[idx.clamp(0, obs.shape[0] - 1)]


def _natural_update(emission, params, prior, stats, scales, rho) -> HMMParams:
    """One natural-gradient step of every parameter group: stats are
    (init, trans, emit), scales the matching unbiasedness factors."""
    (init, trans, emit), (s_init, s_trans, s_emit) = stats, scales
    return HMMParams(
        init=dirichlet.nat_grad_step(params.init, prior.init, init, s_init, rho),
        trans=dirichlet.nat_grad_step(params.trans, prior.trans, trans, s_trans, rho),
        emit=emission.nat_grad_step(params.emit, prior.emit, emit, s_emit, rho),
    )


def make_step(emission, cfg: SVIConfig, chain_len: int, method: str = "auto"):
    """Build the SVI step for a single chain of length T.

    Returns step(state, prior, obs) -> (state', metrics dict) with
    ``step.with_starts(state, prior, obs, starts)`` taking the (B,) subchain
    starts in [0, T-L] instead of drawing them.
    """
    B, L, b = cfg.batch_size, cfg.subchain_len, cfg.buffer
    T = chain_len
    method, W, b_left = messages.plan_window(method, L, b, T)
    num_starts = T - L + 1

    scales = (num_starts / B, (T - 1.0) / (B * max(L - 1, 1)), T / (B * L))
    scale_emit = scales[2]

    def with_starts(state: SVIState, prior: HMMParams, obs: torch.Tensor, starts: torch.Tensor):
        params = state.params
        dtype, dev = params.init.dtype, obs.device
        starts = starts.to(dev)
        ws = torch.clamp(starts - b_left, 0, T - W)  # clipped window starts
        offs = starts - ws  # kept-region offset inside each window
        windows = _gather_windows(obs, ws, W)  # (B, W, D), or (B, W) int

        pos = torch.arange(W, device=dev)[None, :]
        mask = (pos >= offs[:, None]) & (pos < offs[:, None] + L)  # (B, W)
        maskf = mask.to(dtype)

        emit_stats, trans_stats, gamma_at_start, log_c = windowed_local_step(
            params, emission, windows, maskf, offs, method
        )

        # Initial-state stats: gamma at the chain start, only for windows
        # whose subchain begins at t=0; unbiased via inverse inclusion prob.
        is_chain_start = (starts == 0).to(dtype)[:, None]
        init_stats = (gamma_at_start.to(dtype) * is_chain_start).sum(dim=0)

        stats = (init_stats, trans_stats.to(dtype), emit_stats)
        target = None
        if cfg.adaptive:  # the rho=1 step: what the adaptive rule measures the gradient to
            target = _natural_update(emission, params, prior, stats, scales, 1.0)
        rho, new_adapt = _resolve_rho(state, cfg, target)
        new_params = _natural_update(emission, params, prior, stats, scales, rho)

        # Noisy lower-bound estimate: scaled kept-region log-normaliser mass
        # minus the global KL (the reference's "stochastic lower bound").
        local_mass = (log_c.to(dtype) * maskf).sum()
        noisy_elbo = scale_emit * local_mass - global_kl(params, prior, emission)

        metrics = {"rho": rho, "noisy_elbo": noisy_elbo}
        new_state = SVIState(new_params, state.step + 1, state.generator, new_adapt)
        return new_state, metrics

    def step(state: SVIState, prior: HMMParams, obs: torch.Tensor):
        gen = state.generator
        starts = torch.randint(0, num_starts, (B,), generator=gen, device=gen.device)
        return with_starts(state, prior, obs, starts)

    step.with_starts = with_starts
    return step


def make_minibatch_step(emission, cfg: SVIConfig, num_seqs: int, method: str = "auto"):
    """SVI over minibatches of whole sequences from a (N, T, D) dataset.

    B sequences drawn with replacement per step, stats scaled by N/B; with
    B=N and rho=1 it is batch natural-gradient VB. Returns step(state, prior,
    obs) -> (state', metrics) with ``step.with_indices(state, prior, obs,
    idx)`` taking the (B,) sequence indices instead of drawing them.
    """
    B, N = cfg.batch_size, num_seqs
    scale = N / B
    scales = (scale, scale, scale)

    def with_indices(state: SVIState, prior: HMMParams, obs: torch.Tensor, idx: torch.Tensor):
        params = state.params
        dtype = params.init.dtype
        batch = obs[idx.to(obs.device)]
        stats, _ = batch_local_step(params, emission, batch, method, need_gamma=False)
        local = (stats.init.to(dtype), stats.trans.to(dtype), stats.emit)
        target = None
        if cfg.adaptive:
            target = _natural_update(emission, params, prior, local, scales, 1.0)
        rho, new_adapt = _resolve_rho(state, cfg, target)
        new_params = _natural_update(emission, params, prior, local, scales, rho)
        noisy_elbo = scale * stats.log_z.to(dtype) - global_kl(params, prior, emission)
        metrics = {"rho": rho, "noisy_elbo": noisy_elbo}
        return SVIState(new_params, state.step + 1, state.generator, new_adapt), metrics

    def step(state: SVIState, prior: HMMParams, obs: torch.Tensor):
        gen = state.generator
        idx = torch.randint(0, N, (B,), generator=gen, device=gen.device)
        return with_indices(state, prior, obs, idx)

    step.with_indices = with_indices
    return step


def _run(step, state: SVIState, prior: HMMParams, obs: torch.Tensor, num_steps: int):
    """num_steps chained steps; metrics stacked per key, all left on the card."""
    history = []
    for _ in range(num_steps):
        state, m = step(state, prior, obs)
        history.append(m)
    metrics = {k: torch.stack([m[k] for m in history]) for k in history[0]}
    return state, metrics


def fit(
    state: SVIState,
    prior: HMMParams,
    obs: torch.Tensor,
    emission,
    cfg: SVIConfig,
    num_steps: int,
    method: str = "auto",
) -> tuple[SVIState, dict]:
    """Run num_steps SVI updates on one chain obs (T, D); metrics (num_steps,)."""
    return _run(make_step(emission, cfg, obs.shape[0], method), state, prior, obs, num_steps)


def fit_minibatch(
    state: SVIState,
    prior: HMMParams,
    obs: torch.Tensor,
    emission,
    cfg: SVIConfig,
    num_steps: int,
    method: str = "auto",
) -> tuple[SVIState, dict]:
    """Run num_steps minibatch-of-sequences SVI updates over obs (N, T, D)."""
    step = make_minibatch_step(emission, cfg, obs.shape[0], method)
    return _run(step, state, prior, obs, num_steps)
