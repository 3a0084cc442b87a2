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
:func:`make_minibatch_step`. :func:`fit_restarts` takes the best of several
seeds by the exact lower bound, and :func:`select_buffer` chooses the
buffer length b by the paper's doubling test (§3.2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import messages
from ..distributions import diag_gaussian, dirichlet, niw
from ..models.hmm import HMMParams, expected_log_params, global_kl, init_params
from ..utils.device import check_generator, restart_generators
from ..utils.schedules import AdaptiveState, adaptive_init, adaptive_update, power_schedule
from .base import batch_local_step, lower_bound, windowed_local_step


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


def make_step(emission, cfg: SVIConfig, chain_len: int, method: str = "auto",
              in_kernel_feats: bool = False, gamma_sel: bool = False,
              bf16_alpha: bool = False):
    """Build the SVI step for a single chain of length T.

    Returns step(state, prior, obs) -> (state', metrics dict) with
    ``step.with_starts(state, prior, obs, starts)`` taking the (B,) subchain
    starts in [0, T-L] instead of drawing them. ``in_kernel_feats``,
    ``gamma_sel`` and ``bf16_alpha`` are the kernel modes of
    ``base.windowed_local_step``, passed down as ``method`` is.
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
            params, emission, windows, maskf, offs, method, in_kernel_feats, gamma_sel,
            bf16_alpha
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
    idx)`` taking the (B,) sequence indices instead of drawing them,
    ``step.with_batch(state, prior, batch)`` taking the (B, T, ...) batch
    itself (a streamed corpus' batch) and ``step.update(state, prior,
    stats)`` the natural-gradient step from a batch's summed
    :class:`~.base.LocalStats` (the data-parallel steps of ``parallel`` sum
    them over processes first).
    """
    B, N = cfg.batch_size, num_seqs
    scale = N / B
    scales = (scale, scale, scale)

    def update(state: SVIState, prior: HMMParams, stats):
        params = state.params
        dtype = params.init.dtype
        local = (stats.init.to(dtype), stats.trans.to(dtype), stats.emit)
        target = None
        if cfg.adaptive:
            target = _natural_update(emission, params, prior, local, scales, 1.0)
        rho, new_adapt = _resolve_rho(state, cfg, target)
        new_params = _natural_update(emission, params, prior, local, scales, rho)
        noisy_elbo = scale * stats.log_z.to(dtype) - global_kl(params, prior, emission)
        metrics = {"rho": rho, "noisy_elbo": noisy_elbo}
        return SVIState(new_params, state.step + 1, state.generator, new_adapt), metrics

    def with_batch(state: SVIState, prior: HMMParams, batch: torch.Tensor):
        stats, _ = batch_local_step(state.params, emission, batch, method, need_gamma=False)
        return update(state, prior, stats)

    def with_indices(state: SVIState, prior: HMMParams, obs: torch.Tensor, idx: torch.Tensor):
        return with_batch(state, prior, obs[idx.to(obs.device)])

    def step(state: SVIState, prior: HMMParams, obs: torch.Tensor):
        gen = state.generator
        idx = torch.randint(0, N, (B,), generator=gen, device=gen.device)
        return with_indices(state, prior, obs, idx)

    step.with_indices = with_indices
    step.with_batch = with_batch
    step.update = update
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


def fit_restarts_from(
    inits: list[HMMParams],
    generators: list[torch.Generator],
    prior: HMMParams,
    obs: torch.Tensor,
    emission,
    cfg: SVIConfig,
    num_steps: int,
    method: str = "auto",
) -> tuple[SVIState, torch.Tensor, int]:
    """One SVI fit on the chain obs (T, D) from each initial params, each
    drawing its subchains from its own generator; the winner by the EXACT
    full-chain lower bound at its final params (the noisy ELBO is too noisy
    to rank restarts). Returns (best final state, exact final ELBOs (R,),
    best index)."""
    states, elbos = [], []
    for p0, gen in zip(inits, generators, strict=True):
        check_generator(gen, obs.device)
        st, _ = fit(init_state(p0, gen, adaptive=cfg.adaptive), prior, obs, emission, cfg,
                    num_steps, method)
        states.append(st)
        elbos.append(lower_bound(st.params, prior, emission, obs[None], method))
    elbos = torch.stack(elbos)
    best = int(torch.argmax(elbos))
    return states[best], elbos, best


def fit_restarts(
    generator: torch.Generator,
    prior: HMMParams,
    obs: torch.Tensor,
    emission,
    cfg: SVIConfig,
    num_steps: int,
    num_restarts: int = 8,
    method: str = "auto",
) -> tuple[SVIState, torch.Tensor, int]:
    """Best-of-N-seeds single-chain SVI: restarts differ by init and by
    subchain draws, each from its own generator
    (:func:`utils.device.restart_generators`), and run one after another
    (JAX vmaps them). See :func:`fit_restarts_from`."""
    check_generator(generator, obs.device)
    gens = restart_generators(generator, num_restarts)
    inits = [init_params(g, prior, emission, obs) for g in gens]
    return fit_restarts_from(inits, gens, prior, obs, emission, cfg, num_steps, method)


def _buffer_gap(
    params: HMMParams, chain: torch.Tensor, emission, L: int, b: int, starts: torch.Tensor
) -> torch.Tensor:
    """max |gamma_b - gamma_2b| over the kept L steps of the windows of
    length L + 4b at ``starts``: the marginals with buffer b (the middle
    L + 2b steps of each window) against those with buffer 2b (the whole
    window). Both E-steps run through ``messages.e_step_batched`` on "auto",
    the split kernels on the card. Returns a 0-d tensor on chain's device."""
    b2 = 2 * b
    log_pi, log_A = expected_log_params(params)
    wins = _gather_windows(chain, starts, L + 2 * b2)
    ll2 = emission.expected_log_likelihood(params.emit, wins)
    ll1 = ll2[:, b2 - b : b2 - b + L + 2 * b].contiguous()
    g2 = messages.e_step_batched(log_pi, log_A, ll2).gamma[:, b2 : b2 + L]
    g1 = messages.e_step_batched(log_pi, log_A, ll1).gamma[:, b : b + L]
    return (g1 - g2).abs().max()


def select_buffer(
    params: HMMParams,
    chain: torch.Tensor,
    emission,
    subchain_len: int,
    generator: torch.Generator,
    tol: float = 1e-3,
    b_init: int = 1,
    b_max: int | None = None,
    probes: int = 8,
) -> int:
    """Adaptive buffer length (Foti et al. 2014 §3.2).

    The error of buffered subchain marginals decays geometrically in the
    buffer b. Starting from ``b_init``, compare the kept-region marginals
    with buffer b against those with 2b on ``probes`` random subchains
    (:func:`_buffer_gap`); when they agree to ``tol`` (max-abs over gamma),
    b is enough, else double it. Starts are drawn on the generator's device,
    which must be the chain's; each candidate reads one number back to the
    host. Run once against the current params before (or during) training.
    """
    check_generator(generator, chain.device)
    T, L = chain.shape[0], subchain_len
    if b_max is None:
        b_max = max(1, min(L, (T - L) // 4, 64))
    b = max(1, b_init)
    while True:
        W2 = L + 4 * b
        if 2 * b > b_max or W2 > T:
            return min(b, b_max)
        starts = torch.randint(0, T - W2 + 1, (probes,), generator=generator,
                               device=generator.device)
        if float(_buffer_gap(params, chain, emission, L, b, starts)) < tol:
            return b
        b = 2 * b
