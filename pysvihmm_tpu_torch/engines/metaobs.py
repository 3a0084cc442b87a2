"""SVI over meta-observations (port of ``pysvihmm_tpu/engines/metaobs.py``;
reference ``pysvihmm/hmmsgd_metaobs.py``, its largest engine).

The chain is cut into contiguous "meta-observation" blocks of Lm steps;
each step draws a minibatch of M distinct blocks, runs the buffered local
steps of all of them as one batch of windows (the reference's
``multiprocessing.Pool.map``), sums their statistics and takes a
natural-gradient step.

Blocks are aligned and drawn without replacement, as
``torch.randperm(num_blocks)[:M]`` on the state's generator. Buffers of b
steps come from the neighbouring blocks, clipped at the chain's edges by
the kept-mask machinery shared with engines/svi.py. Transitions between
blocks are in no minibatch: the same O(1/Lm) truncation the reference's
estimator has, which the buffers bound (paper §3.2).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import messages
from ..models.hmm import HMMParams, global_kl
from ..utils.device import check_generator
from ..utils.schedules import power_schedule
from .base import LocalStats, windowed_local_step
from .svi import SVIState, _gather_windows, _natural_update, _run, init_state

__all__ = ["MetaObsConfig", "fit", "init_state", "make_step"]


class MetaObsConfig(NamedTuple):
    minibatch: int = 8  # M blocks per step
    block_len: int = 100  # Lm observations per meta-observation
    buffer: int = 10  # b buffered steps on each side
    tau: float = 1.0
    kappa: float = 0.6


def make_step(emission, cfg: MetaObsConfig, chain_len: int, method: str = "auto"):
    """Build the meta-observation SVI step for a chain of length T, a multiple
    of Lm.

    Returns step(state, prior, obs) -> (state', metrics dict), with
    ``step.with_blocks(state, prior, obs, block_ids)`` taking the (M,)
    distinct block ids instead of drawing them,
    ``step.block_stats(params, obs, block_ids)`` the blocks' summed
    statistics (:class:`LocalStats`, ``log_z`` the kept-region log
    normaliser mass) before any scaling, and ``step.update(state, prior,
    stats)`` the natural-gradient step from the statistics of M blocks. The
    window is W = Lm + 2b on every route (``messages.plan_window``).
    """
    M, Lm, b = cfg.minibatch, cfg.block_len, cfg.buffer
    T = chain_len
    if T % Lm != 0:
        raise ValueError(f"chain length {T} must be a multiple of block_len {Lm}")
    num_blocks = T // Lm
    if M > num_blocks:
        raise ValueError("minibatch larger than number of meta-observations")
    method, W, b_left = messages.plan_window(method, Lm, b, T)

    scale_init = scale_emit = num_blocks / M
    scales = (scale_init, (T - 1.0) / (M * max(Lm - 1, 1)), scale_emit)

    def block_stats(params: HMMParams, obs: torch.Tensor, block_ids: torch.Tensor) -> LocalStats:
        dtype, dev = params.init.dtype, obs.device
        block_ids = block_ids.to(dev)
        starts = block_ids * Lm
        ws = torch.clamp(starts - b_left, 0, T - W)
        offs = starts - ws
        windows = _gather_windows(obs, ws, W)
        pos = torch.arange(W, device=dev)[None, :]
        maskf = ((pos >= offs[:, None]) & (pos < offs[:, None] + Lm)).to(dtype)
        emit, trans, gamma_at_start, log_c = windowed_local_step(
            params, emission, windows, maskf, offs, method
        )
        is_first_block = (block_ids == 0).to(dtype)[:, None]
        return LocalStats(
            init=(gamma_at_start.to(dtype) * is_first_block).sum(dim=0),
            trans=trans.to(dtype),
            emit=emit,
            log_z=(log_c.to(dtype) * maskf).sum(),
        )

    def update(state: SVIState, prior: HMMParams, st: LocalStats):
        params = state.params
        rho = power_schedule(state.step.to(params.init.dtype), cfg.tau, cfg.kappa)
        new_params = _natural_update(emission, params, prior, (st.init, st.trans, st.emit),
                                     scales, rho)
        noisy_elbo = scale_emit * st.log_z - global_kl(params, prior, emission)
        metrics = {"rho": rho, "noisy_elbo": noisy_elbo}
        return SVIState(new_params, state.step + 1, state.generator, state.adapt), metrics

    def with_blocks(state: SVIState, prior: HMMParams, obs: torch.Tensor, block_ids: torch.Tensor):
        return update(state, prior, block_stats(state.params, obs, block_ids))

    def step(state: SVIState, prior: HMMParams, obs: torch.Tensor):
        gen = state.generator
        check_generator(gen, obs.device)
        block_ids = torch.randperm(num_blocks, generator=gen, device=gen.device)[:M]
        return with_blocks(state, prior, obs, block_ids)

    step.with_blocks = with_blocks
    step.block_stats = block_stats
    step.update = update
    return step


def fit(
    state: SVIState,
    prior: HMMParams,
    obs: torch.Tensor,
    emission,
    cfg: MetaObsConfig,
    num_steps: int,
    method: str = "auto",
) -> tuple[SVIState, dict]:
    """Run num_steps meta-observation SVI steps on the chain obs (T, D);
    metrics (num_steps,) per key, left on the device."""
    return _run(make_step(emission, cfg, obs.shape[0], method), state, prior, obs, num_steps)
