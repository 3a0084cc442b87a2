"""State-parallel inference for very large K (port of
``pysvihmm_tpu/parallel/state_parallel.py``): the engine layer over
``messages.state_sharded``, the tensor-parallelism analog.

Everything state-indexed is sharded by K-blocks over a ``state`` mesh axis:
the rows of the Dirichlet posteriors, the per-state emission parameters,
the (T, K) likelihoods and marginals and the statistics. Outside the
message pass every update is per state (conjugate row updates, digamma
expectations, emission statistics over time), so each process computes its
block alone. JAX's GSPMD propagates that sharding by itself and inserts
the few collectives it needs; the port writes them out: E[log pi] and the
initial-state KL need the whole (K,) initial posterior (one all-gather of
K floats), the message pass gathers log A's columns once, and the ELBO's
KL terms are summed over the axis.
"""

from __future__ import annotations

import torch

from ..distributions import dirichlet
from ..engines.base import LocalStats
from ..engines.batch_vb import conjugate_update
from ..messages import state_sharded
from ..models.hmm import emission_flat_stats
from ..utils.precision import f32_matmuls
from . import collectives
from .data_parallel import _shard_rows
from .time_parallel import run_vb_scan


def shard_params_by_state(params, mesh, axis: str = "state"):
    """This process's block of every K-leading leaf of params (or a prior):
    rows [d K/D, (d + 1) K/D) of each. K must be a multiple of the axis
    size, or ``ValueError``."""
    group = mesh.get_group(axis)
    D, idx = collectives.axis_size(group), collectives.axis_index(group)

    def put(x):
        if isinstance(x, torch.Tensor):
            return _shard_rows(x, D, idx, "K")
        parts = [put(c) for c in x]
        return type(x)(*parts) if hasattr(x, "_fields") else type(x)(parts)

    return put(params)


def make_ss_vb_step(emission, mesh, axis: str = "state"):
    """Coordinate-ascent VB step on ONE chain with K sharded:
    step(params_block, prior_block, obs) -> (params_block', ELBO at params),
    obs (T, D) floats or (T,) int tokens, replicated (observations are small
    next to the K-sized state)."""
    group = mesh.get_group(axis)
    idx = collectives.axis_index(group)

    def step(params, prior, obs: torch.Tensor):
        f32_matmuls()
        Kd = params.init.shape[0]
        init_all = collectives.all_gather(params.init, group, tiled=True)  # (K,)
        log_pi = dirichlet.expected_log_probs(init_all)[idx * Kd:(idx + 1) * Kd]
        log_A = dirichlet.expected_log_probs(params.trans)  # row-local
        ll = emission.expected_log_likelihood(params.emit, obs)  # (T, K/D)
        fb = state_sharded.state_sharded_forward_backward(log_pi, log_A, ll, mesh, axis)
        emit_stats = emission_flat_stats(emission, params.emit, fb.gamma, obs)
        block_kl = (dirichlet.kl(params.trans, prior.trans).sum()
                    + emission.kl(params.emit, prior.emit))
        kl = (dirichlet.kl(init_all, collectives.all_gather(prior.init, group, tiled=True))
              + collectives.psum(block_kl, group))
        stats = LocalStats(init=fb.init_stats, trans=fb.trans_stats, emit=emit_stats,
                           log_z=fb.log_z)
        return conjugate_update(emission, prior, stats), fb.log_z - kl

    return step


def fit_large_k(params, prior, obs: torch.Tensor, emission, mesh, num_iters: int = 100,
                axis: str = "state"):
    """Batch VB on one chain with the state axis sharded: params and prior
    whole on every process, each keeping its block. Returns (this process's
    block of the fitted params, the (num_iters,) ELBOs)."""
    step = make_ss_vb_step(emission, mesh, axis)
    return run_vb_scan(step, shard_params_by_state(params, mesh, axis),
                       shard_params_by_state(prior, mesh, axis), obs, num_iters)
