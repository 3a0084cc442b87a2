"""Data-parallel inference over a mesh of processes (port of
``pysvihmm_tpu/parallel/data_parallel.py``): the replacement of the
reference's ``multiprocessing.Pool`` local-step fan-out.

Each process holds its shard of the sequences and runs the batch local step
on it (on the card, ``method="auto"``: the fused kernel pair); the summed
:class:`~pysvihmm_tpu_torch.engines.base.LocalStats` are then added over the
mesh's ``data`` axis by one all-reduce (JAX's ``psum`` inside
``shard_map``), and the global update runs identically on every process.
Parameters stay replicated (they are KB-scale); only sequences are sharded,
so all collective traffic is the K*K + K*stats tree once a step.
"""

from __future__ import annotations

import torch

from ..engines import metaobs, svi
from ..engines.base import LocalStats, batch_local_step, elbo_from_stats
from ..engines.batch_vb import conjugate_update
from . import collectives
from .multihost import make_mesh, mesh_device

__all__ = [
    "make_dp_metaobs_step",
    "make_dp_minibatch_svi_step",
    "make_dp_streamed_svi_step",
    "make_dp_vb_step",
    "make_mesh",
    "replicate",
    "shard_batch",
    "sharded_local_step",
]


def _shard_rows(x: torch.Tensor, n: int, rank: int, what: str) -> torch.Tensor:
    """Rows [rank n' : (rank + 1) n') of x, n' = len(x) / n."""
    if x.shape[0] % n:
        raise ValueError(f"{what} {x.shape[0]} must be divisible by the mesh axis size {n}")
    per = x.shape[0] // n
    return x[rank * per:(rank + 1) * per]


def shard_batch(obs: torch.Tensor, mesh, axis: str = "data") -> torch.Tensor:
    """This process's rows of a (B, ...) batch sharded over the mesh axis, on
    the mesh's device (JAX's ``device_put`` with ``P("data")``). B must be a
    multiple of the axis size, or ``ValueError``."""
    group = mesh.get_group(axis)
    return _shard_rows(obs, collectives.axis_size(group), collectives.axis_index(group),
                       "batch size").to(mesh_device(mesh))


def replicate(tree, mesh):
    """A replicated value: every process holds all of it, so it is returned
    as it is (JAX's ``device_put`` with ``P()``)."""
    return tree


def sharded_local_step(params, emission, obs: torch.Tensor, mesh,
                       method: str = "auto") -> LocalStats:
    """The batch local step on this process's shard obs (B_local, T, ...),
    its statistics summed over the mesh's ``data`` axis: the single-process
    :func:`batch_local_step`'s statistics of the whole batch, up to the order
    of the float sums."""
    stats, _ = batch_local_step(params, emission, obs, method, need_gamma=False)
    return collectives.psum(stats, mesh.get_group("data"))


def make_dp_vb_step(emission, mesh, method: str = "auto"):
    """Data-parallel coordinate-ascent VB step (batch VB over a mesh):
    step(params, prior, obs_shard) -> (params', ELBO at params)."""

    def step(params, prior, obs: torch.Tensor):
        stats = sharded_local_step(params, emission, obs, mesh, method)
        elbo = elbo_from_stats(params, prior, emission, stats.log_z)
        return conjugate_update(emission, prior, stats), elbo

    return step


def make_dp_minibatch_svi_step(emission, cfg: svi.SVIConfig, num_seqs: int, mesh,
                               method: str = "auto"):
    """Data-parallel minibatch-of-sequences SVI (``svi.make_minibatch_step``
    over a mesh): each process draws B/n sequences of its own shard, the
    local steps run in parallel, and the statistics are summed over the mesh
    before the replicated natural-gradient step.

    step(state, prior, obs_shard) draws a (n, B/n) array of indices into the
    shard from the state's generator, the same on every process, and takes
    its row of this process's index (JAX folds the process index into the
    step's key): the draws differ between processes and the replicated
    generator advances alike on all. ``step.with_indices(state, prior,
    obs_shard, idx)`` takes this process's (B/n,) indices instead.
    """
    group = mesh.get_group("data")
    n, rank = collectives.axis_size(group), collectives.axis_index(group)
    B = cfg.batch_size
    if B % n:
        raise ValueError(f"batch_size {B} not divisible by mesh size {n}")
    base = svi.make_minibatch_step(emission, cfg, num_seqs, method)

    def with_indices(state: svi.SVIState, prior, obs: torch.Tensor, idx: torch.Tensor):
        stats, _ = batch_local_step(state.params, emission, obs[idx.to(obs.device)], method,
                                    need_gamma=False)
        return base.update(state, prior, collectives.psum(stats, group))

    def step(state: svi.SVIState, prior, obs: torch.Tensor):
        gen = state.generator
        idx = torch.randint(0, obs.shape[0], (n, B // n), generator=gen, device=gen.device)
        return with_indices(state, prior, obs, idx[rank])

    step.with_indices = with_indices
    return step


def make_dp_streamed_svi_step(emission, cfg: svi.SVIConfig, num_seqs: int, mesh=None,
                              method: str = "auto"):
    """Minibatch-of-sequences SVI whose batches arrive from a host pipeline
    (a :class:`~pysvihmm_tpu_torch.data.loader.ShardedSequenceLoader`, which
    hands each process its own rows).

    Returns step(state, prior, batch) -> (state', metrics): the batch local
    step on this process's (B_local, T, ...) batch, the statistics summed
    over the mesh's ``data`` axis (mesh None: over every process when a
    process group is up, else this process alone), scaled by num_seqs /
    cfg.batch_size (B the global batch), and the natural-gradient update.
    The state's generator is not drawn from: the loader's order is the
    randomness.
    """
    group = collectives.world_group() if mesh is None else mesh.get_group("data")
    base = svi.make_minibatch_step(emission, cfg, num_seqs, method)

    def step(state: svi.SVIState, prior, batch: torch.Tensor):
        stats, _ = batch_local_step(state.params, emission, batch, method, need_gamma=False)
        return base.update(state, prior, collectives.psum(stats, group))

    return step


def make_dp_metaobs_step(emission, cfg: metaobs.MetaObsConfig, chain_len: int, mesh,
                         method: str = "auto"):
    """Data-parallel meta-observation SVI: the reference's Pool-parallel
    ``hmmsgd_metaobs`` engine over a mesh. The chain is replicated; the M
    blocks of a step are drawn once, from the state's generator, on every
    process (``torch.randperm(num_blocks)[:M]``, as ``metaobs.make_step``),
    and each process takes its M/n of them, like Pool tasks across workers.
    ``step.with_blocks(state, prior, obs, block_ids)`` takes the (M,) block
    ids instead of drawing them.
    """
    group = mesh.get_group("data")
    n, rank = collectives.axis_size(group), collectives.axis_index(group)
    M = cfg.minibatch
    if M % n:
        raise ValueError(f"minibatch {M} not divisible by mesh size {n}")
    base = metaobs.make_step(emission, cfg, chain_len, method)
    num_blocks = chain_len // cfg.block_len

    def with_blocks(state: svi.SVIState, prior, obs: torch.Tensor, block_ids: torch.Tensor):
        mine = _shard_rows(block_ids, n, rank, "minibatch")
        st = collectives.psum(base.block_stats(state.params, obs, mine), group)
        return base.update(state, prior, st)

    def step(state: svi.SVIState, prior, obs: torch.Tensor):
        gen = state.generator
        block_ids = torch.randperm(num_blocks, generator=gen, device=gen.device)[:M]
        return with_blocks(state, prior, obs, block_ids)

    step.with_blocks = with_blocks
    return step
