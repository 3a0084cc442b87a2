"""Time-parallel inference on ONE long chain (port of
``pysvihmm_tpu/parallel/time_parallel.py``): the engine layer over
``messages.time_sharded``, the context-parallelism analog.

The complement of subchain SVI: exact full-chain batch VB where the time
axis of a long chain is sharded over a ``time`` mesh axis, each iteration
running forward-backward at sequential depth T/D with two small boundary
collectives. Likelihoods and emission statistics are per-step maps and
sums, so each process computes them on its tile; the statistics are summed
over the axis (what GSPMD inserts for JAX). ``lax.scan`` over iterations
becomes a Python loop (:func:`run_vb_scan`).
"""

from __future__ import annotations

import torch

from ..engines.base import LocalStats, _long_chain_ell_fn, elbo_from_stats
from ..engines.batch_vb import conjugate_update
from ..messages import time_sharded
from ..models.hmm import emission_flat_stats, expected_log_params
from ..utils.precision import f32_matmuls
from . import collectives
from .multihost import make_mesh, mesh_device


def make_time_mesh(num_devices: int | None = None, device_type: str | None = None,
                   axis: str = "time"):
    """1-D time mesh over every process (:func:`~.multihost.make_mesh`)."""
    return make_mesh(num_devices, device_type, axis)


def shard_chain(obs: torch.Tensor, mesh, axis: str = "time",
                time_minor: bool = False) -> torch.Tensor:
    """This process's contiguous tile of one chain whose time axis is sharded
    over the mesh, on the mesh's device: rows of a (T, ...) chain, or with
    time_minor the last axis of a feature-major (D, T) chain. T must be a
    multiple of the axis size, or ``ValueError``."""
    group = mesh.get_group(axis)
    D, idx = collectives.axis_size(group), collectives.axis_index(group)
    dim = -1 if (time_minor and obs.ndim >= 2) else 0
    T = obs.shape[dim]
    if T % D != 0:
        raise ValueError(f"T={T} must be divisible by time-axis size {D}")
    return obs.narrow(dim, idx * (T // D), T // D).to(mesh_device(mesh))


def time_sharded_local_step(params, emission, obs: torch.Tensor, mesh,
                            axis: str = "time") -> tuple[LocalStats, torch.Tensor]:
    """Exact local update on one time-sharded chain: obs (C, D) floats or (C,)
    int tokens, this process's tile. Returns (statistics summed over the
    chain, replicated; this tile's gamma (C, K)): ``batch_local_step(params,
    emission, chain[None])``'s statistics."""
    f32_matmuls()
    log_pi, log_A = expected_log_params(params)
    ll = emission.expected_log_likelihood(params.emit, obs)
    fb = time_sharded.time_sharded_forward_backward(log_pi, log_A, ll, mesh, axis)
    emit = collectives.psum(emission_flat_stats(emission, params.emit, fb.gamma, obs),
                            mesh.get_group(axis))
    return LocalStats(init=fb.init_stats, trans=fb.trans_stats, emit=emit,
                      log_z=fb.log_z), fb.gamma


def time_sharded_stream_stats(params, emission, obs: torch.Tensor, mesh, axis: str = "time",
                              block_size: int = 256, impl: str = "fused",
                              time_minor: bool = False) -> LocalStats:
    """Streaming exact local statistics of one time-sharded chain (the
    sharded ``engines.base.long_chain_local_stats``): gamma never exists.
    impl "fused" (default) computes the likelihoods a chunk at a time from
    the observation tile (pass a feature-major (D, C) tile with
    time_minor=True); "twophase" materialises the tile's (C, K)
    likelihoods."""
    f32_matmuls()
    log_pi, log_A = expected_log_params(params)

    def stat_fn(g, y):
        return emission_flat_stats(emission, params.emit, g, y)

    if impl == "fused":
        r = time_sharded.time_sharded_fused_stats(
            log_pi, log_A, obs, _long_chain_ell_fn(params, emission), mesh, axis=axis,
            block_size=block_size, stat_fn=stat_fn, stat_init=emission.zero_stats(params.emit),
            time_minor=time_minor)
    elif impl == "twophase":
        if time_minor:
            raise ValueError("time_minor requires impl='fused'")
        ll = emission.expected_log_likelihood(params.emit, obs)
        r = time_sharded.time_sharded_long_chain_stats(
            log_pi, log_A, ll, mesh, axis=axis, block_size=block_size, stat_xs=obs,
            stat_fn=stat_fn, stat_init=emission.zero_stats(params.emit))
    else:
        raise ValueError(f"unknown impl {impl!r}; expected 'fused' or 'twophase'")
    return LocalStats(init=r.init_stats, trans=r.trans_stats, emit=r.acc, log_z=r.log_z)


def time_sharded_decode(params, emission, obs: torch.Tensor, mesh, axis: str = "time",
                        block_size: int = 1024, chunks: int = 8,
                        time_minor: bool = False) -> torch.Tensor:
    """Streaming argmax-gamma decode of one time-sharded chain: this tile's
    (C,) int32 states (the sharded ``engines.base.long_chain_decode``)."""
    f32_matmuls()
    log_pi, log_A = expected_log_params(params)
    return time_sharded.time_sharded_fused_stats(
        log_pi, log_A, obs, _long_chain_ell_fn(params, emission), mesh, axis=axis,
        block_size=block_size, chunks=chunks, emit_argmax=True, time_minor=time_minor).z


def _vb_step(emission, local_stats):
    def step(params, prior, obs: torch.Tensor):
        stats = local_stats(params, obs)
        elbo = elbo_from_stats(params, prior, emission, stats.log_z)
        return conjugate_update(emission, prior, stats), elbo

    return step


def make_ts_stream_vb_step(emission, mesh, axis: str = "time", block_size: int = 256,
                           impl: str = "fused", time_minor: bool = False):
    """Coordinate-ascent VB step on one time-sharded chain through the
    streaming statistics (no gamma): step(params, prior, tile) -> (params',
    ELBO at params)."""
    return _vb_step(emission, lambda p, o: time_sharded_stream_stats(
        p, emission, o, mesh, axis, block_size, impl=impl, time_minor=time_minor))


def make_ts_vb_step(emission, mesh, axis: str = "time"):
    """Coordinate-ascent VB step on one time-sharded chain:
    step(params, prior, tile) -> (params', ELBO at params)."""
    return _vb_step(emission, lambda p, o: time_sharded_local_step(p, emission, o, mesh,
                                                                   axis)[0])


def run_vb_scan(step, params, prior, obs, num_iters: int):
    """Drive a VB step num_iters times (JAX's one compiled ``lax.scan``; a
    Python loop here). Returns (params, the (num_iters,) ELBOs, each at the
    iteration's input params). Shared by the sharded single-chain engines."""
    elbos = []
    for _ in range(num_iters):
        params, elbo = step(params, prior, obs)
        elbos.append(elbo)
    return params, torch.stack(elbos)


def fit_long_chain(params, prior, obs: torch.Tensor, emission, mesh, num_iters: int = 100,
                   axis: str = "time"):
    """Batch VB on one long chain obs (T, ...), time-sharded over the mesh
    (each process passes the whole chain and keeps its tile)."""
    return run_vb_scan(make_ts_vb_step(emission, mesh, axis), params, prior,
                       shard_chain(obs, mesh, axis), num_iters)
