"""Fault-tolerant training loop: periodic checkpoints and resume on restart
(port of ``pysvihmm_tpu/engines/trainer.py``).

Wraps any (state, prior, data) -> (state, metrics) step function with:

  * periodic atomic checkpoints (``utils/checkpoint.save_step``) of the
    whole state: parameters, the step count that drives the
    (t + tau)^(-kappa) schedule, the adaptive step-size state and the
    ``torch.Generator`` the step draws from;
  * automatic resume from the latest checkpoint in the directory;
  * a NaN watchdog: every ``watchdog_every`` steps, logger or not, the
    metrics are read to the host and a non-finite one raises
    ``FloatingPointError`` with the step and the metrics (no other step
    reads anything back).

Several processes (a ``torch.distributed`` process group) pass the same
shared ``checkpoint_dir``: writes happen on rank 0 only (the state is
replicated; one copy suffices), and every process restores, before its
first collective, the step that rank 0 found latest and broadcast, so that
no process re-enters the collectives at another step than the others.
"""

from __future__ import annotations

import itertools
import math
from collections.abc import Callable, Iterator
from typing import Any

from ..parallel import collectives
from ..utils import checkpoint
from ..utils.device import process_rank_world
from ..utils.logging import MetricsLogger


def _save(checkpoint_dir: str, step: int, state: Any) -> None:
    """The checkpoint write, on rank 0 only."""
    if process_rank_world()[0] == 0:
        checkpoint.save_step(checkpoint_dir, step, state)


def _resume(state: Any, checkpoint_dir: str | None, resume: bool) -> Any:
    if not (checkpoint_dir and resume):
        return state
    latest = checkpoint.latest_step(checkpoint_dir) if process_rank_world()[0] == 0 else None
    step = collectives.broadcast_int(-1 if latest is None else latest, collectives.world_group())
    if step < 0:
        return state
    return checkpoint.restore(checkpoint.step_path(checkpoint_dir, step), state)


def _loop(
    step_fn: Callable,
    state: Any,
    prior: Any,
    data: Iterator,
    start: int,
    num_steps: int,
    checkpoint_dir: str | None,
    checkpoint_every: int,
    log: MetricsLogger | None,
    log_every: int,
    watchdog_every: int,
) -> Any:
    """Steps start+1 .. num_steps, one item of ``data`` a step."""
    for i in range(start, num_steps):
        state, metrics = step_fn(state, prior, next(data))
        done = i + 1
        emit = log is not None and done % log_every == 0
        if done % watchdog_every == 0 or emit:
            host_metrics = {k: float(v) for k, v in metrics.items()}
            if not all(map(math.isfinite, host_metrics.values())):
                err = FloatingPointError(f"non-finite objective at step {done}: {host_metrics}")
                err.step, err.metrics = done, host_metrics
                raise err
            if emit:
                log.write(step=done, **host_metrics)
        if checkpoint_dir and done % checkpoint_every == 0:
            _save(checkpoint_dir, done, state)
    if checkpoint_dir and num_steps > start:
        _save(checkpoint_dir, num_steps, state)
    return state


def train(
    step_fn: Callable,
    state: Any,
    prior: Any,
    obs: Any,
    num_steps: int,
    *,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1000,
    log: MetricsLogger | None = None,
    log_every: int = 100,
    watchdog_every: int | None = None,
    resume: bool = True,
) -> Any:
    """Run ``step_fn(state, prior, obs)`` up to ``num_steps`` steps in all,
    counting the steps of a resumed checkpoint. The watchdog runs every
    ``watchdog_every`` steps (default: ``log_every``)."""
    state = _resume(state, checkpoint_dir, resume)
    return _loop(step_fn, state, prior, itertools.repeat(obs), int(state.step), num_steps,
                 checkpoint_dir, checkpoint_every, log, log_every, watchdog_every or log_every)


def train_streamed(
    step_fn: Callable,
    state: Any,
    prior: Any,
    loader: Any,
    num_steps: int,
    *,
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 1000,
    log: MetricsLogger | None = None,
    log_every: int = 100,
    watchdog_every: int | None = None,
    resume: bool = True,
) -> Any:
    """:func:`train` with one loader batch a step: ``step_fn(state, prior,
    batch)`` over ``loader.stream(start_step)`` (a
    :class:`~pysvihmm_tpu_torch.data.loader.ShardedSequenceLoader`).

    The stream's position is a pure function of the step count, which rides
    in the checkpoint beside the schedule, the adaptive state and the
    generator, so a killed run restarted from its latest checkpoint consumes
    exactly the batches the uninterrupted run would have.
    """
    state = _resume(state, checkpoint_dir, resume)
    start = int(state.step)
    batches = loader.stream(start_step=start)
    try:
        return _loop(step_fn, state, prior, batches, start, num_steps, checkpoint_dir,
                     checkpoint_every, log, log_every, watchdog_every or log_every)
    finally:
        batches.close()
