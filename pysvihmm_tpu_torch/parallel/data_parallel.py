"""Data-parallel SVI over a streamed corpus (port of
``pysvihmm_tpu/parallel/data_parallel.py::make_dp_streamed_svi_step``).

Only the single-process form is ported: JAX's ``shard_map`` with ``psum``
becomes a ``torch.distributed`` all-reduce of the statistics in ROADMAP
Queue 1 item 7, and until then a process group of more than one process
raises.
"""

from __future__ import annotations

from ..engines.svi import SVIConfig, make_minibatch_step
from ..utils.device import process_rank_world


def make_dp_streamed_svi_step(emission, cfg: SVIConfig, num_seqs: int, method: str = "auto"):
    """Minibatch-of-sequences SVI whose batches arrive from a host pipeline
    (a :class:`~pysvihmm_tpu_torch.data.loader.ShardedSequenceLoader`).

    Returns step(state, prior, batch) -> (state', metrics): the batch local
    step on one (B, T, ...) batch, the statistics scaled by num_seqs / B,
    the step size of the power schedule or the adaptive rule, and the
    natural-gradient update (``svi.make_minibatch_step``'s ``with_batch``).
    The state's generator is not drawn from: the loader's order is the
    randomness.
    """
    world = process_rank_world()[1]
    if world > 1:
        raise NotImplementedError(
            f"the streamed SVI step across {world} processes (an all-reduce of the statistics) "
            "is not ported yet (ROADMAP Queue 1 item 7)")
    return make_minibatch_step(emission, cfg, num_seqs, method).with_batch
