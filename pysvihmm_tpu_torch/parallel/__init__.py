"""Parallelism over a mesh of processes (port of ``pysvihmm_tpu/parallel``):
data parallelism with the statistics summed by all-reduce, the
multi-process runtime, and the time- and state-sharded exact tiers. One
process a device, ``torch.distributed`` between them; a mesh is a
``DeviceMesh`` with JAX's axis names.

The names below are loaded from their modules on first use: the sharded
message tiers (``messages.time_sharded``, ``messages.state_sharded``) import
:mod:`.collectives` while ``messages`` itself loads, before the engines
that the other modules here import exist.
"""

import importlib

_EXPORTS = {
    "data_parallel": (
        "make_dp_metaobs_step", "make_dp_minibatch_svi_step", "make_dp_streamed_svi_step",
        "make_dp_vb_step", "replicate", "shard_batch", "sharded_local_step",
    ),
    "multihost": (
        "global_data_mesh", "host_local_batch_to_global", "initialize_distributed",
        "make_mesh", "spawn_local",
    ),
    "state_parallel": ("fit_large_k", "make_ss_vb_step", "shard_params_by_state"),
    "time_parallel": (
        "fit_long_chain", "make_time_mesh", "make_ts_stream_vb_step", "make_ts_vb_step",
        "run_vb_scan", "shard_chain", "time_sharded_decode", "time_sharded_local_step",
        "time_sharded_stream_stats",
    ),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = sorted(_MODULE_OF)


def __getattr__(name: str):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{_MODULE_OF[name]}", __name__), name)
