"""The multi-process runtime (port of ``pysvihmm_tpu/parallel/multihost.py``):
starting ``torch.distributed``, the data mesh over every process, and
host-local batches.

PyTorch runs one process a device, so the world is fixed when the processes
start: a mesh spans the whole world, and each process holds its own shard
of every sharded array. :func:`spawn_local` starts such a world of processes
on one host (the tests' gloo ranks on the CPU, and several ranks sharing one
card).
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import pickle
import queue
import tempfile
import time
import traceback
from collections.abc import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from . import collectives


def initialize_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    initialization_timeout: int | None = None,
    backend: str = "nccl",
) -> None:
    """Start the process group of a multi-process run; nothing on one process.

    ``coordinator_address`` ("host:port", or an init-method URL such as
    ``tcp://host:port`` or ``file:///path``) defaults to the
    ``COORDINATOR_ADDRESS`` variable, and without either to the variables
    ``torchrun`` sets (``env://``, the world size and rank from
    ``WORLD_SIZE`` and ``RANK`` unless given). ``initialization_timeout``
    (seconds) bounds the handshake and becomes the group's collective
    timeout. ``backend`` is "nccl" for the card, "gloo" for CPU processes.

    Calling it again while a group is up does nothing. A request for
    several processes, by the arguments or by torchrun's variables, that
    fails raises, as does a world whose size differs from
    ``num_processes``: a process that carried on alone would compute
    statistics that no other process added to.
    """
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
    if coordinator_address is None and "MASTER_ADDR" in os.environ:
        coordinator_address = "env://"
        if num_processes is None:
            num_processes = int(os.environ.get("WORLD_SIZE", "1"))
            process_id = int(os.environ.get("RANK", "0"))
    if num_processes is not None and num_processes <= 1:
        return
    explicit = num_processes is not None
    if dist.is_initialized():
        _check_world(explicit, num_processes)
        return
    if coordinator_address is None:
        if explicit:
            raise ValueError(f"{num_processes} processes requested but no coordinator address: "
                             "pass one or set COORDINATOR_ADDRESS")
        return
    init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    kwargs = {}
    if num_processes is not None:
        kwargs.update(world_size=num_processes, rank=process_id)
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    try:
        dist.init_process_group(backend, init_method=init, **kwargs)
    except (RuntimeError, ValueError):
        if explicit:
            raise
        return  # no cluster found and none asked for: one process
    _check_world(explicit, num_processes)


def _check_world(explicit: bool, num_processes: int | None) -> None:
    if explicit and dist.get_world_size() != num_processes:
        raise RuntimeError(f"requested {num_processes} processes but the process group has "
                           f"{dist.get_world_size()}: the multi-process start failed")


def make_mesh(num_devices: int | None = None, device_type: str | None = None,
              axis: str = "data") -> DeviceMesh:
    """The 1-D mesh named ``axis`` over every process of the world, on
    ``device_type`` (default "cuda"; "cpu" for gloo processes on the CPU).

    The world is fixed when the processes start, so ``num_devices`` (JAX
    picks that many devices) must equal the world size, or ``ValueError``."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call initialize_distributed (or start the "
                           "processes with torchrun) before building a mesh")
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"a mesh of {num_devices} devices over a world of {world} processes")
    return init_device_mesh(device_type or "cuda", (world,), mesh_dim_names=(axis,))


def global_data_mesh(axis: str = "data", device_type: str | None = None) -> DeviceMesh:
    """1-D mesh over every process of the job, in rank order."""
    return make_mesh(None, device_type, axis)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this process computes on for ``mesh``."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def host_local_batch_to_global(obs_local, mesh: DeviceMesh, axis: str = "data") -> torch.Tensor:
    """This process's (B_local, ...) rows as its shard of the global batch.

    JAX assembles a global array from the processes' rows
    (``make_array_from_process_local_data``); torch has no global array, so
    the shard is the local rows on the mesh's device. Every process must
    hold the same number of rows, or ``ValueError`` on every process."""
    if not isinstance(obs_local, torch.Tensor):
        obs_local = torch.from_numpy(np.array(obs_local))  # a copy: memmaps are read-only
    x = obs_local.to(mesh_device(mesh))
    group = mesh.get_group(axis)
    counts = collectives.all_gather(
        torch.tensor(x.shape[0], device=collectives.host_device(group)), group)
    if bool((counts != counts[0]).any()):
        raise ValueError(f"processes hold different numbers of rows: {counts.tolist()}")
    return x


def _rank_entry(fn, rank, world, init, backend, timeout, args, results) -> None:
    """One spawned process: join the group, run fn, report, leave the group."""
    try:
        dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=timeout))
        # pickled here, not by the queue: torch's queue pickling would share
        # tensors through file descriptors of this process, which then exits
        results.put((rank, True, pickle.dumps(fn(rank, world, *args))))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_local(fn: Callable, world: int, *args, backend: str = "gloo",
                timeout: float = 120.0) -> list:
    """Run ``fn(rank, world, *args)`` in ``world`` new processes of this host
    (the ``spawn`` start method), each a rank of one process group (init
    through a file in a fresh temporary directory, no port). Returns the
    ranks' results in rank order.

    ``fn`` must be importable by name and its arguments and result
    picklable. If a rank raises, or the ranks have not all finished within
    ``timeout`` seconds, every process still running is killed and
    ``RuntimeError`` reports each rank's traceback; collectives time out
    after ``timeout`` seconds too, so a rank left waiting on a failed one
    ends."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_entry,
                             args=(fn, r, world, init, backend, timeout, args, results))
                 for r in range(world)]
        for p in procs:
            p.start()
        got: dict[int, tuple[bool, object]] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(got) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    if not any(p.is_alive() for p in procs) and results.empty():
                        break
                    continue
                got[rank] = (ok, value)
                if not ok:
                    break
        finally:
            for p in procs:
                p.join(timeout=5 if len(got) == world else 0.5)
                if p.is_alive():
                    p.kill()
                    p.join()
    failed = {r: v for r, (ok, v) in got.items() if not ok}
    missing = [r for r in range(world) if r not in got]
    if failed or missing:
        report = "".join(f"\n--- rank {r} ---\n{tb}" for r, tb in sorted(failed.items()))
        raise RuntimeError(f"{len(failed)} rank(s) raised, {len(missing)} did not finish "
                           f"({missing}) within {timeout} s:{report}")
    return [pickle.loads(got[r][1]) for r in range(world)]
