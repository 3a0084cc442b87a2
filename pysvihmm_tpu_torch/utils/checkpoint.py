"""Checkpoint and resume of training state (port of
``pysvihmm_tpu/utils/checkpoint.py``).

A state (an ``SVIState``, ``BatchSGDState`` or ``GibbsState``: NamedTuples,
tuples, lists and dicts of tensors, ``torch.Generator``s and None) is saved
by ``torch.save`` as one flat dict keyed by field path (``params.emit.psi``,
``step``, ``adapt.g_bar``, ``theta.0``), which ``torch.load`` reads with
``weights_only=True``: nothing in a checkpoint is unpickled as code. A
generator is saved as its state (a uint8 tensor, ``get_state()``) under its
path and its device type under ``{path}.device``; restoring puts that state
into a new generator on the target generator's device, so the restored run
draws what the saved one would have. Writes are atomic (a ``.tmp`` file,
then ``os.replace``), so a preempted process never leaves a torn
checkpoint.

:class:`DistributedCheckpointer` is the multi-process tier (JAX's
``OrbaxCheckpointer``) on ``torch.distributed.checkpoint``: every process
takes part in each save and restore, writes run in the background, and a
step becomes visible only once all of it is written.
"""

from __future__ import annotations

import os
import shutil
from typing import Any

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp

from ..parallel.collectives import broadcast_int

SUFFIX = ".pt"
_DEVICE = ".device"  # the key suffix of a generator's device type


def _items(node: Any):
    """(field name, child) pairs of a NamedTuple, tuple, list or dict."""
    if hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    if isinstance(node, dict):
        return list(node.items())
    raise TypeError(f"cannot checkpoint a {type(node).__name__}")


def _join(prefix: str, name) -> str:
    return f"{prefix}.{name}" if prefix else str(name)


def flatten(state: Any, prefix: str = "") -> dict[str, Any]:
    """The flat ``{path: tensor}`` dict that :func:`save` writes: every tensor
    copied to the host, every generator as its state and device type, every
    None left out."""
    out: dict[str, Any] = {}
    if state is None:
        return out
    if isinstance(state, torch.Tensor):
        out[prefix] = state.detach().to("cpu", copy=True)
    elif isinstance(state, torch.Generator):
        out[prefix] = state.get_state()
        out[prefix + _DEVICE] = torch.device(state.device).type
    else:
        for name, child in _items(state):
            out.update(flatten(child, _join(prefix, name)))
    return out


def generator_from_state(
    state: torch.Tensor, device_type: str, device: torch.device | str
) -> torch.Generator:
    """A new generator on ``device`` holding a saved generator ``state``.
    Raises ``ValueError`` when the state was saved from another device type
    (a CUDA generator's state is its seed and offset, a CPU one's the whole
    Mersenne Twister): it never reseeds in its place."""
    device = torch.device(device)
    if device_type != device.type:
        raise ValueError(
            f"a {device_type} generator's state cannot be restored into a generator on {device}"
        )
    gen = torch.Generator(device=device)
    gen.set_state(state)
    return gen


def _rebuild(target: Any, prefix: str, flat: dict[str, Any], used: set[str]) -> Any:
    if target is None:
        return None
    if isinstance(target, (torch.Tensor, torch.Generator)):
        keys = [prefix, prefix + _DEVICE] if isinstance(target, torch.Generator) else [prefix]
        for key in keys:
            if key not in flat:
                raise ValueError(f"checkpoint has no entry {key!r}")
        used.update(keys)
        saved = flat[prefix]
        if isinstance(target, torch.Generator):
            return generator_from_state(saved, flat[prefix + _DEVICE], target.device)
        if saved.shape != target.shape:
            raise ValueError(
                f"checkpoint entry {prefix!r} has shape {tuple(saved.shape)}, the target "
                f"{tuple(target.shape)}"
            )
        return saved.to(device=target.device, dtype=target.dtype)
    children = [(name, _rebuild(child, _join(prefix, name), flat, used))
                for name, child in _items(target)]
    if hasattr(target, "_fields"):
        return type(target)(*(c for _, c in children))
    if isinstance(target, dict):
        return dict(children)
    return type(target)(c for _, c in children)


def save(path: str, state: Any) -> None:
    """Atomically write ``state``'s flat dict (:func:`flatten`) to ``path``."""
    tmp = path + ".tmp"
    torch.save(flatten(state), tmp)
    os.replace(tmp, path)


def restore(path: str, target: Any) -> Any:
    """Load a checkpoint into the structure of ``target``: each tensor on
    that leaf's device and in its dtype, each generator a new one on the
    target generator's device (``target`` itself is not changed). Raises
    ``ValueError`` on a missing entry, an extra entry, a shape that differs
    or a generator saved from another device type."""
    return _unflatten(torch.load(path, map_location="cpu", weights_only=True), target, path)


def _unflatten(flat: dict[str, Any], target: Any, source: str) -> Any:
    used: set[str] = set()
    state = _rebuild(target, "", flat, used)
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(f"checkpoint {source} has entries the target lacks: {extra}")
    return state


def _steps(directory: str, prefix: str) -> dict[int, str]:
    """{step: path} of the ``{prefix}{step}.pt`` files in ``directory``."""
    found = {}
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(SUFFIX):
            try:
                found[int(name[len(prefix) : -len(SUFFIX)])] = os.path.join(directory, name)
            except ValueError:
                continue
    return found


def latest_step(directory: str, prefix: str = "ckpt_") -> int | None:
    """The highest step of the ``{prefix}{step}.pt`` files, or None."""
    found = _steps(directory, prefix) if os.path.isdir(directory) else {}
    return max(found) if found else None


def step_path(directory: str, step: int, prefix: str = "ckpt_") -> str:
    """The file :func:`save_step` writes for ``step``."""
    return os.path.join(directory, f"{prefix}{step}{SUFFIX}")


def latest_step_path(directory: str, prefix: str = "ckpt_") -> str | None:
    """The highest-step checkpoint file ``{prefix}{step}.pt``, or None."""
    step = latest_step(directory, prefix)
    return None if step is None else step_path(directory, step, prefix)


def save_step(directory: str, step: int, state: Any, prefix: str = "ckpt_", keep: int = 3) -> str:
    """Save ``state`` as ``{prefix}{step}.pt`` and keep only the ``keep``
    newest step files."""
    os.makedirs(directory, exist_ok=True)
    path = step_path(directory, step, prefix)
    save(path, state)
    found = _steps(directory, prefix)
    for s in sorted(found)[:-keep]:
        os.remove(found[s])
    return path


def _encode(flat: dict[str, Any]) -> dict[str, torch.Tensor]:
    """:func:`flatten`'s dict with each generator's device type (a string) as
    a uint8 tensor of its characters: ``torch.distributed.checkpoint`` then
    stores tensors only, and reads them back without unpickling."""
    return {k: torch.tensor(list(v.encode()), dtype=torch.uint8) if isinstance(v, str) else v
            for k, v in flat.items()}


def _decode(flat: dict[str, torch.Tensor]) -> dict[str, Any]:
    return {k: bytes(v.tolist()).decode() if k.endswith(_DEVICE) else v for k, v in flat.items()}


class DistributedCheckpointer:
    """Step-numbered checkpoints of a state across processes on
    ``torch.distributed.checkpoint`` (JAX's ``OrbaxCheckpointer``, the
    multi-host tier)::

        ckpt = DistributedCheckpointer(directory, keep=3)
        ckpt.save(step, state)            # asynchronous
        state = ckpt.restore(state_like)  # the latest step
        ckpt.close()                      # waits for the last write

    Every process of the job constructs it and calls each method with the
    same arguments (a save and a restore are collective); without a process
    group it is one process's. The state is :func:`flatten`'s dict (a
    generator as its state and device type). A step is written into
    ``step_<n>.tmp`` and renamed to ``step_<n>`` by process 0 once the whole
    write has finished, so :meth:`latest_step` never sees a torn step; the
    newest ``keep`` steps are kept. The writes of a save run in a thread
    (``dcp.async_save``) while the caller goes on, over a gloo group of
    their own so that they never interleave with the caller's collectives;
    the next save, :meth:`restore` and :meth:`close` wait for them."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        self._group = dist.new_group(backend="gloo") if dist.is_initialized() else None
        self._rank = dist.get_rank() if dist.is_initialized() else 0
        self._pending: tuple[Any, int] | None = None
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}")

    def save(self, step: int, state: Any) -> None:
        """Start writing ``state`` as step ``step`` (the previous save is
        finished first)."""
        self._finish()
        future = dcp.async_save(_encode(flatten(state)), checkpoint_id=self._path(step) + ".tmp",
                                process_group=self._group, no_dist=self._group is None)
        self._pending = (future, step)

    def _finish(self) -> None:
        """Wait for the pending save (raising its error), then on process 0
        make it visible and drop the steps beyond ``keep``."""
        if self._pending is None:
            return
        future, step = self._pending
        self._pending = None
        future.result()
        if self._rank != 0:
            return
        final = self._path(step)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(final + ".tmp", final)
        for old in sorted(self._steps())[:-self.keep]:
            shutil.rmtree(self._path(old))

    def _steps(self) -> list[int]:
        steps = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    steps.append(int(name[len("step_"):]))
                except ValueError:
                    continue
        return steps

    def latest_step(self) -> int | None:
        """The newest finished step in the directory, or None."""
        steps = self._steps()
        return max(steps) if steps else None

    def restore(self, target: Any, step: int | None = None) -> Any:
        """Load a step (default: process 0's latest, the same on every
        process) into the structure of ``target``, as :func:`restore` does.
        Raises ``FileNotFoundError`` when there is none."""
        self._finish()
        if step is None:
            latest = self.latest_step() if self._rank == 0 else None
            step = broadcast_int(-1 if latest is None else latest, self._group)
            if step < 0:
                raise FileNotFoundError(f"no checkpoint in {self.directory}")
        path = self._path(step)
        meta = dcp.FileSystemReader(path).read_metadata()
        flat = {k: torch.empty(m.size, dtype=m.properties.dtype)
                for k, m in meta.state_dict_metadata.items()}
        dcp.load(flat, checkpoint_id=path, process_group=self._group,
                 no_dist=self._group is None)
        return _unflatten(_decode(flat), target, path)

    def close(self) -> None:
        """Finish the pending save."""
        self._finish()
