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
checkpoint. JAX's ``OrbaxCheckpointer``, the multi-host tier, is not
ported (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import os
from typing import Any

import torch

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
    flat = torch.load(path, map_location="cpu", weights_only=True)
    used: set[str] = set()
    state = _rebuild(target, "", flat, used)
    extra = sorted(set(flat) - used)
    if extra:
        raise ValueError(f"checkpoint {path} has entries the target lacks: {extra}")
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


def latest_step_path(directory: str, prefix: str = "ckpt_") -> str | None:
    """The highest-step checkpoint file ``{prefix}{step}.pt``, or None."""
    if not os.path.isdir(directory):
        return None
    found = _steps(directory, prefix)
    return found[max(found)] if found else None


def save_step(directory: str, step: int, state: Any, prefix: str = "ckpt_", keep: int = 3) -> str:
    """Save ``state`` as ``{prefix}{step}.pt`` and keep only the ``keep``
    newest step files."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{prefix}{step}{SUFFIX}")
    save(path, state)
    found = _steps(directory, prefix)
    for s in sorted(found)[:-keep]:
        os.remove(found[s])
    return path
