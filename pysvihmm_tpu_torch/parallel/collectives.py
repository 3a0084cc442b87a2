"""Collectives over one axis of a device mesh: the port's own copy of the
collective semantics that ``shard_map`` gives JAX (``lax.psum`` of a tree,
``all_gather``, ``psum_scatter(tiled=True)``, ``ppermute``, ``pmax`` and
``axis_index``), on a ``torch.distributed`` process group.

A mesh axis is a process group (``mesh.get_group(axis)``); each process holds
its own shard. A group of None is one process with no process group: every
collective is then the identity, as JAX's collectives over an axis of size
1. A group of one process runs its collectives all the same.

The implementation follows the group's backend. NCCL runs ``all_reduce``,
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` on the card. gloo
is used through the two collectives it documents for CUDA tensors,
``all_reduce`` and ``broadcast``, whatever the tensors' device: an
all-gather is an all-reduce of a zero-filled buffer of slots, one a rank; a
reduce-scatter an all-reduce followed by the rank's slice (PyTorch 2.11's
gloo also ran the other two on CUDA tensors on an H100; the port keeps to
what gloo documents). Nothing here catches a failed collective.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

Group = dist.ProcessGroup | None


def world_group() -> Group:
    """The group of every process when a process group is up, else None."""
    return dist.group.WORLD if dist.is_available() and dist.is_initialized() else None


def axis_size(group: Group) -> int:
    """The number of processes on the axis (``lax.psum(1, axis)``)."""
    return 1 if group is None else dist.get_world_size(group)


def axis_index(group: Group) -> int:
    """This process's index on the axis (``lax.axis_index``)."""
    return 0 if group is None else dist.get_rank(group)


def _nccl(group: Group) -> bool:
    return dist.get_backend(group) == "nccl"


def _leaves(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None:
        return []
    return [leaf for child in tree for leaf in _leaves(child)]


def _rebuild(tree, it):
    if isinstance(tree, torch.Tensor):
        return next(it)
    if tree is None:
        return None
    parts = [_rebuild(child, it) for child in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


def psum(tree, group: Group):
    """``lax.psum`` of a tensor or a (named) tuple of tensors: the sum over
    the axis, on every process. The leaves of one dtype and device travel in
    one all-reduce."""
    if group is None:
        return tree
    leaves = _leaves(tree)
    out = [None] * len(leaves)
    buckets: dict[tuple, list[int]] = {}
    for i, x in enumerate(leaves):
        buckets.setdefault((x.dtype, x.device), []).append(i)
    for idx in buckets.values():
        flat = torch.cat([leaves[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        for i, part in zip(idx, flat.split([leaves[i].numel() for i in idx])):
            out[i] = part.view(leaves[i].shape)
    return _rebuild(tree, iter(out))


def pmax(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.pmax``: the elementwise maximum over the axis."""
    if group is None:
        return x
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def _gather_slots(x: torch.Tensor, group: Group) -> torch.Tensor:
    """(D, *x.shape): every process's x, in axis order."""
    D = axis_size(group)
    x = x.contiguous()
    if _nccl(group):
        out = torch.empty((D,) + x.shape, dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=group)
        return out
    out = torch.zeros((D,) + x.shape, dtype=x.dtype, device=x.device)
    out[axis_index(group)] = x
    dist.all_reduce(out, group=group)
    return out


def all_gather(x: torch.Tensor, group: Group, axis: int = 0, tiled: bool = False) -> torch.Tensor:
    """``lax.all_gather``: the axis' shards stacked along a new dimension at
    ``axis``, or with ``tiled=True`` concatenated along ``axis``."""
    if group is None:
        return x if tiled else x.unsqueeze(axis)
    g = _gather_slots(x, group)
    if not tiled:
        return g.movedim(0, axis)
    return torch.cat(g.unbind(0), dim=axis)


def psum_scatter(x: torch.Tensor, group: Group) -> torch.Tensor:
    """``lax.psum_scatter(x, scatter_dimension=0, tiled=True)``: the sum over
    the axis, of which this process keeps its block of x's leading dimension
    (which the axis size must divide)."""
    if group is None:
        return x
    D, n = axis_size(group), x.shape[0]
    if n % D:
        raise ValueError(f"leading dimension {n} not divisible by the axis size {D}")
    if _nccl(group):
        out = torch.empty((n // D,) + x.shape[1:], dtype=x.dtype, device=x.device)
        dist.reduce_scatter_tensor(out, x.contiguous(), group=group)
        return out
    y = x.clone()
    dist.all_reduce(y, group=group)
    return y.chunk(D)[axis_index(group)]


def ppermute(x: torch.Tensor, group: Group, perm: list[tuple[int, int]]) -> torch.Tensor:
    """``lax.ppermute``: process ``dst`` receives ``src``'s x for each (src,
    dst) pair of ``perm``; a process that is no destination receives zeros.
    For the few scalars the sharded tiers pass on: an all-gather and a pick."""
    src = {d: s for s, d in perm}.get(axis_index(group))
    g = x[None] if group is None else _gather_slots(x, group)  # every process takes part
    return torch.zeros_like(x) if src is None else g[src]


def host_device(group: Group) -> torch.device:
    """Where a small bookkeeping tensor (a count, a step) of the group lives:
    the current card for NCCL, which takes CUDA tensors only, else the CPU."""
    if group is not None and _nccl(group):
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def broadcast_int(value: int, group: Group, src: int = 0) -> int:
    """Process ``src``'s integer ``value`` on every process of the group."""
    if group is None:
        return value
    t = torch.tensor([value], dtype=torch.int64, device=host_device(group))
    dist.broadcast(t, group=group, group_src=src)
    return int(t.item())
