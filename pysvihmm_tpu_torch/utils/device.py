"""Where the port builds state when the caller names no device: on the card.

The port is written for an NVIDIA GPU, so its entry points put new tensors
on ``cuda`` unless the caller asks for another device (the tests pass
``device="cpu"``). Without a card that raises; nothing falls back to the
CPU on its own.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = torch.device("cuda")


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``device`` as a :class:`torch.device`, or the card when it is None."""
    return DEFAULT_DEVICE if device is None else torch.device(device)


def check_generator(generator: torch.Generator, device: torch.device | str) -> None:
    """Raise ``ValueError`` unless ``generator`` draws on ``device``: the
    stochastic entry points draw on the generator's device and never move
    draws between devices."""
    want, have = torch.device(device), torch.device(generator.device)
    if want.type != have.type or (want.type == "cuda" and (want.index or 0) != (have.index or 0)):
        raise ValueError(f"generator on {have} but the tensors on {want}")


def restart_generators(generator: torch.Generator, n: int) -> list[torch.Generator]:
    """``n`` generators on ``generator``'s device, seeded from its draws (one
    host read of n seeds): one for each restart of a best-of-N fit."""
    seeds = torch.randint(0, 2**62, (n,), generator=generator, device=generator.device)
    return [torch.Generator(device=generator.device).manual_seed(int(x)) for x in seeds.tolist()]


def process_rank_world() -> tuple[int, int]:
    """(rank, world size) of this process: torch.distributed's when a process
    group is up, else (0, 1) (JAX's ``process_index`` / ``process_count``)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1
