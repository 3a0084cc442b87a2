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
