"""SVI step-size schedules (port of ``pysvihmm_tpu/utils/schedules.py``).

The Robbins-Monro power schedule and an adaptive ("elastic") variant
(Ranganath et al. 2013) whose state is tensors on the parameters' device,
so a training loop never reads it back to the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .device import resolve_device


def power_schedule(step: torch.Tensor, tau: float = 1.0, kappa: float = 0.7) -> torch.Tensor:
    """rho_t = (t + tau)^(-kappa), kappa in (0.5, 1] for RM convergence."""
    return (step + tau) ** (-kappa)


class AdaptiveState(NamedTuple):
    """Running moments of the natural gradient for the adaptive step size.

    g_bar (EW-mean of the flattened stat vector), h_bar (EW-mean of its
    squared norm) and the memory size tau_adapt; the optimal scalar step is
    rho* = |g_bar|^2 / h_bar (Ranganath et al., "An adaptive learning rate
    for stochastic variational inference").
    """

    g_bar: torch.Tensor  # (P,) flattened
    h_bar: torch.Tensor  # ()
    tau_adapt: torch.Tensor  # ()


def adaptive_init(
    param_dim: int, dtype: torch.dtype = torch.float32, device: torch.device | str | None = None
) -> AdaptiveState:
    """Zero gradient mean, unit curvature and memory 10, on ``device`` (the
    card when None)."""
    device = resolve_device(device)
    return AdaptiveState(
        g_bar=torch.zeros((param_dim,), dtype=dtype, device=device),
        h_bar=torch.tensor(1.0, dtype=dtype, device=device),
        tau_adapt=torch.tensor(10.0, dtype=dtype, device=device),
    )


def adaptive_update(
    state: AdaptiveState, grad_flat: torch.Tensor
) -> tuple[AdaptiveState, torch.Tensor]:
    """One elastic adaptation step: returns (new_state, rho)."""
    t = state.tau_adapt
    g_bar = (1.0 - 1.0 / t) * state.g_bar + (1.0 / t) * grad_flat
    h_bar = (1.0 - 1.0 / t) * state.h_bar + (1.0 / t) * (grad_flat**2).sum()
    rho = (g_bar**2).sum() / torch.clamp_min(h_bar, 1e-30)
    rho = torch.clamp(rho, 1e-6, 1.0)
    tau_new = t * (1.0 - rho) + 1.0
    return AdaptiveState(g_bar=g_bar, h_bar=h_bar, tau_adapt=tau_new), rho
