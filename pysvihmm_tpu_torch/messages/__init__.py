"""Message passing: the E-step layer (port of ``pysvihmm_tpu/messages``).

Four implementations of the same batched E-step:
  * ``scan``   -- :mod:`.scan_fb`, a plain loop over time in PyTorch over
                  materialised log-likelihoods; exact, any device.
  * ``fused``  -- :mod:`.fused_fb`, the likelihood matmul, forward-backward
                  and every statistic in two CUDA kernels (JAX's
                  ``"pallas_fused"``).
  * ``split``  -- :mod:`.split_fb`, forward-backward over materialised
                  log-likelihoods in two CUDA kernels (JAX's ``"pallas"``).
  * ``duplex`` -- :mod:`.duplex_fb`, both chains side by side in one CUDA
                  kernel and every statistic chain-free in a second (JAX's
                  ``"pallas_fused"`` with ``PYSVIHMM_DUPLEX`` set; the port
                  has no environment knobs, so it is a method here).
The kernel routes run their kernels' plain twins on CPU tensors.
"""

from __future__ import annotations

import torch

from .scan_fb import FBResult, backward, forward_backward, forward_with_logc
from .split_fb import estep_split

METHODS = ("scan", "fused", "split", "duplex")


def resolve_method(method: str, device: torch.device | str) -> str:
    """Resolve ``method="auto"`` by the tensors' device.

    "auto" is "fused" (the CUDA kernels) for CUDA tensors and "scan" for CPU
    tensors. An explicit method of :data:`METHODS` passes through. A
    configuration the kernels do not take raises where it is launched;
    nothing falls back to "scan" on its own.
    """
    if method == "auto":
        kind = torch.device(device).type
        if kind == "cuda":
            return "fused"
        if kind == "cpu":
            return "scan"
        raise ValueError(f"no E-step method for device type {kind!r}")
    if method not in METHODS:
        raise ValueError(f"unknown E-step method {method!r}; expected one of {METHODS}")
    return method


def plan_window(method: str, keep_len: int, buffer: int, chain_len: int) -> tuple[str, int, int]:
    """Method and window geometry of a windowed engine (svi ``make_step``).

    Returns (method, W, b_left): the window W = keep_len + 2 * buffer and the
    buffer b_left = buffer left of the kept region, on EVERY route. This is
    where the port differs from JAX by design: JAX rounds W up to a multiple
    of 8 on its kernel routes so that Mosaic gets a legal time tile; the
    CUDA kernels walk the whole window inside one block and need no padding.
    An explicit method is checked here; "auto" stays "auto", and each call
    resolves it by its tensors' device. Raises if W exceeds the chain.
    """
    if method not in ("auto", *METHODS):
        raise ValueError(f"unknown E-step method {method!r}; expected one of {METHODS}")
    W = keep_len + 2 * buffer
    if W > chain_len:
        raise ValueError(f"window {W} longer than chain {chain_len}")
    return method, W, buffer


def e_step_batched(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_lik: torch.Tensor,  # (B, T, K)
    weights: torch.Tensor | None = None,  # (B, T) kept-mask
    method: str = "auto",
) -> FBResult:
    """Batched E-step over materialised likelihoods (B, T, K).

    Contract: gamma (B, T, K), log_z (B,), log_c (B, T), init_stats (B, K);
    trans_stats summed over the batch, (K, K). "fused" and "duplex" become
    "split" here, as JAX's "pallas_fused" becomes "pallas": the likelihoods are already
    materialised, so the split kernels take them (CUDA tensors launch them;
    CPU tensors run their float32 twins on float32 copies). "scan" runs
    :func:`scan_fb.forward_backward` in the inputs' dtype.
    """
    method = resolve_method(method, log_lik.device)
    if method == "scan":
        return forward_backward(log_pi, log_A, log_lik, weights)
    ll = log_lik.to(torch.float32).transpose(0, 1).contiguous()
    w = None if weights is None else weights.to(torch.float32).transpose(0, 1).contiguous()
    fb = estep_split(log_pi, log_A, ll, w)
    return fb._replace(gamma=fb.gamma.transpose(0, 1))


__all__ = [
    "FBResult",
    "METHODS",
    "backward",
    "e_step_batched",
    "forward_backward",
    "forward_with_logc",
    "plan_window",
    "resolve_method",
]
