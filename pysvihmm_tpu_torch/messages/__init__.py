"""Message passing: the E-step layer (port of ``pysvihmm_tpu/messages``).

Six implementations of the same batched E-step:
  * ``scan``   -- :mod:`.scan_fb`, a plain loop over time in PyTorch over
                  materialised log-likelihoods; exact, any device.
  * ``assoc``  -- :mod:`.assoc_fb`, prefix and suffix products of the
                  per-step matrices by an associative scan: O(T K^3) work,
                  O(log T) depth. Plain PyTorch, as JAX's is plain XLA.
  * ``blocked``-- :mod:`.blocked`, the associative scan inside blocks of
                  256 steps, the boundary messages carried across blocks.
  * ``fused``  -- :mod:`.fused_fb`, the likelihood matmul, forward-backward
                  and every statistic in two CUDA kernels (JAX's
                  ``"pallas_fused"``).
  * ``split``  -- :mod:`.split_fb`, forward-backward over materialised
                  log-likelihoods in two CUDA kernels (JAX's ``"pallas"``).
  * ``duplex`` -- :mod:`.duplex_fb`, both chains side by side in one CUDA
                  kernel and every statistic chain-free in a second (JAX's
                  ``"pallas_fused"`` with ``PYSVIHMM_DUPLEX`` set; the port
                  has no environment knobs, so it is a method here).
The kernel routes run their kernels' plain twins on CPU tensors. "auto"
never picks "assoc" or "blocked", as in JAX.

One very long chain takes the streaming tiers instead, which reduce the
statistics without gamma: :func:`.blocked.forward_backward_blocked_stream`,
:func:`.blocked.forward_backward_blocked_twophase` and
:func:`.stream_fused.forward_backward_fused_twophase` (through
``engines.base.long_chain_local_stats``). Over a mesh of processes, the
time-sharded tiers (:mod:`.time_sharded`) cut one chain into a tile a
process, and :mod:`.state_sharded` cuts the states into blocks.
"""

from __future__ import annotations

import torch

from .scan_fb import (
    FBResult,
    backward,
    ffbs_from_gumbel,
    ffbs_sample,
    forward,
    forward_backward,
    forward_filter_log,
    forward_with_logc,
    log_normalizer,
    viterbi,
)
from .assoc_fb import forward_backward_assoc, log_normalizer_assoc
from .blocked import forward_backward_blocked, forward_backward_blocked_stream
from .split_fb import estep_split
from .state_sharded import state_sharded_forward_backward
from .time_sharded import time_sharded_forward_backward, time_sharded_forward_backward_batched

METHODS = ("scan", "fused", "split", "duplex", "assoc", "blocked")
PLAIN_METHODS = ("scan", "assoc", "blocked")  # the methods of :func:`e_step`, any device


def resolve_method(method: str, device: torch.device | str) -> str:
    """Resolve ``method="auto"`` by the tensors' device.

    "auto" is "fused" (the CUDA kernels) for CUDA tensors and "scan" for CPU
    tensors; it never picks "assoc" or "blocked". An explicit method of
    :data:`METHODS` passes through. A
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
    trans_stats summed over the batch, (K, K). "scan", "assoc" and "blocked"
    run :func:`e_step` in the inputs' dtype. "fused" and "duplex" become
    "split" here, as JAX's "pallas_fused" becomes "pallas": the likelihoods are already
    materialised, so the split kernels take them (CUDA tensors launch them;
    CPU tensors run their float32 twins on float32 copies).
    """
    method = resolve_method(method, log_lik.device)
    if method in PLAIN_METHODS:
        return e_step(log_pi, log_A, log_lik, weights, method)
    ll = log_lik.to(torch.float32).transpose(0, 1).contiguous()
    w = None if weights is None else weights.to(torch.float32).transpose(0, 1).contiguous()
    fb = estep_split(log_pi, log_A, ll, w)
    return fb._replace(gamma=fb.gamma.transpose(0, 1))


def e_step_grad(log_pi: torch.Tensor, log_A: torch.Tensor, log_lik: torch.Tensor,
                method: str = "scan") -> FBResult:
    """The E-step as gradients of the log-normaliser over log_lik (B, T, K):
    d log Z / d log_lik = gamma, d / d log_A = sum_t xi_t (summed over the
    batch), d / d log_pi = gamma_0 (per sequence: log_pi is broadcast to
    (B, K) first). The max shift is detached (:func:`scan_fb._normalize_loglik`).

    method "scan" differentiates the forward recursion (and returns its
    log_c); "assoc" differentiates :func:`log_normalizer_assoc`, through the
    associative scan, and returns log_c None, as JAX does."""
    if method not in ("scan", "assoc"):
        raise ValueError(f"e_step_grad method must be 'scan' or 'assoc', got {method!r}")
    B = log_lik.shape[0]
    with torch.enable_grad():
        lp = log_pi.detach().expand(B, -1).clone().requires_grad_(True)
        lA = log_A.detach().clone().requires_grad_(True)
        ll = log_lik.detach().clone().requires_grad_(True)
        if method == "scan":
            _, log_z, log_c = forward_with_logc(lp, lA, ll)
        else:
            log_z, log_c = log_normalizer_assoc(lp, lA, ll), None
        # T = 1 leaves log_A out of the graph: its gradient is then zeros
        init, trans, gamma = torch.autograd.grad(log_z.sum(), (lp, lA, ll), allow_unused=True,
                                                 materialize_grads=True)
    return FBResult(gamma=gamma, log_z=log_z.detach(), trans_stats=trans, init_stats=init,
                    log_c=None if log_c is None else log_c.detach())


def e_step(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_lik: torch.Tensor,
    weights: torch.Tensor | None = None,
    method: str = "scan",
) -> FBResult:
    """One batched E-step over log_lik (B, T, K) by the plain methods:
    "scan" (:func:`scan_fb.forward_backward`), "assoc"
    (:func:`assoc_fb.forward_backward_assoc`), "blocked"
    (:func:`blocked.forward_backward_blocked`, blocks of 256 steps) or
    "grad" (:func:`e_step_grad`, which takes no weights)."""
    if method == "scan":
        return forward_backward(log_pi, log_A, log_lik, weights)
    if method == "assoc":
        return forward_backward_assoc(log_pi, log_A, log_lik, weights)
    if method == "blocked":
        return forward_backward_blocked(log_pi, log_A, log_lik, weights)
    if method == "grad":
        if weights is not None:
            raise ValueError("grad e-step does not support buffer weights")
        return e_step_grad(log_pi, log_A, log_lik)
    raise ValueError(f"unknown e_step method: {method}")


__all__ = [
    "FBResult",
    "METHODS",
    "PLAIN_METHODS",
    "backward",
    "e_step",
    "e_step_batched",
    "e_step_grad",
    "ffbs_from_gumbel",
    "ffbs_sample",
    "forward",
    "forward_backward",
    "forward_backward_assoc",
    "forward_backward_blocked",
    "forward_backward_blocked_stream",
    "forward_filter_log",
    "forward_with_logc",
    "log_normalizer",
    "log_normalizer_assoc",
    "plan_window",
    "resolve_method",
    "state_sharded_forward_backward",
    "time_sharded_forward_backward",
    "time_sharded_forward_backward_batched",
    "viterbi",
]
