"""Probes of the split forward chain: the three kernels of the split path's
profiling script, in hand-written CUDA (port of the Pallas kernels of
``scripts/debug_pallas_split.py``). Each is the forward recursion with one
part left out or changed, so that their times, beside the split forward
kernel's, say where that kernel's time goes (``scripts/debug_split.py``).

Kernels (``csrc/split_probe.cu``; the source notes what bounds them), over
tiles of C steps (tile j holds steps jC .. jC+C-1):

* ``probe_fwd_nos_kernel`` replaces ``_fwd_nos`` (debug_pallas_split.py:25):
  a_0 = pi * lik_0; then, at tile step p = t % C, a = a / sum(a) when
  p % 4 == 0 (p = 0 is the TPU kernel's carry renormalisation at the end of
  the previous tile) and a = (a @ A) * lik_t. Every a is stored to alpha.
  Raw likelihoods in; no scale output, shift or floor.
* ``probe_fwd_stack_kernel`` replaces ``_fwd_stack`` (:48): the same chain,
  dividing by the previous stored a's sum, and writing each stored a's sum
  to s (T, B).
* ``probe_micro_kernel<BODY, OUT_T>`` replaces ``make_micro``'s ``kern``
  (:203), the product chain alone: a tile starts from a = pi * lik_0 (tile
  0) or the carry, takes C products a = a @ A, and carries the last one
  times 1e-20. Bodies: "dot_only" (:229; stores the last product at row jC
  only, the other rows stay unwritten), "dot_store" (:235; every product at
  its own row), "dot_bf16" (:241; A and a rounded to bf16 before each
  product, float32 sums, alpha stored as bf16) and "chunk8" / "chunk4"
  (:250; what "dot_store" computes, with 8 or 4 sequences in one block: the
  TPU's interleaved chunks read as independent chains in flight on one SM).

Each kernel has a launcher (:func:`probe_fwd_nos`, :func:`probe_fwd_stack`,
:func:`probe_micro`) with a launch counter and a plain PyTorch twin (the
``*_reference`` functions). A launcher given CPU tensors runs the twin;
given CUDA tensors it launches the kernel or raises. ``probe_micro.launches``
counts per body, one entry per kernel instance.

Layout, as the JAX functions take it: lik and alpha (T, B, K) time-major,
s (T, B); pi (K,) and A (K, K) float32. T must be a multiple of C (the TPU
grid has T // C tiles and would leave a remainder unwritten).
"""

from __future__ import annotations

import torch

from ._launch import bind, check, device_index, ptr, raise_on, runs_plain_twin, stream

MICRO_BODIES = ("dot_only", "dot_store", "dot_bf16", "chunk8", "chunk4")
CARRY_SCALE = 1e-20  # the micro bodies' carry factor (debug_pallas_split.py:233)

_LIB = "split_probe"


def _library():
    """Build (at first use) and bind the kernels' C interface."""
    from .._build import load_library

    return bind(
        load_library(_LIB),
        {"split_probe_fwd_nos": "pppp" "iiii" "ip",
         "split_probe_fwd_stack": "ppppp" "iiii" "ip",
         "split_probe_micro": "pppp" "i" "iiii" "ip",
         "split_probe_kmax": ""},
        "split_probe_error_string",
    )


def _check(pi_t, A_t, lik, C: int) -> tuple[int, int, int]:
    """(T, B, K) of valid inputs; raises on a wrong shape, dtype, device or
    layout, or a C that does not divide T."""
    T, B, K = lik.shape
    dev = lik.device
    for name, x, shape in (("pi_t", pi_t, (K,)), ("A_t", A_t, (K, K)), ("lik", lik, (T, B, K))):
        check(name, x, shape, dev)
    if C < 1 or T % C:
        raise ValueError(f"C={C} must be a positive divisor of T={T}")
    return T, B, K


def _check_kernel_limits(K: int) -> None:
    """Raise on a K the CUDA kernels do not take (one thread per state)."""
    kmax = _library().split_probe_kmax()
    if K > kmax:
        raise NotImplementedError(
            f"the split probe kernels take K <= {kmax}, got K={K} (ROADMAP Queue 2: wider kernels)"
        )


# --------------------------------------------------------------- forwards


def probe_fwd_reference(
    pi_t: torch.Tensor, A_t: torch.Tensor, lik: torch.Tensor, C: int, stack: bool = False
) -> torch.Tensor | tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of both forward probes: alpha (T, B, K) of ``_fwd_nos``,
    or (alpha, s (T, B)) of ``_fwd_stack`` when ``stack``."""
    T = lik.shape[0]
    alpha = torch.empty_like(lik)
    s = torch.empty(lik.shape[:2], dtype=lik.dtype, device=lik.device)
    a = pi_t * lik[0]
    for t in range(T):
        if t > 0:
            if (t % C) % 4 == 0:
                a = a / (s[t - 1][:, None] if stack else a.sum(dim=-1, keepdim=True))
            a = (a @ A_t) * lik[t]
        alpha[t] = a
        if stack:
            s[t] = a.sum(dim=-1)
    return (alpha, s) if stack else alpha


def probe_fwd_nos_reference(pi_t, A_t, lik, C: int) -> torch.Tensor:
    """Plain twin of ``probe_fwd_nos_kernel``: alpha (T, B, K)."""
    return probe_fwd_reference(pi_t, A_t, lik, C)


def probe_fwd_stack_reference(pi_t, A_t, lik, C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of ``probe_fwd_stack_kernel``: (alpha (T, B, K), s (T, B))."""
    return probe_fwd_reference(pi_t, A_t, lik, C, stack=True)


def probe_fwd_nos(pi_t: torch.Tensor, A_t: torch.Tensor, lik: torch.Tensor, C: int) -> torch.Tensor:
    """``probe_fwd_nos_kernel`` launcher; contract of :func:`probe_fwd_nos_reference`."""
    T, B, K = _check(pi_t, A_t, lik, C)
    if runs_plain_twin(lik):
        return probe_fwd_nos_reference(pi_t, A_t, lik, C)
    _check_kernel_limits(K)
    lib = _library()
    alpha = torch.empty((T, B, K), dtype=torch.float32, device=lik.device)
    code = lib.split_probe_fwd_nos(ptr(pi_t), ptr(A_t), ptr(lik), ptr(alpha), T, B, K, C,
                                   device_index(lik.device), stream(lik.device))
    probe_fwd_nos.launches += 1
    raise_on(lib.split_probe_error_string, code, "probe_fwd_nos_kernel")
    return alpha


probe_fwd_nos.launches = 0


def probe_fwd_stack(
    pi_t: torch.Tensor, A_t: torch.Tensor, lik: torch.Tensor, C: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """``probe_fwd_stack_kernel`` launcher; contract of :func:`probe_fwd_stack_reference`."""
    T, B, K = _check(pi_t, A_t, lik, C)
    if runs_plain_twin(lik):
        return probe_fwd_stack_reference(pi_t, A_t, lik, C)
    _check_kernel_limits(K)
    lib = _library()
    alpha = torch.empty((T, B, K), dtype=torch.float32, device=lik.device)
    s = torch.empty((T, B), dtype=torch.float32, device=lik.device)
    code = lib.split_probe_fwd_stack(ptr(pi_t), ptr(A_t), ptr(lik), ptr(alpha), ptr(s),
                                     T, B, K, C, device_index(lik.device), stream(lik.device))
    probe_fwd_stack.launches += 1
    raise_on(lib.split_probe_error_string, code, "probe_fwd_stack_kernel")
    return alpha, s


probe_fwd_stack.launches = 0


# ------------------------------------------------------------------ micro


def micro_dtype(body: str) -> torch.dtype:
    """alpha's dtype for a micro body."""
    return torch.bfloat16 if body == "dot_bf16" else torch.float32


def probe_micro_reference(
    pi_t: torch.Tensor, A_t: torch.Tensor, lik: torch.Tensor, C: int, body: str
) -> torch.Tensor:
    """Plain twin of ``probe_micro_kernel`` with ``body``: alpha (T, B, K) in
    :func:`micro_dtype`. The rows "dot_only" leaves unwritten are NaN here
    (uninitialised in the kernel's output): compare rows t % C == 0 only."""
    if body not in MICRO_BODIES:
        raise ValueError(f"unknown micro body {body!r}; expected one of {MICRO_BODIES}")
    T = lik.shape[0]
    bf16 = body == "dot_bf16"
    alpha = torch.full(lik.shape, float("nan"), dtype=micro_dtype(body), device=lik.device)
    A_use = A_t.to(torch.bfloat16).float() if bf16 else A_t
    a = pi_t * lik[0]
    for t0 in range(0, T, C):
        for p in range(C):
            if bf16:  # the products of bf16 operands are exact in float32
                a = a.to(torch.bfloat16).float()
            a = a @ A_use
            if body != "dot_only":
                alpha[t0 + p] = a
        if body == "dot_only":
            alpha[t0] = a
        a = a * CARRY_SCALE
    return alpha


def probe_micro(
    pi_t: torch.Tensor, A_t: torch.Tensor, lik: torch.Tensor, C: int, body: str
) -> torch.Tensor:
    """``probe_micro_kernel`` launcher for ``body`` (:data:`MICRO_BODIES`);
    contract of :func:`probe_micro_reference`, except that the rows
    "dot_only" leaves unwritten hold whatever ``torch.empty`` gave."""
    T, B, K = _check(pi_t, A_t, lik, C)
    if body not in MICRO_BODIES:
        raise ValueError(f"unknown micro body {body!r}; expected one of {MICRO_BODIES}")
    if runs_plain_twin(lik):
        return probe_micro_reference(pi_t, A_t, lik, C, body)
    _check_kernel_limits(K)
    lib = _library()
    alpha = torch.empty((T, B, K), dtype=micro_dtype(body), device=lik.device)
    code = lib.split_probe_micro(ptr(pi_t), ptr(A_t), ptr(lik), ptr(alpha),
                                 MICRO_BODIES.index(body), T, B, K, C,
                                 device_index(lik.device), stream(lik.device))
    probe_micro.launches[body] += 1
    raise_on(lib.split_probe_error_string, code, f"probe_micro_kernel ({body})")
    return alpha


probe_micro.launches = dict.fromkeys(MICRO_BODIES, 0)


def reset_launch_counts() -> None:
    probe_fwd_nos.launches = 0
    probe_fwd_stack.launches = 0
    probe_micro.launches = dict.fromkeys(MICRO_BODIES, 0)
