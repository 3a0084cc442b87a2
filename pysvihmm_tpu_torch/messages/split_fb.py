"""The split E-step: forward-backward over log-likelihoods already in device
memory, in two hand-written CUDA kernels (port of
``pysvihmm_tpu/messages/pallas_fb.py::pallas_forward_backward_batched``,
pallas_fb.py:1121-1304, without its lane packing).

Kernels (``csrc/split_fb.cu``; the source notes what bounds them):

* ``split_fwd_kernel`` replaces ``_fwd_kernel`` (pallas_fb.py:339) with
  ``log_in``: per step the max shift sh_t = max_k ll_t, lik_t =
  exp(ll_t - sh_t), the forward chain with per-sequence renormalisation every
  step, the stored raw alpha and its per-step sums s.
* ``split_bwd_kernel`` replaces ``_bwd_kernel`` (pallas_fb.py:406): the
  reverse walk, gamma, and the pairwise accumulator
  sum_t outer(alpha_{t-1}, d_t n_t g_t) with an optional pair gate g. It
  computes no emission statistics; the engines take those outside, as
  gamma^T @ features (engines/base.py::_split_estep).

Each kernel has a launcher (:func:`split_forward`, :func:`split_backward`)
with a launch counter and a plain PyTorch twin
(:func:`split_forward_reference`, :func:`split_backward_reference`). A
launcher given CPU tensors runs the twin; given CUDA tensors it launches the
kernel or raises. The twins are also the chain of the fused E-step's twins
(``fused_fb.py`` runs them on ll = feats @ W).

Contract of :func:`estep_split`: log-likelihoods ``ll`` (T, B, K) float32,
TIME-MAJOR and contiguous, and an optional kept-mask ``weights`` (T, B).
Returns an ``FBResult`` with gamma (T, B, K) (ungated), log_c (B, T), log_z
(B,), init_stats = w_0 gamma_0 (B, K) and trans_stats = A~ * acc (K, K),
pair-gated and summed over sequences.
"""

from __future__ import annotations

import torch

from ._launch import bind, check, device_index, ptr, raise_on, runs_plain_twin, scratch, stream
from .scan_fb import FBResult

SUM_FLOOR = 1e-38  # per-sequence sum floor (pallas_fb.py:82)

_LIB = "split_fb"


def _library():
    """Build (at first use) and bind the kernels' C interface."""
    from .._build import load_library

    return bind(
        load_library(_LIB),
        {"split_fb_forward": "pppppp" "iiii" "p",
         "split_fb_backward": "ppppppppp" "iiii" "p",
         "split_fb_scratch": "iiip",
         "split_fb_kmax": ""},
        "split_fb_error_string",
    )


def _check_kernel_limits(K: int) -> None:
    """Raise on a K the CUDA kernels do not take (K <= 64 on the first
    instances, 65-256 on the large-K ones) instead of falling back."""
    kmax = _library().split_fb_kmax()
    if K > kmax:
        raise NotImplementedError(f"the split CUDA kernels take K <= {kmax}, got K={K}")


def exp_params(log_pi: torch.Tensor, log_A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """pi~, A~ as contiguous float32 (exp first, then the cast, as the JAX
    wrappers do)."""
    return (
        torch.exp(log_pi).to(torch.float32).contiguous(),
        torch.exp(log_A).to(torch.float32).contiguous(),
    )


def pair_gate(weights: torch.Tensor) -> torch.Tensor:
    """Kept-mask w (T, B) -> pair gate g (T, B): g_0 = 0, g_t = w_{t-1} w_t.

    The transition (t-1, t) counts iff both ends are kept
    (pallas_fb.py:1014-1019, :1243-1248)."""
    return torch.cat([torch.zeros_like(weights[:1]), weights[:-1] * weights[1:]], dim=0)


# ----------------------------------------------------------------- forward


def split_forward_reference(
    pi_t: torch.Tensor, A_t: torch.Tensor, ll: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the forward kernel.

    pi_t (K,), A_t (K, K) the exponentiated params; ll (T, B, K)
    log-likelihoods. Returns (alpha (T, B, K) raw stored messages, s (B, T)
    their per-step sums, sh (B, T) the max shifts)."""
    T = ll.shape[0]
    sh = ll.amax(dim=-1)
    lik = torch.exp(ll - sh[..., None])
    alpha = torch.empty_like(lik)
    s = torch.empty_like(sh)
    a = pi_t * lik[0]
    alpha[0], s[0] = a, a.sum(dim=-1)
    for t in range(1, T):
        inv = 1.0 / torch.clamp_min(s[t - 1], SUM_FLOOR)
        a = (a @ A_t) * (lik[t] * inv[:, None])
        alpha[t], s[t] = a, a.sum(dim=-1)
    return alpha, s.T.contiguous(), sh.T.contiguous()


def split_forward(
    pi_t: torch.Tensor, A_t: torch.Tensor, ll: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward kernel launcher; contract of :func:`split_forward_reference`.

    Inputs are float32 and contiguous on one device. CPU tensors run the
    plain twin; CUDA tensors launch ``split_fwd_kernel`` or raise."""
    T, B, K = ll.shape
    dev = ll.device
    for name, x, shape in (("pi_t", pi_t, (K,)), ("A_t", A_t, (K, K)), ("ll", ll, (T, B, K))):
        check(name, x, shape, dev)
    if runs_plain_twin(ll):
        return split_forward_reference(pi_t, A_t, ll)
    _check_kernel_limits(K)
    lib = _library()
    alpha = torch.empty((T, B, K), dtype=torch.float32, device=dev)
    s = torch.empty((B, T), dtype=torch.float32, device=dev)
    sh = torch.empty((B, T), dtype=torch.float32, device=dev)
    code = lib.split_fb_forward(
        ptr(pi_t), ptr(A_t), ptr(ll), ptr(alpha), ptr(s), ptr(sh),
        T, B, K, device_index(dev), stream(dev),
    )
    split_forward.launches += 1
    raise_on(lib.split_fb_error_string, code, "split_fwd_kernel")
    return alpha, s, sh


split_forward.launches = 0


# ---------------------------------------------------------------- backward


def split_backward_reference(
    A_t: torch.Tensor,
    ll: torch.Tensor,
    alpha: torch.Tensor,
    s: torch.Tensor,
    sh: torch.Tensor,
    g: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the backward kernel.

    Takes the forward's (alpha (T, B, K), s (B, T), sh (B, T)) and the
    optional pair gate g (T, B). Returns (gamma (T, B, K), ungated; acc
    (K, K) = sum over sequences and t of outer(alpha_{t-1}, d_t n_t g_t)).
    The beta chain runs on the ungated d."""
    T, B, K = ll.shape
    lik = torch.exp(ll - sh.T[..., None])
    r = 1.0 / torch.clamp_min(s, SUM_FLOOR)  # (B, T)
    beta = r[:, T - 1, None].expand(B, K)
    gamma = torch.empty_like(alpha)
    acc = torch.zeros((K, K), dtype=alpha.dtype, device=alpha.device)
    for t in range(T - 1, -1, -1):
        graw = alpha[t] * beta
        n = 1.0 / torch.clamp_min(graw.sum(dim=-1), SUM_FLOOR)
        gamma[t] = graw * n[:, None]
        if t >= 1:
            d = (lik[t] * r[:, t - 1, None]) * beta
            dn = d * n[:, None]
            if g is not None:
                dn = dn * g[t, :, None]
            acc += alpha[t - 1].T @ dn
            beta = d @ A_t.T
    return gamma, acc


def split_backward(
    A_t: torch.Tensor,
    ll: torch.Tensor,
    alpha: torch.Tensor,
    s: torch.Tensor,
    sh: torch.Tensor,
    g: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward kernel launcher; contract of :func:`split_backward_reference`.

    CPU tensors run the plain twin; CUDA tensors launch ``split_bwd_kernel``
    (``split_bwd_wide_kernel`` above K = 64) or raise. acc is summed across
    sequences in an order fixed by the shapes (csrc/fb_stats.cuh), so
    repeated calls on one card give the same bits. Above K = 64 the launch
    takes a scratch of min(T B, max(B, 2^17)) K floats beside the carried
    beta (B K) and the sum's partials, whatever T: about 0.14 GB at B =
    1024, K = 256 (acc a window of time steps a launch)."""
    T, B, K = ll.shape
    dev = ll.device
    args = [("A_t", A_t, (K, K)), ("ll", ll, (T, B, K)), ("alpha", alpha, (T, B, K)),
            ("s", s, (B, T)), ("sh", sh, (B, T))]
    if g is not None:
        args.append(("g", g, (T, B)))
    for name, x, shape in args:
        check(name, x, shape, dev)
    if runs_plain_twin(ll):
        return split_backward_reference(A_t, ll, alpha, s, sh, g)
    _check_kernel_limits(K)
    lib = _library()
    gamma = torch.empty((T, B, K), dtype=torch.float32, device=dev)
    acc = torch.empty((K, K), dtype=torch.float32, device=dev)
    work = scratch(lib, "split_fb_scratch", lib.split_fb_error_string, dev, T, B, K)
    code = lib.split_fb_backward(
        ptr(A_t), ptr(ll), ptr(alpha), ptr(s), ptr(sh), ptr(g), ptr(gamma), ptr(acc),
        ptr(work), T, B, K, device_index(dev), stream(dev),
    )
    split_backward.launches += 1
    raise_on(lib.split_fb_error_string, code, "split_bwd_kernel")
    return gamma, acc


split_backward.launches = 0


def reset_launch_counts() -> None:
    split_forward.launches = 0
    split_backward.launches = 0


# ------------------------------------------------------------------ E-step


def _assemble(A_t, s, sh, gamma, acc, weights) -> FBResult:
    log_c = torch.log(s) + sh  # (B, T): log c_t = log s_t + sh_t
    init = gamma[0] if weights is None else gamma[0] * weights[0][:, None]
    return FBResult(
        gamma=gamma,
        log_z=log_c.sum(dim=-1),
        trans_stats=A_t * acc,
        init_stats=init,
        log_c=log_c,
    )


def estep_split(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    ll: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> FBResult:
    """Split batched E-step over log-likelihoods ll (T, B, K) float32,
    time-major and contiguous, with an optional kept-mask weights (T, B)
    float32. Contract in the module docstring. CPU tensors run the plain
    twins; CUDA tensors run the two kernels."""
    pi_t, A_t = exp_params(log_pi, log_A)
    alpha, s, sh = split_forward(pi_t, A_t, ll)
    g = None if weights is None else pair_gate(weights)
    gamma, acc = split_backward(A_t, ll, alpha, s, sh, g)
    return _assemble(A_t, s, sh, gamma, acc, weights)


def estep_split_reference(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    ll: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> FBResult:
    """Plain PyTorch version of :func:`estep_split` on any device."""
    pi_t, A_t = exp_params(log_pi, log_A)
    alpha, s, sh = split_forward_reference(pi_t, A_t, ll)
    g = None if weights is None else pair_gate(weights)
    gamma, acc = split_backward_reference(A_t, ll, alpha, s, sh, g)
    return _assemble(A_t, s, sh, gamma, acc, weights)
