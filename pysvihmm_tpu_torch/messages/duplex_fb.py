"""The duplex E-step: the forward and the backward chain side by side in one
kernel, then every posterior quantity and statistic chain-free in a second
(port of ``pysvihmm_tpu/messages/pallas_duplex.py::pallas_estep_duplex``).

Kernels (``csrc/duplex_fb.cu``; the source notes what bounds them):

* ``duplex_chain_kernel`` replaces ``_duplex_kernel`` (pallas_duplex.py:82):
  per sequence, the fused forward's recursion (raw alpha, its per-step sums
  s, the max shifts sh) and, independently, the raw backward messages

      b_{T-1} = 1,   d_t = lik_t * b_t / sum_k b_t,   b_{t-1} = A~ d_t

  (normalisation deferred, pallas_duplex.py:146-167), with
  lik_t = exp(ll_t - max_k ll_t) and ll_t = f_t @ W in-kernel.
* ``duplex_combine_kernel`` replaces ``_combine_kernel``
  (pallas_duplex.py:175): with no chain at all, gamma_t = a_t b_t / sum,
  the pairwise accumulator sum_t outer(a_{t-1}, d_t pg_t / sum(a_{t-1}
  b_{t-1})) (the scale-cancelling identity of pallas_duplex.py:19-29) and
  the emission accumulator sum_t outer(w_t gamma_t, f_t). Gated by an SVI
  kept-mask w (T, B) when ``weights`` is given; the pair gate
  pg_t = w_{t-1} w_t (pg_0 = 0) is formed in the kernel from w, and the
  gates touch the statistics only.

Each kernel has a launcher (:func:`duplex_chain`, :func:`duplex_combine`)
with a launch counter and a plain PyTorch twin
(:func:`duplex_chain_reference`, :func:`duplex_combine_reference`) that
follows the duplex recursions and identities step by step, independently of
the fused twins. A launcher given CPU tensors runs the twin; given CUDA
tensors it launches the kernel or raises. :func:`estep_duplex` composes the
launchers and :func:`estep_duplex_reference` the twins, with the contract of
``fused_fb.estep_fused``.
"""

from __future__ import annotations

import torch

from ._launch import bind, check, device_index, ptr, raise_on, runs_plain_twin, stream
from .fused_fb import assemble
from .scan_fb import FBResult
from .split_fb import SUM_FLOOR, exp_params

_LIB = "duplex_fb"


def _library():
    """Build (at first use) and bind the kernels' C interface."""
    from .._build import load_library

    return bind(
        load_library(_LIB),
        {"duplex_fb_chain": "pppppppp" "iiiii" "p",
         "duplex_fb_combine": "pppppppppp" "iiiii" "p",
         "duplex_fb_kmax": "",
         "duplex_fb_fmax": ""},
        "duplex_fb_error_string",
    )


def _check_kernel_limits(K: int, F: int) -> None:
    """Raise on a K or F the CUDA kernels do not take, instead of falling back."""
    lib = _library()
    kmax, fmax = lib.duplex_fb_kmax(), lib.duplex_fb_fmax()
    if K > kmax or F > fmax:
        raise NotImplementedError(
            f"the duplex CUDA kernels take K <= {kmax} and F <= {fmax}, got K={K}, "
            f"F={F} (ROADMAP Queue 2: wider fused kernels)"
        )


def _inv_sum(x: torch.Tensor) -> torch.Tensor:
    """1 / max(sum over the last axis, SUM_FLOOR), keeping that axis."""
    return 1.0 / torch.clamp_min(x.sum(dim=-1, keepdim=True), SUM_FLOOR)


# ------------------------------------------------------------------- chain


def duplex_chain_reference(
    pi_t: torch.Tensor, A_t: torch.Tensor, W: torch.Tensor, feats: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the chain kernel.

    pi_t (K,), A_t (K, K) the exponentiated params; W (F, K); feats
    (T, B, F). Returns (alpha (T, B, K) raw forward messages, s (B, T) their
    per-step sums, sh (B, T) the max shifts, beta (T, B, K) raw backward
    messages). Step j advances the forward to t = j and the backward to
    t = T-1-j, as the TPU kernel interleaves them."""
    ll = feats @ W
    T = ll.shape[0]
    sh = ll.amax(dim=-1)  # (T, B)
    lik = torch.exp(ll - sh[..., None])
    alpha, beta = torch.empty_like(lik), torch.empty_like(lik)
    a = pi_t * lik[0]
    b = torch.ones_like(a)
    alpha[0], beta[T - 1] = a, b
    for j in range(1, T):
        a = (a @ A_t) * (lik[j] * _inv_sum(alpha[j - 1]))
        alpha[j] = a
        t = T - j  # the backward's step: d_t builds b_{t-1}
        b = ((lik[t] * _inv_sum(b)) * b) @ A_t.T
        beta[t - 1] = b
    return alpha, alpha.sum(dim=-1).T.contiguous(), sh.T.contiguous(), beta


def duplex_chain(
    pi_t: torch.Tensor, A_t: torch.Tensor, W: torch.Tensor, feats: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chain kernel launcher; contract of :func:`duplex_chain_reference`.

    Inputs are float32 and contiguous on one device. CPU tensors run the
    plain twin; CUDA tensors launch ``duplex_chain_kernel`` or raise."""
    T, B, F = feats.shape
    K = A_t.shape[0]
    dev = feats.device
    for name, x, shape in (("pi_t", pi_t, (K,)), ("A_t", A_t, (K, K)),
                           ("W", W, (F, K)), ("feats", feats, (T, B, F))):
        check(name, x, shape, dev)
    if runs_plain_twin(feats):
        return duplex_chain_reference(pi_t, A_t, W, feats)
    _check_kernel_limits(K, F)
    lib = _library()
    alpha = torch.empty((T, B, K), dtype=torch.float32, device=dev)
    beta = torch.empty((T, B, K), dtype=torch.float32, device=dev)
    s = torch.empty((B, T), dtype=torch.float32, device=dev)
    sh = torch.empty((B, T), dtype=torch.float32, device=dev)
    code = lib.duplex_fb_chain(
        ptr(pi_t), ptr(A_t), ptr(W), ptr(feats), ptr(alpha), ptr(s), ptr(sh), ptr(beta),
        T, B, K, F, device_index(dev), stream(dev),
    )
    duplex_chain.launches += 1
    raise_on(lib.duplex_fb_error_string, code, "duplex_chain_kernel")
    return alpha, s, sh, beta


duplex_chain.launches = 0


# ----------------------------------------------------------------- combine


def duplex_combine_reference(
    W: torch.Tensor,
    feats: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    sh: torch.Tensor,
    emit_gamma: bool = False,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the combine kernel, over all t at once.

    Takes the chain's raw alpha and beta (T, B, K), its shifts sh (B, T) and
    an optional kept-mask weights (T, B). Returns (gamma (T, B, K), ungated,
    or None; gamma0 = w_0 gamma_0 (B, K); acc (K, K) = sum over sequences and
    t >= 1 of outer(a_{t-1}, d_t pg_t / sum(a_{t-1} b_{t-1})); eacc (K, F)
    = sum of outer(w_t gamma_t, f_t)), with w = pg = 1 when ungated."""
    T, B, F = feats.shape
    K = alpha.shape[-1]
    lik = torch.exp(feats @ W - sh.T[..., None])
    g = alpha * beta
    ginv = _inv_sum(g)  # (T, B, 1)
    gamma = g * ginv
    d = (lik * _inv_sum(beta)) * beta
    dn = d[1:] * ginv[:-1]
    if weights is None:
        gamma_w = gamma
    else:
        gamma_w = gamma * weights[..., None]
        dn = dn * (weights[:-1] * weights[1:])[..., None]  # pg_t, t >= 1
    acc = alpha[:-1].reshape(-1, K).T @ dn.reshape(-1, K)
    eacc = gamma_w.reshape(T * B, K).T @ feats.reshape(T * B, F)
    return (gamma if emit_gamma else None), gamma_w[0].clone(), acc, eacc


def duplex_combine(
    W: torch.Tensor,
    feats: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    sh: torch.Tensor,
    emit_gamma: bool = False,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Combine kernel launcher; contract of :func:`duplex_combine_reference`.

    CPU tensors run the plain twin; CUDA tensors launch
    ``duplex_combine_kernel`` (gated when ``weights`` is given) or raise.
    Each block takes a chunk of time steps (16 or more); acc and eacc are
    summed across blocks with atomics, so their summation order varies from
    run to run."""
    T, B, F = feats.shape
    K = alpha.shape[-1]
    dev = feats.device
    args = [("W", W, (F, K)), ("feats", feats, (T, B, F)), ("alpha", alpha, (T, B, K)),
            ("beta", beta, (T, B, K)), ("sh", sh, (B, T))]
    if weights is not None:
        args.append(("weights", weights, (T, B)))
    for name, x, shape in args:
        check(name, x, shape, dev)
    if runs_plain_twin(feats):
        return duplex_combine_reference(W, feats, alpha, beta, sh, emit_gamma, weights)
    _check_kernel_limits(K, F)
    lib = _library()
    gamma = torch.empty((T, B, K), dtype=torch.float32, device=dev) if emit_gamma else None
    gamma0 = torch.empty((B, K), dtype=torch.float32, device=dev)
    acc = torch.zeros((K, K), dtype=torch.float32, device=dev)
    eacc = torch.zeros((K, F), dtype=torch.float32, device=dev)
    code = lib.duplex_fb_combine(
        ptr(W), ptr(feats), ptr(alpha), ptr(beta), ptr(sh), ptr(weights),
        ptr(gamma), ptr(gamma0), ptr(acc), ptr(eacc),
        T, B, K, F, device_index(dev), stream(dev),
    )
    duplex_combine.launches += 1
    raise_on(lib.duplex_fb_error_string, code, "duplex_combine_kernel")
    return gamma, gamma0, acc, eacc


duplex_combine.launches = 0


def reset_launch_counts() -> None:
    duplex_chain.launches = 0
    duplex_combine.launches = 0


# ------------------------------------------------------------------ E-step


def estep_duplex(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    W: torch.Tensor,
    feats: torch.Tensor,
    emit_gamma: bool = False,
    weights: torch.Tensor | None = None,
) -> tuple[FBResult, torch.Tensor]:
    """Duplex batched E-step, with the contract of ``fused_fb.estep_fused``:
    log_pi (K,), log_A (K, K); W (F, K) and feats (T, B, F) float32,
    time-major and contiguous; weights an optional (T, B) float32 kept-mask.
    Returns (FBResult, emit_stats (K, F)).

    CPU tensors run the plain twins; CUDA tensors run the two kernels."""
    pi_t, A_t = exp_params(log_pi, log_A)
    alpha, s, sh, beta = duplex_chain(pi_t, A_t, W, feats)
    gamma, gamma0, acc, eacc = duplex_combine(W, feats, alpha, beta, sh, emit_gamma, weights)
    return assemble(A_t, s, sh, gamma, gamma0, acc, eacc)


def estep_duplex_reference(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    W: torch.Tensor,
    feats: torch.Tensor,
    emit_gamma: bool = False,
    weights: torch.Tensor | None = None,
) -> tuple[FBResult, torch.Tensor]:
    """Plain PyTorch version of :func:`estep_duplex` on any device."""
    pi_t, A_t = exp_params(log_pi, log_A)
    alpha, s, sh, beta = duplex_chain_reference(pi_t, A_t, W, feats)
    gamma, gamma0, acc, eacc = duplex_combine_reference(
        W, feats, alpha, beta, sh, emit_gamma, weights
    )
    return assemble(A_t, s, sh, gamma, gamma0, acc, eacc)
