"""Forward-backward as a plain loop over time, batched over sequences (port of
``pysvihmm_tpu/messages/scan_fb.py``).

The exact plain path: every kernel of the port is checked against it. Each
step is a (B, K) @ (K, K) product plus elementwise rescaling; ``lax.scan``
becomes a Python loop, ``vmap`` the leading batch axis. The decoders and
the sampler live here too: Viterbi, the log-space filter and
forward-filter backward-sampling (FFBS), which JAX also runs as plain
scans, with no kernel.

Math (normalised space with per-step scaling constants):

    alpha_t ∝ (alpha_{t-1} @ A~) * lik_t          c_t = sum_k(...)
    beta_t  ∝ A~ @ (lik_{t+1} * beta_{t+1})
    log Z   = sum_t log c_t (+ the max shifts)
    gamma_t ∝ alpha_t * beta_t
    xi_t    ∝ alpha_t ⊗ (A~ * (lik_{t+1} beta_{t+1}))

with A~ = exp(E_q[log A]), pi~ = exp(E_q[log pi]) and
lik_t = exp(loglik_t - max_k loglik_tk).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import check_generator


class FBResult(NamedTuple):
    """Posterior quantities of one batched forward-backward sweep.

    gamma:        (B, T, K) smoothed marginals (the fused path gives (T, B, K)
                  or None, see messages/fused_fb.py)
    log_z:        (B,)      variational log-normaliser per sequence
    trans_stats:  (K, K)    sum over sequences and t of w-gated xi_t
    init_stats:   (B, K)    w_0 * gamma_0 per sequence
    log_c:        (B, T)    per-step log scaling constants (sum over T = log_z)
    """

    gamma: torch.Tensor | None
    log_z: torch.Tensor
    trans_stats: torch.Tensor
    init_stats: torch.Tensor
    log_c: torch.Tensor


def _normalize_loglik(log_lik: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-step max shift: (lik in [0, 1], shifts (..., T)). The shift is
    detached, as JAX's ``stop_gradient``: log Z does not depend on it."""
    m = log_lik.detach().amax(dim=-1)
    return torch.exp(log_lik - m[..., None]), m


def forward(
    log_pi: torch.Tensor, log_A: torch.Tensor, log_lik: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Normalised forward recursion over log_lik (B, T, K): (alpha (B, T, K),
    log_z (B,)). Differentiable: d log_z / d log_lik = gamma, d / d log_A =
    sum_t xi_t, d / d log_pi = gamma_0 (:func:`messages.e_step_grad`)."""
    alpha, log_z, _ = forward_with_logc(log_pi, log_A, log_lik)
    return alpha, log_z


def forward_with_logc(
    log_pi: torch.Tensor, log_A: torch.Tensor, log_lik: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Normalised forward recursion over log_lik (B, T, K).

    Returns (alpha (B, T, K) filtered marginals, log_z (B,), log_c (B, T))."""
    A = torch.exp(log_A)
    lik, shifts = _normalize_loglik(log_lik)
    a = torch.exp(log_pi) * lik[:, 0]
    c = a.sum(dim=-1)
    alpha = a / c[:, None]
    alphas, logcs = [alpha], [torch.log(c)]
    for t in range(1, log_lik.shape[1]):
        a = (alpha @ A) * lik[:, t]
        c = a.sum(dim=-1)
        alpha = a / c[:, None]
        alphas.append(alpha)
        logcs.append(torch.log(c))
    log_c = torch.stack(logcs, dim=1) + shifts
    return torch.stack(alphas, dim=1), log_c.sum(dim=-1), log_c


def backward(log_A: torch.Tensor, log_lik: torch.Tensor,
             beta_last: torch.Tensor | None = None) -> torch.Tensor:
    """Normalised backward messages beta (B, T, K): ``beta_last`` (default all
    ones) at t = T-1, each earlier step summing to 1. The time-sharded tiles
    seed beta_last with their boundary message."""
    A = torch.exp(log_A)
    lik, _ = _normalize_loglik(log_lik)
    beta = torch.ones_like(lik[:, 0]) if beta_last is None else beta_last.expand_as(lik[:, 0])
    betas = [beta]
    for t in range(log_lik.shape[1] - 1, 0, -1):
        b = (lik[:, t] * beta) @ A.T
        beta = b / b.sum(dim=-1, keepdim=True)
        betas.append(beta)
    return torch.stack(betas[::-1], dim=1)


def forward_backward(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_lik: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> FBResult:
    """Full smoothing pass over log_lik (B, T, K).

    weights: optional (B, T) 0/1 mask of kept positions (SVI's buffer
    discard). They gate init_stats (w_0) and trans_stats (a transition
    t -> t+1 counts iff w_t = w_{t+1} = 1); the caller gates the emission
    side. trans_stats is summed over the batch:
    sum w xi = A~ ⊙ ((alpha ⊙ w/n)[:-1]^T @ (lik * beta)[1:]).
    """
    A = torch.exp(log_A)
    lik, _ = _normalize_loglik(log_lik)
    alpha, log_z, log_c = forward_with_logc(log_pi, log_A, log_lik)
    beta = backward(log_A, log_lik)
    if weights is None:
        w = torch.ones(log_lik.shape[:2], dtype=log_lik.dtype, device=log_lik.device)
    else:
        w = weights.to(log_lik.dtype)

    g = alpha * beta
    gamma = g / g.sum(dim=-1, keepdim=True)

    bl = lik[:, 1:] * beta[:, 1:]  # (B, T-1, K)
    n = ((alpha[:, :-1] @ A) * bl).sum(dim=-1)  # xi_t normalisers (B, T-1)
    w_pair = w[:, :-1] * w[:, 1:]
    alpha_w = alpha[:, :-1] * (w_pair / n)[..., None]
    trans_stats = A * torch.einsum("btk,btj->kj", alpha_w, bl)
    return FBResult(
        gamma=gamma,
        log_z=log_z,
        trans_stats=trans_stats,
        init_stats=w[:, 0, None] * gamma[:, 0],
        log_c=log_c,
    )


def log_normalizer(
    log_pi: torch.Tensor, log_A: torch.Tensor, log_lik: torch.Tensor
) -> torch.Tensor:
    """log p~(y) per sequence (B,) from the forward pass alone; the autodiff
    generating function."""
    return forward(log_pi, log_A, log_lik)[1]


def viterbi(log_pi: torch.Tensor, log_A: torch.Tensor, log_lik: torch.Tensor) -> torch.Tensor:
    """MAP state paths (B, T) int64 by a max-plus forward loop and a
    backtrace; ties go to the lowest state, as ``jnp.argmax``. The scores
    are shifted by their maximum every step: no argmax sees the shift, and
    float32 scores keep their precision over long chains."""
    delta = log_pi + log_lik[:, 0]  # (B, K)
    args = []
    for t in range(1, log_lik.shape[1]):
        best, arg = (delta[:, :, None] + log_A).max(dim=1)  # (B, K, K): from i to j
        args.append(arg)
        delta = best + log_lik[:, t]
        delta = delta - delta.amax(dim=-1, keepdim=True)
    z = torch.argmax(delta, dim=-1)
    path = [z]
    for arg in reversed(args):
        z = arg.gather(1, z[:, None])[:, 0]
        path.append(z)
    return torch.stack(path[::-1], dim=1)


def forward_filter_log(
    log_pi: torch.Tensor, log_A: torch.Tensor, log_lik: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Log-space filtered marginals log alpha (B, T, K) and log_z (B,) by a
    logsumexp recursion, for FFBS and evaluation."""
    la = log_pi + log_lik[:, 0]
    las = [la]
    for t in range(1, log_lik.shape[1]):
        la = torch.logsumexp(la[:, :, None] + log_A, dim=1) + log_lik[:, t]
        las.append(la)
    return torch.stack(las, dim=1), torch.logsumexp(la, dim=-1)


def gumbel(generator: torch.Generator, shape, dtype: torch.dtype) -> torch.Tensor:
    """Standard Gumbel noise -log(-log U), U uniform in [tiny, 1) as JAX's
    ``gumbel`` draws it, made on the generator's device."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=generator.device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(dtype).tiny)))


def ffbs_from_gumbel(
    log_pi: torch.Tensor, log_A: torch.Tensor, log_lik: torch.Tensor, noise: torch.Tensor
) -> torch.Tensor:
    """Forward-filter backward-sample with the Gumbel noise (B, T, K) given:
    z_t = argmax(logits_t + noise_t), JAX's ``categorical``, so JAX's noise
    gives JAX's path. Returns (B, T) int64.

    The filter is the normalised forward (:func:`forward`): its log differs
    from JAX's log-space filter (:func:`forward_filter_log`) by a constant
    a step, which no argmax sees, and stays of order one where the log-space
    filter grows with t, so float32 logits keep their precision."""
    log_alpha = torch.log(forward(log_pi, log_A, log_lik)[0])
    T = log_lik.shape[1]
    z = torch.argmax(noise[:, T - 1] + log_alpha[:, T - 1], dim=-1)
    path = [z]
    for t in range(T - 2, -1, -1):
        logits = log_alpha[:, t] + log_A.T[z]  # log_A[:, z_next] per sequence
        z = torch.argmax(noise[:, t] + logits, dim=-1)
        path.append(z)
    return torch.stack(path[::-1], dim=1)


def ffbs_sample(
    generator: torch.Generator, log_pi: torch.Tensor, log_A: torch.Tensor, log_lik: torch.Tensor
) -> torch.Tensor:
    """One posterior draw of the state paths (B, T) int64: Gumbel noise
    (B, T, K) drawn on the generator's device, which must be log_lik's, then
    :func:`ffbs_from_gumbel`."""
    check_generator(generator, log_lik.device)
    return ffbs_from_gumbel(log_pi, log_A, log_lik, gumbel(generator, log_lik.shape, log_lik.dtype))
