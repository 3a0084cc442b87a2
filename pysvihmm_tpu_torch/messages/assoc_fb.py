"""Forward-backward as prefix products of per-step matrices (port of
``pysvihmm_tpu/messages/assoc_fb.py``).

The forward recursion is a product of per-step K x K matrices
M_t[i, j] = A~[i, j] * lik_t[j], so prefix products give every alpha_t in
O(log T) depth and suffix products every beta_t (Särkkä & García-Fernández,
arXiv:2102.05743). Each combine is a batched (K, K) @ (K, K) product.

Representation: (M, s) stands for exp(s) * M, with M max-normalised so that
products neither overflow nor underflow at T = 100k+.

PyTorch has no ``lax.associative_scan``: :func:`_associative_scan` is this
module's own, and follows JAX's recursion (combine adjacent pairs, recurse
on the half, fill the even positions), so the tree of products, and where
each max-renormalisation falls, are JAX's. It writes nothing in place, so
autograd differentiates through it (:func:`messages.e_step_grad` with
``method="assoc"``).

O(T K^3) flops against the scan's O(T K^2), and T x K x K prefix matrices
in memory: long chains take the streaming tiers of :mod:`.blocked` and
:mod:`.stream_fused`.
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch

from .scan_fb import FBResult, _normalize_loglik


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """[even[0], odd[0], even[1], odd[1], ...] along axis 0; ``even`` has as
    many rows as ``odd`` or one more."""
    n = odd.shape[0]
    pairs = torch.stack((even[:n], odd), dim=1).flatten(0, 1)
    return pairs if even.shape[0] == n else torch.cat((pairs, even[n:]), dim=0)


def _associative_scan(
    fn: Callable[[Sequence[torch.Tensor], Sequence[torch.Tensor]], Sequence[torch.Tensor]],
    elems: Sequence[torch.Tensor],
    reverse: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Inclusive scan of ``fn`` over axis 0 of every tensor in ``elems``, in
    JAX's order (``lax.associative_scan``): element t is
    fn(...fn(fn(e_0, e_1), e_2)..., e_t), each bracket where JAX puts it.

    reverse=True scans the elements in reversed order and reverses the
    result back, as JAX does: element t is then e_{T-1} (x) ... (x) e_t,
    the product composed in REVERSED order (so a caller that wants the
    suffix products e_t ... e_{T-1} of matrices feeds their transposes)."""
    elems = [torch.flip(e, (0,)) for e in elems] if reverse else list(elems)

    def scan(xs: list[torch.Tensor]) -> list[torch.Tensor]:
        n = xs[0].shape[0]
        if n < 2:
            return xs
        odd = scan(list(fn([x[0:-1:2] for x in xs], [x[1::2] for x in xs])))
        if n % 2 == 0:
            even = fn([o[:-1] for o in odd], [x[2::2] for x in xs])
        else:
            even = fn(odd, [x[2::2] for x in xs])
        even = [torch.cat((x[:1], e), dim=0) for x, e in zip(xs, even)]
        return [_interleave(e, o) for e, o in zip(even, odd)]

    out = scan(elems)
    return tuple(torch.flip(o, (0,)) for o in out) if reverse else tuple(out)


def _combine(a: Sequence[torch.Tensor],
             b: Sequence[torch.Tensor]) -> tuple[torch.Tensor, torch.Tensor]:
    """(Ma, sa) (x) (Mb, sb) -> max-normalised (Ma @ Mb, sa + sb + log c)."""
    Ma, sa = a
    Mb, sb = b
    P = torch.matmul(Ma, Mb)
    c = P.amax(dim=(-2, -1), keepdim=True)
    return P / c, sa + sb + torch.log(c[..., 0, 0])


def _step_matrices(A: torch.Tensor, lik: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The transitions' max-normalised matrices, time-major: (M_n (T-1, B,
    K, K), s0 (T-1, B)) for lik (B, T, K), M_t = A~ * lik_t[None, :]."""
    M = (A * lik[:, 1:, None, :]).transpose(0, 1)
    m0 = M.amax(dim=(-2, -1), keepdim=True)
    return M / m0, torch.log(m0[..., 0, 0])


def forward_backward_assoc(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_lik: torch.Tensor,
    weights: torch.Tensor | None = None,
) -> FBResult:
    """:func:`scan_fb.forward_backward`'s contract over log_lik (B, T, K),
    log-depth in T. JAX vmaps the one-sequence form; the port scans every
    sequence at once (the batch is an axis of each product)."""
    B, T, K = log_lik.shape
    dtype = log_lik.dtype
    A = torch.exp(log_A)
    lik, shifts = _normalize_loglik(log_lik)
    w = (torch.ones((B, T), dtype=dtype, device=log_lik.device) if weights is None
         else weights.to(dtype))

    v0 = torch.exp(log_pi) * lik[:, 0]
    c0 = v0.sum(dim=-1)
    alpha0 = v0 / c0[:, None]
    if T == 1:
        # no transitions: the chain posterior is one categorical
        log_z = torch.log(c0) + shifts.sum(dim=-1)
        return FBResult(
            gamma=alpha0[:, None],
            log_z=log_z,
            trans_stats=torch.zeros((K, K), dtype=dtype, device=log_lik.device),
            init_stats=w[:, :1] * alpha0,
            log_c=log_z[:, None],
        )

    M_n, s0 = _step_matrices(A, lik)
    # prefix products P_t = M_1 ... M_t (inclusive)
    P, sP = _associative_scan(_combine, (M_n, s0))
    alpha_un = torch.einsum("bk,tbkj->btj", alpha0, P)  # (B, T-1, K)
    alpha_sums = alpha_un.sum(dim=-1)
    alpha = torch.cat((alpha0[:, None], alpha_un / alpha_sums[..., None]), dim=1)

    # per-step log c from differences of the cumulative log-mass
    cums = torch.log(alpha_sums) + sP.T  # (B, T-1)
    zero = torch.zeros((B, 1), dtype=dtype, device=log_lik.device)
    log_c = torch.cat((torch.log(c0)[:, None], torch.diff(cums, dim=1, prepend=zero)), dim=1)
    log_c = log_c + shifts
    log_z = torch.log(c0) + cums[:, -1] + shifts.sum(dim=-1)

    # suffix products through the reversed scan of transposes:
    # S'_t = M_{T-1}^T ... M_{t+1}^T = (M_{t+1} ... M_{T-1})^T, and
    # beta_t = (M_{t+1} ... M_{T-1}) @ 1 = the column sums of S'_t
    S, _ = _associative_scan(_combine, (M_n.transpose(-1, -2), s0), reverse=True)
    beta_un = S.sum(dim=-2).transpose(0, 1)  # (B, T-1, K), rows t = 0..T-2
    beta = torch.cat((beta_un / beta_un.sum(dim=-1, keepdim=True),
                      torch.ones((B, 1, K), dtype=dtype, device=log_lik.device)), dim=1)

    g = alpha * beta
    gamma = g / g.sum(dim=-1, keepdim=True)

    bl = lik[:, 1:] * beta[:, 1:]
    n = ((alpha[:, :-1] @ A) * bl).sum(dim=-1)
    w_pair = w[:, :-1] * w[:, 1:]
    alpha_w = alpha[:, :-1] * (w_pair / n)[..., None]
    trans_stats = A * torch.einsum("btk,btj->kj", alpha_w, bl)
    return FBResult(
        gamma=gamma,
        log_z=log_z,
        trans_stats=trans_stats,
        init_stats=w[:, :1] * gamma[:, 0],
        log_c=log_c,
    )


def log_normalizer_assoc(
    log_pi: torch.Tensor, log_A: torch.Tensor, log_lik: torch.Tensor
) -> torch.Tensor:
    """log p~(y) per sequence (B,) for log_lik (B, T, K) by one prefix-product
    scan (log depth); differentiable, the generating function of
    :func:`messages.e_step_grad` with ``method="assoc"``."""
    A = torch.exp(log_A)
    lik, shifts = _normalize_loglik(log_lik)
    v0 = torch.exp(log_pi) * lik[:, 0]
    if log_lik.shape[1] == 1:
        return torch.log(v0.sum(dim=-1)) + shifts.sum(dim=-1)
    M_n, s0 = _step_matrices(A, lik)
    P, sP = _associative_scan(_combine, (M_n, s0))
    c0 = v0.sum(dim=-1)
    total = torch.einsum("bk,bkj->b", v0 / c0[:, None], P[-1])
    return torch.log(c0) + torch.log(total) + sP[-1] + shifts.sum(dim=-1)
