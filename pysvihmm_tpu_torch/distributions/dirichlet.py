"""Dirichlet distribution functions (port of ``pysvihmm_tpu/distributions/dirichlet.py``).

All functions broadcast over leading axes with the simplex on the LAST axis:
a (K, K) tensor is K independent Dirichlet rows (the transition posterior).
"""

from __future__ import annotations

import torch


def expected_log_probs(alpha: torch.Tensor) -> torch.Tensor:
    """E_q[log x] for x ~ Dir(alpha): digamma(alpha_i) - digamma(sum_i alpha_i)."""
    return torch.special.digamma(alpha) - torch.special.digamma(
        alpha.sum(dim=-1, keepdim=True)
    )


def log_normalizer(alpha: torch.Tensor) -> torch.Tensor:
    """log B(alpha) = sum_i lgamma(alpha_i) - lgamma(sum_i alpha_i)."""
    return torch.lgamma(alpha).sum(dim=-1) - torch.lgamma(alpha.sum(dim=-1))


def kl(q_alpha: torch.Tensor, p_alpha: torch.Tensor) -> torch.Tensor:
    """KL(Dir(q_alpha) || Dir(p_alpha)) per row (leading axes kept)."""
    q0 = q_alpha.sum(dim=-1)
    elog = torch.special.digamma(q_alpha) - torch.special.digamma(q0)[..., None]
    return (
        -log_normalizer(q_alpha)
        + log_normalizer(p_alpha)
        + ((q_alpha - p_alpha) * elog).sum(dim=-1)
    )


def posterior(prior_alpha: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
    """Exact conjugate mean-field update: alpha_post = alpha_prior + E[counts]."""
    return prior_alpha + stats


def nat_grad_step(
    q_alpha: torch.Tensor,
    prior_alpha: torch.Tensor,
    stats: torch.Tensor,
    scale: torch.Tensor | float,
    rho: torch.Tensor | float,
) -> torch.Tensor:
    """Natural-gradient SVI step (Hoffman et al. 2013).

    q <- (1 - rho) * q + rho * (prior + scale * stats)

    ``scale`` is the unbiasedness factor turning minibatch expected counts
    into a full-dataset estimate. With rho=1, scale=1 and full-data stats this
    reduces exactly to :func:`posterior`.
    """
    return (1.0 - rho) * q_alpha + rho * (prior_alpha + scale * stats)


def mean(alpha: torch.Tensor) -> torch.Tensor:
    """Posterior mean point estimate (plug-in for predictive scoring)."""
    return alpha / alpha.sum(dim=-1, keepdim=True)
