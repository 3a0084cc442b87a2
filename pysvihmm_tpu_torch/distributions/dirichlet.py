"""Dirichlet distribution functions (port of ``pysvihmm_tpu/distributions/dirichlet.py``).

All functions broadcast over leading axes with the simplex on the LAST axis:
a (K, K) tensor is K independent Dirichlet rows (the transition posterior).
"""

from __future__ import annotations

import torch

from ..utils.device import check_generator


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


def lgamma_diff(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log Gamma(x) - log Gamma(y), taken in float64 and returned in x's
    dtype. The predictive densities need such differences at posterior
    concentrations of 1e4 and more, where each float32 log Gamma is already
    ~1e5 and its rounding exceeds the difference's own precision."""
    return (torch.lgamma(x.double()) - torch.lgamma(y.double())).to(x.dtype)


def standard_gamma(generator: torch.Generator, alpha: torch.Tensor) -> torch.Tensor:
    """Gamma(alpha, 1) draws of alpha's shape, made on the generator's
    device, which must be alpha's."""
    check_generator(generator, alpha.device)
    return torch._standard_gamma(alpha, generator=generator)


def log_gamma(generator: torch.Generator, alpha: torch.Tensor) -> torch.Tensor:
    """log of Gamma(alpha, 1) draws without underflow at small alpha: below
    1, log Gamma(alpha + 1) + log(U) / alpha, the boost JAX's ``loggamma``
    uses. Drawn on the generator's device, which must be alpha's."""
    small = alpha < 1.0
    g = standard_gamma(generator, torch.where(small, alpha + 1.0, alpha))
    u = torch.rand(alpha.shape, generator=generator, dtype=alpha.dtype, device=alpha.device)
    boost = torch.log(u.clamp_min(torch.finfo(alpha.dtype).tiny)) / alpha
    return torch.log(g) + torch.where(small, boost, 0.0)


def from_log_gamma(log_g: torch.Tensor) -> torch.Tensor:
    """Dirichlet draws from log Gamma(alpha_i, 1) draws: their softmax over
    the last axis (JAX's ``dirichlet``)."""
    return torch.softmax(log_g, dim=-1)


def sample(generator: torch.Generator, alpha: torch.Tensor) -> torch.Tensor:
    """Draw from Dir(alpha), batched over leading axes (for the Gibbs engine)."""
    return from_log_gamma(log_gamma(generator, alpha))
