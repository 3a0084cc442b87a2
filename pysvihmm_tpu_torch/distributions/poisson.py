"""Poisson emissions under per-dimension conjugate Gamma priors (port of
``pysvihmm_tpu/distributions/poisson.py``).

Per-state count vectors y in N^D with independent rates,
    y_d ~ Poisson(lambda_d);   lambda_d ~ Gamma(a_d, b_d)   (rate b).

The expected log-likelihood is linear in the per-observation features
[1, y, sum_d log y_d!] (F = 2 + D, 10 at D=8):
    E[log p(y | lambda_k)] = sum_d (y_d E[log lambda_kd] - E[lambda_kd]) - sum_d log y_d!
with E[log lambda] = digamma(a) - log b and E[lambda] = a / b. The
log-factorial feature has the weight -1 for every state: it cancels in the
posterior over states but keeps log Z and the ELBO exact. The sufficient
statistics are (n, sum_y), the first 1 + D feature columns.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.device import resolve_device
from .dirichlet import lgamma_diff, standard_gamma


class GammaP(NamedTuple):
    """Per-dimension Gamma(a, b) params (rate b), leading axes broadcast
    (canonically (K,)); both fields (..., D)."""

    a: torch.Tensor  # shape
    b: torch.Tensor  # rate


class PoissonStats(NamedTuple):
    """Weighted Poisson sufficient statistics sum_t w_t (1, y)."""

    n: torch.Tensor  # (...,)
    sum_y: torch.Tensor  # (..., D)


def make_prior(
    K: int,
    D: int,
    *,
    a: float = 1.0,
    b: float = 1.0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> GammaP:
    """Weakly-informative Gamma prior replicated over K states (E[lambda] = 1
    at the defaults), on ``device`` (the card when None)."""
    device = resolve_device(device)
    return GammaP(
        a=torch.full((K, D), a, dtype=dtype, device=device),
        b=torch.full((K, D), b, dtype=dtype, device=device),
    )


def _log_factorial_sum(y: torch.Tensor) -> torch.Tensor:
    """sum_d log y_d! over the last axis, keeping it: (..., D) -> (..., 1)."""
    return torch.lgamma(y + 1.0).sum(dim=-1, keepdim=True)


def expected_log_likelihood(q: GammaP, y: torch.Tensor) -> torch.Tensor:
    """E_q[log Poisson(y | lambda_k)]: y (..., D) float counts -> (..., K),
    with the exact -sum_d log y_d! term."""
    e_log_lam = torch.special.digamma(q.a) - torch.log(q.b)  # (K, D)
    const = -(q.a / q.b).sum(dim=-1)  # (K,)
    return y @ e_log_lam.T + const - _log_factorial_sum(y)


def ell_features(y: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., 2 + D) features [1, y, sum_d log y_d!];
    ``expected_log_likelihood(q, y) == ell_features(y) @ ell_feature_matrix(q)``."""
    ones = torch.ones(y.shape[:-1] + (1,), dtype=y.dtype, device=y.device)
    return torch.cat([ones, y, _log_factorial_sum(y)], dim=-1)


def ell_feature_matrix(q: GammaP) -> torch.Tensor:
    """(2 + D, K) weights W: rows [-sum_d E[lambda]; E[log lambda] (D); -1]."""
    e_log_lam = torch.special.digamma(q.a) - torch.log(q.b)  # (K, D)
    const = -(q.a / q.b).sum(dim=-1)  # (K,)
    neg1 = -torch.ones((1, q.a.shape[0]), dtype=q.a.dtype, device=q.a.device)
    return torch.cat([const[None, :], e_log_lam.T, neg1], dim=0)


def suff_stats(gamma: torch.Tensor, y: torch.Tensor) -> PoissonStats:
    """gamma (..., T, K), y (..., T, D) -> stats with leading (..., K)."""
    return PoissonStats(n=gamma.sum(dim=-2), sum_y=torch.einsum("...tk,...td->...kd", gamma, y))


def posterior(prior: GammaP, stats: PoissonStats) -> GammaP:
    """Exact conjugate mean-field update."""
    return GammaP(a=prior.a + stats.sum_y, b=prior.b + stats.n[..., None])


def nat_grad_step(
    q: GammaP,
    prior: GammaP,
    stats: PoissonStats,
    scale: torch.Tensor | float,
    rho: torch.Tensor | float,
) -> GammaP:
    """SVI natural-gradient step. The Gamma natural params (a - 1, -b) are
    affine in (a, b), so blending (a, b) is the natural-parameter blend;
    rho=1, scale=1 with full-data stats equals :func:`posterior`."""
    return GammaP(
        a=(1.0 - rho) * q.a + rho * (prior.a + scale * stats.sum_y),
        b=(1.0 - rho) * q.b + rho * (prior.b + scale * stats.n[..., None]),
    )


def kl(q: GammaP, p: GammaP) -> torch.Tensor:
    """KL(Gamma_q || Gamma_p) per leading element, summed over D."""
    val = (
        (q.a - p.a) * torch.special.digamma(q.a)
        - torch.lgamma(q.a)
        + torch.lgamma(p.a)
        + p.a * (torch.log(q.b) - torch.log(p.b))
        + q.a * (p.b - q.b) / q.b
    )
    return val.sum(dim=-1)


def mean_params(q: GammaP) -> torch.Tensor:
    """Posterior-mean rates E[lambda] = a / b for plug-in scoring."""
    return q.a / q.b


def poisson_log_likelihood(lam: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """log Poisson(y_t | lambda_k): y (..., D), lam (K, D) -> (..., K)."""
    return y @ torch.log(lam).T - lam.sum(dim=-1) - _log_factorial_sum(y)


def predictive_log_likelihood(q: GammaP, y: torch.Tensor) -> torch.Tensor:
    """Exact Gamma-Poisson posterior predictive: per dimension a negative
    binomial NB(r = a, p = b / (b + 1)), product over dimensions.
    y (..., D) -> (..., K). log(b / (1 + b)) is taken as -log1p(1 / b): at
    the posterior's b ~ 1e4 the difference log b - log1p(b) would keep two
    float32 digits."""
    yk = y[..., None, :]  # (..., 1, D) against (K, D)
    return (
        lgamma_diff(yk + q.a, q.a)
        - torch.lgamma(yk + 1.0)
        - q.a * torch.log1p(1.0 / q.b)
        - yk * torch.log1p(q.b)
    ).sum(dim=-1)


def sample_draws(generator: torch.Generator, q: GammaP) -> tuple[torch.Tensor]:
    """The draws :func:`sample_params` consumes: Gamma(a, 1) of a's shape, on
    the generator's device."""
    return (standard_gamma(generator, q.a),)


def params_from_draws(q: GammaP, g: torch.Tensor) -> torch.Tensor:
    """lambda = g / b from Gamma(a, 1) draws g: a draw of Gamma(a, b)."""
    return g / q.b


def sample_params(generator: torch.Generator, q: GammaP) -> torch.Tensor:
    """Draw lambda ~ Gamma(a, b) per leading element (the Gibbs engine)."""
    return params_from_draws(q, *sample_draws(generator, q))
