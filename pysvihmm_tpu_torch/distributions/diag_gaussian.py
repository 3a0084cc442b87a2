"""Diagonal-Gaussian emissions under per-dimension Normal-Inverse-Gamma priors
(port of ``pysvihmm_tpu/distributions/diag_gaussian.py``).

Model, independently per dimension d:
    sigma2_d ~ InvGamma(a_d, b_d);  mu_d | sigma2_d ~ N(m_d, sigma2_d / kappa_d)

Everything is elementwise over (..., D). The expected log-likelihood is
linear in the per-observation features [1, y, y^2] (F = 1 + 2D, 17 at D=8),
which are also the observation side of the sufficient statistics, so the
family runs on the fused and duplex kernels as the NIW does. Natural
coordinates (kappa m, kappa, 2b + kappa m^2, 2a) make the SVI step an
elementwise blend with the statistic map t = (sum_y, n, sum_y2, n).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils.device import resolve_device


class NIG(NamedTuple):
    """Per-dimension NIG parameters, leading axes broadcast (canonically
    (K,)); every field is (..., D)."""

    mean: torch.Tensor  # (..., D)
    kappa: torch.Tensor  # (..., D)
    a: torch.Tensor  # (..., D) inverse-gamma shape
    b: torch.Tensor  # (..., D) inverse-gamma scale


class DiagGaussianStats(NamedTuple):
    """Weighted diagonal-Gaussian sufficient statistics sum_t w_t (1, y, y^2)."""

    n: torch.Tensor  # (...,)
    sum_y: torch.Tensor  # (..., D)
    sum_y2: torch.Tensor  # (..., D)


class EllParams(NamedTuple):
    """E_q[log N(y | mu, diag sigma2)] = const + y . c1 + y^2 . c2."""

    c1: torch.Tensor  # (..., D)
    c2: torch.Tensor  # (..., D)
    const: torch.Tensor  # (...,)


def make_prior(
    K: int,
    D: int,
    *,
    mean: torch.Tensor | None = None,
    kappa: float = 1.0,
    a: float = 2.0,
    b: float = 1.0,
    dtype: torch.dtype = torch.float32,
    device: torch.device | str | None = None,
) -> NIG:
    """Weakly-informative NIG prior replicated over K states (E[sigma2] = 1 at
    the defaults), on ``device`` (the card when None)."""
    device = resolve_device(device)
    if mean is None:
        mean = torch.zeros((D,), dtype=dtype, device=device)
    mean = torch.as_tensor(mean, dtype=dtype, device=device).expand(K, D).clone()

    def full(v):
        return torch.full((K, D), v, dtype=dtype, device=device)

    return NIG(mean=mean, kappa=full(kappa), a=full(a), b=full(b))


def ell_params(q: NIG) -> EllParams:
    e_prec = q.a / q.b  # E[1/sigma2]
    e_log_prec = torch.special.digamma(q.a) - torch.log(q.b)  # E[log 1/sigma2]
    const = 0.5 * (
        e_log_prec - math.log(2.0 * math.pi) - e_prec * q.mean**2 - 1.0 / q.kappa
    ).sum(dim=-1)
    return EllParams(c1=e_prec * q.mean, c2=-0.5 * e_prec, const=const)


def expected_log_likelihood(q: NIG, y: torch.Tensor) -> torch.Tensor:
    """E_q[log N(y_t | mu_k, diag sigma2_k)]: y (..., D), q leading (K,) ->
    (..., K), as two (..., D) @ (D, K) products."""
    p = ell_params(q)
    return p.const + y @ p.c1.T + (y * y) @ p.c2.T


def ell_features(y: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (..., 1 + 2D) features [1, y, y^2];
    ``expected_log_likelihood(q, y) == ell_features(y) @ ell_feature_matrix(q)``."""
    ones = torch.ones(y.shape[:-1] + (1,), dtype=y.dtype, device=y.device)
    return torch.cat([ones, y, y * y], dim=-1)


def ell_feature_matrix(q: NIG) -> torch.Tensor:
    """(1 + 2D, K) weights W with E_q[log N(y | mu_k, .)] = feats @ W."""
    p = ell_params(q)
    return torch.cat([p.const[None, :], p.c1.T, p.c2.T], dim=0)


def suff_stats(gamma: torch.Tensor, y: torch.Tensor) -> DiagGaussianStats:
    """gamma (..., T, K), y (..., T, D) -> stats with leading (..., K)."""
    return DiagGaussianStats(
        n=gamma.sum(dim=-2),
        sum_y=torch.einsum("...tk,...td->...kd", gamma, y),
        sum_y2=torch.einsum("...tk,...td->...kd", gamma, y * y),
    )


def posterior(prior: NIG, stats: DiagGaussianStats) -> NIG:
    """Exact conjugate mean-field update."""
    n = stats.n[..., None]
    kappa_n = prior.kappa + n
    mean_n = (prior.kappa * prior.mean + stats.sum_y) / kappa_n
    b_n = prior.b + 0.5 * (stats.sum_y2 + prior.kappa * prior.mean**2 - kappa_n * mean_n**2)
    return NIG(mean=mean_n, kappa=kappa_n, a=prior.a + 0.5 * n, b=b_n)


class NIGNat(NamedTuple):
    eta1: torch.Tensor  # kappa * m            (..., D)
    eta2: torch.Tensor  # kappa                (..., D)
    eta3: torch.Tensor  # 2b + kappa m^2       (..., D)
    eta4: torch.Tensor  # 2a                   (..., D)


def to_natural(q: NIG) -> NIGNat:
    return NIGNat(
        eta1=q.kappa * q.mean,
        eta2=q.kappa,
        eta3=2.0 * q.b + q.kappa * q.mean**2,
        eta4=2.0 * q.a,
    )


def from_natural(n: NIGNat) -> NIG:
    mean = n.eta1 / n.eta2
    return NIG(mean=mean, kappa=n.eta2, a=0.5 * n.eta4, b=0.5 * (n.eta3 - n.eta2 * mean**2))


def nat_grad_step(
    q: NIG,
    prior: NIG,
    stats: DiagGaussianStats,
    scale: torch.Tensor | float,
    rho: torch.Tensor | float,
) -> NIG:
    """SVI natural-gradient step: eta <- (1-rho) eta + rho (eta_prior +
    scale * t(stats)) with t = (sum_y, n, sum_y2, n). With rho=1, scale=1 and
    full-data stats this equals :func:`posterior`."""
    qn, pn = to_natural(q), to_natural(prior)
    n = stats.n[..., None]
    blended = NIGNat(
        eta1=(1.0 - rho) * qn.eta1 + rho * (pn.eta1 + scale * stats.sum_y),
        eta2=(1.0 - rho) * qn.eta2 + rho * (pn.eta2 + scale * n),
        eta3=(1.0 - rho) * qn.eta3 + rho * (pn.eta3 + scale * stats.sum_y2),
        eta4=(1.0 - rho) * qn.eta4 + rho * (pn.eta4 + scale * n),
    )
    return from_natural(blended)


def kl(q: NIG, p: NIG) -> torch.Tensor:
    """KL(NIG_q || NIG_p) per leading element, summed over D: the Gamma KL on
    the precision plus the expected Gaussian KL on the mean."""
    kl_gamma = (
        (q.a - p.a) * torch.special.digamma(q.a)
        - torch.lgamma(q.a)
        + torch.lgamma(p.a)
        + p.a * (torch.log(q.b) - torch.log(p.b))
        + q.a * (p.b - q.b) / q.b
    )
    ratio = p.kappa / q.kappa
    kl_normal = 0.5 * (
        ratio - 1.0 - torch.log(ratio) + p.kappa * (q.a / q.b) * (q.mean - p.mean) ** 2
    )
    return (kl_gamma + kl_normal).sum(dim=-1)


def mean_params(q: NIG) -> tuple[torch.Tensor, torch.Tensor]:
    """Posterior-mean point estimate (E[mu], E[sigma2]) for plug-in scoring."""
    return q.mean, q.b / torch.clamp_min(q.a - 1.0, 1e-2)
