"""Emission families with a uniform static interface (port of
``pysvihmm_tpu/distributions/emissions.py``).

Families:
  * :class:`GaussianNIW` -- Gaussian emissions under a Normal-Inverse-Wishart
    prior; features [1, y, triu(y y^T)].
  * :class:`DiagonalGaussianNIG` -- diagonal-covariance Gaussian emissions
    under per-dimension Normal-Inverse-Gamma priors; features [1, y, y^2].
  * :class:`MultinomialDirichlet` -- categorical emissions over V symbols
    under a Dirichlet prior; integer observations, no feature form: the
    fused and duplex routes feed the kernels one-hot features and
    W = E[log phi]^T (engines/base.py).
  * :class:`PoissonGamma` -- per-dimension Poisson counts under conjugate
    Gamma priors; features [1, y, sum_d log y_d!].

Families with ``ell_features`` / ``ell_feature_matrix`` run on the kernel
routes through one (T, B, F) feature array, and ``unpack_flat_stats`` turns
the kernels' (K, F) accumulator into the family's statistics.
"""

from __future__ import annotations

import torch

from ..utils.device import resolve_device
from . import diag_gaussian, dirichlet, niw, poisson
from .diag_gaussian import NIG, DiagGaussianStats
from .niw import NIW, GaussianStats
from .poisson import GammaP, PoissonStats


class GaussianNIW:
    """Gaussian emissions with a conjugate NIW prior. Params: :class:`NIW` (K, ...)."""

    name = "gaussian_niw"

    @staticmethod
    def make_prior(K: int, obs_dim: int, dtype=torch.float32, device=None, **kw) -> NIW:
        """The NIW prior on ``device`` (the card when None)."""
        return niw.make_prior(K, obs_dim, dtype=dtype, device=device, **kw)

    @staticmethod
    def expected_log_likelihood(params: NIW, y: torch.Tensor) -> torch.Tensor:
        """y (..., D) -> (..., K)."""
        return niw.expected_log_likelihood(params, y)

    @staticmethod
    def ell_features(y: torch.Tensor) -> torch.Tensor:
        """Per-observation features [1, y, triu(y y^T)] (see :func:`niw.ell_features`)."""
        return niw.ell_features(y)

    @staticmethod
    def ell_feature_matrix(params: NIW) -> torch.Tensor:
        return niw.ell_feature_matrix(params)

    @staticmethod
    def suff_stats(gamma: torch.Tensor, y: torch.Tensor) -> GaussianStats:
        return niw.suff_stats(gamma, y)

    @staticmethod
    def posterior(prior: NIW, stats: GaussianStats) -> NIW:
        return niw.posterior(prior, stats)

    @staticmethod
    def nat_grad_step(q: NIW, prior: NIW, stats: GaussianStats, scale, rho) -> NIW:
        return niw.nat_grad_step(q, prior, stats, scale, rho)

    @staticmethod
    def kl(q: NIW, p: NIW) -> torch.Tensor:
        return niw.kl(q, p).sum()

    @staticmethod
    def sample_obs(
        generator: torch.Generator, theta: tuple[torch.Tensor, torch.Tensor], z: torch.Tensor
    ) -> torch.Tensor:
        """Sample y_t | z_t for an int state path z (...,); draws on z's device."""
        mu, sigma = theta
        chol = torch.linalg.cholesky(sigma)
        eps = torch.randn(
            z.shape + (mu.shape[-1],), generator=generator, dtype=mu.dtype, device=z.device
        )
        return mu[z] + (chol[z] @ eps[..., None])[..., 0]

    @staticmethod
    def unpack_flat_stats(params: NIW, S: torch.Tensor) -> GaussianStats:
        """(K, 1 + D + D(D+1)/2) fused-kernel accumulator -> GaussianStats.

        The triu columns are the raw sums sum gamma y_i y_j for i <= j
        (:func:`niw.ell_features` layout); mirror them to the full symmetric
        (K, D, D) second-moment matrix."""
        D = params.mean.shape[-1]
        K = S.shape[0]
        iu, ju = torch.triu_indices(D, D, device=S.device)
        upper = torch.zeros((K, D, D), dtype=S.dtype, device=S.device)
        upper[:, iu, ju] = S[:, 1 + D :]
        eye = torch.eye(D, dtype=S.dtype, device=S.device)
        sum_yyT = upper + upper.transpose(-1, -2) * (1.0 - eye)
        return GaussianStats(n=S[:, 0], sum_y=S[:, 1 : 1 + D], sum_yyT=sum_yyT)


class DiagonalGaussianNIG:
    """Diagonal-Gaussian emissions, per-dimension NIG prior. Params: :class:`NIG` (K, D)."""

    name = "diag_gaussian_nig"

    @staticmethod
    def make_prior(K: int, obs_dim: int, dtype=torch.float32, device=None, **kw) -> NIG:
        """The NIG prior on ``device`` (the card when None)."""
        return diag_gaussian.make_prior(K, obs_dim, dtype=dtype, device=device, **kw)

    @staticmethod
    def expected_log_likelihood(params: NIG, y: torch.Tensor) -> torch.Tensor:
        """y (..., D) -> (..., K)."""
        return diag_gaussian.expected_log_likelihood(params, y)

    @staticmethod
    def ell_features(y: torch.Tensor) -> torch.Tensor:
        """Per-observation features [1, y, y^2] (width 1 + 2D)."""
        return diag_gaussian.ell_features(y)

    @staticmethod
    def ell_feature_matrix(params: NIG) -> torch.Tensor:
        return diag_gaussian.ell_feature_matrix(params)

    @staticmethod
    def suff_stats(gamma: torch.Tensor, y: torch.Tensor) -> DiagGaussianStats:
        return diag_gaussian.suff_stats(gamma, y)

    @staticmethod
    def posterior(prior: NIG, stats: DiagGaussianStats) -> NIG:
        return diag_gaussian.posterior(prior, stats)

    @staticmethod
    def nat_grad_step(q: NIG, prior: NIG, stats: DiagGaussianStats, scale, rho) -> NIG:
        return diag_gaussian.nat_grad_step(q, prior, stats, scale, rho)

    @staticmethod
    def kl(q: NIG, p: NIG) -> torch.Tensor:
        return diag_gaussian.kl(q, p).sum()

    @staticmethod
    def mean_params(q: NIG) -> tuple[torch.Tensor, torch.Tensor]:
        return diag_gaussian.mean_params(q)

    @staticmethod
    def sample_obs(
        generator: torch.Generator, theta: tuple[torch.Tensor, torch.Tensor], z: torch.Tensor
    ) -> torch.Tensor:
        """Sample y_t | z_t for an int state path z (...,); draws on z's device."""
        mu, sigma2 = theta
        eps = torch.randn(
            z.shape + (mu.shape[-1],), generator=generator, dtype=mu.dtype, device=z.device
        )
        return mu[z] + torch.sqrt(sigma2[z]) * eps

    @staticmethod
    def unpack_flat_stats(params: NIG, S: torch.Tensor) -> DiagGaussianStats:
        """(K, 1 + 2D) kernel accumulator -> DiagGaussianStats."""
        D = params.mean.shape[-1]
        return DiagGaussianStats(n=S[:, 0], sum_y=S[:, 1 : 1 + D], sum_y2=S[:, 1 + D :])


class MultinomialDirichlet:
    """Categorical emissions over V symbols, Dirichlet prior. Params: a (K, V) tensor."""

    name = "multinomial_dirichlet"

    @staticmethod
    def make_prior(
        K: int, num_symbols: int, alpha: float = 0.5, dtype=torch.float32, device=None
    ) -> torch.Tensor:
        """Symmetric Dirichlet(alpha) rows on ``device`` (the card when None)."""
        return torch.full((K, num_symbols), alpha, dtype=dtype, device=resolve_device(device))

    @staticmethod
    def expected_log_likelihood(params: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """y int (...,) -> (..., K) by gathering E[log phi_{k, y_t}]."""
        return dirichlet.expected_log_probs(params).T[y.long()]

    @staticmethod
    def posterior(prior: torch.Tensor, stats: torch.Tensor) -> torch.Tensor:
        return dirichlet.posterior(prior, stats)

    @staticmethod
    def nat_grad_step(q, prior, stats, scale, rho) -> torch.Tensor:
        return dirichlet.nat_grad_step(q, prior, stats, scale, rho)

    @staticmethod
    def kl(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        return dirichlet.kl(q, p).sum()

    @staticmethod
    def mean_params(q: torch.Tensor) -> torch.Tensor:
        return dirichlet.mean(q)

    @staticmethod
    def sample_obs(
        generator: torch.Generator, theta: torch.Tensor, z: torch.Tensor
    ) -> torch.Tensor:
        """Sample y_t | z_t (int64) for an int state path z (...,) by one
        inverse-CDF search over the K rows of theta laid end to end (row k
        spans [k, k + 1]), so no (..., V) array is built; draws on z's device."""
        K, V = theta.shape
        rows = torch.arange(K, dtype=theta.dtype, device=theta.device)[:, None]
        cum = torch.cumsum(theta, dim=-1) + rows
        u = torch.rand(z.shape, generator=generator, dtype=theta.dtype, device=z.device)
        idx = torch.searchsorted(cum.reshape(-1), (z + u).reshape(-1), right=True).reshape(z.shape)
        return (idx - z * V).clamp(0, V - 1)

    @staticmethod
    def unpack_flat_stats(params: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
        """The (K, V) kernel accumulator over one-hot features IS the Dirichlet
        statistic."""
        return S


class PoissonGamma:
    """Poisson-count emissions, per-dimension Gamma prior. Params: :class:`GammaP` (K, D)."""

    name = "poisson_gamma"

    @staticmethod
    def make_prior(K: int, obs_dim: int, dtype=torch.float32, device=None, **kw) -> GammaP:
        """The Gamma prior on ``device`` (the card when None)."""
        return poisson.make_prior(K, obs_dim, dtype=dtype, device=device, **kw)

    @staticmethod
    def expected_log_likelihood(params: GammaP, y: torch.Tensor) -> torch.Tensor:
        """y (..., D) float counts -> (..., K)."""
        return poisson.expected_log_likelihood(params, y)

    @staticmethod
    def ell_features(y: torch.Tensor) -> torch.Tensor:
        """Per-observation features [1, y, sum_d log y_d!] (width 2 + D)."""
        return poisson.ell_features(y)

    @staticmethod
    def ell_feature_matrix(params: GammaP) -> torch.Tensor:
        return poisson.ell_feature_matrix(params)

    @staticmethod
    def suff_stats(gamma: torch.Tensor, y: torch.Tensor) -> PoissonStats:
        return poisson.suff_stats(gamma, y)

    @staticmethod
    def posterior(prior: GammaP, stats: PoissonStats) -> GammaP:
        return poisson.posterior(prior, stats)

    @staticmethod
    def nat_grad_step(q: GammaP, prior: GammaP, stats: PoissonStats, scale, rho) -> GammaP:
        return poisson.nat_grad_step(q, prior, stats, scale, rho)

    @staticmethod
    def kl(q: GammaP, p: GammaP) -> torch.Tensor:
        return poisson.kl(q, p).sum()

    @staticmethod
    def mean_params(q: GammaP) -> torch.Tensor:
        return poisson.mean_params(q)

    @staticmethod
    def sample_obs(
        generator: torch.Generator, theta: torch.Tensor, z: torch.Tensor
    ) -> torch.Tensor:
        """Sample y_t | z_t as float counts (the engines' observation dtype)
        for an int state path z (...,); draws on z's device."""
        return torch.poisson(theta[z], generator=generator)

    @staticmethod
    def unpack_flat_stats(params: GammaP, S: torch.Tensor) -> PoissonStats:
        """(K, 2 + D) kernel accumulator -> PoissonStats (the log-factorial
        column is not a sufficient statistic and is dropped)."""
        D = params.a.shape[-1]
        return PoissonStats(n=S[:, 0], sum_y=S[:, 1 : 1 + D])


FAMILIES = (GaussianNIW, DiagonalGaussianNIG, MultinomialDirichlet, PoissonGamma)
