"""Emission families with a uniform static interface (port of
``pysvihmm_tpu/distributions/emissions.py``).

This slice ports :class:`GaussianNIW`, the family of the main path. The
diagonal-Gaussian, multinomial and Poisson families are still to be ported
(ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import torch

from . import niw
from .niw import NIW, GaussianStats


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
