"""Synthetic HMM data for the four emission families (port of
``pysvihmm_tpu/data/synthetic.py``).

Samples true parameters, rolls the chains forward and returns (obs, true
states, true params). Every draw comes from an explicit ``torch.Generator``
and happens on that generator's device, so data for the card is made on the
card. The streams differ from JAX's PRNG for the same seed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..distributions.emissions import (
    DiagonalGaussianNIG,
    GaussianNIW,
    MultinomialDirichlet,
    PoissonGamma,
)


class TrueParams(NamedTuple):
    pi: torch.Tensor  # (K,)
    A: torch.Tensor  # (K, K)
    theta: object  # (mu, Sigma) or (mu, sigma2) or phi (K, V) or lambda (K, D)


def _sticky_transitions(K: int, self_prob: float, dtype, device) -> torch.Tensor:
    """self_prob on the diagonal, the rest uniform."""
    off = (1.0 - self_prob) / (K - 1)
    return torch.full((K, K), off, dtype=dtype, device=device) + (
        self_prob - off
    ) * torch.eye(K, dtype=dtype, device=device)


def make_gaussian_params(
    generator: torch.Generator,
    K: int,
    D: int,
    *,
    mean_scale: float = 5.0,
    cov_scale: float = 0.5,
    self_prob: float = 0.8,
    dtype: torch.dtype = torch.float32,
) -> TrueParams:
    """Well-separated Gaussian states with sticky transitions."""
    dev = generator.device
    pi = torch.full((K,), 1.0 / K, dtype=dtype, device=dev)
    A = _sticky_transitions(K, self_prob, dtype, dev)
    mu = mean_scale * torch.randn((K, D), generator=generator, dtype=dtype, device=dev)
    sigma = cov_scale * torch.eye(D, dtype=dtype, device=dev).expand(K, D, D)
    return TrueParams(pi=pi, A=A, theta=(mu, sigma))


def sample_states(
    generator: torch.Generator, params: TrueParams, T: int, num_seqs: int
) -> torch.Tensor:
    """State paths (num_seqs, T) int64 by inverse-CDF draws, all sequences
    advanced together one step at a time."""
    K = params.pi.shape[0]
    u = torch.rand(
        (T, num_seqs, 1), generator=generator, dtype=params.A.dtype, device=generator.device
    )
    cum_pi = torch.cumsum(params.pi, dim=0)
    cum_A = torch.cumsum(params.A, dim=-1)
    z = torch.empty((T, num_seqs), dtype=torch.int64, device=generator.device)
    z[0] = torch.searchsorted(cum_pi, u[0, :, 0], right=True).clamp_max(K - 1)
    for t in range(1, T):
        z[t] = torch.searchsorted(cum_A[z[t - 1]], u[t], right=True)[:, 0].clamp_max(K - 1)
    return z.T.contiguous()


def gen_data(
    generator: torch.Generator, params: TrueParams, emission, num_seqs: int, T: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(obs (num_seqs, T, D) float or (num_seqs, T) int, states (num_seqs, T))."""
    z = sample_states(generator, params, T, num_seqs)
    return emission.sample_obs(generator, params.theta, z), z


def gen_gaussian_dataset(
    generator: torch.Generator, K: int, D: int, num_seqs: int, T: int, **kw
) -> tuple[torch.Tensor, torch.Tensor, TrueParams]:
    """(obs (num_seqs, T, D), states (num_seqs, T), true params)."""
    params = make_gaussian_params(generator, K, D, **kw)
    return (*gen_data(generator, params, GaussianNIW, num_seqs, T), params)


def make_diag_gaussian_params(
    generator: torch.Generator,
    K: int,
    D: int,
    *,
    mean_scale: float = 5.0,
    var_scale: float = 0.5,
    self_prob: float = 0.8,
    dtype: torch.dtype = torch.float32,
) -> TrueParams:
    """Diagonal-covariance variant of :func:`make_gaussian_params`: theta =
    (mu (K, D), sigma2 (K, D)) with per-dimension variances in
    var_scale * [0.5, 2)."""
    dev = generator.device
    mu = mean_scale * torch.randn((K, D), generator=generator, dtype=dtype, device=dev)
    u = torch.rand((K, D), generator=generator, dtype=dtype, device=dev)
    return TrueParams(
        pi=torch.full((K,), 1.0 / K, dtype=dtype, device=dev),
        A=_sticky_transitions(K, self_prob, dtype, dev),
        theta=(mu, var_scale * (0.5 + 1.5 * u)),
    )


def gen_diag_gaussian_dataset(
    generator: torch.Generator, K: int, D: int, num_seqs: int, T: int, **kw
) -> tuple[torch.Tensor, torch.Tensor, TrueParams]:
    """(obs (num_seqs, T, D), states (num_seqs, T), true params)."""
    params = make_diag_gaussian_params(generator, K, D, **kw)
    return (*gen_data(generator, params, DiagonalGaussianNIG, num_seqs, T), params)


def make_multinomial_params(
    generator: torch.Generator,
    K: int,
    V: int,
    *,
    concentration: float = 0.3,
    self_prob: float = 0.85,
    dtype: torch.dtype = torch.float32,
) -> TrueParams:
    """Sparse symbol distributions per state, phi_k ~ Dir(concentration)
    (normalised Gamma draws), with sticky transitions."""
    dev = generator.device
    alpha = torch.full((K, V), concentration, dtype=dtype, device=dev)
    g = torch._standard_gamma(alpha, generator=generator)
    return TrueParams(
        pi=torch.full((K,), 1.0 / K, dtype=dtype, device=dev),
        A=_sticky_transitions(K, self_prob, dtype, dev),
        theta=g / g.sum(dim=-1, keepdim=True),
    )


def gen_multinomial_dataset(
    generator: torch.Generator, K: int, V: int, num_seqs: int, T: int, **kw
) -> tuple[torch.Tensor, torch.Tensor, TrueParams]:
    """(obs (num_seqs, T) int64 symbols, states (num_seqs, T), true params)."""
    params = make_multinomial_params(generator, K, V, **kw)
    return (*gen_data(generator, params, MultinomialDirichlet, num_seqs, T), params)


def make_poisson_params(
    generator: torch.Generator,
    K: int,
    D: int,
    *,
    rate_scale: float = 10.0,
    self_prob: float = 0.8,
    dtype: torch.dtype = torch.float32,
) -> TrueParams:
    """Per-state rate vectors theta = lambda (K, D), log-uniform in
    [rate_scale / 10, rate_scale], with sticky transitions."""
    dev = generator.device
    u = torch.rand((K, D), generator=generator, dtype=dtype, device=dev)
    return TrueParams(
        pi=torch.full((K,), 1.0 / K, dtype=dtype, device=dev),
        A=_sticky_transitions(K, self_prob, dtype, dev),
        theta=rate_scale / 10.0 * 10.0**u,
    )


def gen_poisson_dataset(
    generator: torch.Generator, K: int, D: int, num_seqs: int, T: int, **kw
) -> tuple[torch.Tensor, torch.Tensor, TrueParams]:
    """(obs (num_seqs, T, D) float counts, states (num_seqs, T), true params)."""
    params = make_poisson_params(generator, K, D, **kw)
    return (*gen_data(generator, params, PoissonGamma, num_seqs, T), params)
