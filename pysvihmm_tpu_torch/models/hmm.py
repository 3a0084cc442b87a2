"""Bayesian HMM global variational state (port of ``pysvihmm_tpu/models/hmm.py``).

Generative model (K states; Foti et al. 2014 §2):
    pi ~ Dir(alpha_pi);  A_k. ~ Dir(alpha_A);  phi_k ~ the family's prior
    z_1 ~ pi;  z_{t+1} | z_t ~ A_{z_t .};  y_t | z_t ~ p(y | phi_{z_t})

The four emission families of ``distributions/emissions.py``; anything else
raises ``ValueError`` as in JAX.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..distributions import dirichlet
from ..distributions.emissions import (
    FAMILIES,
    DiagonalGaussianNIG,
    GaussianNIW,
    MultinomialDirichlet,
    PoissonGamma,
)
from ..utils.device import resolve_device

# Above this vocabulary size the multinomial's statistics are a segment-sum
# (``index_add_``) instead of a product with the (N, V) one-hot, and its
# "fused" and "duplex" routes run the split kernels over gathered likelihoods
# (pysvihmm_tpu/models/hmm.py:166).
ONE_HOT_MAX_V = 256


# The one string -> family mapping of the configuration layer and scripts.
EMISSION_FAMILIES = {
    "gaussian": GaussianNIW,
    "diag_gaussian": DiagonalGaussianNIG,
    "multinomial": MultinomialDirichlet,
    "poisson": PoissonGamma,
}


def resolve_emission(name: str):
    """The emission family of a configuration string; raises ``ValueError``
    on unknown names."""
    try:
        return EMISSION_FAMILIES[name]
    except KeyError:
        raise ValueError(
            f"unknown emission family {name!r}; expected one of {sorted(EMISSION_FAMILIES)}"
        ) from None


class HMMParams(NamedTuple):
    """Variational posterior q(pi) q(A) q(phi), also used for the prior.

    init:  (K,)   Dirichlet concentrations of q(pi)
    trans: (K, K) Dirichlet concentrations, row k = q(A_k.)
    emit:  emission-family params with leading axis K (an NIW, NIG or
           GammaP, or a (K, V) tensor of Dirichlet concentrations)
    """

    init: torch.Tensor
    trans: torch.Tensor
    emit: Any


def check_family(emission) -> None:
    """Raise ``ValueError`` for an emission family the package does not have."""
    if emission not in FAMILIES:
        raise ValueError(f"unknown emission family {emission}")


def make_prior(
    K: int,
    emission,
    *,
    obs_dim: int | None = None,
    num_symbols: int | None = None,
    alpha_init: float = 1.0,
    alpha_tran: float = 1.0,
    dtype: torch.dtype | None = None,
    device: torch.device | str | None = None,
    **emission_kw,
) -> HMMParams:
    """Symmetric Dirichlet priors and the family's weak prior, in ``dtype``
    (default: torch's default float dtype) on ``device`` (default: the card;
    pass ``device="cpu"`` for the CPU). The multinomial takes
    ``num_symbols``, the other families ``obs_dim``."""
    check_family(emission)
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.get_default_dtype()
    if emission is MultinomialDirichlet:
        emit = emission.make_prior(K, num_symbols, dtype=dtype, device=device, **emission_kw)
    else:
        emit = emission.make_prior(K, obs_dim, dtype=dtype, device=device, **emission_kw)
    return HMMParams(
        init=torch.full((K,), alpha_init, dtype=dtype, device=device),
        trans=torch.full((K, K), alpha_tran, dtype=dtype, device=device),
        emit=emit,
    )


def _farthest_point_means(
    generator: torch.Generator, flat: torch.Tensor, K: int
) -> torch.Tensor:
    """k-means++-style seeding: a random first point, then greedily the point
    farthest from all chosen so far, over a random subsample of <= 4096
    points. Random draws happen on the generator's device."""
    N = flat.shape[0]
    perm = torch.randperm(N, generator=generator, device=generator.device)
    sub = flat[perm[: min(N, 4096)].to(flat.device)]
    first = torch.randint(
        0, sub.shape[0], (1,), generator=generator, device=generator.device
    ).to(flat.device)
    means = sub[first].expand(K, -1).clone()
    for i in range(1, K):
        d = ((sub[:, None, :] - means[None, :i, :]) ** 2).sum(dim=-1).amin(dim=1)
        means[i] = sub[torch.argmax(d)]
    return means


def init_params(
    generator: torch.Generator,
    prior: HMMParams,
    emission,
    obs_sample: torch.Tensor | None = None,
) -> HMMParams:
    """Randomised initial variational params: the prior plus U(0.5, 1.5)
    noise on the Dirichlet concentrations, and per family (JAX's branches,
    pysvihmm_tpu/models/hmm.py:133-143): Gaussian means seeded at
    farthest-point observations, U(0, 1) noise on the multinomial's Dirichlet
    rows, Poisson rates E[lambda] = a / b seeded at farthest-point count
    vectors. Draws on the generator's device, results on the prior's device."""
    check_family(emission)
    K = prior.init.shape[0]
    dev, dt = prior.init.device, prior.init.dtype

    def uniform(shape, lo):
        u = torch.rand(shape, generator=generator, dtype=dt, device=generator.device)
        return (u + lo).to(dev)

    def flat(dtype):
        return obs_sample.reshape(-1, obs_sample.shape[-1]).to(dtype)

    init = prior.init + uniform(prior.init.shape, 0.5)
    trans = prior.trans + uniform(prior.trans.shape, 0.5)
    emit = prior.emit
    if emission in (GaussianNIW, DiagonalGaussianNIG) and obs_sample is not None:
        emit = emit._replace(mean=_farthest_point_means(generator, flat(emit.mean.dtype), K))
    elif emission is MultinomialDirichlet:
        emit = emit + uniform(emit.shape, 0.0)
    elif emission is PoissonGamma and obs_sample is not None:
        m = torch.clamp_min(_farthest_point_means(generator, flat(emit.a.dtype), K), 0.1)
        emit = emit._replace(a=m * emit.b)
    return HMMParams(init=init, trans=trans, emit=emit)


def expected_log_params(params: HMMParams) -> tuple[torch.Tensor, torch.Tensor]:
    """(E[log pi], E[log A]): the variational pi~ and A~ in log space."""
    return dirichlet.expected_log_probs(params.init), dirichlet.expected_log_probs(
        params.trans
    )


def global_kl(params: HMMParams, prior: HMMParams, emission) -> torch.Tensor:
    """KL(q(pi)||p) + sum_k KL(q(A_k.)||p) + sum_k KL(q(phi_k)||p)."""
    return (
        dirichlet.kl(params.init, prior.init)
        + dirichlet.kl(params.trans, prior.trans).sum()
        + emission.kl(params.emit, prior.emit)
    )


def emission_flat_stats(emission, emit_params, gamma: torch.Tensor, obs: torch.Tensor):
    """Emission sufficient stats with every leading and time axis flattened:
    gamma (..., K) weights aligned with obs (..., D), or with int obs (...,)
    for the multinomial, whose (K, V) counts are one gamma^T @ one_hot(y)
    product, or above ``ONE_HOT_MAX_V`` symbols a segment-sum that never
    builds the one-hot."""
    check_family(emission)
    K = gamma.shape[-1]
    g2 = gamma.reshape(-1, K)
    if emission is MultinomialDirichlet:
        y2 = obs.reshape(-1).long()
        V = emit_params.shape[-1]
        if V > ONE_HOT_MAX_V:
            return torch.zeros((V, K), dtype=g2.dtype, device=g2.device).index_add_(0, y2, g2).T
        return g2.T @ torch.nn.functional.one_hot(y2, V).to(g2.dtype)
    return emission.suff_stats(g2, obs.reshape(-1, obs.shape[-1]))
