"""Bayesian HMM global variational state (port of ``pysvihmm_tpu/models/hmm.py``).

Generative model (K states; Foti et al. 2014 §2):
    pi ~ Dir(alpha_pi);  A_k. ~ Dir(alpha_A);  phi_k ~ NIW
    z_1 ~ pi;  z_{t+1} | z_t ~ A_{z_t .};  y_t | z_t ~ N(y | phi_{z_t})

Only the Gaussian-NIW family is ported in this slice; the other families
raise ``NotImplementedError`` (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from ..distributions import dirichlet
from ..distributions.emissions import GaussianNIW
from ..utils.device import resolve_device


class HMMParams(NamedTuple):
    """Variational posterior q(pi) q(A) q(phi), also used for the prior.

    init:  (K,)   Dirichlet concentrations of q(pi)
    trans: (K, K) Dirichlet concentrations, row k = q(A_k.)
    emit:  emission-family params with leading axis K (an NIW)
    """

    init: torch.Tensor
    trans: torch.Tensor
    emit: Any


def require_ported_family(emission) -> None:
    """Raise for an emission family the port does not carry yet."""
    if emission is not GaussianNIW:
        raise NotImplementedError(
            f"emission family {getattr(emission, 'name', emission)!r} is not ported "
            "yet (ROADMAP Queue 1 item 7); this slice ports GaussianNIW"
        )


def make_prior(
    K: int,
    emission,
    *,
    obs_dim: int,
    alpha_init: float = 1.0,
    alpha_tran: float = 1.0,
    dtype: torch.dtype | None = None,
    device: torch.device | str | None = None,
    **emission_kw,
) -> HMMParams:
    """Symmetric Dirichlet priors and the family's weak prior, in ``dtype``
    (default: torch's default float dtype) on ``device`` (default: the card;
    pass ``device="cpu"`` for the CPU)."""
    require_ported_family(emission)
    device = resolve_device(device)
    if dtype is None:
        dtype = torch.get_default_dtype()
    emit = GaussianNIW.make_prior(K, obs_dim, dtype=dtype, device=device, **emission_kw)
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
    noise on the Dirichlet concentrations, and Gaussian means seeded at
    farthest-point observations. Draws on the generator's device, results
    on the prior's device."""
    require_ported_family(emission)
    K = prior.init.shape[0]
    dev, dt = prior.init.device, prior.init.dtype

    def uniform(shape):
        u = torch.rand(shape, generator=generator, dtype=dt, device=generator.device)
        return (u + 0.5).to(dev)

    init = prior.init + uniform(prior.init.shape)
    trans = prior.trans + uniform(prior.trans.shape)
    emit = prior.emit
    if obs_sample is not None:
        flat = obs_sample.reshape(-1, obs_sample.shape[-1]).to(prior.emit.mean.dtype)
        emit = emit._replace(mean=_farthest_point_means(generator, flat, K))
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
    gamma (..., K) weights aligned with obs (..., D)."""
    require_ported_family(emission)
    K = gamma.shape[-1]
    return emission.suff_stats(gamma.reshape(-1, K), obs.reshape(-1, obs.shape[-1]))
