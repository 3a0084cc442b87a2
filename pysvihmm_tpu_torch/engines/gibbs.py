"""Blocked Gibbs sampling for the conjugate HMM (port of
``pysvihmm_tpu/engines/gibbs.py``): the "Gibbs-style comparisons" of the
reference's experiments.

A sweep alternates
  1. z | theta: an exact joint draw of every state path by forward-filter
     backward-sampling (``messages.ffbs_sample``), batched over sequences;
  2. theta | z: conjugate posterior draws, pi and the rows of A from
     Dirichlet(prior + counts), the emission parameters from the family's
     posterior given the hard counts.

Every draw comes from the state's ``torch.Generator`` on the data's device.
``sweep.with_draws`` takes them instead (:class:`GibbsDraws`), so a test can
feed the draws JAX made and get JAX's sweep.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from .. import messages
from ..distributions import dirichlet
from ..distributions.emissions import DiagonalGaussianNIG, GaussianNIW
from ..messages.scan_fb import gumbel
from ..models.hmm import HMMParams, _farthest_point_means, emission_flat_stats
from ..utils.device import check_generator
from ..utils.precision import f32_matmuls
from .svi import _run


class GibbsState(NamedTuple):
    z: torch.Tensor  # (B, T) int64 current state paths
    theta: Any  # (pi (K,), A (K, K), the family's point params)
    generator: torch.Generator  # every draw of the sweep (JAX: the PRNG key)


class GibbsDraws(NamedTuple):
    """The random inputs of one sweep, in the order the sweep uses them."""

    gumbel: torch.Tensor  # (B, T, K) FFBS noise (messages.ffbs_from_gumbel)
    log_g_pi: torch.Tensor  # (K,) log Gamma(prior.init + counts, 1)
    log_g_A: torch.Tensor  # (K, K) log Gamma(prior.trans + counts, 1)
    emit: tuple  # the family's ``sample_draws`` at its posterior


def _count_stats(z: torch.Tensor, K: int, dtype: torch.dtype):
    """Initial and transition counts of hard paths z (B, T) by one-hot
    products; returns (init (K,), trans (K, K), one-hot (B, T, K))."""
    oh = torch.nn.functional.one_hot(z, K).to(dtype)
    init_counts = oh[:, 0].sum(dim=0)
    trans_counts = torch.einsum("bti,btj->ij", oh[:, :-1], oh[:, 1:])
    return init_counts, trans_counts, oh


def _cast(x, dtype: torch.dtype):
    """Emission params (a tensor or a NamedTuple of them) in ``dtype``."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype)
    return type(x)(*(v.to(dtype) for v in x))


def _hard_posterior(emission, prior_emit, oh: torch.Tensor, obs: torch.Tensor):
    """The emission posterior given hard paths (one-hot oh (B, T, K)): the
    statistics summed and the update taken in float64, the result in the
    prior's dtype. The Gaussian posteriors subtract second moments that can
    be tens of times larger than the result (psi = sum y y^T - n m m^T for
    data far from the prior mean): float32 sums over ~1e4 observations
    a state moved sigma by 2.2e-4 relative on an H100 at K=64, D=8, 1024 x
    1000 observations."""
    dtype = oh.dtype
    prior64 = _cast(prior_emit, torch.float64)
    obs64 = obs.double() if obs.is_floating_point() else obs
    stats = emission_flat_stats(emission, prior64, oh.double(), obs64)
    return _cast(emission.posterior(prior64, stats), dtype)


def make_sweep(emission, K: int):
    """Build the sweep: sweep(state, prior, obs) -> (state', metrics), with
    ``sweep.with_draws(state, prior, obs, draws)`` taking a
    :class:`GibbsDraws` instead of drawing. metrics["marginal_loglik"] is
    the data's log-likelihood under the parameters the sweep started from
    (monitoring)."""

    def run_sweep(state: GibbsState, prior: HMMParams, obs: torch.Tensor,
                  draws: GibbsDraws | None):
        f32_matmuls()
        gen, dtype = state.generator, prior.init.dtype
        pi_cur, A_cur, theta_cur = state.theta
        log_pi, log_A = torch.log(pi_cur), torch.log(A_cur)
        ll = emission.point_log_likelihood(theta_cur, obs)  # (B, T, K)

        # z | theta, first, so the data-seeded initial theta drives the first sweep
        noise = gumbel(gen, ll.shape, ll.dtype) if draws is None else draws.gumbel
        z = messages.ffbs_from_gumbel(log_pi, log_A, ll, noise)

        # theta | z
        init_counts, trans_counts, oh = _count_stats(z, K, dtype)
        alpha_pi, alpha_A = prior.init + init_counts, prior.trans + trans_counts
        emit_post = _hard_posterior(emission, prior.emit, oh, obs)
        if draws is None:
            draws = GibbsDraws(noise, dirichlet.log_gamma(gen, alpha_pi),
                               dirichlet.log_gamma(gen, alpha_A),
                               emission.sample_draws(gen, emit_post))
        pi = dirichlet.from_log_gamma(draws.log_g_pi)
        A = dirichlet.from_log_gamma(draws.log_g_A)
        theta_emit = emission.params_from_draws(emit_post, draws.emit)

        metrics = {"marginal_loglik": messages.forward(log_pi, log_A, ll)[1].sum()}
        return GibbsState(z=z, theta=(pi, A, theta_emit), generator=gen), metrics

    def sweep(state: GibbsState, prior: HMMParams, obs: torch.Tensor):
        check_generator(state.generator, obs.device)
        return run_sweep(state, prior, obs, None)

    def with_draws(state: GibbsState, prior: HMMParams, obs: torch.Tensor, draws: GibbsDraws):
        return run_sweep(state, prior, obs, draws)

    sweep.with_draws = with_draws
    return sweep


def init_state(
    generator: torch.Generator, prior: HMMParams, emission, obs: torch.Tensor, K: int
) -> GibbsState:
    """Uniform random paths, uniform pi and A, and emission params drawn from
    the prior; the Gaussian families' means seeded at farthest-point
    observations instead (prior-mean draws mix badly on offset data). Draws
    on the generator's device, which must be obs'."""
    check_generator(generator, obs.device)
    B, T = obs.shape[0], obs.shape[1]
    dtype, dev = prior.init.dtype, obs.device
    z0 = torch.randint(0, K, (B, T), generator=generator, device=dev)
    pi0 = torch.full((K,), 1.0 / K, dtype=dtype, device=dev)
    A0 = torch.full((K, K), 1.0 / K, dtype=dtype, device=dev)
    theta0 = emission.sample_params(generator, prior.emit)
    if emission in (GaussianNIW, DiagonalGaussianNIG):
        flat = obs.reshape(-1, obs.shape[-1]).to(prior.emit.mean.dtype)
        theta0 = (_farthest_point_means(generator, flat, K), theta0[1])
    return GibbsState(z=z0, theta=(pi0, A0, theta0), generator=generator)


def run(
    state: GibbsState,
    prior: HMMParams,
    obs: torch.Tensor,
    emission,
    K: int,
    num_sweeps: int,
) -> tuple[GibbsState, dict]:
    """num_sweeps chained sweeps; metrics stacked per key, left on the device."""
    return _run(make_sweep(emission, K), state, prior, obs, num_sweeps)
