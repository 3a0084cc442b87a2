"""Synthetic HMM data for the four emission families (port of
``pysvihmm_tpu/data/synthetic.py``).

Samples true parameters, rolls the chains forward and returns (obs, true
states, true params). Every draw comes from an explicit ``torch.Generator``
and happens on that generator's device, so data for the card is made on the
card. The streams differ from JAX's PRNG for the same seed, except
:func:`sample_states_fast`, the host sampler of very long chains, which
draws from a NumPy generator as JAX's does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
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


_BUCKETS = 1 << 16


def _step_maps(A_cum: np.ndarray, u: np.ndarray, K: int) -> np.ndarray:
    """The state maps of draws u (steps, blocks): M[s, b, k] =
    ``min(searchsorted(A_cum[k], u[s, b], side="right"), K - 1)`` as int8,
    the same values, through a (_BUCKETS, K) table of equal bins of [0, 1):
    a bin that no row's cut point enters gives each row one answer for every
    u in it, and only draws in the few other bins are searched. The clip
    guards draws above a row's float-rounded cumsum (A_cum[k, -1] can sit
    just below 1), which a chain of 10^8 steps meets."""
    lo = np.arange(_BUCKETS) / _BUCKETS
    table = np.empty((_BUCKETS, K), np.int8)
    mixed = np.zeros((_BUCKETS,), bool)
    for k in range(K):
        right = np.searchsorted(A_cum[k], lo, side="right")
        table[:, k] = np.minimum(right, K - 1)
        mixed |= np.searchsorted(A_cum[k], lo + 1.0 / _BUCKETS, side="left") != right
    bucket = (u * _BUCKETS).astype(np.intp).ravel()  # exact: a power-of-two scale
    M = table[bucket]  # (steps * blocks, K), rows in u's C order
    hit = np.flatnonzero(mixed[bucket])
    u_hit = u.ravel()[hit]
    for k in range(K):
        M[hit, k] = np.minimum(np.searchsorted(A_cum[k], u_hit, side="right"), K - 1)
    return M.reshape(u.shape + (K,))


def sample_states_fast(pi, A, T: int, rng, block: int = 4096,
                       group_steps: int = 1 << 24) -> np.ndarray:
    """One state path (T,) int32 on the host, for chains of tens to hundreds
    of millions of steps (JAX's ``sample_states_fast``, in NumPy; it draws
    from the same ``numpy.random.Generator`` calls, so the same ``rng``
    state gives JAX's path bit for bit).

    Each step's inverse-CDF draw defines a map state -> next state; a
    block's maps are composed vectorised over all its blocks at once, a
    boundary recursion threads the true entry state of every block, and a
    replay inside all blocks at once writes the path. JAX builds the int8
    maps of the whole chain up front (T K bytes); the port walks them a
    group of ``group_steps`` steps at a time, the groups in order, so the
    maps take K group_steps bytes.

    pi (K,), A (K, K) arrays; rng a ``numpy.random.Generator``."""
    K = len(pi)
    if K > 127:
        raise ValueError(f"K={K} exceeds the int8 state-map limit (127)")
    pi = np.asarray(pi, np.float64)
    A_cum = np.cumsum(np.asarray(A, np.float64), axis=1)
    z0 = int(rng.choice(K, p=pi / pi.sum()))
    if T == 1:
        return np.array([z0], np.int32)
    n = T - 1
    nB = -(-n // block)
    u = rng.random(nB * block)  # the padded tail's draws are discarded
    z = np.empty((T,), np.int32)
    z[0] = state = z0
    G = max(1, group_steps // block)  # blocks a group
    for g0 in range(0, nB, G):
        nb = min(G, nB - g0)
        # M[s, b, k]: the state after k under block b's step-s draw
        M = _step_maps(A_cum, u[g0 * block:(g0 + nb) * block].reshape(nb, block).T, K)
        # V[b, k]: block b's exit state from entry state k, composed as flat
        # indices b K + V[b, k] into each step's (nb, K) map
        base = np.arange(nb)[:, None] * K
        idx = base + np.arange(K)
        for s in range(block):
            idx = base + M[s].ravel().take(idx)
        V = idx - base
        entry = np.empty((nb,), np.int32)
        entry[0] = state
        for b in range(nb - 1):
            entry[b + 1] = V[b, entry[b]]
        state = int(V[nb - 1, entry[nb - 1]])
        zs = np.empty((block, nb), np.int8)
        cur, rows = entry.astype(np.intp), np.arange(nb)
        for s in range(block):
            cur = M[s][rows, cur]
            zs[s] = cur
            cur = cur.astype(np.intp)
        lo = 1 + g0 * block
        hi = min(lo + nb * block, T)
        z[lo:hi] = zs.T.reshape(-1)[:hi - lo]
    return z


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
