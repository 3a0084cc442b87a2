"""Shared engine machinery: the batched local E-step, ELBO, decoding (port of
``pysvihmm_tpu/engines/base.py``).

Everything is a function of (params, prior, obs); engines differ only in
which data they feed the local step and how they turn the statistics into
the next global state.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import messages
from ..distributions import dirichlet
from ..distributions.emissions import MultinomialDirichlet
from ..messages.duplex_fb import estep_duplex
from ..messages.fused_fb import FMAX, estep_fused
from ..messages.scan_fb import FBResult
from ..messages.split_fb import estep_split
from ..models.hmm import (
    HMMParams,
    check_family,
    emission_flat_stats,
    expected_log_params,
    global_kl,
)
from ..utils.precision import f32_matmuls


class LocalStats(NamedTuple):
    """Summed expected sufficient statistics from a batch local step."""

    init: torch.Tensor  # (K,)
    trans: torch.Tensor  # (K, K)
    emit: object  # emission-family stats, leading K
    log_z: torch.Tensor  # () summed variational log-normaliser


def feature_width(emission, emit_params, obs: torch.Tensor) -> int:
    """F, the width of the fused and duplex kernels' feature array: V for the
    multinomial (its one-hot), else the width of the family's
    ``ell_features`` at obs' D, taken on one row of zeros on the host."""
    if emission is MultinomialDirichlet:
        return emit_params.shape[-1]
    return emission.ell_features(torch.zeros((1, obs.shape[-1]))).shape[-1]


def wider_than_fused_kernels(emission, emit_params, obs: torch.Tensor) -> bool:
    """The features are wider than the fused and duplex kernels take
    (F > ``FMAX``): a Gaussian-NIW at D >= 10 (F = 66 at D = 10), a
    multinomial above 64 symbols. Their "fused" and "duplex" routes run the
    split kernels instead, decided by width before any launch, on every
    device; JAX's fused kernels take any F."""
    return feature_width(emission, emit_params, obs) > FMAX


def prepare_fused_obs(params: HMMParams, emission, obs: torch.Tensor) -> torch.Tensor | None:
    """The fused and duplex E-steps' observation side, built once.

    Returns the time-major feature array (T, B, F) as contiguous float32:
    the family's ``ell_features``, or for the multinomial the one-hot
    (T, B, V) of its int observations (B, T). None when the features are
    wider than the kernels take (:func:`wider_than_fused_kernels`): those
    routes run the split kernels then. It depends on the data only, so
    engines whose data is fixed across iterations (batch VB) build it once
    and pass it as ``prepared=``."""
    check_family(emission)
    if wider_than_fused_kernels(emission, params.emit, obs):
        return None
    if emission is MultinomialDirichlet:
        feats = torch.nn.functional.one_hot(obs.transpose(0, 1).long(), params.emit.shape[-1])
        return feats.to(torch.float32).contiguous()
    return _features(emission, obs)


def _features(emission, obs: torch.Tensor) -> torch.Tensor:
    """The family's ``ell_features`` of obs (B, T, D), time-major (T, B, F)
    contiguous float32."""
    return emission.ell_features(obs.transpose(0, 1)).to(torch.float32).contiguous()


def _fused_W(emission, emit_params) -> torch.Tensor:
    """The kernels' (F, K) float32 weight matrix, rebuilt every step:
    E[log phi]^T for the multinomial (its one-hot features pick a row)."""
    if emission is MultinomialDirichlet:
        W = dirichlet.expected_log_probs(emit_params).T
    else:
        W = emission.ell_feature_matrix(emit_params)
    return W.to(torch.float32).contiguous()


def _time_major_weights(weights: torch.Tensor | None) -> torch.Tensor | None:
    """(B, T) kept-mask -> the kernels' (T, B) contiguous float32, or None."""
    if weights is None:
        return None
    return weights.to(torch.float32).transpose(0, 1).contiguous()


_FUSED_ESTEPS = {"fused": estep_fused, "duplex": estep_duplex}
# the routes whose kernels take the feature array of :func:`prepare_fused_obs`
FEATURE_ROUTES = tuple(_FUSED_ESTEPS)


def _fused_estep(
    params: HMMParams,
    emission,
    obs: torch.Tensor,
    weights: torch.Tensor | None = None,
    need_gamma: bool = True,
    prepared: torch.Tensor | None = None,
    method: str = "fused",
) -> tuple[FBResult, object]:
    """The fused and duplex routes (JAX's ``_pallas_fused_estep``, the duplex
    one with ``PYSVIHMM_DUPLEX`` set): returns (FBResult with gamma (T, B, K)
    time-major, or None; emission stats), the stats kept-mask-gated in-kernel
    when ``weights`` (B, T) is given. Features wider than the kernels take
    (:func:`wider_than_fused_kernels`) run the split route instead: JAX
    does so above ``ONE_HOT_MAX_V`` symbols (engines/base.py:547) and
    computes widths of 65-256 in its fused kernels, which the port's take
    only up to ``FMAX``."""
    feats = prepare_fused_obs(params, emission, obs) if prepared is None else prepared
    if feats is None:
        return _split_estep(params, emission, obs, weights)
    log_pi, log_A = expected_log_params(params)
    fb, S = _FUSED_ESTEPS[method](
        log_pi, log_A, _fused_W(emission, params.emit), feats,
        emit_gamma=need_gamma, weights=_time_major_weights(weights),
    )
    return fb, emission.unpack_flat_stats(params.emit, S)


def _split_estep(
    params: HMMParams, emission, obs: torch.Tensor, weights: torch.Tensor | None = None
) -> tuple[FBResult, object]:
    """The split route (JAX's ``_pallas_packed_estep``): returns (FBResult
    with gamma (T, B, K) time-major, emission stats).

    The likelihoods are one float32 ``feats @ W`` product outside the
    kernels (JAX leaves it to XLA), time-major so no (B, T, K) transpose
    feeds the kernels, and the same feature array is the observation side
    of the emission statistics, (w * gamma)^T @ feats, taken outside the
    kernels as ``_packed_emission_stats`` does (engines/base.py:751-829 of
    the JAX package). The multinomial has no features: its likelihoods are
    gathered, and its statistics are the one-hot product or, above
    ``ONE_HOT_MAX_V`` symbols, a segment-sum (``emission_flat_stats``)."""
    check_family(emission)
    w_tm = _time_major_weights(weights)
    log_pi, log_A = expected_log_params(params)
    if emission is MultinomialDirichlet:
        obs_tm = obs.transpose(0, 1)
        ll = emission.expected_log_likelihood(params.emit, obs_tm).to(torch.float32)
        fb = estep_split(log_pi, log_A, ll.contiguous(), w_tm)
        gamma_w = fb.gamma if w_tm is None else fb.gamma * w_tm[..., None]
        return fb, emission_flat_stats(emission, params.emit, gamma_w, obs_tm)
    feats = _features(emission, obs)  # (T, B, F)
    T, B, F = feats.shape
    K = params.init.shape[0]
    ll = torch.matmul(feats, _fused_W(emission, params.emit))  # (T, B, K)
    fb = estep_split(log_pi, log_A, ll, w_tm)
    gamma_w = fb.gamma if w_tm is None else fb.gamma * w_tm[..., None]
    S = gamma_w.reshape(T * B, K).T @ feats.reshape(T * B, F)
    return fb, emission.unpack_flat_stats(params.emit, S)


def batch_local_step(
    params: HMMParams,
    emission,
    obs: torch.Tensor,
    method: str = "auto",
    weights: torch.Tensor | None = None,
    need_gamma: bool = True,
    prepared: torch.Tensor | None = None,
    exact: bool = False,
) -> tuple[LocalStats, torch.Tensor | None]:
    """Full local update over a batch of sequences obs (B, T, D), or int obs
    (B, T) for the multinomial.

    Returns (summed stats, gamma (B, T, K), or None when need_gamma=False).
    method "auto" resolves by obs' device: "fused" (the two fused CUDA
    kernels: likelihoods, forward-backward and emission stats in-kernel) on
    CUDA, "scan" (plain PyTorch over materialised likelihoods) on CPU.
    "split" runs the split CUDA kernels over likelihoods computed outside
    them, "duplex" the duplex kernels (both chains in one kernel, the
    statistics chain-free in a second). The kernel routes run their
    kernels' plain twins on CPU tensors.
    weights: optional (B, T) kept-mask; it gates init_stats (w_0),
    trans_stats (pairs w_{t-1} w_t) and the emission stats on every route,
    and never the chain: gamma comes out ungated.

    exact: accepted for the JAX contract (evaluation callers set it so that
    log Z comes from float32 alpha). The port stores alpha in float32
    always, so it changes nothing yet.
    """
    del exact  # alpha is float32 on every route of the port
    f32_matmuls()
    method = messages.resolve_method(method, obs.device)

    if method == "scan":
        log_pi, log_A = expected_log_params(params)
        ll = emission.expected_log_likelihood(params.emit, obs)  # (B, T, K)
        fb = messages.e_step_batched(log_pi, log_A, ll, weights=weights, method="scan")
        gamma_w = fb.gamma if weights is None else fb.gamma * weights[..., None]
        emit_stats = emission_flat_stats(emission, params.emit, gamma_w, obs)
        gamma = fb.gamma if need_gamma else None
    else:
        if method == "split":
            fb, emit_stats = _split_estep(params, emission, obs, weights)
        else:
            fb, emit_stats = _fused_estep(params, emission, obs, weights, need_gamma, prepared,
                                          method)
        gamma = fb.gamma.transpose(0, 1) if need_gamma else None
    stats = LocalStats(
        init=fb.init_stats.sum(dim=0),
        trans=fb.trans_stats,
        emit=emit_stats,
        log_z=fb.log_z.sum(),
    )
    return stats, gamma


def windowed_local_step(
    params: HMMParams,
    emission,
    windows: torch.Tensor,  # (B, W, D), or (B, W) int for the multinomial
    maskf: torch.Tensor,  # (B, W) kept-mask (0/1 floats)
    offs: torch.Tensor,  # (B,) kept-region offset inside each window
    method: str = "auto",
) -> tuple[object, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared local step of the windowed engines (svi subchains).

    Returns (emit_stats, trans_stats, gamma_at_off, log_c): emission stats
    kept-mask-gated and summed over windows; trans_stats pair-gated and
    summed, (K, K); gamma_at_off (B, K) = each window's smoothed marginal at
    its kept-region offset (the initial-state stats site); log_c (B, W) per
    step log normalisers (the mask applies to their sum).

    The kernel routes keep gamma time-major (W, B, K) as the kernels write
    it; the per-window pick gamma[offs[b], b, :] is a plain gather on it.
    """
    f32_matmuls()
    method = messages.resolve_method(method, windows.device)
    rows = torch.arange(windows.shape[0], device=windows.device)
    if method == "split":
        fb, emit_stats = _split_estep(params, emission, windows, maskf)
        return emit_stats, fb.trans_stats, fb.gamma[offs, rows], fb.log_c
    if method in FEATURE_ROUTES:
        fb, emit_stats = _fused_estep(params, emission, windows, maskf, method=method)
        return emit_stats, fb.trans_stats, fb.gamma[offs, rows], fb.log_c

    log_pi, log_A = expected_log_params(params)
    ll = emission.expected_log_likelihood(params.emit, windows)
    fb = messages.e_step_batched(log_pi, log_A, ll, weights=maskf, method="scan")
    gamma_w = fb.gamma * maskf[..., None]
    emit_stats = emission_flat_stats(emission, params.emit, gamma_w, windows)
    return emit_stats, fb.trans_stats, fb.gamma[rows, offs], fb.log_c


def elbo_from_stats(
    params: HMMParams, prior: HMMParams, emission, log_z: torch.Tensor
) -> torch.Tensor:
    """ELBO = sum_seqs log Z~ - KL(q(theta) || p(theta))."""
    return log_z - global_kl(params, prior, emission)


def lower_bound(
    params: HMMParams, prior: HMMParams, emission, obs: torch.Tensor, method: str = "auto"
) -> torch.Tensor:
    """Exact full-data ELBO at the current global state (a fresh local step)."""
    stats, _ = batch_local_step(params, emission, obs, method, need_gamma=False, exact=True)
    return elbo_from_stats(params, prior, emission, stats.log_z)


def decode(
    params: HMMParams, emission, obs: torch.Tensor, method: str = "auto"
) -> torch.Tensor:
    """Posterior-marginal state decode: argmax_k gamma_tk per sequence (B, T)."""
    _, gamma = batch_local_step(params, emission, obs, method)
    return torch.argmax(gamma, dim=-1)
