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
from ..distributions.emissions import DiagonalGaussianNIG, GaussianNIW, MultinomialDirichlet
from ..messages.blocked import forward_backward_blocked_stream, forward_backward_blocked_twophase
from ..messages.duplex_fb import estep_duplex
from ..messages.fused_fb import FMAX, estep_fused
from ..messages.fused_fb import feature_width as kind_feature_width
from ..messages.scan_fb import FBResult
from ..messages.split_fb import estep_split
from ..messages.stream_fused import forward_backward_fused_twophase
from ..models.hmm import (
    ONE_HOT_MAX_V,
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
    """JAX's rule (``_pallas_fused_estep``, engines/base.py:547 of the JAX
    package): only a multinomial above ``ONE_HOT_MAX_V`` = 256 symbols
    leaves the fused kernels, whose one-hot features would then outweigh the
    gathered likelihoods; its "fused" (and "auto") route runs the split
    kernels. Every other family runs the fused pair at any F (above
    ``FMAX`` on its WF instances, up to a ceiling set by their feature
    slots in shared memory: about F = 4,200 at K = 256, 6,100 up to K =
    64, where the launchers raise). Decided before any launch, on every
    device."""
    return emission is MultinomialDirichlet and emit_params.shape[-1] > ONE_HOT_MAX_V


def wider_than_duplex_kernels(emission, emit_params, obs: torch.Tensor) -> bool:
    """The features are wider than the duplex kernels take (F > ``FMAX`` =
    64: a Gaussian-NIW at D >= 10, a diagonal Gaussian at D >= 32, a Poisson
    at D >= 65, a multinomial above 64 symbols), or leave the fused kernels
    (:func:`wider_than_fused_kernels`): "duplex" then runs the split kernels.
    JAX's duplex kernels take any F; these take F <= 64."""
    return (wider_than_fused_kernels(emission, emit_params, obs)
            or feature_width(emission, emit_params, obs) > FMAX)


# the families whose features the fused and duplex kernels build from the
# raw observations (``in_kernel_feats``), by the kernels' kind
_BUILT_KINDS = {GaussianNIW: "niw", DiagonalGaussianNIG: "nig"}


def in_kernel_kind(emission) -> str:
    """The kernels' feature kind of a family that builds its features on
    the chip: "niw" for the Gaussian-NIW, "nig" for the diagonal Gaussian
    (JAX's ``PYSVIHMM_INKERNEL_FEATS``, engines/base.py:357-361). Any other
    family raises ``ValueError``: the port never falls back to the array
    silently."""
    if emission not in _BUILT_KINDS:
        raise ValueError(f"in_kernel_feats takes the Gaussian-NIW or the diagonal Gaussian, "
                         f"got {getattr(emission, '__name__', emission)}")
    return _BUILT_KINDS[emission]


# the routes whose kernels store bf16 alpha: the fused pair and the split pair
# (JAX's `_alpha_store_dtype()` on both; the duplex stores float32, as JAX's)
BF16_ROUTES = ("fused", "split")


def check_kernel_modes(method: str, in_kernel_feats: bool = False, gamma_sel: bool = False,
                       bf16_alpha: bool = False) -> None:
    """Raise ``ValueError`` for a kernel mode the resolved route does not
    run: the in-kernel features on "fused" and "duplex" only, the in-kernel
    gamma pick on "fused" only (the duplex has no pick, as JAX's has not),
    bf16 alpha on "fused" and "split" (the duplex stores alpha in float32,
    as JAX's does)."""
    if in_kernel_feats and method not in FEATURE_ROUTES:
        raise ValueError(f"in_kernel_feats runs on {FEATURE_ROUTES}, not on {method!r}")
    if gamma_sel and method != "fused":
        raise ValueError(f"gamma_sel requires the fused kernels, not {method!r}")
    if bf16_alpha and method not in BF16_ROUTES:
        raise ValueError(f"bf16_alpha requires the fused or the split kernels, not {method!r}")


def check_duplex_width(emission, obs: torch.Tensor, in_kernel_feats: bool) -> None:
    """Raise ``ValueError`` for in-kernel features wider than the duplex
    kernels build (``FMAX``): "duplex" runs the split kernels at such
    widths, which build no features."""
    if in_kernel_feats:
        kind = in_kernel_kind(emission)
        F = kind_feature_width(kind, obs.shape[-1])
        if F > FMAX:
            raise ValueError(f"in-kernel {kind!r} features at D={obs.shape[-1]} are {F} wide; "
                             f"the duplex kernels build at most {FMAX}")


def prepare_fused_obs(params: HMMParams, emission, obs: torch.Tensor,
                      in_kernel_feats: bool = False, method: str = "fused") -> torch.Tensor | None:
    """The fused and duplex E-steps' observation side, built once.

    Returns the time-major feature array (T, B, F) as contiguous float32:
    the family's ``ell_features``, or for the multinomial the one-hot
    (T, B, V) of its int observations (B, T). None when ``method``'s route
    runs the split kernels on these features (a multinomial above
    ``ONE_HOT_MAX_V`` symbols, :func:`wider_than_fused_kernels`; on
    "duplex" also F > ``FMAX``, :func:`wider_than_duplex_kernels`). With
    ``in_kernel_feats`` the raw observations (T, B, D) instead, whose
    features the kernels build; a family without a built kind
    (:func:`in_kernel_kind`), or on "duplex" features wider than ``FMAX``,
    raise ``ValueError``. It depends on the data only, so engines whose data
    is fixed across iterations (batch VB) build it once and pass it as
    ``prepared=``."""
    check_family(emission)
    if in_kernel_feats:
        in_kernel_kind(emission)
        if method == "duplex":
            check_duplex_width(emission, obs, in_kernel_feats)
        return obs.transpose(0, 1).to(torch.float32).contiguous()
    wide = wider_than_duplex_kernels if method == "duplex" else wider_than_fused_kernels
    if wide(emission, params.emit, obs):
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
    in_kernel_feats: bool = False,
    gamma_sel: torch.Tensor | None = None,
    alpha_dtype: torch.dtype = torch.float32,
) -> tuple[FBResult, object]:
    """The fused and duplex routes (JAX's ``_pallas_fused_estep``, the duplex
    one with ``PYSVIHMM_DUPLEX`` set): returns (FBResult with gamma (T, B, K)
    time-major, or None; emission stats), the stats kept-mask-gated in-kernel
    when ``weights`` (B, T) is given. A multinomial above ``ONE_HOT_MAX_V``
    symbols runs the split route instead, as JAX's does (engines/base.py:547;
    :func:`wider_than_fused_kernels`), its alpha in ``alpha_dtype``; the
    split kernels have no pick, so ``gamma_sel`` there raises ``ValueError``.
    Every other width runs the fused pair. "duplex" runs the split route at
    F > ``FMAX`` too (:func:`wider_than_duplex_kernels`), until its kernels
    take wider features.

    The kernel modes (:func:`check_kernel_modes`): ``in_kernel_feats`` has
    the kernels build the features from the raw observations (``prepared``
    then the raw (T, B, D) of ``prepare_fused_obs(..., in_kernel_feats=
    True)``); ``gamma_sel`` (B,) has the fused backward pick each
    sequence's gamma at that step into FBResult.init_stats, with no gamma
    written; ``alpha_dtype`` is the fused forward's alpha storage."""
    check_kernel_modes(method, in_kernel_feats, gamma_sel is not None,
                       alpha_dtype != torch.float32)
    check_family(emission)
    if method == "duplex":
        check_duplex_width(emission, obs, in_kernel_feats)
        if wider_than_duplex_kernels(emission, params.emit, obs):
            return _split_estep(params, emission, obs, weights)
    feats = (prepare_fused_obs(params, emission, obs, in_kernel_feats, method)
             if prepared is None else prepared)
    if feats is None:
        if gamma_sel is not None:
            raise ValueError(
                f"gamma_sel runs in the fused kernels, which a multinomial of more than "
                f"{ONE_HOT_MAX_V} symbols leaves for the split kernels (V = "
                f"{params.emit.shape[-1]}), as JAX's does")
        return _split_estep(params, emission, obs, weights, alpha_dtype)
    log_pi, log_A = expected_log_params(params)
    modes = {"in_kernel_feats": in_kernel_kind(emission) if in_kernel_feats else None,
             "gamma_sel": gamma_sel}
    if method == "fused":
        modes["alpha_dtype"] = alpha_dtype
    fb, S = _FUSED_ESTEPS[method](
        log_pi, log_A, _fused_W(emission, params.emit), feats,
        emit_gamma=need_gamma and gamma_sel is None, weights=_time_major_weights(weights),
        **modes,
    )
    return fb, emission.unpack_flat_stats(params.emit, S)


def _split_estep(
    params: HMMParams, emission, obs: torch.Tensor, weights: torch.Tensor | None = None,
    alpha_dtype: torch.dtype = torch.float32,
) -> tuple[FBResult, object]:
    """The split route (JAX's ``_pallas_packed_estep``): returns (FBResult
    with gamma (T, B, K) time-major, emission stats); ``alpha_dtype`` the
    split forward's alpha storage (JAX's ``_alpha_store_dtype()``).

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
        fb = estep_split(log_pi, log_A, ll.contiguous(), w_tm, alpha_dtype)
        gamma_w = fb.gamma if w_tm is None else fb.gamma * w_tm[..., None]
        return fb, emission_flat_stats(emission, params.emit, gamma_w, obs_tm)
    feats = _features(emission, obs)  # (T, B, F)
    T, B, F = feats.shape
    K = params.init.shape[0]
    ll = torch.matmul(feats, _fused_W(emission, params.emit))  # (T, B, K)
    fb = estep_split(log_pi, log_A, ll, w_tm, alpha_dtype)
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
    in_kernel_feats: bool = False,
    bf16_alpha: bool = False,
) -> tuple[LocalStats, torch.Tensor | None]:
    """Full local update over a batch of sequences obs (B, T, D), or int obs
    (B, T) for the multinomial.

    Returns (summed stats, gamma (B, T, K), or None when need_gamma=False).
    method "auto" resolves by obs' device: "fused" (the two fused CUDA
    kernels: likelihoods, forward-backward and emission stats in-kernel) on
    CUDA, "scan" (plain PyTorch over materialised likelihoods) on CPU;
    "assoc" and "blocked" are the other plain methods of ``messages.e_step``.
    "split" runs the split CUDA kernels over likelihoods computed outside
    them, "duplex" the duplex kernels (both chains in one kernel, the
    statistics chain-free in a second). The kernel routes run their
    kernels' plain twins on CPU tensors.
    weights: optional (B, T) kept-mask; it gates init_stats (w_0),
    trans_stats (pairs w_{t-1} w_t) and the emission stats on every route,
    and never the chain: gamma comes out ungated.

    The kernel modes, off by default (JAX reaches them through
    ``PYSVIHMM_INKERNEL_FEATS`` and ``PYSVIHMM_BF16_ALPHA``):
    ``in_kernel_feats`` has the "fused" and "duplex" kernels build the
    Gaussian families' features from the raw observations (the same bits as
    the feature array); ``bf16_alpha`` stores the "fused" or "split"
    forward's alpha as bf16 (a multinomial above 256 symbols on "fused":
    the split forward's, as JAX's). Another route, a family without a built
    kind, or on "duplex" features wider than its kernels build, raise
    ``ValueError`` (:func:`check_kernel_modes`, :func:`in_kernel_kind`).

    exact: evaluation callers set it so that log Z comes from float32
    alpha: it pins float32 storage, whatever ``bf16_alpha``.
    """
    f32_matmuls()
    method = messages.resolve_method(method, obs.device)
    check_kernel_modes(method, in_kernel_feats, bf16_alpha=bf16_alpha)
    alpha_dtype = torch.bfloat16 if bf16_alpha and not exact else torch.float32

    if method in messages.PLAIN_METHODS:
        log_pi, log_A = expected_log_params(params)
        ll = emission.expected_log_likelihood(params.emit, obs)  # (B, T, K)
        fb = messages.e_step_batched(log_pi, log_A, ll, weights=weights, method=method)
        gamma_w = fb.gamma if weights is None else fb.gamma * weights[..., None]
        emit_stats = emission_flat_stats(emission, params.emit, gamma_w, obs)
        gamma = fb.gamma if need_gamma else None
    else:
        if method == "split":
            fb, emit_stats = _split_estep(params, emission, obs, weights, alpha_dtype)
        else:
            fb, emit_stats = _fused_estep(params, emission, obs, weights, need_gamma, prepared,
                                          method, in_kernel_feats, alpha_dtype=alpha_dtype)
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
    in_kernel_feats: bool = False,
    gamma_sel: bool = False,
    bf16_alpha: bool = False,
) -> tuple[object, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared local step of the windowed engines (svi subchains).

    Returns (emit_stats, trans_stats, gamma_at_off, log_c): emission stats
    kept-mask-gated and summed over windows; trans_stats pair-gated and
    summed, (K, K); gamma_at_off (B, K) = each window's smoothed marginal at
    its kept-region offset (the initial-state stats site); log_c (B, W) per
    step log normalisers (the mask applies to their sum).

    The kernel routes keep gamma time-major (W, B, K) as the kernels write
    it; the per-window pick gamma[offs[b], b, :] is a plain gather on it.
    With ``gamma_sel`` ("fused" only; JAX's ``PYSVIHMM_GAMMA_SEL``) the
    fused backward picks it in-kernel and writes no gamma; a multinomial
    above 256 symbols, which runs the split kernels, then raises
    ``ValueError``.
    ``in_kernel_feats`` and ``bf16_alpha`` as :func:`batch_local_step`'s.
    """
    f32_matmuls()
    method = messages.resolve_method(method, windows.device)
    check_kernel_modes(method, in_kernel_feats, gamma_sel, bf16_alpha)
    rows = torch.arange(windows.shape[0], device=windows.device)
    alpha_dtype = torch.bfloat16 if bf16_alpha else torch.float32
    if method == "split":
        fb, emit_stats = _split_estep(params, emission, windows, maskf, alpha_dtype)
        return emit_stats, fb.trans_stats, fb.gamma[offs, rows], fb.log_c
    if method in FEATURE_ROUTES:
        fb, emit_stats = _fused_estep(params, emission, windows, maskf, method=method,
                                      in_kernel_feats=in_kernel_feats,
                                      gamma_sel=offs if gamma_sel else None,
                                      alpha_dtype=alpha_dtype)
        pick = fb.init_stats if gamma_sel else fb.gamma[offs, rows]
        return emit_stats, fb.trans_stats, pick, fb.log_c

    log_pi, log_A = expected_log_params(params)
    ll = emission.expected_log_likelihood(params.emit, windows)
    fb = messages.e_step_batched(log_pi, log_A, ll, weights=maskf, method=method)
    gamma_w = fb.gamma * maskf[..., None]
    emit_stats = emission_flat_stats(emission, params.emit, gamma_w, windows)
    return emit_stats, fb.trans_stats, fb.gamma[rows, offs], fb.log_c


LONG_CHAIN_IMPLS = ("fused", "twophase", "assoc")


def long_chain_local_stats(
    params: HMMParams,
    emission,
    chain: torch.Tensor,
    block_size: int = 256,
    impl: str = "fused",
    time_minor: bool = False,
) -> LocalStats:
    """Exact full-chain local statistics of ONE very long chain, streaming.

    The statistics of ``batch_local_step(params, emission, chain[None],
    method="blocked", need_gamma=False)[0]``, but gamma and the per-step
    K x K matrices never exist: the emission statistics are summed inside
    the backward sweep, so a K = 64 chain of 10^7+ steps fits the card.

    impl: "fused" (default; :func:`messages.stream_fused.
    forward_backward_fused_twophase`: likelihoods computed a chunk at a time
    from the raw observations, so no (T, K) array exists), "twophase"
    (:func:`messages.blocked.forward_backward_blocked_twophase` over the
    (T, K) log-likelihoods) or "assoc"
    (:func:`messages.blocked.forward_backward_blocked_stream`, the
    associative-scan tier). JAX's ``PYSVIHMM_STREAM_IMPL`` variable is this
    argument only: the port reads no environment knobs.

    chain: (T, D) floats or (T,) int tokens; with time_minor=True (impl
    "fused" only) the chain arrives feature-major, (D, T)."""
    if impl not in LONG_CHAIN_IMPLS:
        raise ValueError(f"unknown long-chain impl {impl!r}; expected one of {LONG_CHAIN_IMPLS}")
    if time_minor and impl != "fused":
        # the other tiers take a (T, K) likelihood of a TIME-MAJOR chain
        raise ValueError(f"time_minor=True requires impl='fused' (got impl={impl!r})")
    f32_matmuls()
    check_family(emission)

    def stat_fn(g, y):
        return emission_flat_stats(emission, params.emit, g, y)

    log_pi, log_A = expected_log_params(params)
    if impl == "fused":
        r = forward_backward_fused_twophase(
            log_pi, log_A, chain, _long_chain_ell_fn(params, emission),
            block_size=block_size, stat_fn=stat_fn,
            stat_init=emission.zero_stats(params.emit), time_minor=time_minor,
        )
    else:
        fb_stream = (forward_backward_blocked_twophase if impl == "twophase"
                     else forward_backward_blocked_stream)
        ll = emission.expected_log_likelihood(params.emit, chain)  # (T, K)
        r = fb_stream(log_pi, log_A, ll, block_size=block_size, stat_xs=chain,
                      stat_fn=stat_fn, stat_init=emission.zero_stats(params.emit))
    return LocalStats(init=r.init_stats, trans=r.trans_stats, emit=r.acc, log_z=r.log_z)


def _long_chain_ell_fn(params: HMMParams, emission):
    """The streaming tiers' per-chunk expected log-likelihood: one
    ``ell_features(rows) @ W`` product for the families with a feature form
    (JAX runs it at its 3-pass "high" tier; the port in float32), else the
    family's ``expected_log_likelihood``."""
    if hasattr(emission, "ell_features"):
        W = emission.ell_feature_matrix(params.emit)
        return lambda rows: emission.ell_features(rows) @ W
    return lambda rows: emission.expected_log_likelihood(params.emit, rows)


def long_chain_decode(
    params: HMMParams,
    emission,
    chain: torch.Tensor,
    block_size: int = 1024,
    chunks: int = 8,
    time_minor: bool = False,
) -> torch.Tensor:
    """Posterior-marginal decode of ONE long chain, streaming: (T,) int32.

    :func:`decode`'s argmax_k gamma_tk, but gamma never exists: the fused
    streaming tier's backward sweep emits each step's argmax
    (``emit_argmax``), so the decode reaches the streaming E-step's scale."""
    f32_matmuls()
    check_family(emission)
    log_pi, log_A = expected_log_params(params)
    return forward_backward_fused_twophase(
        log_pi, log_A, chain, _long_chain_ell_fn(params, emission), block_size=block_size,
        chunks=chunks, emit_argmax=True, time_minor=time_minor,
    ).z


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


def viterbi_decode(params: HMMParams, emission, obs: torch.Tensor) -> torch.Tensor:
    """MAP state paths (B, T) int64 under the variational-mean parameters
    (E[log pi], E[log A] and the expected log-likelihoods)."""
    f32_matmuls()
    log_pi, log_A = expected_log_params(params)
    ll = emission.expected_log_likelihood(params.emit, obs)
    return messages.viterbi(log_pi, log_A, ll)


def predictive_log_likelihood(
    params: HMMParams, emission, obs: torch.Tensor, exact: bool = False
) -> torch.Tensor:
    """Held-out predictive log-likelihood of obs (B, T, ...), summed, by the
    forward filter under the posterior-mean pi and A.

    exact=False: the emissions scored under the posterior-mean point
    parameters (the reference's plug-in). exact=True: under the exact
    posterior predictive (Student-t, negative binomial or
    Dirichlet-multinomial), integrating out phi per observation.
    """
    f32_matmuls()
    log_pi = torch.log(dirichlet.mean(params.init))
    log_A = torch.log(dirichlet.mean(params.trans))
    if exact:
        ll = emission.predictive_log_likelihood(params.emit, obs)
    else:
        ll = emission.point_log_likelihood(emission.mean_params(params.emit), obs)
    return messages.forward(log_pi, log_A, ll)[1].sum()
