"""Likelihood-fused two-phase streaming forward-backward for one chain of
up to hundreds of millions of steps (port of
``pysvihmm_tpu/messages/stream_fused.py``).

:func:`blocked.forward_backward_blocked_twophase` takes the (T, K)
log-likelihood array as input and reads it in all three phases. Here the
likelihoods are computed chunk by chunk from the raw observations inside
each phase, one batched product a chunk off the sequential chain, so no
(T, K) array exists. What lives at full length (K = 64, float32):

* the observations, T D floats (or T int32 tokens);
* the filtered messages, T K floats when ``store_alphas``; otherwise one
  chunk's T K / chunks and chunks (T / S) K checkpoints: the backward pass
  rematerialises each chunk's messages from its checkpoint, one more vector
  sweep of work for a footprint set by the observations.

The schedule is the two-phase tier's: (1) per-block transfer products with
the likelihood rows built in-chunk (:func:`_block_products_fused`); (2) the
boundary recursions (:func:`blocked.boundary_seeds`); (3) chunked, seeded
sweeps across all blocks at once, each chunk's likelihoods one product.

``emit_argmax=True`` also streams the posterior-marginal decode argmax_k
gamma_tk out of the backward sweep, (T,) int32, the only per-step output.

Everything runs under ``torch.no_grad()`` (JAX's ``stop_gradient`` of the
shifts has no role here).
"""

from __future__ import annotations

import torch

from ..utils.precision import f32_matmuls
from .blocked import (
    StreamStats,
    _pad_count,
    _single_step,
    _stat_rows,
    accumulate,
    boundary_seeds,
    leaf_products,
    tree_add,
)

LEAF_BYTES = 128 << 20  # phase 1's leaf level (CB S / 2 matrices) per chunk


def _lik_factory(ell_fn, dtype):
    """rows (..., N, obs-dims) -> (lik (..., N, K) in [0, 1], the max shifts)."""

    def lik_fn(rows):
        ll = ell_fn(rows)
        sh = ll.amax(dim=-1)
        return torch.exp(ll - sh[..., None]).to(dtype), sh.to(dtype)

    return lik_fn


def _transition_rows(obs: torch.Tensor, time_minor: bool, n_blocks: int, S: int,
                     pad: int) -> torch.Tensor:
    """The observations of times b S + s + 1, zero-padded to whole blocks:
    (n_blocks, S, ...) time-major, or (D, n_blocks, S) time-minor. Padded
    rows give finite likelihoods that every consumer gates out (a view of
    obs when no padding is needed)."""
    if time_minor:
        tail = (obs.shape[0],)
        rows = obs[:, 1:]
        if pad:
            rows = torch.cat((rows, torch.zeros(tail + (pad,), dtype=obs.dtype,
                                                device=obs.device)), dim=1)
        return rows.reshape(tail + (n_blocks, S))
    tail = tuple(obs.shape[1:])
    rows = obs[1:]
    if pad:
        rows = torch.cat((rows, torch.zeros((pad,) + tail, dtype=obs.dtype, device=obs.device)))
    return rows.reshape((n_blocks, S) + tail)


def _block_rows(obs_blocks: torch.Tensor, time_minor: bool, blocks: slice,
                steps: slice) -> torch.Tensor:
    """Rows of some blocks and in-block steps, (steps, blocks, ...) contiguous
    time-major: a time-minor chunk is transposed into rows here, one chunk
    at a time."""
    if time_minor:
        return obs_blocks[:, blocks, steps].permute(2, 1, 0).contiguous()
    return obs_blocks[blocks, steps].transpose(0, 1).contiguous()


def _block_products_fused(
    A_tilde, obs_blocks, valid, n_blocks: int, S: int, lik_fn, chunk_blocks: int | None = None,
    time_minor: bool = False,
) -> torch.Tensor:
    """Per-block transfer products Q (n_blocks, K, K), the likelihood rows
    computed from each chunk of observations here, so no (T, K) array feeds
    this phase; the tree reduce is :func:`blocked.leaf_products`. The rows'
    max shifts are dropped: every consumer of Q renormalises. The leaf
    level's (CB S / 2, K, K) products are capped at about 128 MB a chunk.

    obs_blocks: (n_blocks, S, ...) or, time_minor, (D, n_blocks, S)."""
    K = A_tilde.shape[0]
    if chunk_blocks is None:
        chunk_blocks = max(1, LEAF_BYTES // max(S // 2, 1) // (K * K * A_tilde.element_size()))
    Q = torch.empty((n_blocks, K, K), dtype=A_tilde.dtype, device=A_tilde.device)
    for c0 in range(0, n_blocks, chunk_blocks):
        c1 = min(c0 + chunk_blocks, n_blocks)
        # (blocks, S, ...) rows; a time-minor chunk is transposed here
        rows = obs_blocks[:, c0:c1].permute(1, 2, 0) if time_minor else obs_blocks[c0:c1]
        lik, _ = lik_fn(rows.reshape(((c1 - c0) * S,) + tuple(rows.shape[2:])))
        # padding trails the last transition: only the last chunk holds any
        val = valid[c0:c1] if c1 == n_blocks else None
        Q[c0:c1] = leaf_products(A_tilde, lik.reshape(c1 - c0, S, K), val, S)
    return Q


@torch.no_grad()
def _seeded_sweeps(
    A, lik_fn, obs_blocks, valid, seeds_a, seeds_b, C: int, *, time_minor: bool,
    store_alphas: bool, stat_fn=None, stat_init=None, xtra=None, emit_argmax: bool = False,
):
    """Phase 3: the forward and backward sweeps inside all blocks at once,
    seeded by phase 2's messages, C chunks of S / C in-block steps, each
    chunk's likelihoods one product from its observations (recomputed in
    the backward sweep, with its filtered messages when not
    ``store_alphas``). xtra: stat_fn's operand laid out (S, n_blocks, ...),
    or None for the observation rows.

    Returns (the sum of the per-step log normalisers, beta at time 0, the
    summed pairwise marginals, stat_fn's sums or None, the decode (n_blocks,
    S) int32 at times b S + s + 1 or None)."""
    K = A.shape[0]
    n_blocks, S = valid.shape
    S2 = S // C
    dtype, dev = A.dtype, A.device
    have_stats = stat_fn is not None
    val_s = valid.T  # (S, n_blocks)
    every = slice(None)

    def chunk_rows(c):
        return _block_rows(obs_blocks, time_minor, every, slice(c * S2, (c + 1) * S2))

    a, ckpts, logc_chunks, alphas_all = seeds_a, [], [], []
    for c in range(C):
        ckpts.append(a)  # alpha at this chunk's start, per block
        lik_c, sh_c = lik_fn(chunk_rows(c))  # one batched product, off the chain
        logc_steps, al_c = [], []
        for s2 in range(S2):
            v = val_s[c * S2 + s2]
            au = (a @ A) * lik_c[s2]
            cs = au.sum(dim=-1)
            a = torch.where(v[:, None], au / cs[:, None], a)
            logc_steps.append(torch.where(v, torch.log(cs) + sh_c[s2], 0.0).sum())
            if store_alphas:
                al_c.append(a)
        logc_chunks.append(torch.stack(logc_steps).sum())
        if store_alphas:
            alphas_all.append(al_c)
        del lik_c, sh_c

    z_buf = (torch.empty((n_blocks, S), dtype=torch.int32, device=dev) if emit_argmax
             else None)
    b, acc_tr, acc = seeds_b, torch.zeros((K, K), dtype=dtype, device=dev), None
    for c in reversed(range(C)):
        rows = chunk_rows(c)
        x_c = rows if xtra is None else xtra[c * S2:(c + 1) * S2]
        lik_c, _ = lik_fn(rows)  # the shifts cancel in every backward consumer
        if store_alphas:
            al_c = alphas_all[c]
        else:
            # rematerialise this chunk's filtered messages from its checkpoint
            a, al_c = ckpts[c], []
            for s2 in range(S2):
                au = (a @ A) * lik_c[s2]
                a = torch.where(val_s[c * S2 + s2, :, None],
                                au / au.sum(dim=-1, keepdim=True), a)
                al_c.append(a)
        for s2 in reversed(range(S2)):
            t = c * S2 + s2
            v = val_s[t]
            keep = v[:, None]
            a_prev = al_c[s2 - 1] if s2 else ckpts[c]
            if have_stats or emit_argmax:
                g = al_c[s2] * b
                gamma = g / g.sum(dim=-1, keepdim=True)
                if emit_argmax:
                    z_buf[:, t] = gamma.argmax(dim=-1)
                if have_stats:
                    acc = accumulate(acc, stat_fn(gamma * keep, x_c[s2]), stat_init)
            bl = lik_c[s2] * b
            n = ((a_prev @ A) * bl).sum(dim=-1)
            aw = a_prev * (v / n)[:, None]
            acc_tr = acc_tr + A * (aw.T @ bl)
            b_new = bl @ A.T
            b = torch.where(keep, b_new / b_new.sum(dim=-1, keepdim=True), b)
        if store_alphas:
            alphas_all[c] = None
        del lik_c, al_c
    # b[0] is now beta at time 0
    return torch.stack(logc_chunks).sum(), b[0], acc_tr, acc, z_buf


STORE_ALPHAS_BYTES = 2 << 30  # the most the stored (T, K) filtered messages may take


def stores_alphas(T: int, K: int, dtype: torch.dtype) -> bool:
    """The default of ``store_alphas``: store the (T, K) filtered messages
    when they take at most :data:`STORE_ALPHAS_BYTES` in ``dtype`` (the
    likelihoods'), else rematerialise them. JAX's rule counts 4 bytes an
    entry whatever the dtype (``pysvihmm_tpu/messages/stream_fused.py:213``),
    which lets float64 messages reach twice the cap."""
    return T * K * dtype.itemsize <= STORE_ALPHAS_BYTES


@torch.no_grad()
def forward_backward_fused_twophase(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    obs: torch.Tensor,  # (T, ...) raw observations, floats or int tokens
    ell_fn,  # rows (..., N, obs-dims) -> expected log-likelihoods (..., N, K)
    block_size: int = 1024,
    chunks: int = 8,
    store_alphas: bool | None = None,
    stat_xs: torch.Tensor | None = None,  # defaults to obs
    stat_fn=None,
    stat_init=None,
    beta_end: torch.Tensor | None = None,
    emit_argmax: bool = False,
    time_minor: bool = False,
) -> StreamStats:
    """Exact streaming E-step for ONE long chain, likelihoods fused:
    :func:`blocked.forward_backward_blocked_twophase`'s contract with the
    (T, K) log-likelihood input replaced by (raw observations, ell_fn), plus
    the argmax-gamma decode in ``.z`` when ``emit_argmax``.

    ell_fn must map over any leading axes; it runs once a chunk in each
    phase (the likelihood work is paid three times, their memory traffic
    not at all). chunks: the phase-3 chunking of the in-block time axis
    (lowered to divide S), which sets the transient footprint T K / chunks
    and, under rematerialisation, the checkpoint count. store_alphas: True
    stores all (T, K) filtered messages between the sweeps, False
    rematerialises each chunk's from its checkpoint; None
    (:func:`stores_alphas`) stores while they take at most 2 GiB in the
    likelihoods' dtype. The two give the same bits.

    stat_fn(gamma (n_blocks, K), rows) is summed over all time steps, its
    operand ``stat_xs`` (default the observations, which then share their
    reads with the likelihoods).

    time_minor=True takes the chain feature-major, obs (D, T), and
    transposes each chunk into rows; ell_fn and stat_fn still see (N, D)
    rows, and stat_xs must be None. JAX needs this layout on the TPU, where
    a (T, 8) float32 array is padded to 128 lanes."""
    f32_matmuls()
    tm = time_minor and obs.ndim >= 2
    if tm and stat_xs is not None:
        raise ValueError("time_minor supports stat_xs=None (obs) only")
    T = obs.shape[-1] if tm else obs.shape[0]
    rows0 = obs[:, :1].T if tm else obs[:1]  # the t = 0 observation row
    probe = ell_fn(rows0)
    K, dtype = probe.shape[-1], probe.dtype
    lik_fn = _lik_factory(ell_fn, dtype)
    have_stats = stat_fn is not None
    own_rows = stat_xs is None or stat_xs is obs
    if stat_xs is None:
        stat_xs = obs
    if store_alphas is None:
        store_alphas = stores_alphas(T, K, dtype)
    dev = obs.device

    lik0, sh0 = lik_fn(rows0)
    if T == 1:
        r = _single_step(log_pi, lik0, sh0, rows0 if tm else stat_xs, stat_fn, stat_init,
                         beta_end)
        z = r.init_stats.argmax()[None].to(torch.int32) if emit_argmax else None
        return r._replace(z=z)
    a0 = torch.exp(log_pi).to(dtype) * lik0[0]
    c0 = a0.sum()

    # power-of-two S for the tree reduce; C divides S
    S = 1 << (min(block_size, T - 1).bit_length() - 1)
    C = min(chunks, S)
    while S % C:
        C -= 1
    A = torch.exp(log_A).to(dtype)
    n_trans = T - 1
    pad = _pad_count(n_trans, S)
    n_blocks = (n_trans + pad) // S
    obs_blocks = _transition_rows(obs, tm, n_blocks, S, pad)
    valid = (torch.arange(n_trans + pad, device=dev) < n_trans).reshape(n_blocks, S)

    # phase 1: block products, likelihoods built in-chunk
    Q = _block_products_fused(A, obs_blocks, valid, n_blocks, S, lik_fn, time_minor=tm)

    # phase 2: boundary recursions over blocks
    alpha0 = a0 / c0
    seeds_a, seeds_b = boundary_seeds(Q, alpha0, beta_end)
    del Q

    # phase 3: seeded sweeps inside all blocks at once
    xtra = None if (own_rows or not have_stats) else _stat_rows(stat_xs, n_blocks, S)
    logc, beta0, acc_tr, acc, z_buf = _seeded_sweeps(
        A, lik_fn, obs_blocks, valid, seeds_a, seeds_b, C, time_minor=tm,
        store_alphas=store_alphas, stat_fn=stat_fn, stat_init=stat_init, xtra=xtra,
        emit_argmax=emit_argmax)
    log_z = torch.log(c0) + sh0[0] + logc

    g0 = alpha0 * beta0
    init_stats = g0 / g0.sum()
    if have_stats:
        acc = tree_add(acc, stat_fn(init_stats[None], rows0 if tm else stat_xs[:1]))
    z = None
    if emit_argmax:
        # z_buf[b, s] is the decode at time b S + s + 1
        z = torch.cat((init_stats.argmax()[None].to(torch.int32), z_buf.reshape(-1)[:n_trans]))
    return StreamStats(log_z=log_z, init_stats=init_stats, trans_stats=acc_tr, acc=acc, z=z)
