"""Exact forward-backward with the TIME axis sharded over a mesh of processes
(port of ``pysvihmm_tpu/messages/time_sharded.py``): the context-parallelism
analog.

The chain is cut into D contiguous tiles, one a process on a ``time`` mesh
axis; each process passes its own tile (what ``parallel.shard_chain``
returns) and the replicated log_pi and log_A. Smoothing is exact by three
phases:

1. **Local tile products** (batched matrix products, no sequential chain):
   each process forms its per-step transfer matrices S_t = A~ diag(lik_t)
   and tree-reduces them (log depth, renormalised each level) into one
   K x K tile operator Q_d. Row-vector convention: alpha_t ∝ alpha_{t-1} @
   S_t, so Q_d composes the whole tile.
2. **Boundary exchange**: one all-gather of the D tile operators (D K K
   floats); every process then replays the D-step boundary recursions
   a_d = normalise(a_{d-1} @ Q_d) (the filtered alpha at each tile's last
   step, seeded by pi~ through tile 0's first factor diag(lik_0)) and
   b_d = normalise(Q_{d+1} @ b_{d+1}) (beta at each tile's last step).
3. **Seeded local sweeps** (sequential depth T/D instead of T): each tile
   runs the normalised scans seeded with its boundary messages.
   log_pi := log(a_in @ A~) reproduces the global per-step scaling
   constants c_t exactly (a_in is the true normalised filtered marginal),
   so gamma, the statistics, log_c and log Z match the one-process scan to
   rounding. The pairwise marginal of the transition into tile d needs only
   a_in (replicated), the tile's first likelihood row and its first beta.

Per-step weights (SVI kept-masks) gate init and trans stats, as in
``scan_fb``. The streaming tiers (:func:`time_sharded_long_chain_stats`,
:func:`time_sharded_fused_stats`) run the two-phase sweeps on each tile
instead, seeded the same way, and never form gamma. Every tier is plain
PyTorch, as JAX's is plain XLA; its collectives are
:mod:`~pysvihmm_tpu_torch.parallel.collectives`'.
"""

from __future__ import annotations

import torch

from ..parallel import collectives
from ..utils.precision import f32_matmuls
from .blocked import StreamStats, _block_products, _pad_count, forward_backward_blocked_twophase
from .scan_fb import FBResult, _normalize_loglik, backward, forward_with_logc
from .stream_fused import (
    _block_products_fused,
    _lik_factory,
    _transition_rows,
    forward_backward_fused_twophase,
)


def _check_tiles(n: int, group, what: str, axis_name: str) -> int:
    """Every process of the axis holds n rows, or ``ValueError`` on all of
    them: the global length must be a multiple of the axis size (JAX's
    check, here on the tiles the processes were given). Returns D."""
    D = collectives.axis_size(group)
    counts = collectives.all_gather(torch.tensor(n, device=collectives.host_device(group)), group)
    if bool((counts != counts[0]).any()):
        raise ValueError(f"{what}={int(counts.sum())} must be divisible by {axis_name}-axis "
                         f"size {D} (tiles of {counts.tolist()})")
    return D


def _tree_product(S: torch.Tensor) -> torch.Tensor:
    """Left-to-right product of a stack of matrices, log depth: S (..., n, K,
    K) -> S[..., 0] @ ... @ S[..., n-1], (..., K, K).

    Each level is one batched product, renormalised by its max to keep the
    geometric decay of sub-stochastic transfer products away from underflow
    (the dropped scales cancel in the normalised boundary messages); the max
    is floored at ``tiny`` so that an underflowed product propagates zeros
    (a clean -inf log Z) instead of 0/0 NaNs. Identity padding makes any n
    exact."""
    n, K = S.shape[-3], S.shape[-1]
    p2 = 1 << max(n - 1, 0).bit_length()
    if p2 != n:
        eye = torch.eye(K, dtype=S.dtype, device=S.device).expand(S.shape[:-3] + (p2 - n, K, K))
        S = torch.cat((S, eye), dim=-3)
    tiny = torch.finfo(S.dtype).tiny
    while S.shape[-3] > 1:
        S = S[..., 0::2, :, :] @ S[..., 1::2, :, :]
        S = S / torch.clamp_min(S.amax(dim=(-2, -1), keepdim=True), tiny)
    return S[..., 0, :, :]


def _boundary_recursions(Qg: torch.Tensor, a0: torch.Tensor, b0: torch.Tensor):
    """Phase 2 from the gathered tile operators Qg (D, ..., K, K): a_last[d] =
    the normalised filtered alpha at tile d's LAST step, b_last[d] = the
    normalised beta there (b0 at the right edge). a0, b0 (..., K); returns
    two (D, ..., K) stacks. Replicated on every process."""
    D = Qg.shape[0]
    a, a_last = a0, []
    for d in range(D):
        a = (a[..., None, :] @ Qg[d])[..., 0, :]
        a = a / a.sum(dim=-1, keepdim=True)
        a_last.append(a)
    b, b_last = b0, [b0]
    for d in range(D - 1, 0, -1):
        b = (Qg[d] @ b[..., None])[..., 0]
        b = b / b.sum(dim=-1, keepdim=True)
        b_last.append(b)
    return torch.stack(a_last), torch.stack(b_last[::-1])


def _seed_log_pi(log_pi: torch.Tensor, a_in: torch.Tensor, A: torch.Tensor, idx: int):
    """The tile's seed: log_pi on tile 0, else log(a_in @ A~) from the left
    neighbour's last filtered alpha."""
    if idx == 0:
        return log_pi.to(A.dtype)
    return torch.log(torch.clamp_min(a_in @ A, 1e-38))


def _boundary_xi(A, a_in, lik0, beta0):
    """The pairwise marginal of the transition into a tile, (..., K, K), from
    the left neighbour's last filtered alpha a_in, the tile's first
    likelihood row and its first beta (scales cancel)."""
    blb = lik0 * beta0
    xi = A * a_in[..., :, None] * blb[..., None, :]
    return xi / torch.clamp_min(xi.sum(dim=(-2, -1), keepdim=True), 1e-38)


def _chain_tile_fb(log_pi, log_A, ll, w, idx: int, w_prev, group):
    """One process's tile of a batch of chains: ll (B, C, K), w (B, C)
    kept-masks, w_prev (B,) the left neighbour's last mask value. Returns
    (gamma (B, C, K), log_c (B, C), trans partial (K, K) summed over the
    batch, init partial (B, K), log Z partial (B,)); the partials still need
    a sum over the time axis."""
    B, C, K = ll.shape
    A = torch.exp(log_A)
    lik, _ = _normalize_loglik(ll)

    # phase 1: tile operators (batched, no chain)
    S = A * lik[:, :, None, :]  # S_t = A~ diag(lik_t), (B, C, K, K)
    if idx == 0:  # alpha_0 ∝ pi~ @ diag(lik_0)
        S = torch.cat((torch.diag_embed(lik[:, 0])[:, None], S[:, 1:]), dim=1)
    Q = _tree_product(S)  # (B, K, K)
    del S

    # phase 2: boundary recursions on the gathered tile operators
    Qg = collectives.all_gather(Q, group)  # (D, B, K, K)
    a0 = torch.exp(log_pi).expand(B, K)
    b0 = torch.full((B, K), 1.0 / K, dtype=lik.dtype, device=lik.device)
    a_last, b_last = _boundary_recursions(Qg, a0, b0)

    # phase 3: seeded local sweeps
    a_in = a_last[max(idx - 1, 0)]  # (B, K) alpha at the step before the tile
    alpha, _, log_c = forward_with_logc(_seed_log_pi(log_pi, a_in, A, idx), log_A, ll)
    beta = backward(log_A, ll, beta_last=b_last[idx])
    g = alpha * beta
    gamma = g / g.sum(dim=-1, keepdim=True)

    bl = lik[:, 1:] * beta[:, 1:]
    n = ((alpha[:, :-1] @ A) * bl).sum(dim=-1)
    alpha_w = alpha[:, :-1] * (w[:, :-1] * w[:, 1:] / n)[..., None]
    trans = A * torch.einsum("btk,btj->kj", alpha_w, bl)
    if idx > 0:  # the transition into this tile, gated by both masks
        xi_b = _boundary_xi(A, a_in, lik[:, 0], beta[:, 0])
        trans = trans + torch.einsum("b,bkj->kj", w_prev * w[:, 0], xi_b)
    init = w[:, :1] * gamma[:, 0] if idx == 0 else torch.zeros_like(gamma[:, 0])
    return gamma, log_c, trans, init, log_c.sum(dim=-1)


def _left_mask(w: torch.Tensor, group) -> torch.Tensor:
    """Each process's left neighbour's last mask value (``ppermute`` by +1)."""
    D = collectives.axis_size(group)
    return collectives.ppermute(w[..., -1].contiguous(), group,
                                [(i, (i + 1) % D) for i in range(D)])


def time_sharded_forward_backward(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_lik: torch.Tensor,
    mesh,
    axis: str = "time",
    weights: torch.Tensor | None = None,
) -> FBResult:
    """Exact forward-backward of one chain whose time axis is sharded over
    ``mesh[axis]``: log_lik (C, K) is this process's tile of the (T, K)
    chain, weights its (C,) tile of the kept-mask.

    ``scan_fb.forward_backward``'s contract for one chain: gamma (C, K) and
    log_c (C,) come back as this tile's; log_z (), trans_stats (K, K) and
    init_stats (K,) replicated. T must be a multiple of the axis size (every
    tile C long), or ``ValueError``."""
    f32_matmuls()
    group = mesh.get_group(axis)
    _check_tiles(log_lik.shape[0], group, "T", axis)
    idx = collectives.axis_index(group)
    w = torch.ones_like(log_lik[:, 0]) if weights is None else weights.to(log_lik.dtype)
    gamma, log_c, trans, init, log_z = _chain_tile_fb(
        log_pi, log_A, log_lik[None], w[None], idx, _left_mask(w[None], group), group)
    log_z, trans, init = collectives.psum((log_z[0], trans, init[0]), group)
    return FBResult(gamma=gamma[0], log_z=log_z, trans_stats=trans, init_stats=init,
                    log_c=log_c[0])


def _tile_operator(A: torch.Tensor, lik0: torch.Tensor, Qb: torch.Tensor | None, idx: int):
    """Q_d = F0 @ (the product of the tile's remaining transitions), from the
    per-block products Qb (n_blocks, K, K), or None for a one-step tile;
    F0 = diag(lik_0) on tile 0 (alpha_0 ∝ pi~ lik_0), else A~ diag(lik_0)."""
    F0 = torch.diag(lik0) if idx == 0 else A * lik0[None, :]
    Q = F0 if Qb is None else F0 @ _tree_product(Qb)
    return Q / torch.clamp_min(Q.max(), torch.finfo(A.dtype).tiny)


def _reduce_tile(A, a_in, log_pi_loc, lik0, r: StreamStats, idx: int, group, have_stats):
    """A streaming tile's reduced outputs: the boundary pairwise marginal into
    the tile added to its transitions (beta_0 ∝ gamma_0 / alpha_0 with
    alpha_0 ∝ exp(log_pi_loc) lik_0: scales cancel), then every sum over the
    time axis (init_stats from tile 0 alone)."""
    trans = r.trans_stats
    if idx > 0:
        al0 = torch.exp(log_pi_loc) * lik0
        al0 = al0 / al0.max()
        beta0 = r.init_stats / torch.clamp_min(al0, 1e-30)
        trans = trans + _boundary_xi(A, a_in, lik0, beta0 / beta0.max())
    init = r.init_stats if idx == 0 else torch.zeros_like(r.init_stats)
    log_z, init, trans, acc = collectives.psum(
        (r.log_z, init, trans, r.acc if have_stats else None), group)
    return log_z, init, trans, acc


def _stat_init_for(stat_init, idx: int):
    """stat_init seeds tile 0 only: the accumulators are summed over the time
    axis, so a seed on every tile would count D times."""
    if stat_init is None or idx == 0:
        return stat_init
    return _zeros_like_tree(stat_init)


def _zeros_like_tree(tree):
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    parts = [_zeros_like_tree(x) for x in tree]
    return type(tree)(*parts) if hasattr(tree, "_fields") else type(tree)(parts)


@torch.no_grad()
def time_sharded_long_chain_stats(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_lik: torch.Tensor,
    mesh,
    axis: str = "time",
    block_size: int = 256,
    stat_xs: torch.Tensor | None = None,
    stat_fn=None,
    stat_init=None,
) -> StreamStats:
    """Streaming long-chain E-step with the time axis sharded: log_lik (C, K)
    and stat_xs (C, ...) are this process's tiles.

    Each process forms its tile operator from chunked block products (no
    (C, K, K) array), one all-gather exchanges the D operators, every process
    replays the boundary recursions, and each runs
    :func:`~.blocked.forward_backward_blocked_twophase` on its tile seeded by
    its neighbours' messages (log_pi := log(a_in @ A~); beta_end seeds the
    backward). Returns a :class:`~.blocked.StreamStats` with log_z, init,
    trans and acc summed over the axis (replicated)."""
    f32_matmuls()
    group = mesh.get_group(axis)
    C, K = log_lik.shape
    _check_tiles(C, group, "T", axis)
    idx = collectives.axis_index(group)
    have_stats = stat_fn is not None
    if have_stats and stat_xs is None:
        raise ValueError("stat_fn requires stat_xs")
    dtype = log_lik.dtype
    A = torch.exp(log_A).to(dtype)
    lik, _ = _normalize_loglik(log_lik)

    Qb = None
    if C > 1:
        S = 1 << (min(block_size, C - 1).bit_length() - 1)
        pad = _pad_count(C - 1, S)
        nb = (C - 1 + pad) // S
        lik_tr = torch.cat((lik[1:], torch.ones((pad, K), dtype=dtype, device=lik.device)))
        val = torch.arange(C - 1 + pad, device=lik.device) < C - 1
        Qb = _block_products(A, lik_tr.reshape(nb, S, K), val.reshape(nb, S), nb, S)
    Qg = collectives.all_gather(_tile_operator(A, lik[0], Qb, idx), group)
    a_last, b_last = _boundary_recursions(
        Qg, torch.exp(log_pi).to(dtype), torch.ones(K, dtype=dtype, device=lik.device))

    a_in = a_last[max(idx - 1, 0)]
    log_pi_loc = _seed_log_pi(log_pi, a_in, A, idx)
    r = forward_backward_blocked_twophase(
        log_pi_loc, log_A, log_lik, block_size=block_size,
        stat_xs=stat_xs if have_stats else None, stat_fn=stat_fn,
        stat_init=_stat_init_for(stat_init, idx), beta_end=b_last[idx])
    log_z, init, trans, acc = _reduce_tile(A, a_in, log_pi_loc, lik[0], r, idx, group,
                                                have_stats)
    return StreamStats(log_z=log_z, init_stats=init, trans_stats=trans, acc=acc)


@torch.no_grad()
def time_sharded_fused_stats(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    obs: torch.Tensor,
    ell_fn,
    mesh,
    axis: str = "time",
    block_size: int = 1024,
    chunks: int = 8,
    store_alphas: bool | None = None,
    stat_xs: torch.Tensor | None = None,
    stat_fn=None,
    stat_init=None,
    emit_argmax: bool = False,
    time_minor: bool = False,
) -> StreamStats:
    """Likelihood-fused sharded streaming E-step: the per-process memory of
    the one-process fused tier on a tile of T/D steps.

    obs (C, ...) is this process's tile of raw observations, or with
    time_minor its (D_obs, C) feature-major tile; ell_fn maps rows (..., N,
    obs-dims) to expected log-likelihoods (..., N, K), computed a chunk at a
    time in every phase (:mod:`.stream_fused`), so no (C, K) array exists.
    Same three phases and exactness as :func:`time_sharded_long_chain_stats`;
    each tile runs :func:`~.stream_fused.forward_backward_fused_twophase`.
    ``emit_argmax`` also returns this tile's argmax-gamma decode in ``.z``
    ((C,) int32). stat_xs (this tile's operand of stat_fn, default the
    observations) must be None with time_minor."""
    f32_matmuls()
    tm = time_minor and obs.ndim >= 2
    if tm and stat_xs is not None and stat_xs is not obs:
        raise ValueError("time_minor supports stat_xs=None (obs) only")
    group = mesh.get_group(axis)
    C = obs.shape[-1] if tm else obs.shape[0]
    _check_tiles(C, group, "T", axis)
    idx = collectives.axis_index(group)
    rows0 = obs[:, :1].T if tm else obs[:1]
    lik_fn = _lik_factory(ell_fn, ell_fn(rows0).dtype)
    lik0, _ = lik_fn(rows0)
    K, dtype, dev = lik0.shape[-1], lik0.dtype, obs.device
    A = torch.exp(log_A).to(dtype)

    Qb = None
    if C > 1:
        S = 1 << (min(block_size, C - 1).bit_length() - 1)
        pad = _pad_count(C - 1, S)
        nb = (C - 1 + pad) // S
        val = (torch.arange(C - 1 + pad, device=dev) < C - 1).reshape(nb, S)
        Qb = _block_products_fused(A, _transition_rows(obs, tm, nb, S, pad), val, nb, S, lik_fn,
                                   time_minor=tm)
    Qg = collectives.all_gather(_tile_operator(A, lik0[0], Qb, idx), group)
    del Qb
    a_last, b_last = _boundary_recursions(
        Qg, torch.exp(log_pi).to(dtype), torch.ones(K, dtype=dtype, device=dev))

    a_in = a_last[max(idx - 1, 0)]
    log_pi_loc = _seed_log_pi(log_pi, a_in, A, idx)
    r = forward_backward_fused_twophase(
        log_pi_loc, log_A, obs, ell_fn, block_size=block_size, chunks=chunks,
        store_alphas=store_alphas, stat_xs=None if stat_xs is obs else stat_xs,
        stat_fn=stat_fn, stat_init=_stat_init_for(stat_init, idx), beta_end=b_last[idx],
        emit_argmax=emit_argmax, time_minor=tm)
    log_z, init, trans, acc = _reduce_tile(A, a_in, log_pi_loc, lik0[0], r, idx, group,
                                                stat_fn is not None)
    return StreamStats(log_z=log_z, init_stats=init, trans_stats=trans, acc=acc, z=r.z)


def time_sharded_forward_backward_batched(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_lik: torch.Tensor,
    mesh,
    batch_axis: str = "data",
    time_axis: str = "time",
    weights: torch.Tensor | None = None,
) -> FBResult:
    """Exact batched forward-backward on a 2-D (batch, time) mesh: chains
    data-parallel, each chain's time axis sharded. log_lik (B_loc, C, K) and
    weights (B_loc, C) are this process's block.

    ``messages.e_step_batched``'s contract on the block: gamma (B_loc, C, K)
    and log_c (B_loc, C) this block's; log_z (B_loc,) and init_stats
    (B_loc, K) this process's chains; trans_stats (K, K) summed over ALL
    chains, replicated. B must be a multiple of the batch axis' size and T
    of the time axis', or ``ValueError``."""
    f32_matmuls()
    bgroup, tgroup = mesh.get_group(batch_axis), mesh.get_group(time_axis)
    B_loc, C, _ = log_lik.shape
    _check_tiles(B_loc, bgroup, "B", batch_axis)
    _check_tiles(C, tgroup, "T", time_axis)
    idx = collectives.axis_index(tgroup)
    w = torch.ones_like(log_lik[..., 0]) if weights is None else weights.to(log_lik.dtype)
    gamma, log_c, trans, init, log_z = _chain_tile_fb(
        log_pi, log_A, log_lik, w, idx, _left_mask(w, tgroup), tgroup)
    log_z, init, trans = collectives.psum((log_z, init, trans), tgroup)
    trans = collectives.psum(trans, bgroup)
    return FBResult(gamma=gamma, log_z=log_z, trans_stats=trans, init_stats=init, log_c=log_c)
