"""Time-tiled forward-backward for very long single chains (port of
``pysvihmm_tpu/messages/blocked.py``).

The chain is cut into blocks of S steps. :func:`forward_backward_blocked`
combines each block's K x K matrices by the associative scan of
:mod:`.assoc_fb` and carries the boundary messages across blocks in a
Python loop (JAX's ``lax.scan``). Transitions are padded to whole blocks
with identity matrices, exactly neutral for products and normalisers, so
any T works.

The streaming tiers reduce instead of emitting gamma, for one chain of
millions of steps:

* :func:`forward_backward_blocked_stream` (``impl="assoc"`` of
  ``engines.base.long_chain_local_stats``): the same block scans, the
  matrices built inside each block from its likelihood rows;
* :func:`forward_backward_blocked_twophase` (``impl="twophase"``): (1)
  per-block transfer products, tree-reduced in chunks; (2) boundary
  recursions over blocks (:func:`boundary_seeds`); (3) seeded vector sweeps
  inside every block at once, each step one (n_blocks, K) @ (K, K) product.

JAX runs phase 1's products at ``lax.Precision.DEFAULT`` (one bf16 pass on
the TPU); the port runs every product in float32 (TF32 off, set by
``utils.precision.f32_matmuls``).

``stat_fn(gamma, rows) -> stats`` (a tensor or a tuple of tensors) is summed
over every time step, gamma zeroed outside the chain: the emission
statistics. Per-step kept-masks are not taken: these tiers are for exact
full-chain E-steps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.precision import f32_matmuls
from .assoc_fb import _associative_scan, _combine, forward_backward_assoc
from .scan_fb import FBResult, _normalize_loglik

# phase 2's boundary recursions on the card replay CUDA graphs of this many
# steps (the rest of the blocks run eagerly)
GRAPH_STEPS = 1024


class StreamStats(NamedTuple):
    """Reduced outputs of the streaming long-chain tiers."""

    log_z: torch.Tensor  # ()
    init_stats: torch.Tensor  # (K,) = gamma_0
    trans_stats: torch.Tensor  # (K, K) summed pairwise marginals
    acc: object  # stat_fn's summed statistics (None without stat_fn)
    z: torch.Tensor | None = None  # (T,) int32 argmax-gamma decode when asked
    #   for (stream_fused.py, emit_argmax); None otherwise


def _pad_count(n_trans: int, S: int) -> int:
    return (S - n_trans % S) % S


def tree_add(a, b):
    """a + b leaf by leaf over a tensor or a (named) tuple of tensors."""
    if isinstance(a, torch.Tensor):
        return a + b
    parts = [tree_add(x, y) for x, y in zip(a, b)]
    return type(a)(*parts) if hasattr(a, "_fields") else type(a)(parts)


def accumulate(acc, stats, stat_init=None):
    """acc + stats; the first call (acc None) starts from ``stat_init``
    (zeros, or None) cast to the dtypes stat_fn produces, as JAX's
    accumulator is promoted to ``stat_fn``'s output dtype."""
    if acc is not None:
        return tree_add(acc, stats)
    if stat_init is None:
        return stats
    return _tree_map2(lambda z, s: torch.as_tensor(z, dtype=s.dtype, device=s.device) + s,
                      stat_init, stats)


def _tree_map2(fn, a, b):
    if isinstance(b, torch.Tensor):
        return fn(a, b)
    parts = [_tree_map2(fn, x, y) for x, y in zip(a, b)]
    return type(b)(*parts) if hasattr(b, "_fields") else type(b)(parts)


def forward_backward_blocked(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_lik: torch.Tensor,
    weights: torch.Tensor | None = None,
    block_size: int = 256,
) -> FBResult:
    """:func:`scan_fb.forward_backward`'s contract over log_lik (B, T, K),
    O(T / S) sequential depth; every sequence is scanned at once."""
    B, T, K = log_lik.shape
    if T == 1:  # no transitions: the posterior is one categorical
        return forward_backward_assoc(log_pi, log_A, log_lik, weights)
    dtype, dev = log_lik.dtype, log_lik.device
    S = min(block_size, T - 1)
    A = torch.exp(log_A)
    lik, shifts = _normalize_loglik(log_lik)

    n_trans = T - 1
    pad = _pad_count(n_trans, S)
    n_blocks = (n_trans + pad) // S

    # per-transition matrices M_t (t = 1..T-1), padded with identity,
    # (n_blocks, S, B, K, K)
    eye = torch.eye(K, dtype=dtype, device=dev)
    lik_tr = torch.cat((lik[:, 1:], torch.ones((B, pad, K), dtype=dtype, device=dev)), dim=1)
    valid = torch.arange(n_trans + pad, device=dev) < n_trans
    M_all = torch.where(valid[None, :, None, None], A * lik_tr[..., None, :], eye)
    M_all = M_all.reshape(B, n_blocks, S, K, K).permute(1, 2, 0, 3, 4)

    a0 = torch.exp(log_pi) * lik[:, 0]
    c0 = a0.sum(dim=-1)
    alpha0 = a0 / c0[:, None]

    def normalised(M_blk):
        m0 = M_blk.amax(dim=(-2, -1), keepdim=True)
        return M_blk / m0, torch.log(m0[..., 0, 0])

    a, alphas_blk, logc_blk = alpha0, [], []
    for j in range(n_blocks):
        P, sP = _associative_scan(_combine, normalised(M_all[j]))
        au = torch.einsum("bk,tbkj->tbj", a, P)  # (S, B, K)
        sums = au.sum(dim=-1)
        alphas = au / sums[..., None]
        cums = torch.log(sums) + sP
        logc_blk.append(torch.diff(cums, dim=0, prepend=torch.zeros_like(cums[:1])))
        alphas_blk.append(alphas)
        a = alphas[-1]
    alpha = torch.cat((alpha0[:, None],
                       torch.cat(alphas_blk, dim=0).transpose(0, 1)[:, :n_trans]), dim=1)
    log_c = torch.cat((torch.log(c0)[:, None], torch.cat(logc_blk, dim=0).T[:, :n_trans]),
                      dim=1) + shifts
    log_z = log_c.sum(dim=-1)

    b, betas_blk = torch.ones((B, K), dtype=dtype, device=dev), [None] * n_blocks
    for j in reversed(range(n_blocks)):
        M_n, s0 = normalised(M_all[j])
        # the reversed-order scan of transposes: S'_i = (M_i ... M_last)^T
        Sp, _ = _associative_scan(_combine, (M_n.transpose(-1, -2), s0), reverse=True)
        bu = torch.einsum("tbkj,bk->tbj", Sp, b)  # beta_{i-1} rows within the block
        betas_blk[j] = bu / bu.sum(dim=-1, keepdim=True)
        b = betas_blk[j][0]
    # betas_blk[j][i] is beta at position j S + i; beta_{T-1} = 1 closes it
    beta = torch.cat((torch.cat(betas_blk, dim=0).transpose(0, 1)[:, :n_trans],
                      torch.ones((B, 1, K), dtype=dtype, device=dev)), dim=1)

    g = alpha * beta
    gamma = g / g.sum(dim=-1, keepdim=True)
    w = torch.ones((B, T), dtype=dtype, device=dev) if weights is None else weights.to(dtype)
    bl = lik[:, 1:] * beta[:, 1:]
    n = ((alpha[:, :-1] @ A) * bl).sum(dim=-1)
    w_pair = w[:, :-1] * w[:, 1:]
    alpha_w = alpha[:, :-1] * (w_pair / n)[..., None]
    trans_stats = A * torch.einsum("btk,btj->kj", alpha_w, bl)
    return FBResult(
        gamma=gamma,
        log_z=log_z,
        trans_stats=trans_stats,
        init_stats=w[:, :1] * gamma[:, 0],
        log_c=log_c,
    )


def leaf_products(A_tilde: torch.Tensor, lik_blk: torch.Tensor,
                  val_blk: torch.Tensor | None, S: int) -> torch.Tensor:
    """The transfer products Q_b = M_{bS+1} ... M_{(b+1)S} of a chunk of
    blocks, lik_blk (CB, S, K) and val_blk (CB, S) bool, or None where no
    transition of the chunk is padding -> (CB, K, K) (row convention:
    alpha @ Q_b advances a whole block).

    The leaf level multiplies the factored matrices A~ * lik[None, :] in
    pairs, each pair one K^3 product, with the identity where a transition
    is padding (padding only trails the last real transition, so a pair is
    (M, M), (M, I) or (I, I)); each level renormalises by its max, floored
    at ``tiny``: a likelihood row that is hard zero (-inf log-likelihood)
    can drive a product to all zeros, and 0 / 0 would turn a clean -inf
    log Z into NaN, where 0 / tiny propagates the zeros. Dropped scales
    cancel in the normalised boundary messages, the only consumer."""
    CB, _, K = lik_blk.shape
    eye = torch.eye(K, dtype=A_tilde.dtype, device=A_tilde.device)
    tiny = torch.finfo(A_tilde.dtype).tiny

    def factor(lik, val):  # (N, K), (N,) or None -> (N, K, K)
        M = A_tilde * lik[:, None, :]
        return M if val is None else torch.where(val[:, None, None], M, eye)

    if S == 1:
        return factor(lik_blk[:, 0], None if val_blk is None else val_blk[:, 0])

    def mm(x, y):
        r = torch.matmul(x, y)
        return r / torch.clamp_min(r.amax(dim=(1, 2), keepdim=True), tiny)

    l2 = lik_blk.reshape(CB * S // 2, 2, K)
    v2 = [None, None] if val_blk is None else val_blk.reshape(CB * S // 2, 2).unbind(1)
    Q = mm(factor(l2[:, 0], v2[0]), factor(l2[:, 1], v2[1]))
    m = CB * S // 2
    while m > CB:
        Q = mm(Q[0::2], Q[1::2])
        m //= 2
    return Q


def _block_products(A_tilde, lik_tr, valid, n_blocks: int, S: int, chunk_blocks: int = 64):
    """Per-block transfer products Q (n_blocks, K, K) from the padded
    likelihood rows lik_tr (n_blocks, S, K) and valid (n_blocks, S), chunk
    by chunk of ``chunk_blocks`` blocks (:func:`leaf_products`), so no
    (T, K, K) array exists. S is a power of two: the tree pairs a flat stack
    of factors, which stays inside block boundaries only while every level's
    count a block is even. JAX shrinks the chunk to a divisor of n_blocks;
    the port lets the last chunk be short (a block's product does not depend
    on its chunk)."""
    K = A_tilde.shape[0]
    Q = torch.empty((n_blocks, K, K), dtype=lik_tr.dtype, device=lik_tr.device)
    for c0 in range(0, n_blocks, chunk_blocks):
        c1 = min(c0 + chunk_blocks, n_blocks)
        # padding trails the last transition: only the last chunk holds any
        val = valid[c0:c1] if c1 == n_blocks else None
        Q[c0:c1] = leaf_products(A_tilde, lik_tr[c0:c1], val, S)
    return Q


def _seed_walk(Q: torch.Tensor, seed: torch.Tensor, forward: bool) -> torch.Tensor:
    """One boundary recursion, eagerly: the message at every block's start
    (forward, x <- norm(x @ Q_b)) or end (backward, x <- norm(Q_b @ x)),
    (n_blocks, K)."""
    n = Q.shape[0]
    out, x = [None] * n, seed
    for j in (range(n) if forward else reversed(range(n))):
        out[j] = x
        y = x @ Q[j] if forward else Q[j] @ x
        x = y / y.sum()
    return torch.stack(out) if n else seed[:0].reshape(0, seed.shape[0])


def _seed_walk_graphed(Q: torch.Tensor, seed: torch.Tensor, forward: bool,
                       steps: int = GRAPH_STEPS) -> torch.Tensor:
    """:func:`_seed_walk` on the card, ``steps`` blocks a CUDA-graph replay
    and the remainder eagerly: the same products and divisions in the same
    order, so the same bits as the eager loop, at a fraction of its launch
    cost. The graph reads its blocks from a static buffer that each replay
    refills, and walks a static (steps + 1, K) sequence whose row 0 is the
    carried message."""
    n, K = Q.shape[0], Q.shape[1]
    groups = n // steps
    if groups == 0:
        return _seed_walk(Q, seed, forward)
    q = torch.empty((steps, K, K), dtype=Q.dtype, device=Q.device)
    seq = torch.empty((steps + 1, K), dtype=Q.dtype, device=Q.device)

    def body():
        for i in range(steps):
            y = seq[i] @ q[i] if forward else q[i] @ seq[i]
            torch.div(y, y.sum(), out=seq[i + 1])

    # blocks in walking order: forward from block 0, backward from the last
    def load(g):
        j0 = g * steps if forward else n - (g + 1) * steps
        blk = Q[j0:j0 + steps]
        q.copy_(blk if forward else blk.flip(0))
        return j0

    seq[0] = seed
    load(0)
    side = torch.cuda.Stream(device=Q.device)
    side.wait_stream(torch.cuda.current_stream(Q.device))
    with torch.cuda.stream(side):
        body()  # warm-up before capture
    torch.cuda.current_stream(Q.device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()

    out = torch.empty((n, K), dtype=Q.dtype, device=Q.device)
    seq[0] = seed
    for g in range(groups):
        j0 = load(g)
        graph.replay()
        out[j0:j0 + steps] = seq[:steps] if forward else seq[:steps].flip(0)
        seq[0] = seq[steps]
    x = seq[0].clone()
    del graph
    if forward:
        out[groups * steps:] = _seed_walk(Q[groups * steps:], x, True)
    else:
        out[:n - groups * steps] = _seed_walk(Q[:n - groups * steps], x, False)
    return out


def boundary_seeds(
    Q: torch.Tensor, alpha0: torch.Tensor, beta_end: torch.Tensor | None = None,
    graphs: bool | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Phase 2 of the two-phase tiers: the two recursions over the blocks'
    transfer products Q (n_blocks, K, K). Returns (the filtered alpha at
    every block's start, the normalised beta at every block's end), each
    (n_blocks, K); beta_end seeds the last block (default uniform; a scalar
    rescale of it is immaterial).

    Each step is a K-vector times a K x K matrix and a normalisation,
    n_blocks of them a direction. graphs (default: on a CUDA device) runs
    them as CUDA-graph replays of ``GRAPH_STEPS`` steps (the port's
    counterpart of JAX compiling the scan), which give the eager loop's
    bits."""
    K = Q.shape[-1]
    b_seed = (torch.full((K,), 1.0 / K, dtype=Q.dtype, device=Q.device) if beta_end is None
              else beta_end / beta_end.sum())
    if graphs is None:
        graphs = Q.is_cuda
    walk = _seed_walk_graphed if graphs else _seed_walk
    return walk(Q, alpha0, True), walk(Q, b_seed, False)


def _stat_rows(stat_xs: torch.Tensor, n_blocks: int, S: int) -> torch.Tensor:
    """stat_xs rows for times b S + s + 1, zero-padded to n_blocks S rows and
    laid out (S, n_blocks, ...)."""
    target = n_blocks * S
    xs_p = stat_xs[1:target + 1]
    if xs_p.shape[0] < target:
        pad_rows = torch.zeros((target - xs_p.shape[0],) + stat_xs.shape[1:],
                               dtype=stat_xs.dtype, device=stat_xs.device)
        xs_p = torch.cat((xs_p, pad_rows), dim=0)
    return xs_p.reshape((n_blocks, S) + stat_xs.shape[1:]).transpose(0, 1)


def _single_step(log_pi, lik, shifts, stat_xs, stat_fn, stat_init, beta_end=None) -> StreamStats:
    """T == 1: no transitions, the posterior one categorical."""
    K = lik.shape[-1]
    v0 = torch.exp(log_pi).to(lik.dtype) * lik[0]
    g = v0 if beta_end is None else v0 * beta_end
    gamma0 = g / g.sum()
    acc = None
    if stat_fn is not None:
        acc = stat_fn(gamma0[None], stat_xs[:1])
        if stat_init is not None:
            acc = _tree_map2(lambda z, s: s + torch.as_tensor(z, dtype=s.dtype, device=s.device),
                             stat_init, acc)
    return StreamStats(
        log_z=torch.log(v0.sum()) + shifts.sum(),
        init_stats=gamma0,
        trans_stats=torch.zeros((K, K), dtype=lik.dtype, device=lik.device),
        acc=acc,
    )


@torch.no_grad()
def forward_backward_blocked_twophase(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_lik: torch.Tensor,
    block_size: int = 256,
    stat_xs: torch.Tensor | None = None,
    stat_fn=None,
    stat_init=None,
    beta_end: torch.Tensor | None = None,
) -> StreamStats:
    """Two-phase streaming forward-backward for ONE long chain, log_lik
    (T, K): returns the reduced :class:`StreamStats` (log Z, gamma_0, summed
    pairwise marginals, stat_fn's sums), never gamma.

    1. per-block transfer products Q_b, tree-reduced (products only, in
       chunks; :func:`_block_products`);
    2. the boundary recursions over blocks (:func:`boundary_seeds`): the
       exact filtered alpha at every block start, the beta seed at every
       block end;
    3. seeded sweeps inside all blocks at once: each in-block step is one
       (n_blocks, K) @ (K, K) product, so the sequential depth is S, not T.
       Per-step normalisers seeded by the true filtered alpha give the
       global log Z, and the backward sweep sums gamma's statistics and the
       pairwise marginals.

    S is block_size rounded down to a power of two. beta_end: optional (K,)
    backward seed at the last time (default uniform), for a caller that runs
    this per tile with its right neighbour's message."""
    f32_matmuls()
    T, K = log_lik.shape
    dtype, dev = log_lik.dtype, log_lik.device
    lik, shifts = _normalize_loglik(log_lik)
    if stat_fn is not None and stat_xs is None:
        raise ValueError("stat_fn requires stat_xs (the per-step operand)")
    if T == 1:
        return _single_step(log_pi, lik, shifts, stat_xs, stat_fn, stat_init, beta_end)

    S = 1 << (min(block_size, T - 1).bit_length() - 1)
    A = torch.exp(log_A).to(dtype)
    n_trans = T - 1
    pad = _pad_count(n_trans, S)
    n_blocks = (n_trans + pad) // S
    lik_tr = torch.cat((lik[1:], torch.ones((pad, K), dtype=dtype, device=dev)), dim=0)
    valid_b = torch.arange(n_trans + pad, device=dev) < n_trans

    # phase 1: block products
    Q = _block_products(A, lik_tr.reshape(n_blocks, S, K), valid_b.reshape(n_blocks, S),
                        n_blocks, S)

    # phase 2: boundary recursions over blocks
    a0 = torch.exp(log_pi).to(dtype) * lik[0]
    c0 = a0.sum()
    alpha0 = a0 / c0
    seeds_a, seeds_b = boundary_seeds(Q, alpha0, beta_end)

    # phase 3: in-block sweeps over all blocks at once, (S, n_blocks, ...)
    lik_s = lik_tr.reshape(n_blocks, S, K).transpose(0, 1)
    val_s = valid_b.reshape(n_blocks, S).T
    a, alphas, log_cs = seeds_a, [], []
    for s in range(S):
        au = (a @ A) * lik_s[s]
        c = au.sum(dim=-1)
        a = torch.where(val_s[s, :, None], au / c[:, None], a)
        alphas.append(a)  # alpha at time b S + s + 1
        log_cs.append(torch.where(val_s[s], torch.log(c), 0.0))
    log_z = torch.log(c0) + torch.stack(log_cs).sum() + shifts.sum()

    xs_s = _stat_rows(stat_xs, n_blocks, S) if stat_fn is not None else None
    b, acc_tr, acc = seeds_b, torch.zeros((K, K), dtype=dtype, device=dev), None
    for s in reversed(range(S)):
        keep = val_s[s, :, None]
        # alpha at time b S + s, the xi's left operand: the block's seed at s = 0
        a_prev = alphas[s - 1] if s else seeds_a
        if stat_fn is not None:
            g = alphas[s] * b
            gamma = g / g.sum(dim=-1, keepdim=True) * keep
            acc = accumulate(acc, stat_fn(gamma, xs_s[s]), stat_init)
        bl = lik_s[s] * b
        n = ((a_prev @ A) * bl).sum(dim=-1)
        aw = a_prev * (val_s[s] / n)[:, None]
        acc_tr = acc_tr + A * (aw.T @ bl)
        b_new = bl @ A.T
        b = torch.where(keep, b_new / b_new.sum(dim=-1, keepdim=True), b)
    # b[0] is now beta at time 0
    g0 = alpha0 * b[0]
    init_stats = g0 / g0.sum()
    if stat_fn is not None:
        acc = tree_add(acc, stat_fn(init_stats[None], stat_xs[:1]))
    return StreamStats(log_z=log_z, init_stats=init_stats, trans_stats=acc_tr, acc=acc)


@torch.no_grad()
def forward_backward_blocked_stream(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_lik: torch.Tensor,
    block_size: int = 256,
    stat_xs: torch.Tensor | None = None,
    stat_fn=None,
    stat_init=None,
) -> StreamStats:
    """Streaming blocked forward-backward for ONE long chain, log_lik (T, K):
    :func:`forward_backward_blocked`'s math, reduced to
    :class:`StreamStats`. Each block's K x K matrices are built inside the
    block from its likelihood rows and combined by the associative scan; the
    backward sweep sums gamma's statistics a block at a time. Memory O(T K +
    S K^2).

    The per-block log-normaliser sums are kept as one stacked tensor and
    reduced by one ``torch.sum``, never carried as a running sum across the
    loop: a float32 log Z carried over tens of thousands of blocks would
    random-walk."""
    f32_matmuls()
    T, K = log_lik.shape
    dtype, dev = log_lik.dtype, log_lik.device
    lik, shifts = _normalize_loglik(log_lik)
    if stat_fn is not None and stat_xs is None:
        raise ValueError("stat_fn requires stat_xs (the per-step operand)")
    if T == 1:
        return _single_step(log_pi, lik, shifts, stat_xs, stat_fn, stat_init)

    S = min(block_size, T - 1)
    A = torch.exp(log_A)
    eye = torch.eye(K, dtype=dtype, device=dev)
    n_trans = T - 1
    pad = _pad_count(n_trans, S)
    n_blocks = (n_trans + pad) // S
    lik_tr = torch.cat((lik[1:], torch.ones((pad, K), dtype=dtype, device=dev)),
                       dim=0).reshape(n_blocks, S, K)
    valid = (torch.arange(n_trans + pad, device=dev) < n_trans).reshape(n_blocks, S)

    def normalised_M(j):
        M = torch.where(valid[j, :, None, None], A * lik_tr[j, :, None, :], eye)
        m0 = M.amax(dim=(-2, -1), keepdim=True)
        return M / m0, torch.log(m0[..., 0, 0])

    a0 = torch.exp(log_pi) * lik[0]
    c0 = a0.sum()
    alpha0 = a0 / c0

    a, alphas_blk, logc_sums = alpha0, [], []
    for j in range(n_blocks):
        P, sP = _associative_scan(_combine, normalised_M(j))
        au = a @ P  # (S, K)
        sums = au.sum(dim=-1)
        alphas_blk.append(au / sums[:, None])
        # the block's log c sum is its last cumulative value (padding adds 0)
        logc_sums.append(torch.log(sums[-1]) + sP[-1])
        a = alphas_blk[-1][-1]
    log_z = torch.log(c0) + torch.stack(logc_sums).sum() + shifts.sum()

    if stat_fn is not None:
        target = n_blocks * S  # rows aligned with times j S + i
        xs_p = stat_xs[:target]
        if xs_p.shape[0] < target:
            pad_rows = torch.zeros((target - xs_p.shape[0],) + stat_xs.shape[1:],
                                   dtype=stat_xs.dtype, device=dev)
            xs_p = torch.cat((stat_xs, pad_rows), dim=0)
        xs_blocks = xs_p.reshape((n_blocks, S) + stat_xs.shape[1:])

    b, acc_tr, acc = torch.ones((K,), dtype=dtype, device=dev), \
        torch.zeros((K, K), dtype=dtype, device=dev), None
    for j in reversed(range(n_blocks)):
        M_n, s0 = normalised_M(j)
        Sp, _ = _associative_scan(_combine, (M_n.transpose(-1, -2), s0), reverse=True)
        bu = b @ Sp  # beta at times j S + i, (S, K)
        betas = bu / bu.sum(dim=-1, keepdim=True)
        # alpha at times j S + i: block j's row 0 is block j-1's last alpha
        a_first = alpha0 if j == 0 else alphas_blk[j - 1][-1]
        a_rows = torch.cat((a_first[None], alphas_blk[j][:S - 1]), dim=0)
        wv = valid[j].to(dtype)
        if stat_fn is not None:
            g = a_rows * betas
            gamma = g / g.sum(dim=-1, keepdim=True) * wv[:, None]
            acc = accumulate(acc, stat_fn(gamma, xs_blocks[j]), stat_init)
        # pairwise marginals of transitions t = 1 + j S + i: beta_t is this
        # block's betas shifted by one, closed by the carried b
        bl = lik_tr[j] * torch.cat((betas[1:], b[None]), dim=0)
        n = ((a_rows @ A) * bl).sum(dim=-1)
        alpha_w = a_rows * (wv / n)[:, None]
        acc_tr = acc_tr + A * (alpha_w.T @ bl)
        b = betas[0]

    g0 = alpha0 * b
    init_stats = g0 / g0.sum()
    if stat_fn is not None:
        # time T-1 (beta = 1) is in no block's gamma rows
        last = n_trans - 1
        gamma_last = alphas_blk[last // S][last % S]
        acc = tree_add(acc, stat_fn(gamma_last[None], stat_xs[T - 1:]))
    return StreamStats(log_z=log_z, init_stats=init_stats, trans_stats=acc_tr, acc=acc)
