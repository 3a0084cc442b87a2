"""Exact forward-backward with the STATE axis sharded over a mesh of
processes (port of ``pysvihmm_tpu/messages/state_sharded.py``): the
tensor-parallelism analog for very large K.

Process d owns a K/D block of every state-indexed array: log_pi's block,
the ROW block of log A~ (K/D, K) and the (T, K/D) block of the
log-likelihoods (what ``parallel.shard_params_by_state`` leaves it). The
backward's per-step operand is the COLUMN block of A~, which one all-gather
of the row blocks provides per call.

Per forward step   a_t ∝ (a_{t-1} @ A~) ⊙ lik_t:
    partial = a_d @ A~[block_d, :]   (a (K/D) x (K/D, K) product)
    a_t,d = psum_scatter(partial) ⊙ lik_t,d  -- one reduce-scatter a step.
Per backward step  b_t ∝ A~ @ (lik_{t+1} ⊙ b_{t+1}): the same with A~^T's
row block, one reduce-scatter a step. The normalisers are psum'd scalars.
The summed pairwise statistics come from the usual factored product after
the sweeps (one all-gather of the (T-1, K/D) right-hand factor, then a
local (K/D, T-1) @ (T-1, K) product: this process's ROW block of
trans_stats).

A capability tier, not a speed tier: the 2T collectives a pass cost more
than the work at any K one card holds. It keeps the parallelism story
exact on the state axis.
"""

from __future__ import annotations

import torch

from ..parallel import collectives
from ..utils.precision import f32_matmuls
from .scan_fb import FBResult, forward_backward


def state_sharded_forward_backward(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    log_lik: torch.Tensor,
    mesh,
    axis: str = "state",
    weights: torch.Tensor | None = None,
) -> FBResult:
    """Exact forward-backward of one chain with K sharded over ``mesh[axis]``:
    log_pi (K/D,), log_A (K/D, K) and log_lik (T, K/D) are this process's
    state block, weights (T,) the replicated kept-mask.

    Outputs are sharded as in JAX: gamma (T, K/D) and init_stats (K/D,) by
    state block, trans_stats this process's (K/D, K) row block, log_z () and
    log_c (T,) replicated. The axis size must divide K, or ``ValueError``.
    On an axis of one process it is :func:`scan_fb.forward_backward`."""
    f32_matmuls()
    group = mesh.get_group(axis)
    D = collectives.axis_size(group)
    T, Kd = log_lik.shape
    K = log_A.shape[-1]
    if K % D != 0 or Kd * D != K or log_A.shape[0] != Kd:
        raise ValueError(f"K={K} must be divisible by state-axis size {D} "
                         f"(blocks of {Kd} states, log_A rows {log_A.shape[0]})")
    if D == 1:
        fb = forward_backward(log_pi, log_A, log_lik[None],
                              None if weights is None else weights[None])
        return FBResult(gamma=fb.gamma[0], log_z=fb.log_z[0], trans_stats=fb.trans_stats,
                        init_stats=fb.init_stats[0], log_c=fb.log_c[0])

    r = collectives.axis_index(group)
    w = torch.ones_like(log_lik[:, 0]) if weights is None else weights.to(log_lik.dtype)
    shifts = collectives.pmax(log_lik.amax(dim=-1), group)  # (T,)
    lik = torch.exp(log_lik - shifts[:, None])  # (T, Kd)
    A_rows = torch.exp(log_A)  # (Kd, K): rows of A~ owned here
    A_cols = torch.exp(collectives.all_gather(log_A, group, tiled=True)[:, r * Kd:(r + 1) * Kd])
    At_rows = A_cols.T.contiguous()  # (Kd, K): rows of A~^T (= A~'s columns)

    # forward: one reduce-scatter and one normaliser psum a step
    a = torch.exp(log_pi) * lik[0]
    c = collectives.psum(a.sum(), group)
    a = a / c
    alphas, log_cs = [a], [torch.log(c)]
    for t in range(1, T):
        a = collectives.psum_scatter(a @ A_rows, group) * lik[t]
        c = collectives.psum(a.sum(), group)
        a = a / c
        alphas.append(a)
        log_cs.append(torch.log(c))
    alpha = torch.stack(alphas)  # (T, Kd)
    log_c = torch.stack(log_cs) + shifts

    # backward: the same rhythm over A~^T's rows
    b = torch.ones_like(lik[0])
    betas = [b]
    for t in range(T - 1, 0, -1):
        b = collectives.psum_scatter((lik[t] * b) @ At_rows, group)
        b = b / collectives.psum(b.sum(), group)
        betas.append(b)
    beta = torch.stack(betas[::-1])  # (T, Kd)

    g = alpha * beta
    gamma = g / collectives.psum(g.sum(dim=-1, keepdim=True), group)
    bl_full = collectives.all_gather(lik[1:] * beta[1:], group, axis=1, tiled=True)  # (T-1, K)
    # the xi normalisers n_t = (alpha_t @ A~) . bl_t, each process its rows' share
    n = collectives.psum(((alpha[:-1] @ A_rows) * bl_full).sum(dim=-1), group)
    alpha_w = alpha[:-1] * (w[:-1] * w[1:] / n)[:, None]
    trans_rows = A_rows * (alpha_w.T @ bl_full)  # (Kd, K)
    return FBResult(gamma=gamma, log_z=log_c.sum(), trans_stats=trans_rows,
                    init_stats=w[0] * gamma[0], log_c=log_c)
