"""The duplex E-step: the forward and the backward chain side by side in one
kernel, then every posterior quantity and statistic chain-free in a second
(port of ``pysvihmm_tpu/messages/pallas_duplex.py::pallas_estep_duplex``).

Kernels (``csrc/duplex_fb.cu``; the source notes what bounds them):

* ``duplex_chain_kernel`` replaces ``_duplex_kernel`` (pallas_duplex.py:82):
  per sequence, the fused forward's recursion (raw alpha, its per-step sums
  s, the max shifts sh) and, independently, the raw backward messages

      b_{T-1} = 1,   b_{t-1} = (A~ (lik_t * b_t)) / sum_k b_t

  (normalisation deferred, pallas_duplex.py:146-167; the scale applied
  after the product, as the forward applies 1 / s_{t-1}), with
  lik_t = exp(ll_t - max_k ll_t) and ll_t = f_t @ W in-kernel. A block
  carries S sequences (the fused forward's layout, one block a direction;
  up to K = 64 ``duplex_chain_kernel``, S = 2 or 4, above
  ``duplex_chain_wide_kernel``, S = 1, 2, 4 or 8): :func:`default_seqs`
  picks S from the card's occupancy so that the 2 ceil(B / S) blocks run
  in one wave where they can. Every output is the same bits at every S.
* ``duplex_combine_kernel`` replaces ``_combine_kernel``
  (pallas_duplex.py:175): with no chain at all, gamma_t = a_t b_t / sum,
  the pairwise accumulator sum_t outer(a_{t-1}, d_t pg_t / sum(a_{t-1}
  b_{t-1})) with d_t = lik_t b_t / sum_k b_t (the scale-cancelling identity
  of pallas_duplex.py:19-29) and the emission accumulator
  sum_t outer(w_t gamma_t, f_t). A block takes a tile of 8 sequences by a
  chunk of time steps, a warp a sequence's rows; up to K = 64 the tile's
  rows are added into acc and eacc as register-blocked outer products.
  Gated by an SVI kept-mask w (T, B) when ``weights`` is given; the pair
  gate pg_t = w_{t-1} w_t (pg_0 = 0) is formed in the kernel from w, and
  the gates touch the statistics only.

Each kernel has a launcher (:func:`duplex_chain`, :func:`duplex_combine`)
with a launch counter and a plain PyTorch twin
(:func:`duplex_chain_reference`, :func:`duplex_combine_reference`) that
follows the duplex recursions and identities step by step, independently of
the fused twins. A launcher given CPU tensors runs the twin; given CUDA
tensors it launches the kernel or raises. :func:`estep_duplex` composes the
launchers and :func:`estep_duplex_reference` the twins, with the contract of
``fused_fb.estep_fused``.

Both kernels take ``in_kernel_feats`` "niw" or "nig" as the fused pair does
(pallas_duplex.py:290, :349, :444): ``feats`` is then a Gaussian family's
raw observations (T, B, D), the features built on the chip with
``ell_features``' bits, so every output is the array mode's bit for bit.
The duplex stores alpha in float32 always, as JAX's does, and has no time
pick: ``gamma_sel`` raises ``ValueError``, as JAX's ``_pallas_fused_estep``
does on the duplex route.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._launch import (
    bind,
    check,
    device_index,
    instance_tier,
    ptr,
    raise_on,
    runs_plain_twin,
    scratch,
    stream,
)
from .fused_fb import (
    FMAX,
    assemble,
    build_features,
    built_seqs,
    check_modes,
    count_mode,
    kind_code,
    seqs_per_block,
)
from .scan_fb import FBResult
from .split_fb import SUM_FLOOR, exp_params

_LIB = "duplex_fb"


def _library():
    """Build (at first use) and bind the kernels' C interface."""
    from .._build import load_library

    return bind(
        load_library(_LIB),
        {"duplex_fb_chain": "pppppppp" "iiiiiii" "p",
         "duplex_fb_combine": "pppppppppp" "iiiiii" "p",
         "duplex_fb_scratch": "iiiiip",
         "duplex_fb_kernel_info": "iiiiiip",
         "duplex_fb_kmax": "",
         "duplex_fb_fmax": ""},
        "duplex_fb_error_string",
    )


def _check_kernel_limits(K: int, F: int) -> None:
    """Raise on a K or F the CUDA kernels do not take, instead of falling back."""
    lib = _library()
    kmax, fmax = lib.duplex_fb_kmax(), lib.duplex_fb_fmax()
    if K > kmax or F > fmax:
        raise NotImplementedError(
            f"the duplex CUDA kernels take K <= {kmax} and F <= {fmax}, got K={K}, F={F}"
        )


_KERNELS = {"chain": 0, "combine": 1, "gated combine": 2}


def kernel_info(kernel: str, S: int, F: int, device: torch.device | None = None,
                K: int = 64, in_kernel_feats: str | None = None) -> dict:
    """What one instance takes on the card, from the library: ``kernel`` is
    "chain", "combine" or "gated combine", S the chain's sequences a block
    (one of :func:`built_seqs`; unused for the combine), F the feature width
    and K the states (up to 64 the instance built for F padded to 16, 32, 48
    or 64; above, the large-K instance of K's padded state count, 128 or
    256), for the feature kind ``in_kernel_feats``. Returns registers (a
    thread), static_smem and dynamic_smem (bytes a block), local_bytes
    (spills, a thread), blocks_per_sm (resident, by the CUDA occupancy
    calculator), sms (the card's) and threads (a block)."""
    dev = device if device is not None else torch.device("cuda")
    return dict(_kernel_info(kernel, S, F, instance_tier(K), device_index(dev),
                             kind_code(in_kernel_feats)))


@functools.cache
def _kernel_info(kernel: str, S: int, F: int, K: int, index: int, kind: int = 0) -> tuple:
    out = (ctypes.c_int * 7)()
    lib = _library()
    code = lib.duplex_fb_kernel_info(_KERNELS[kernel], S, K, F, kind, index,
                                     ctypes.addressof(out))
    raise_on(lib.duplex_fb_error_string, code,
             f"duplex_fb_kernel_info({kernel}, S={S}, K={K}, F={F}, kind={kind})")
    keys = ("registers", "static_smem", "dynamic_smem", "local_bytes", "blocks_per_sm", "sms",
            "threads")
    return tuple(zip(keys, list(out)))


def default_seqs(B: int, F: int, device: torch.device, K: int = 64,
                 in_kernel_feats: str | None = None) -> int:
    """The chain launcher's S: ``fused_fb.seqs_per_block`` over the chain's
    instances built for K (:func:`built_seqs`, the fused pair's S) on the
    card's own occupancy, with 2 blocks (a forward and a backward) a group
    of S: at B = 1024 S = 4 at K = 64 and 8 above (one wave at KP = 128,
    none fits one at KP = 256)."""
    return _default_seqs(B, F, instance_tier(K), device_index(device),
                         kind_code(in_kernel_feats))


@functools.cache
def _default_seqs(B: int, F: int, K: int, index: int, kind: int = 0) -> int:
    seqs = built_seqs(K)
    info = {S: dict(_kernel_info("chain", S, F, K, index, kind)) for S in seqs}
    return seqs_per_block(B, {S: i["blocks_per_sm"] * i["sms"] for S, i in info.items()}, 2,
                          seqs)


def _inv_sum(x: torch.Tensor) -> torch.Tensor:
    """1 / max(sum over the last axis, SUM_FLOOR), keeping that axis."""
    return 1.0 / torch.clamp_min(x.sum(dim=-1, keepdim=True), SUM_FLOOR)


# ------------------------------------------------------------------- chain


def duplex_chain_reference(
    pi_t: torch.Tensor, A_t: torch.Tensor, W: torch.Tensor, feats: torch.Tensor,
    in_kernel_feats: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the chain kernel.

    pi_t (K,), A_t (K, K) the exponentiated params; W (F, K); feats
    (T, B, F), or a built kind's raw observations (T, B, D). Returns (alpha (T, B, K) raw forward messages, s (B, T) their
    per-step sums, sh (B, T) the max shifts, beta (T, B, K) raw backward
    messages, b_{t-1} = (A~ (lik_t b_t)) / sum_k b_t). Step j advances the
    forward to t = j and the backward to t = T-1-j, as the TPU kernel
    interleaves them."""
    ll = build_features(feats, in_kernel_feats) @ W
    T = ll.shape[0]
    sh = ll.amax(dim=-1)  # (T, B)
    lik = torch.exp(ll - sh[..., None])
    alpha, beta = torch.empty_like(lik), torch.empty_like(lik)
    a = pi_t * lik[0]
    b = torch.ones_like(a)
    alpha[0], beta[T - 1] = a, b
    for j in range(1, T):
        a = (a @ A_t) * (lik[j] * _inv_sum(alpha[j - 1]))
        alpha[j] = a
        t = T - j  # the backward's step: lik_t b_t builds b_{t-1}
        b = ((lik[t] * b) @ A_t.T) * _inv_sum(b)
        beta[t - 1] = b
    return alpha, alpha.sum(dim=-1).T.contiguous(), sh.T.contiguous(), beta


def duplex_chain(
    pi_t: torch.Tensor, A_t: torch.Tensor, W: torch.Tensor, feats: torch.Tensor,
    in_kernel_feats: str | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chain kernel launcher; contract of :func:`duplex_chain_reference`.

    Inputs are float32 and contiguous on one device. CPU tensors run the
    plain twin; CUDA tensors launch ``duplex_chain_kernel`` or raise."""
    return _launch_chain(None, pi_t, A_t, W, feats, in_kernel_feats)


def _launch_chain(S: int | None, pi_t, A_t, W, feats, in_kernel_feats=None):
    """:func:`duplex_chain` with S sequences a block (one of
    :func:`built_seqs` at this K, else ``ValueError`` on every device before
    anything runs; None for :func:`default_seqs`): the card tests and
    chip_smoke.py's sweeps of S."""
    T, B, Fin = feats.shape
    K = A_t.shape[0]
    dev = feats.device
    F = check_modes(W, feats, in_kernel_feats, fmax=FMAX)
    for name, x, shape in (("pi_t", pi_t, (K,)), ("A_t", A_t, (K, K)),
                           ("W", W, (F, K)), ("feats", feats, (T, B, Fin))):
        check(name, x, shape, dev)
    if S is not None and S not in built_seqs(K):
        raise ValueError(f"no duplex chain instance with S={S} at K={K}: built {built_seqs(K)}")
    if runs_plain_twin(feats):
        return duplex_chain_reference(pi_t, A_t, W, feats, in_kernel_feats)
    _check_kernel_limits(K, F)
    lib = _library()
    index = device_index(dev)
    kind = kind_code(in_kernel_feats)
    if S is None:
        S = _default_seqs(B, F, instance_tier(K), index, kind)
    alpha = torch.empty((T, B, K), dtype=torch.float32, device=dev)
    beta = torch.empty((T, B, K), dtype=torch.float32, device=dev)
    s = torch.empty((B, T), dtype=torch.float32, device=dev)
    sh = torch.empty((B, T), dtype=torch.float32, device=dev)
    code = lib.duplex_fb_chain(
        ptr(pi_t), ptr(A_t), ptr(W), ptr(feats), ptr(alpha), ptr(s), ptr(sh), ptr(beta),
        T, B, K, F, S, kind, index, stream(dev),
    )
    duplex_chain.launches += 1
    count_mode(duplex_chain, in_kernel_feats)
    raise_on(lib.duplex_fb_error_string, code, "duplex_chain_kernel")
    return alpha, s, sh, beta


duplex_chain.launches = 0
duplex_chain.mode_launches = {}


# ----------------------------------------------------------------- combine


def duplex_combine_reference(
    W: torch.Tensor,
    feats: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    sh: torch.Tensor,
    emit_gamma: bool = False,
    weights: torch.Tensor | None = None,
    in_kernel_feats: str | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the combine kernel, over all t at once.

    Takes the chain's raw alpha and beta (T, B, K), its shifts sh (B, T) and
    an optional kept-mask weights (T, B). Returns (gamma (T, B, K), ungated,
    or None; gamma0 = w_0 gamma_0 (B, K); acc (K, K) = sum over sequences and
    t >= 1 of outer(a_{t-1}, d_t pg_t / sum(a_{t-1} b_{t-1})); eacc (K, F)
    = sum of outer(w_t gamma_t, f_t)), with w = pg = 1 when ungated; feats
    as the chain's."""
    feats = build_features(feats, in_kernel_feats)
    T, B, F = feats.shape
    K = alpha.shape[-1]
    lik = torch.exp(feats @ W - sh.T[..., None])
    g = alpha * beta
    ginv = _inv_sum(g)  # (T, B, 1)
    gamma = g * ginv
    d = (lik * beta) * _inv_sum(beta)
    dn = d[1:] * ginv[:-1]
    if weights is None:
        gamma_w = gamma
    else:
        gamma_w = gamma * weights[..., None]
        dn = dn * (weights[:-1] * weights[1:])[..., None]  # pg_t, t >= 1
    acc = alpha[:-1].reshape(-1, K).T @ dn.reshape(-1, K)
    eacc = gamma_w.reshape(T * B, K).T @ feats.reshape(T * B, F)
    return (gamma if emit_gamma else None), gamma_w[0].clone(), acc, eacc


def duplex_combine(
    W: torch.Tensor,
    feats: torch.Tensor,
    alpha: torch.Tensor,
    beta: torch.Tensor,
    sh: torch.Tensor,
    emit_gamma: bool = False,
    weights: torch.Tensor | None = None,
    in_kernel_feats: str | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Combine kernel launcher; contract of :func:`duplex_combine_reference`.

    CPU tensors run the plain twin; CUDA tensors launch
    ``duplex_combine_kernel`` (gated when ``weights`` is given) or raise.
    Each block takes 8 sequences by a chunk of time steps, the chunks cut
    so that a launch holds at most about 264 blocks (more only where
    ceil(B / 8) exceeds that); above K = 64 the instances at 128 or 256
    padded states run. acc and eacc are summed across blocks in
    an order fixed by the shapes (csrc/fb_stats.cuh), so repeated calls on
    one card give the same bits. Above K = 64 the launch takes a scratch of
    2 min(T B, max(B, 2^17)) K floats beside the sums' partials, whatever T:
    about 0.28 GB at B = 1024, K = 256, F = 45 (the statistics a window of
    time steps a launch)."""
    T, B, Fin = feats.shape
    K = alpha.shape[-1]
    dev = feats.device
    F = check_modes(W, feats, in_kernel_feats, fmax=FMAX)
    args = [("W", W, (F, K)), ("feats", feats, (T, B, Fin)), ("alpha", alpha, (T, B, K)),
            ("beta", beta, (T, B, K)), ("sh", sh, (B, T))]
    if weights is not None:
        args.append(("weights", weights, (T, B)))
    for name, x, shape in args:
        check(name, x, shape, dev)
    if runs_plain_twin(feats):
        return duplex_combine_reference(W, feats, alpha, beta, sh, emit_gamma, weights,
                                        in_kernel_feats)
    _check_kernel_limits(K, F)
    lib = _library()
    kind = kind_code(in_kernel_feats)
    gamma = torch.empty((T, B, K), dtype=torch.float32, device=dev) if emit_gamma else None
    gamma0 = torch.empty((B, K), dtype=torch.float32, device=dev)
    stats = torch.empty(K * K + K * F, dtype=torch.float32, device=dev)  # acc, then eacc
    work = scratch(lib, "duplex_fb_scratch", lib.duplex_fb_error_string, dev, T, B, K, F, kind)
    code = lib.duplex_fb_combine(
        ptr(W), ptr(feats), ptr(alpha), ptr(beta), ptr(sh), ptr(weights),
        ptr(gamma), ptr(gamma0), ptr(stats), ptr(work),
        T, B, K, F, kind, device_index(dev), stream(dev),
    )
    acc, eacc = stats[: K * K].view(K, K), stats[K * K:].view(K, F)
    duplex_combine.launches += 1
    count_mode(duplex_combine, in_kernel_feats)
    raise_on(lib.duplex_fb_error_string, code, "duplex_combine_kernel")
    return gamma, gamma0, acc, eacc


duplex_combine.launches = 0
duplex_combine.mode_launches = {}


def reset_launch_counts() -> None:
    duplex_chain.launches = 0
    duplex_combine.launches = 0
    duplex_chain.mode_launches.clear()
    duplex_combine.mode_launches.clear()


# ------------------------------------------------------------------ E-step


def estep_duplex(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    W: torch.Tensor,
    feats: torch.Tensor,
    emit_gamma: bool = False,
    weights: torch.Tensor | None = None,
    gamma_sel: torch.Tensor | None = None,
    in_kernel_feats: str | None = None,
) -> tuple[FBResult, torch.Tensor]:
    """Duplex batched E-step, with the contract of ``fused_fb.estep_fused``:
    log_pi (K,), log_A (K, K); W (F, K) and feats (T, B, F) float32 (with
    ``in_kernel_feats`` the raw observations (T, B, D)), time-major and
    contiguous; weights an optional (T, B) float32 kept-mask.
    Returns (FBResult, emit_stats (K, F)). ``gamma_sel`` raises
    ``ValueError``: the duplex kernels have no time pick.

    CPU tensors run the plain twins; CUDA tensors run the two kernels."""
    _check_duplex_modes(W, feats, emit_gamma, gamma_sel, in_kernel_feats)
    pi_t, A_t = exp_params(log_pi, log_A)
    alpha, s, sh, beta = duplex_chain(pi_t, A_t, W, feats, in_kernel_feats)
    gamma, gamma0, acc, eacc = duplex_combine(W, feats, alpha, beta, sh, emit_gamma, weights,
                                              in_kernel_feats)
    return assemble(A_t, s, sh, gamma, gamma0, acc, eacc)


def _check_duplex_modes(W, feats, emit_gamma, gamma_sel, in_kernel_feats) -> None:
    if gamma_sel is not None:
        raise ValueError("gamma_sel requires the fused kernels")
    check_modes(W, feats, in_kernel_feats, emit_gamma, fmax=FMAX)


def estep_duplex_reference(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    W: torch.Tensor,
    feats: torch.Tensor,
    emit_gamma: bool = False,
    weights: torch.Tensor | None = None,
    gamma_sel: torch.Tensor | None = None,
    in_kernel_feats: str | None = None,
) -> tuple[FBResult, torch.Tensor]:
    """Plain PyTorch version of :func:`estep_duplex` on any device."""
    _check_duplex_modes(W, feats, emit_gamma, gamma_sel, in_kernel_feats)
    pi_t, A_t = exp_params(log_pi, log_A)
    alpha, s, sh, beta = duplex_chain_reference(pi_t, A_t, W, feats, in_kernel_feats)
    gamma, gamma0, acc, eacc = duplex_combine_reference(
        W, feats, alpha, beta, sh, emit_gamma, weights, in_kernel_feats
    )
    return assemble(A_t, s, sh, gamma, gamma0, acc, eacc)
