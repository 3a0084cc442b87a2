"""The split E-step: forward-backward over log-likelihoods already in device
memory, in two hand-written CUDA kernels (port of
``pysvihmm_tpu/messages/pallas_fb.py::pallas_forward_backward_batched``,
pallas_fb.py:1121-1304, without its lane packing).

Kernels (``csrc/split_fb.cu``; the source notes what bounds them):

* ``split_fwd_kernel`` replaces ``_fwd_kernel`` (pallas_fb.py:339) with
  ``log_in``: per step the max shift sh_t = max_k ll_t, lik_t =
  exp(ll_t - sh_t), the forward chain with per-sequence renormalisation every
  step, the stored raw alpha and its per-step sums s.
* ``split_bwd_kernel`` replaces ``_bwd_kernel`` (pallas_fb.py:406): the
  reverse walk, gamma, and the pairwise accumulator
  sum_t outer(alpha_{t-1}, d_t n_t g_t) with an optional pair gate g_t =
  w_{t-1} w_t, which the kernel forms from the kept-mask w. It computes no
  emission statistics; the engines take those outside, as gamma^T @ features
  (engines/base.py::_split_estep).

A block of either kernel carries S sequences, one thread per state, each
thread running its state of all S as interleaved chains over one copy of A~
(the fused pair's layouts: ``fb_seqs.cuh`` up to K = 64, ``fb_wide.cuh``
above; for 257 <= K <= 1024 the XL instances of ``fb_xl.cuh``, the same
chains with A~ read from device memory (L2) every step, the backward's
from a transposed copy made once a call). The launchers take S from
:func:`default_seqs`, the fused pair's
one-wave rule (``fused_fb.seqs_per_block``) over this library's own
instances (:func:`built_seqs`) and the card's occupancy
(:func:`kernel_info`), or from the caller (``S=``); an S not built raises
``ValueError``. Every output is the same bits at every S, and so at every
B: each sequence's arithmetic does not depend on S, and acc is summed in an
order fixed by (T, B, K) (up to K = 64 each sequence keeps its own partial
sums, added in sequence order; above, outer products over windows of time
steps). Above 1024 states the launchers raise, and so does bf16 alpha
above 256 (no XL instance stores it).

Each kernel has a launcher (:func:`split_forward`, :func:`split_backward`)
with a launch counter and a plain PyTorch twin
(:func:`split_forward_reference`, :func:`split_backward_reference`). A
launcher given CPU tensors runs the twin; given CUDA tensors it launches the
kernel or raises. The twins are also the chain of the fused E-step's twins
(``fused_fb.py`` runs them on ll = feats @ W).

bf16-stored alpha (``alpha_dtype=torch.bfloat16``; JAX's
``_alpha_store_dtype()``, pallas_fb.py:198-230, :1213): the forward stores
alpha rounded to bf16 while its chain carries float32, s sums the rounded
values, and the backward reads the stored words back, so its replay factors
1 / s and the alpha it reads are the same numbers; the twins round alike.

Contract of :func:`estep_split`: log-likelihoods ``ll`` (T, B, K) float32,
TIME-MAJOR and contiguous, and an optional kept-mask ``weights`` (T, B).
Returns an ``FBResult`` with gamma (T, B, K) (ungated), log_c (B, T), log_z
(B,), init_stats = w_0 gamma_0 (B, K) and trans_stats = A~ * acc (K, K),
pair-gated and summed over sequences.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ._launch import (
    bind,
    check,
    check_xl_modes,
    count_xl,
    device_index,
    instance_tier,
    ptr,
    raise_on,
    resident_blocks,
    runs_plain_twin,
    scratch,
    stream,
)
from .scan_fb import FBResult

SUM_FLOOR = 1e-38  # per-sequence sum floor (pallas_fb.py:82)
ALPHA_DTYPES = (torch.float32, torch.bfloat16)  # alpha's storage

_LIB = "split_fb"


def _library():
    """Build (at first use) and bind the kernels' C interface."""
    from .._build import load_library

    return bind(
        load_library(_LIB),
        {"split_fb_forward": "ppppppp" "iiiii" "p",
         "split_fb_backward": "pppppppppp" "iiiii" "p",
         "split_fb_scratch": "iiiip",
         "split_fb_kernel_info": "iiiiip",
         "split_fb_prep_launches": "ii",
         "split_fb_kmax": ""},
        "split_fb_error_string",
    )


def _check_kernel_limits(K: int) -> None:
    """Raise on a K the CUDA kernels do not take (K <= 64 on the first
    instances, 65-256 on the large-K ones, 257-1024 on the XL ones) instead
    of falling back."""
    kmax = _library().split_fb_kmax()
    if K > kmax:
        raise NotImplementedError(f"the split CUDA kernels take K <= {kmax}, got K={K}")


# the sequences a block the library is built for (csrc/split_fb.cu): up to K
# = 64 by kernel (each sequence's column of acc takes K registers of a
# backward thread, so only S = 2 fits there), and above, every kernel's
# large-K instances
SEQS = {"forward": (2, 4), "backward": (2,), "gated backward": (2,)}
WIDE_SEQS = (1, 2, 4, 8)
KMAX_SEQS = 64  # the largest K of the SEQS instances
_KERNELS = {"forward": 0, "backward": 1, "gated backward": 2}


def built_seqs(kernel: str, K: int) -> tuple[int, ...]:
    """The S values the library holds instances of for ``kernel`` ("forward",
    "backward" or "gated backward") at K states, ascending."""
    return SEQS[kernel] if K <= KMAX_SEQS else WIDE_SEQS


def kernel_info(kernel: str, S: int, device: torch.device | None = None,
                K: int = KMAX_SEQS, bf16: bool = False) -> dict:
    """What one instance of the kernels takes on the card, from the library:
    ``kernel`` is "forward", "backward" or "gated backward", S the sequences a
    block and K the states (up to 64 the K <= 64 instance; above, the
    large-K instance of K's padded state count, 128 or 256, and above 256
    the XL one of 512 or 1024); ``bf16`` the instance that stores (reads)
    bf16 alpha (none at the XL tiers). Returns
    registers (a thread), static_smem and dynamic_smem (bytes a block),
    local_bytes (spills, a thread), blocks_per_sm (resident, by the CUDA
    occupancy calculator), sms (the card's) and threads (a block)."""
    dev = device if device is not None else torch.device("cuda")
    return dict(_kernel_info(kernel, S, instance_tier(K), device_index(dev), bf16))


@functools.cache
def _kernel_info(kernel: str, S: int, K: int, index: int, bf16: bool = False) -> tuple:
    out = (ctypes.c_int * 7)()
    lib = _library()
    code = lib.split_fb_kernel_info(_KERNELS[kernel], S, K, int(bf16), index,
                                    ctypes.addressof(out))
    raise_on(lib.split_fb_error_string, code,
             f"split_fb_kernel_info({kernel}, S={S}, K={K}, bf16={bf16})")
    keys = ("registers", "static_smem", "dynamic_smem", "local_bytes", "blocks_per_sm", "sms",
            "threads")
    return tuple(zip(keys, list(out)))


def default_seqs(kernel: str, B: int, device: torch.device, K: int = KMAX_SEQS,
                 bf16: bool = False) -> int:
    """The launchers' S: ``fused_fb.seqs_per_block`` (the smallest built S
    whose ceil(B / S) blocks run in one wave) over this library's instances
    for ``kernel`` at K (:func:`built_seqs`; ``bf16`` alpha's) on the card's
    own occupancy, one block an SM at the XL tiers
    (``_launch.resident_blocks``)."""
    return _default_seqs(kernel, B, instance_tier(K), device_index(device), bf16)


@functools.cache
def _default_seqs(kernel: str, B: int, K: int, index: int, bf16: bool = False) -> int:
    from .fused_fb import seqs_per_block  # fused_fb imports this module

    seqs = built_seqs(kernel, K)
    info = {S: dict(_kernel_info(kernel, S, K, index, bf16)) for S in seqs}
    return seqs_per_block(B, {S: resident_blocks(i, K) for S, i in info.items()}, seqs=seqs)


def check_seqs(kernel: str, S: int | None, K: int) -> None:
    """Raise ``ValueError`` unless S is None or one of :func:`built_seqs`
    (no fallback to another S); the launchers check it on every device."""
    if S is not None and S not in built_seqs(kernel, K):
        raise ValueError(f"no split {kernel} instance with S={S} at K={K}: built "
                         f"{built_seqs(kernel, K)}")


def _seqs(kernel: str, S: int | None, B: int, K: int, index: int, bf16: bool = False) -> int:
    """S for a launch: the default when None, else a built one or raise."""
    check_seqs(kernel, S, K)
    return _default_seqs(kernel, B, instance_tier(K), index, bf16) if S is None else S


def check_alpha_dtype(alpha_dtype: torch.dtype) -> None:
    """Raise ``ValueError`` for an alpha storage the kernels have no
    instance of (float32 and bf16 they have)."""
    if alpha_dtype not in ALPHA_DTYPES:
        raise ValueError(f"alpha is stored as one of {ALPHA_DTYPES}, got {alpha_dtype}")


def exp_params(log_pi: torch.Tensor, log_A: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """pi~, A~ as contiguous float32 (exp first, then the cast, as the JAX
    wrappers do)."""
    return (
        torch.exp(log_pi).to(torch.float32).contiguous(),
        torch.exp(log_A).to(torch.float32).contiguous(),
    )


def pair_gate(weights: torch.Tensor) -> torch.Tensor:
    """Kept-mask w (T, B) -> pair gate g (T, B): g_0 = 0, g_t = w_{t-1} w_t.

    The transition (t-1, t) counts iff both ends are kept
    (pallas_fb.py:1014-1019, :1243-1248)."""
    return torch.cat([torch.zeros_like(weights[:1]), weights[:-1] * weights[1:]], dim=0)


# ----------------------------------------------------------------- forward


def split_forward_reference(
    pi_t: torch.Tensor, A_t: torch.Tensor, ll: torch.Tensor,
    alpha_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the forward kernel.

    pi_t (K,), A_t (K, K) the exponentiated params; ll (T, B, K)
    log-likelihoods. Returns (alpha (T, B, K) raw stored messages, in
    ``alpha_dtype``; s (B, T) their per-step sums, of the stored values; sh
    (B, T) the max shifts). The chain carries float32 whatever alpha's
    storage: bf16 alpha is float32's rounded."""
    check_alpha_dtype(alpha_dtype)
    T = ll.shape[0]
    sh = ll.amax(dim=-1)
    lik = torch.exp(ll - sh[..., None])
    alpha = torch.empty_like(lik)
    s = torch.empty_like(sh)
    a = pi_t * lik[0]
    alpha[0], s[0] = a, a.sum(dim=-1)
    for t in range(1, T):
        inv = 1.0 / torch.clamp_min(s[t - 1], SUM_FLOOR)
        a = (a @ A_t) * (lik[t] * inv[:, None])
        alpha[t], s[t] = a, a.sum(dim=-1)
    if alpha_dtype != torch.float32:
        alpha = alpha.to(alpha_dtype)
        s = alpha.to(torch.float32).sum(dim=-1)
    return alpha, s.T.contiguous(), sh.T.contiguous()


def split_forward(
    pi_t: torch.Tensor, A_t: torch.Tensor, ll: torch.Tensor, S: int | None = None,
    alpha_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward kernel launcher; contract of :func:`split_forward_reference`.

    Inputs are float32 and contiguous on one device. CPU tensors run the
    plain twin; CUDA tensors launch ``split_fwd_kernel`` (its bf16-alpha
    instance for ``alpha_dtype=torch.bfloat16``, which above 256 states
    raises ``NotImplementedError``) with S sequences a block
    (:func:`default_seqs` when None; one of :func:`built_seqs`, else
    ``ValueError``) or raise. The outputs do not depend on S."""
    T, B, K = ll.shape
    dev = ll.device
    for name, x, shape in (("pi_t", pi_t, (K,)), ("A_t", A_t, (K, K)), ("ll", ll, (T, B, K))):
        check(name, x, shape, dev)
    check_seqs("forward", S, K)
    check_alpha_dtype(alpha_dtype)
    if runs_plain_twin(ll):
        return split_forward_reference(pi_t, A_t, ll, alpha_dtype)
    _check_kernel_limits(K)
    check_xl_modes(K, "split", bf16_alpha=alpha_dtype == torch.bfloat16)
    lib = _library()
    index = device_index(dev)
    bf16 = alpha_dtype == torch.bfloat16
    S = _seqs("forward", S, B, K, index, bf16)
    alpha = torch.empty((T, B, K), dtype=alpha_dtype, device=dev)
    a32, a16 = (None, alpha) if bf16 else (alpha, None)
    s = torch.empty((B, T), dtype=torch.float32, device=dev)
    sh = torch.empty((B, T), dtype=torch.float32, device=dev)
    code = lib.split_fb_forward(
        ptr(pi_t), ptr(A_t), ptr(ll), ptr(a32), ptr(a16), ptr(s), ptr(sh),
        T, B, K, S, index, stream(dev),
    )
    split_forward.launches += 1
    split_forward.bf16_launches += bf16
    count_xl(split_forward, K)
    raise_on(lib.split_fb_error_string, code, "split_fwd_kernel")
    return alpha, s, sh


split_forward.launches = 0
split_forward.bf16_launches = 0  # of them, the bf16-alpha instance's
split_forward.xl_launches = {}  # of them, the XL instances', by padded state count


# ---------------------------------------------------------------- backward


def split_backward_reference(
    A_t: torch.Tensor,
    ll: torch.Tensor,
    alpha: torch.Tensor,
    s: torch.Tensor,
    sh: torch.Tensor,
    w: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of the backward kernel.

    Takes the forward's (alpha (T, B, K), float32 or bf16 as stored, s
    (B, T), sh (B, T)) and the optional kept-mask w (T, B). Returns (gamma (T, B, K), ungated; acc
    (K, K) = sum over sequences and t of outer(alpha_{t-1}, d_t n_t g_t),
    g = :func:`pair_gate` (w), g = 1 ungated). The beta chain runs on the
    ungated d."""
    T, B, K = ll.shape
    alpha = alpha.to(torch.promote_types(alpha.dtype, torch.float32))  # bf16 read as float32
    g = None if w is None else pair_gate(w)
    lik = torch.exp(ll - sh.T[..., None])
    r = 1.0 / torch.clamp_min(s, SUM_FLOOR)  # (B, T)
    beta = r[:, T - 1, None].expand(B, K)
    gamma = torch.empty_like(alpha)
    acc = torch.zeros((K, K), dtype=alpha.dtype, device=alpha.device)
    for t in range(T - 1, -1, -1):
        graw = alpha[t] * beta
        n = 1.0 / torch.clamp_min(graw.sum(dim=-1), SUM_FLOOR)
        gamma[t] = graw * n[:, None]
        if t >= 1:
            d = (lik[t] * r[:, t - 1, None]) * beta
            dn = d * n[:, None]
            if g is not None:
                dn = dn * g[t, :, None]
            acc += alpha[t - 1].T @ dn
            beta = d @ A_t.T
    return gamma, acc


def split_backward(
    A_t: torch.Tensor,
    ll: torch.Tensor,
    alpha: torch.Tensor,
    s: torch.Tensor,
    sh: torch.Tensor,
    w: torch.Tensor | None = None,
    S: int | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Backward kernel launcher; contract of :func:`split_backward_reference`.

    CPU tensors run the plain twin; CUDA tensors launch ``split_bwd_kernel``
    (``split_bwd_wide_kernel`` above K = 64; gated when the kept-mask ``w``
    is given, the kernel forming the pair gate from it; the bf16-alpha
    instance when alpha is bf16) with S sequences a
    block (:func:`default_seqs` when None; one of :func:`built_seqs`, else
    ``ValueError``), or raise. acc is summed across sequences in an order
    fixed by (T, B, K) alone (csrc/fb_stats.cuh): the same bits at every S
    and over repeated calls on one card. Above K = 64 the launch takes a
    scratch of min(T B, max(B, 2^17)) K floats beside the carried beta (B K)
    and the sum's partials, whatever T: about 0.14 GB at B = 1024, K = 256
    (acc a window of time steps a launch; with bf16 alpha a window's alpha
    widened beside it); above K = 256 also A~^T (K K floats), which the XL
    chain reads (0.54 GB of dn at K = 1024, B = 1024; gamma 4.2 GB at T =
    1000). bf16 alpha above 256 states raises ``NotImplementedError``."""
    T, B, K = ll.shape
    dev = ll.device
    args = [("A_t", A_t, (K, K)), ("ll", ll, (T, B, K)), ("s", s, (B, T)), ("sh", sh, (B, T))]
    if w is not None:
        args.append(("w", w, (T, B)))
    for name, x, shape in args:
        check(name, x, shape, dev)
    check_alpha_dtype(alpha.dtype)
    check("alpha", alpha, (T, B, K), dev, alpha.dtype)
    kind = "backward" if w is None else "gated backward"
    check_seqs(kind, S, K)
    if runs_plain_twin(ll):
        return split_backward_reference(A_t, ll, alpha, s, sh, w)
    _check_kernel_limits(K)
    check_xl_modes(K, "split", bf16_alpha=alpha.dtype == torch.bfloat16)
    lib = _library()
    index = device_index(dev)
    bf16 = alpha.dtype == torch.bfloat16
    S = _seqs(kind, S, B, K, index, bf16)
    gamma = torch.empty((T, B, K), dtype=torch.float32, device=dev)
    acc = torch.empty((K, K), dtype=torch.float32, device=dev)
    work = scratch(lib, "split_fb_scratch", lib.split_fb_error_string, dev, T, B, K, int(bf16))
    a32, a16 = (None, alpha) if bf16 else (alpha, None)
    code = lib.split_fb_backward(
        ptr(A_t), ptr(ll), ptr(a32), ptr(a16), ptr(s), ptr(sh), ptr(w), ptr(gamma), ptr(acc),
        ptr(work), T, B, K, S, index, stream(dev),
    )
    split_backward.launches += 1
    split_backward.bf16_launches += bf16
    count_xl(split_backward, K)
    raise_on(lib.split_fb_error_string, code, "split_bwd_kernel")
    return gamma, acc


split_backward.launches = 0
split_backward.bf16_launches = 0  # of them, the bf16-alpha instance's
split_backward.xl_launches = {}  # of them, the XL instances', by padded state count


def reset_launch_counts() -> None:
    split_forward.launches = 0
    split_backward.launches = 0
    split_forward.bf16_launches = 0
    split_backward.bf16_launches = 0
    split_forward.xl_launches.clear()
    split_backward.xl_launches.clear()


# ------------------------------------------------------------------ E-step


def _assemble(A_t, s, sh, gamma, acc, weights) -> FBResult:
    log_c = torch.log(s) + sh  # (B, T): log c_t = log s_t + sh_t
    init = gamma[0] if weights is None else gamma[0] * weights[0][:, None]
    return FBResult(
        gamma=gamma,
        log_z=log_c.sum(dim=-1),
        trans_stats=A_t * acc,
        init_stats=init,
        log_c=log_c,
    )


def estep_split(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    ll: torch.Tensor,
    weights: torch.Tensor | None = None,
    alpha_dtype: torch.dtype = torch.float32,
) -> FBResult:
    """Split batched E-step over log-likelihoods ll (T, B, K) float32,
    time-major and contiguous, with an optional kept-mask weights (T, B)
    float32; ``alpha_dtype`` the stored alpha's (torch.bfloat16 rounds it;
    evaluation callers keep float32). Contract in the module docstring. CPU
    tensors run the plain twins; CUDA tensors run the two kernels."""
    pi_t, A_t = exp_params(log_pi, log_A)
    alpha, s, sh = split_forward(pi_t, A_t, ll, alpha_dtype=alpha_dtype)
    gamma, acc = split_backward(A_t, ll, alpha, s, sh, weights)
    return _assemble(A_t, s, sh, gamma, acc, weights)


def estep_split_reference(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    ll: torch.Tensor,
    weights: torch.Tensor | None = None,
    alpha_dtype: torch.dtype = torch.float32,
) -> FBResult:
    """Plain PyTorch version of :func:`estep_split` on any device."""
    pi_t, A_t = exp_params(log_pi, log_A)
    alpha, s, sh = split_forward_reference(pi_t, A_t, ll, alpha_dtype)
    gamma, acc = split_backward_reference(A_t, ll, alpha, s, sh, weights)
    return _assemble(A_t, s, sh, gamma, acc, weights)
