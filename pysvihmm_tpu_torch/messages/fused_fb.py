"""The fused E-step: likelihoods, forward-backward and every sufficient
statistic in two hand-written CUDA kernels (port of
``pysvihmm_tpu/messages/pallas_fb.py::pallas_estep_fused``).

Kernels (``csrc/fused_fb.cu``; the source notes what bounds them):

* ``fused_fwd_kernel`` replaces ``_fwd_kernel_fused`` (pallas_fb.py:516):
  ll = feats @ W in-kernel, the forward chain with per-sequence
  renormalisation every step, the stored raw alpha, its per-step sums s and
  the max shifts sh.
* ``fused_bwd_kernel`` replaces ``_bwd_kernel_fused`` (pallas_fb.py:577):
  the reverse walk recomputing ll identically, gamma, the pairwise
  accumulator sum_t outer(alpha_{t-1}, d_t n_t g_t) and the emission
  accumulator sum_t outer(w_t gamma_t, f_t). Gated by an SVI kept-mask w
  (T, B) and its pair gate g_t = w_{t-1} w_t when ``weights`` is given
  (pallas_fb.py:693-697, :1014-1019, :1095-1099): the gates touch the
  statistics only, so buffer steps still drive the chain and the gamma
  written out is ungated. The kernel forms the pair gate from w.

Up to K = 64 a block of either kernel carries S sequences, one thread per
state, each thread running its state of all S as interleaved chains; the
launchers take S from :func:`seqs_per_block`, a plain function of B and the
blocks of each instance the card holds at once (the library's occupancy
query). For 65 <= K <= 256 they launch the large-K instances
(``fused_fwd_wide_kernel<KP, S>``, ``fused_bwd_wide_kernel<KP, S, GATED>``,
KP = 128 or 256 padded states, S in :data:`WIDE_SEQS`): S sequences a block
over one copy of A~, one thread a state, S by the same rule, and the
statistics summed off the chain in an order that does not depend on S, so
every output is the same bits at every S. Above 256 states they raise.

Each kernel has a launcher (:func:`fused_forward`, :func:`fused_backward`)
and a plain PyTorch twin (:func:`forward_reference`,
:func:`backward_reference`) computing the same function; the twins run the
split E-step's twins (``split_fb.py``) on ll = feats @ W. A launcher given
CPU tensors runs the twin; given CUDA tensors it launches the kernel or
raises. :func:`estep_fused` composes the launchers and
:func:`estep_fused_reference` the twins.

:func:`outer_sum` (twin :func:`outer_sum_reference`) runs the large-K
statistics' outer sums alone (``csrc/fb_stats.cuh``, 3xTF32 on the tensor
cores), which the large-K backward and combine launchers of all three
libraries run on each window; :func:`outer_launches` reads the libraries'
counts of that kernel's launches.

Ported modes: ungated and gated, ``emit_gamma`` True and False. The
per-window gamma pick (``gamma_sel``), the in-kernel feature build and bf16
alpha storage are still open (ROADMAP Queue 2).
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
from .scan_fb import FBResult
from .split_fb import exp_params, split_backward_reference, split_forward_reference

_LIB = "fused_fb"
# the widest feature array the fused and duplex kernels take (fbc::FMAX in
# csrc/fb_common.cuh, which both libraries report): the engines route wider
# ones to the split kernels before any launch
FMAX = 64


def _library():
    """Build (at first use) and bind the kernels' C interface."""
    from .._build import load_library

    return bind(
        load_library(_LIB),
        {"fused_fb_forward": "ppppppp" "iiiiii" "p",
         "fused_fb_backward": "ppppppppppp" "iiiiii" "p",
         "fused_fb_scratch": "iiiiip",
         "fused_fb_kernel_info": "iiiiip",
         "fused_fb_outer_scratch": "iiip",
         "fused_fb_outer_sum": "pppp" "iiii" "p",
         "fused_fb_outer_launches": "i",
         "fused_fb_kmax": "",
         "fused_fb_fmax": ""},
        "fused_fb_error_string",
    )


def _check_kernel_limits(K: int, F: int) -> None:
    """K and F the CUDA kernels take (K <= 64 on the S-sequence instances,
    65-256 on the large-K ones; F <= 64): raise on larger ones instead of
    falling back."""
    lib = _library()
    kmax, fmax = lib.fused_fb_kmax(), lib.fused_fb_fmax()
    if K > kmax or F > fmax:
        raise NotImplementedError(
            f"the fused CUDA kernels take K <= {kmax} and F <= {fmax}, got K={K}, F={F}"
        )


# the sequences a block the library is built for (csrc/fused_fb.cu): up to
# K = 64, and above (the large-K instances)
SEQS = (2, 4)
WIDE_SEQS = (1, 2, 4, 8)
KMAX_SEQS = 64  # the largest K of the SEQS instances


def built_seqs(K: int) -> tuple[int, ...]:
    """The S values the library holds instances of at K states."""
    return SEQS if K <= KMAX_SEQS else WIDE_SEQS


def seqs_per_block(B: int, resident: dict[int, int], per_group: int = 1,
                   seqs: tuple[int, ...] = SEQS) -> int:
    """Sequences a block S for a batch of B, given ``resident[S]``, the blocks
    of the S instance the card holds at once (blocks an SM times SMs), and
    the blocks a group of S sequences takes (2 for the duplex chain: a
    forward and a backward block).

    The smallest S of ``seqs`` (the built values, ascending) whose
    per_group ceil(B / S) blocks run in one wave, and the largest when none
    does. For the large-K instances (``seqs`` = WIDE_SEQS) that keeps a
    block a sequence for a small B, and carries S sequences over one copy
    of A~ where B would need more waves: S = 8 at KP = 256 and S = 4 at KP =
    128 for B = 1024, each the fastest S measured there (PERF.md). Up to K =
    64, measured on the H100 (PERF.md): S = 2 is the fastest for both
    kernels at B = 32, 256 and 1024 (two sequences a thread fill the FMA
    pipe's latency, and the backward shares each A~ and W word it reads
    between them); S = 4 at B = 2048, where S = 2 needs a second wave, and
    for the backward at B = 4096. S = 1 lost to S = 2 at every B it was
    timed at, and S = 8 everywhere (the backward spills): neither is built
    for K <= 64."""
    for S in seqs:
        if per_group * -(-B // S) <= resident[S]:
            return S
    return seqs[-1]


_KERNELS = {"forward": 0, "backward": 1, "gated backward": 2}


def kernel_info(kernel: str, S: int, F: int, device: torch.device | None = None,
                K: int = KMAX_SEQS) -> dict:
    """What one instance of the kernels takes on the card, from the library:
    ``kernel`` is "forward", "backward" or "gated backward", S the sequences a
    block, F the feature width and K the states (up to 64 the instance built
    for F padded to 16, 32, 48 or 64; above, the large-K instance of K's
    padded state count, 128 or 256). Returns registers (a thread),
    static_smem and dynamic_smem (bytes a block), local_bytes (spills, a
    thread), blocks_per_sm (resident, by the CUDA occupancy calculator), sms
    (the card's) and threads (a block)."""
    dev = device if device is not None else torch.device("cuda")
    return dict(_kernel_info(kernel, S, F, instance_tier(K), device_index(dev)))


@functools.cache
def _kernel_info(kernel: str, S: int, F: int, K: int, index: int) -> tuple:
    out = (ctypes.c_int * 7)()
    lib = _library()
    code = lib.fused_fb_kernel_info(_KERNELS[kernel], S, K, F, index, ctypes.addressof(out))
    raise_on(lib.fused_fb_error_string, code,
             f"fused_fb_kernel_info({kernel}, S={S}, K={K}, F={F})")
    keys = ("registers", "static_smem", "dynamic_smem", "local_bytes", "blocks_per_sm", "sms",
            "threads")
    return tuple(zip(keys, list(out)))


def default_seqs(kernel: str, B: int, F: int, device: torch.device, K: int = KMAX_SEQS) -> int:
    """The launchers' S: :func:`seqs_per_block` over the instances built for
    K (:func:`built_seqs`) on the card's own occupancy."""
    return _default_seqs(kernel, B, F, instance_tier(K), device_index(device))


@functools.cache
def _default_seqs(kernel: str, B: int, F: int, K: int, index: int) -> int:
    seqs = built_seqs(K)
    info = {S: dict(_kernel_info(kernel, S, F, K, index)) for S in seqs}
    return seqs_per_block(B, {S: i["blocks_per_sm"] * i["sms"] for S, i in info.items()},
                          seqs=seqs)


def _seqs(kernel: str, S: int | None, B: int, K: int, F: int, index: int) -> int:
    """S for a launch: the default when None, else a built one or raise."""
    if S is None:
        return _default_seqs(kernel, B, F, instance_tier(K), index)
    if S not in built_seqs(K):
        raise ValueError(f"no {kernel} instance with S={S} at K={K}: built {built_seqs(K)}")
    return S


# ----------------------------------------------------------------- forward


def forward_reference(
    pi_t: torch.Tensor, A_t: torch.Tensor, W: torch.Tensor, feats: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the forward kernel.

    pi_t (K,), A_t (K, K) the exponentiated params; W (F, K); feats (T, B, F).
    Returns (alpha (T, B, K) raw stored messages, s (B, T) their per-step
    sums, sh (B, T) the max shifts)."""
    return split_forward_reference(pi_t, A_t, feats @ W)


def fused_forward(
    pi_t: torch.Tensor, A_t: torch.Tensor, W: torch.Tensor, feats: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward kernel launcher; contract of :func:`forward_reference`.

    Inputs are float32 and contiguous on one device. CPU tensors run the
    plain twin; CUDA tensors launch ``fused_fwd_kernel`` or raise."""
    return _launch_forward(None, pi_t, A_t, W, feats)


def _launch_forward(S: int | None, pi_t, A_t, W, feats):
    """:func:`fused_forward` with S sequences a block (one of
    :func:`built_seqs` at this K; None for :func:`default_seqs`): the card
    tests and chip_smoke.py's sweeps of S."""
    T, B, F = feats.shape
    K = A_t.shape[0]
    dev = feats.device
    for name, x, shape in (("pi_t", pi_t, (K,)), ("A_t", A_t, (K, K)),
                           ("W", W, (F, K)), ("feats", feats, (T, B, F))):
        check(name, x, shape, dev)
    if runs_plain_twin(feats):
        return forward_reference(pi_t, A_t, W, feats)
    _check_kernel_limits(K, F)
    lib = _library()
    index = device_index(dev)
    S = _seqs("forward", S, B, K, F, index)
    alpha = torch.empty((T, B, K), dtype=torch.float32, device=dev)
    s = torch.empty((B, T), dtype=torch.float32, device=dev)
    sh = torch.empty((B, T), dtype=torch.float32, device=dev)
    code = lib.fused_fb_forward(
        ptr(pi_t), ptr(A_t), ptr(W), ptr(feats), ptr(alpha), ptr(s), ptr(sh),
        T, B, K, F, S, index, stream(dev),
    )
    fused_forward.launches += 1
    raise_on(lib.fused_fb_error_string, code, "fused_fwd_kernel")
    return alpha, s, sh


fused_forward.launches = 0


# ---------------------------------------------------------------- backward


def backward_reference(
    A_t: torch.Tensor,
    W: torch.Tensor,
    feats: torch.Tensor,
    alpha: torch.Tensor,
    s: torch.Tensor,
    sh: torch.Tensor,
    emit_gamma: bool = False,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the backward kernel.

    Takes the forward's (alpha (T, B, K), s (B, T), sh (B, T)) and an
    optional kept-mask weights (T, B). Returns (gamma (T, B, K), ungated, or
    None; gamma0 = w_0 gamma_0 (B, K); acc (K, K) = sum over sequences and t
    of outer(alpha_{t-1}, d_t n_t g_t); eacc (K, F) = sum of
    outer(w_t gamma_t, f_t)), with w = g = 1 when ungated."""
    T, B, F = feats.shape
    K = A_t.shape[0]
    gamma, acc = split_backward_reference(A_t, feats @ W, alpha, s, sh, weights)
    gamma_w = gamma if weights is None else gamma * weights[..., None]
    eacc = gamma_w.reshape(T * B, K).T @ feats.reshape(T * B, F)
    return (gamma if emit_gamma else None), gamma_w[0].clone(), acc, eacc


def fused_backward(
    A_t: torch.Tensor,
    W: torch.Tensor,
    feats: torch.Tensor,
    alpha: torch.Tensor,
    s: torch.Tensor,
    sh: torch.Tensor,
    emit_gamma: bool = False,
    weights: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward kernel launcher; contract of :func:`backward_reference`.

    CPU tensors run the plain twin; CUDA tensors launch ``fused_bwd_kernel``
    (gated when ``weights`` is given; the kernel forms the pair gate from
    them) or raise. acc and eacc are summed across blocks in an order fixed
    by the shapes (csrc/fb_stats.cuh), so repeated calls on one card give
    the same bits. Up to K = 64 the grouping follows S, so another S (another
    B, or ``_launch_backward``'s) may round them differently; above, the
    grouping follows (T, B, K, F) alone. Above K = 64 the launch takes a
    scratch of 2 min(T B, max(B, 2^17)) K floats beside the carried beta
    (B K) and the sums' partials, whatever T: about 0.28 GB at B = 1024,
    K = 256, F = 45 (the statistics a window of time steps a launch,
    csrc/fb_stats.cuh)."""
    return _launch_backward(None, A_t, W, feats, alpha, s, sh, emit_gamma, weights)


def _launch_backward(S: int | None, A_t, W, feats, alpha, s, sh, emit_gamma=False,
                     weights=None):
    """:func:`fused_backward` with S sequences a block, as
    :func:`_launch_forward`."""
    T, B, F = feats.shape
    K = A_t.shape[0]
    dev = feats.device
    args = [("A_t", A_t, (K, K)), ("W", W, (F, K)), ("feats", feats, (T, B, F)),
            ("alpha", alpha, (T, B, K)), ("s", s, (B, T)), ("sh", sh, (B, T))]
    if weights is not None:
        args.append(("weights", weights, (T, B)))
    for name, x, shape in args:
        check(name, x, shape, dev)
    if runs_plain_twin(feats):
        return backward_reference(A_t, W, feats, alpha, s, sh, emit_gamma, weights)
    _check_kernel_limits(K, F)
    lib = _library()
    kind = "backward" if weights is None else "gated backward"
    index = device_index(dev)
    S = _seqs(kind, S, B, K, F, index)
    gamma = torch.empty((T, B, K), dtype=torch.float32, device=dev) if emit_gamma else None
    gamma0 = torch.empty((B, K), dtype=torch.float32, device=dev)
    stats = torch.empty(K * K + K * F, dtype=torch.float32, device=dev)  # acc, then eacc
    work = scratch(lib, "fused_fb_scratch", lib.fused_fb_error_string, dev, T, B, K, F, S)
    code = lib.fused_fb_backward(
        ptr(A_t), ptr(W), ptr(feats), ptr(alpha), ptr(s), ptr(sh),
        ptr(weights), ptr(gamma), ptr(gamma0), ptr(stats), ptr(work),
        T, B, K, F, S, index, stream(dev),
    )
    acc, eacc = stats[: K * K].view(K, K), stats[K * K:].view(K, F)
    fused_backward.launches += 1
    raise_on(lib.fused_fb_error_string, code, "fused_bwd_kernel")
    return gamma, gamma0, acc, eacc


fused_backward.launches = 0


def reset_launch_counts() -> None:
    fused_forward.launches = 0
    fused_backward.launches = 0
    outer_sum.launches = 0


# ------------------------------------------------------------- outer sums

OUTER_MAX = 256  # the widest operand: K states (acc), at most 64 features (eacc)
# the libraries whose large-K launchers run the outer sums (csrc/fb_stats.cuh)
OUTER_LIBS = ("fused_fb", "split_fb", "duplex_fb")


def outer_sum_reference(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Plain twin of the outer sums: X^T Y (I, J) for X (N, I), Y (N, J)."""
    return X.T @ Y


def outer_sum(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """The large-K statistics' outer sums alone: sum over the rows n of
    outer(X[n], Y[n]) = X^T Y, (I, J), for float32 X (N, I) and Y (N, J),
    contiguous on one device, N >= 1 and 1 <= I, J <= 256.

    The kernel (``csrc/fb_stats.cuh::outer_partial_kernel``) is the one the
    large-K backward kernels and the duplex combine run on each window of
    their statistics (acc: X the alpha rows, Y the gated d n; eacc: X the
    weighted gamma rows, Y the features), in the counterpart of the
    reference's "bf16x3" tier: 3xTF32 on the tensor cores, float32 sums in
    an order fixed by (N, I, J), so repeated calls give the same bits. CPU
    tensors run :func:`outer_sum_reference`; CUDA tensors launch the kernel
    or raise."""
    if X.dim() != 2 or Y.dim() != 2:
        raise ValueError(f"X and Y must be 2-D, got {tuple(X.shape)} and {tuple(Y.shape)}")
    (N, I), J = X.shape, Y.shape[1]
    dev = X.device
    check("X", X, (N, I), dev)
    check("Y", Y, (N, J), dev)
    if N < 1 or not (1 <= I <= OUTER_MAX and 1 <= J <= OUTER_MAX):
        raise ValueError(f"outer_sum takes N >= 1 rows and 1 to {OUTER_MAX} columns, got "
                         f"X {tuple(X.shape)}, Y {tuple(Y.shape)}")
    if runs_plain_twin(X):
        return outer_sum_reference(X, Y)
    lib = _library()
    out = torch.empty((I, J), dtype=torch.float32, device=dev)
    work = scratch(lib, "fused_fb_outer_scratch", lib.fused_fb_error_string, dev, N, I, J)
    index = device_index(dev)
    code = lib.fused_fb_outer_sum(ptr(X), ptr(Y), ptr(work), ptr(out), N, I, J, index,
                                  stream(dev))
    outer_sum.launches += 1
    raise_on(lib.fused_fb_error_string, code, "outer_partial_kernel")
    return out


outer_sum.launches = 0


def outer_launches(clear: bool = False) -> int:
    """Launches of the outer sums' kernel since the counts were last
    cleared, over the libraries loaded so far (:data:`OUTER_LIBS`): each
    library counts where it launches the kernel, inside the large-K
    backward and combine launchers and in :func:`outer_sum`. Clears the
    counts when ``clear``."""
    from .._build import loaded_library

    total = 0
    for name in OUTER_LIBS:
        lib = loaded_library(name)
        if lib is not None:
            fn = getattr(lib, f"{name}_outer_launches")
            fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
            total += fn(int(clear))
    return total


# ------------------------------------------------------------------ E-step


def assemble(A_t, s, sh, gamma, gamma0, acc, eacc) -> tuple[FBResult, torch.Tensor]:
    """(FBResult, emit_stats) from the kernels' outputs; the fused and the
    duplex E-step share it."""
    log_c = torch.log(s) + sh  # (B, T): log c_t = log s_t + sh_t
    fb = FBResult(
        gamma=gamma,
        log_z=log_c.sum(dim=-1),
        trans_stats=A_t * acc,
        init_stats=gamma0,
        log_c=log_c,
    )
    return fb, eacc


def estep_fused(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    W: torch.Tensor,
    feats: torch.Tensor,
    emit_gamma: bool = False,
    weights: torch.Tensor | None = None,
) -> tuple[FBResult, torch.Tensor]:
    """Fused batched E-step: likelihoods + forward-backward + all stats.

    log_pi (K,), log_A (K, K); W (F, K) float32 feature weights with
    ll = feats @ W; feats (T, B, F) float32, TIME-MAJOR and contiguous;
    weights: optional (T, B) float32 kept-mask (SVI windows).
    Returns (FBResult, emit_stats (K, F)). FBResult holds log_c (B, T),
    log_z (B,), init_stats = w_0 gamma_0 (B, K), trans_stats summed over
    sequences and pair-gated (K, K) and gamma (T, B, K), ungated, when
    ``emit_gamma`` else None. emit_stats = sum over sequences and t of
    outer(w_t gamma_t, f_t).

    CPU tensors run the plain twins; CUDA tensors run the two kernels."""
    pi_t, A_t = exp_params(log_pi, log_A)
    alpha, s, sh = fused_forward(pi_t, A_t, W, feats)
    gamma, gamma0, acc, eacc = fused_backward(
        A_t, W, feats, alpha, s, sh, emit_gamma, weights
    )
    return assemble(A_t, s, sh, gamma, gamma0, acc, eacc)


def estep_fused_reference(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    W: torch.Tensor,
    feats: torch.Tensor,
    emit_gamma: bool = False,
    weights: torch.Tensor | None = None,
) -> tuple[FBResult, torch.Tensor]:
    """Plain PyTorch version of :func:`estep_fused` on any device."""
    pi_t, A_t = exp_params(log_pi, log_A)
    alpha, s, sh = forward_reference(pi_t, A_t, W, feats)
    gamma, gamma0, acc, eacc = backward_reference(
        A_t, W, feats, alpha, s, sh, emit_gamma, weights
    )
    return assemble(A_t, s, sh, gamma, gamma0, acc, eacc)
