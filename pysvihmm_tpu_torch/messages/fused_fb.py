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
query). Features wider than :data:`FMAX` run the WF instances of either
tier (``csrc/fb_seqs_wf.cuh`` up to K = 64, ``fb_wide.cuh``'s chains on
read likelihoods above), F a run-time bound, at any F, as JAX's fused
kernels take any F. Up to K = 64 the WF forward sums the likelihoods of all
T B rows with :func:`likelihood_tile`'s kernel into a scratch of T B K
floats (the size of alpha) and runs the split forward's chain on them; the
WF backward has two tiers (:func:`wf_backward_tier`): the tiled one (up to
about F = 310) computes ll a window of steps ahead of its chain and adds
eacc a window behind it on two or four more warps a block, eacc in shared
memory, one launch over T; past it the window tier runs, for each window
of 2^17 / B steps, the same tile kernel on the window's feature rows and
then its chain on the tile, acc in the chain's registers and eacc by the
outer sums, so neither W nor a feature row is in its shared memory. Above
K = 64 the WF forward's and backward's chains read each window's
likelihoods (2^17 / B steps), which the same kernel sums from the window's
feature rows before each: the forward the split forward's large-K chain,
its float32 state carried from a window to the next. For 65 <= K <= 256
they launch the large-K instances
(``fused_fwd_wide_kernel<KP, S>``, ``fused_bwd_wide_kernel<KP, S, GATED>``,
KP = 128 or 256 padded states, S in :data:`WIDE_SEQS`): S sequences a block
over one copy of A~, one thread a state, S by the same rule, and the
statistics summed off the chain in an order that does not depend on S, so
every output is the same bits at every S. For 257 <= K <= 1024 the XL
instances (``fused_fwd_xl_kernel<KP, S>``, ``fused_bwd_xl_kernel<KP, S,
GATED>``, KP = 512 or 1024; ``csrc/fb_xl.cuh``) run the same chains with
A~ read from device memory (L2) every step, at every F on likelihoods that
the tile kernel sums a window at a time, as above K = 64 at F > 64; bf16
alpha and ``gamma_sel`` have no XL instance and raise
``NotImplementedError`` there. Above 1024 states the launchers raise.

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
counts of that kernel's launches. :func:`feature_rows` and
:func:`widen_alpha` run the two kernels that make those sums' operands in
the modes below (a window's built feature rows, its bf16 alpha widened),
:func:`likelihood_tile` (twin :func:`likelihood_tile_reference`) the WF
instances' likelihoods, and :func:`prep_launches` reads the three kernels'
counts.

Modes, all of ``pallas_estep_fused``'s: ungated and gated, ``emit_gamma``
True and False, and

* ``in_kernel_feats`` "niw" or "nig" (pallas_fb.py:287 ``_build_feats``):
  ``feats`` holds a Gaussian family's raw observations (T, B, D), and both
  kernels build each step's features [1, y, triu(y y^T)] or [1, y, y * y]
  on the chip, each product one float32 multiply kept as it is, so that the
  rows are ``ell_features(obs)``'s bits and every output is the array
  mode's bit for bit; only D floats a step and sequence cross device memory
  instead of F;
* ``gamma_sel`` (B,) (pallas_fb.py:608 ``sel_mode``): the backward writes
  each sequence's ungated gamma at t = gamma_sel[b] to the (B, K) output
  that otherwise holds w_0 gamma_0 (the windowed engines' per-window pick),
  and no (T, B, K) gamma; it requires ``emit_gamma=False``;
* ``alpha_dtype=torch.bfloat16`` (pallas_fb.py:198 ``_alpha_store_dtype``):
  the forward stores alpha rounded to bf16 while its chain carries float32,
  and s sums the rounded values, so the backward's replay factors 1 / s and
  the alpha it reads are the same stored numbers.

The twins take the same arguments: they build ``ell_features`` of the
observations, round alpha through ``.to(torch.bfloat16)`` where the kernel
stores it, and gather the pick.
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
from .split_fb import (
    check_alpha_dtype,
    exp_params,
    split_backward_reference,
    split_forward_reference,
)

_LIB = "fused_fb"
# the widest feature array of the fused and duplex pairs' first instances
# (fbc::FMAX in csrc/fb_common.cuh, which the duplex library reports): both
# pairs run wider ones on their WF instances
FMAX = 64

# what the kernels read a (t, b) row of (fbc::FEATS_* in csrc/fb_common.cuh):
# the feature array (None), or the raw observations of a Gaussian family
# whose features the kernels build ("niw", "nig")
FEATURE_KINDS = {None: 0, "niw": 1, "nig": 2}


def kind_code(in_kernel_feats: str | None) -> int:
    """The libraries' code of a feature kind; ``ValueError`` on another."""
    if in_kernel_feats not in FEATURE_KINDS:
        raise ValueError(f"unknown in-kernel feature kind {in_kernel_feats!r}; expected one "
                         f"of {tuple(FEATURE_KINDS)}")
    return FEATURE_KINDS[in_kernel_feats]


def feature_width(in_kernel_feats: str | None, D: int) -> int:
    """F of a built kind at D observation dims: 1 + D + D (D + 1) / 2 for
    "niw", 1 + 2 D for "nig"; D itself (the array's width) for None."""
    kind_code(in_kernel_feats)
    if in_kernel_feats == "niw":
        return 1 + D + D * (D + 1) // 2
    return 1 + 2 * D if in_kernel_feats == "nig" else D


def build_features(obs: torch.Tensor, in_kernel_feats: str | None) -> torch.Tensor:
    """The feature rows a built kind's kernels form from obs (..., D), as a
    contiguous float32 array (..., F): the family's ``ell_features`` of the
    float32 observations; obs itself for None."""
    from ..distributions import diag_gaussian, niw

    if in_kernel_feats is None:
        return obs
    build = niw.ell_features if kind_code(in_kernel_feats) == 1 else diag_gaussian.ell_features
    return build(obs.to(torch.float32)).contiguous()


def check_modes(W: torch.Tensor, src: torch.Tensor, in_kernel_feats: str | None,
                emit_gamma: bool = False, gamma_sel: torch.Tensor | None = None,
                alpha_dtype: torch.dtype = torch.float32) -> int:
    """F for a launch in these modes, or ``ValueError`` where JAX raises
    (``pallas_estep_fused``: W's rows not the kind's width, ``gamma_sel``
    with ``emit_gamma``) and where the kernels take no such mode (another
    alpha dtype); on every device."""
    F = feature_width(in_kernel_feats, src.shape[-1])
    if W.shape[0] != F:
        raise ValueError(f"W rows {W.shape[0]} != feature width {F}")
    if gamma_sel is not None and emit_gamma:
        raise ValueError("gamma_sel requires emit_gamma=False")
    check_alpha_dtype(alpha_dtype)
    return F


def _sel_int32(gamma_sel: torch.Tensor | None, B: int, dev: torch.device):
    """The (B,) time pick as the kernel takes it: contiguous int32 on dev."""
    if gamma_sel is None:
        return None
    if tuple(gamma_sel.shape) != (B,) or gamma_sel.is_floating_point():
        raise ValueError(f"gamma_sel must be a ({B},) integer tensor, got "
                         f"{tuple(gamma_sel.shape)} {gamma_sel.dtype}")
    if gamma_sel.device != dev:
        raise ValueError(f"gamma_sel is on {gamma_sel.device}, expected {dev}")
    return gamma_sel.to(torch.int32).contiguous()


def _library():
    """Build (at first use) and bind the kernels' C interface."""
    from .._build import load_library

    return bind(
        load_library(_LIB),
        {"fused_fb_forward": "ppppppppp" "iiiiiii" "p",
         "fused_fb_forward_scratch": "iiiiip",
         "fused_fb_backward": "ppppppppppppp" "iiiiiii" "p",
         "fused_fb_scratch": "iiiiiiip",
         "fused_fb_kernel_info": "iiiiiiip",
         "fused_fb_outer_scratch": "iiip",
         "fused_fb_outer_sum": "pppp" "iiii" "p",
         "fused_fb_outer_launches": "i",
         "fused_fb_build_feats": "pp" "l" "iiii" "p",
         "fused_fb_widen": "pp" "l" "i" "p",
         "fused_fb_prep_launches": "ii",
         "fused_fb_forward_launches": "i",
         "fused_fb_backward_launches": "i",
         "fused_fb_wf_tiled": "iii",
         "fused_fb_ll_tile": "ppp" "l" "iiii" "p",
         "fused_fb_kmax": ""},
        "fused_fb_error_string",
    )


def _check_kernel_limits(K: int) -> None:
    """K the CUDA kernels take (K <= 64 on the S-sequence instances, 65-256
    on the large-K ones, 257-1024 on the XL ones, at any F): raise on a
    larger one instead of falling back."""
    kmax = _library().fused_fb_kmax()
    if K > kmax:
        raise NotImplementedError(f"the fused CUDA kernels take K <= {kmax}, got K={K}")


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
    does, among those the card holds a block of (a WF instance's shared
    memory grows with F: at F = 300 and K = 256, S = 8 does not fit). For the large-K instances (``seqs`` = WIDE_SEQS) that keeps a
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
    fits = [S for S in seqs if resident[S] > 0]
    if not fits:
        raise ValueError(f"no instance of S in {seqs} fits the card: resident blocks {resident}")
    for S in fits:
        if per_group * -(-B // S) <= resident[S]:
            return S
    return fits[-1]


_KERNELS = {"forward": 0, "backward": 1, "gated backward": 2}


def kernel_info(kernel: str, S: int, F: int, device: torch.device | None = None,
                K: int = KMAX_SEQS, in_kernel_feats: str | None = None,
                modes: bool = False) -> dict:
    """What one instance of the kernels takes on the card, from the library:
    ``kernel`` is "forward", "backward" or "gated backward", S the sequences a
    block, F the feature width and K the states (up to 64 the instance built
    for F padded to 16, 32, 48 or 64, or above 64 the WF instance at F;
    above, the large-K instance of K's padded state count, 128 or 256, WF
    above F = 64; above 256 the XL instance of 512 or 1024, one for every F
    and kind, the default mode only), for the feature kind
    ``in_kernel_feats``; ``modes`` names the modes' instance (the forward
    that stores bf16 alpha, the backward that takes it or the gamma pick),
    else the default one. Returns registers (a thread), static_smem and
    dynamic_smem (bytes a block), local_bytes (spills, a thread),
    blocks_per_sm (resident, by the CUDA occupancy calculator; 0 where the
    card cannot give a WF instance its shared memory at F), sms (the card's),
    threads (a block) and groups (the chain groups of S sequences a block
    runs: in the WF backward's tiled tier at S = 2, 2 up to F = 116 and 4
    above, else 1)."""
    dev = device if device is not None else torch.device("cuda")
    return dict(_kernel_info(kernel, S, F, instance_tier(K), device_index(dev),
                             kind_code(in_kernel_feats), modes))


@functools.cache
def _kernel_info(kernel: str, S: int, F: int, K: int, index: int, kind: int = 0,
                 modes: bool = False) -> tuple:
    out = (ctypes.c_int * 8)()
    lib = _library()
    code = lib.fused_fb_kernel_info(_KERNELS[kernel], S, K, F, kind, int(modes), index,
                                    ctypes.addressof(out))
    raise_on(lib.fused_fb_error_string, code,
             f"fused_fb_kernel_info({kernel}, S={S}, K={K}, F={F}, kind={kind}, modes={modes})")
    keys = ("registers", "static_smem", "dynamic_smem", "local_bytes", "blocks_per_sm", "sms",
            "threads", "groups")
    return tuple(zip(keys, list(out)))


def default_seqs(kernel: str, B: int, F: int, device: torch.device, K: int = KMAX_SEQS,
                 in_kernel_feats: str | None = None, modes: bool = False) -> int:
    """The launchers' S: :func:`seqs_per_block` over the instances built for
    K (:func:`built_seqs`), the feature kind and the default or the modes'
    instance (as :func:`kernel_info`) on the card's own occupancy."""
    return _default_seqs(kernel, B, F, instance_tier(K), device_index(device),
                         kind_code(in_kernel_feats), modes)


@functools.cache
def _default_seqs(kernel: str, B: int, F: int, K: int, index: int, kind: int = 0,
                  modes: bool = False) -> int:
    seqs = built_seqs(K)
    info = {S: dict(_kernel_info(kernel, S, F, K, index, kind, modes)) for S in seqs}
    # resident chain groups of S sequences (a block runs several in the WF
    # backward's tiled tier)
    return seqs_per_block(
        B, {S: resident_blocks(i, K) * i["groups"] for S, i in info.items()}, seqs=seqs)


def _seqs(kernel: str, S: int | None, B: int, K: int, F: int, index: int, kind: int = 0,
          modes: bool = False) -> int:
    """S for a launch: the default when None, else a built one or raise."""
    if S is None:
        return _default_seqs(kernel, B, F, instance_tier(K), index, kind, modes)
    if S not in built_seqs(K):
        raise ValueError(f"no {kernel} instance with S={S} at K={K}: built {built_seqs(K)}")
    return S


# ----------------------------------------------------------------- forward


def forward_reference(
    pi_t: torch.Tensor, A_t: torch.Tensor, W: torch.Tensor, feats: torch.Tensor,
    in_kernel_feats: str | None = None, alpha_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the forward kernel.

    pi_t (K,), A_t (K, K) the exponentiated params; W (F, K); feats (T, B, F),
    or the raw observations (T, B, D) of a built kind ``in_kernel_feats``.
    Returns (alpha (T, B, K) raw stored messages, in ``alpha_dtype``; s
    (B, T) their per-step sums, of the stored values; sh (B, T) the max
    shifts). The chain carries float32 whatever alpha's storage."""
    f = build_features(feats, in_kernel_feats)
    return split_forward_reference(pi_t, A_t, f @ W, alpha_dtype)


def fused_forward(
    pi_t: torch.Tensor, A_t: torch.Tensor, W: torch.Tensor, feats: torch.Tensor,
    in_kernel_feats: str | None = None, alpha_dtype: torch.dtype = torch.float32,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Forward kernel launcher; contract of :func:`forward_reference`.

    Inputs are float32 and contiguous on one device. CPU tensors run the
    plain twin; CUDA tensors launch ``fused_fwd_kernel`` or raise. At F > 64
    the launch takes a scratch of the likelihoods, which ``ll_tile_kernel``
    sums before the chain reads them: up to K = 64 T B K floats, one tile
    and one chain launch; above, a window of ``WideStats::window(T, B)``
    steps (2^17 / B) and the chain's carry between windows, one tile and one
    chain launch a window (:func:`forward_launches`); above K = 256 (the XL
    instances) the same at every F. bf16 alpha above 256 states raises
    ``NotImplementedError``."""
    return _launch_forward(None, pi_t, A_t, W, feats, in_kernel_feats, alpha_dtype)


def _launch_forward(S: int | None, pi_t, A_t, W, feats, in_kernel_feats=None,
                    alpha_dtype=torch.float32):
    """:func:`fused_forward` with S sequences a block (one of
    :func:`built_seqs` at this K; None for :func:`default_seqs`): the card
    tests and chip_smoke.py's sweeps of S."""
    T, B, Fin = feats.shape
    K = A_t.shape[0]
    dev = feats.device
    F = check_modes(W, feats, in_kernel_feats, alpha_dtype=alpha_dtype)
    for name, x, shape in (("pi_t", pi_t, (K,)), ("A_t", A_t, (K, K)),
                           ("W", W, (F, K)), ("feats", feats, (T, B, Fin))):
        check(name, x, shape, dev)
    if runs_plain_twin(feats):
        return forward_reference(pi_t, A_t, W, feats, in_kernel_feats, alpha_dtype)
    _check_kernel_limits(K)
    check_xl_modes(K, "fused", bf16_alpha=alpha_dtype == torch.bfloat16)
    lib = _library()
    index = device_index(dev)
    kind = kind_code(in_kernel_feats)
    S = _seqs("forward", S, B, K, F, index, kind, alpha_dtype == torch.bfloat16)
    alpha = torch.empty((T, B, K), dtype=alpha_dtype, device=dev)
    a32, a16 = (alpha, None) if alpha_dtype == torch.float32 else (None, alpha)
    s = torch.empty((B, T), dtype=torch.float32, device=dev)
    sh = torch.empty((B, T), dtype=torch.float32, device=dev)
    work = scratch(lib, "fused_fb_forward_scratch", lib.fused_fb_error_string, dev, T, B, K, F,
                   kind)
    code = lib.fused_fb_forward(
        ptr(pi_t), ptr(A_t), ptr(W), ptr(feats), ptr(a32), ptr(a16), ptr(s), ptr(sh), ptr(work),
        T, B, K, F, S, kind, index, stream(dev),
    )
    fused_forward.launches += 1
    count_xl(fused_forward, K)
    count_mode(fused_forward, in_kernel_feats, alpha_dtype=alpha_dtype)
    count_wide(fused_forward, K, F, in_kernel_feats, alpha_dtype=alpha_dtype)
    raise_on(lib.fused_fb_error_string, code, "fused_fwd_kernel")
    return alpha, s, sh


fused_forward.launches = 0


def count_mode(fn, in_kernel_feats, gamma_sel=None, alpha_dtype=torch.float32,
               counts: dict | None = None) -> None:
    """Add one to a launcher's ``mode_launches`` (or to ``counts``) for each
    mode its launch ran in (the fused and the duplex launchers')."""
    counts = fn.mode_launches if counts is None else counts
    for mode, on in ((in_kernel_feats, in_kernel_feats is not None),
                     ("gamma_sel", gamma_sel is not None),
                     ("bf16", alpha_dtype == torch.bfloat16)):
        if on:
            counts[mode] = counts.get(mode, 0) + 1


def count_wide(fn, K, F, in_kernel_feats, gamma_sel=None, alpha_dtype=torch.float32,
               width_tier: str | None = None) -> None:
    """A launch of a WF instance (F > FMAX): one more in the launcher's
    ``wf_launches`` under its tier (64, 128 or 256 states, as
    ``_launch.instance_tier``), under ``width_tier`` (the backward's up to
    K = 64: "tiled" or "window", :func:`wf_backward_tier`) where given, and
    in ``wf_mode_launches`` for each mode."""
    if F > FMAX:
        tier = instance_tier(K)
        fn.wf_launches[tier] = fn.wf_launches.get(tier, 0) + 1
        if width_tier is not None:
            fn.wf_launches[width_tier] = fn.wf_launches.get(width_tier, 0) + 1
        count_mode(fn, in_kernel_feats, gamma_sel, alpha_dtype, fn.wf_mode_launches)


fused_forward.mode_launches = {}
fused_forward.wf_launches = {}
fused_forward.wf_mode_launches = {}
fused_forward.xl_launches = {}


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
    in_kernel_feats: str | None = None,
    gamma_sel: torch.Tensor | None = None,
) -> tuple[torch.Tensor | None, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the backward kernel.

    Takes the forward's (alpha (T, B, K), float32 or bf16 as stored, s
    (B, T), sh (B, T)), an optional kept-mask weights (T, B) and feats as
    the forward's. Returns (gamma (T, B, K), ungated, or None; gamma0 =
    w_0 gamma_0 (B, K), or with ``gamma_sel`` (B,) each sequence's ungated
    gamma at t = gamma_sel[b] (zeros outside 0 .. T-1); acc (K, K) = sum
    over sequences and t of outer(alpha_{t-1}, d_t n_t g_t); eacc (K, F) =
    sum of outer(w_t gamma_t, f_t)), with w = g = 1 when ungated."""
    f = build_features(feats, in_kernel_feats)
    T, B, F = f.shape
    K = A_t.shape[0]
    wide = torch.promote_types(alpha.dtype, torch.float32)  # bf16 read as float32
    gamma, acc = split_backward_reference(A_t, f @ W, alpha.to(wide), s, sh, weights)
    gamma_w = gamma if weights is None else gamma * weights[..., None]
    eacc = gamma_w.reshape(T * B, K).T @ f.reshape(T * B, F)
    if gamma_sel is None:
        gamma0 = gamma_w[0].clone()
    else:
        sel = gamma_sel.to(device=gamma.device, dtype=torch.long)
        inside = (sel >= 0) & (sel < T)
        gamma0 = gamma[sel.clamp(0, T - 1), torch.arange(B, device=gamma.device)]
        gamma0 = torch.where(inside[:, None], gamma0, torch.zeros_like(gamma0))
    return (gamma if emit_gamma else None), gamma0, acc, eacc


def fused_backward(
    A_t: torch.Tensor,
    W: torch.Tensor,
    feats: torch.Tensor,
    alpha: torch.Tensor,
    s: torch.Tensor,
    sh: torch.Tensor,
    emit_gamma: bool = False,
    weights: torch.Tensor | None = None,
    in_kernel_feats: str | None = None,
    gamma_sel: torch.Tensor | None = None,
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
    csrc/fb_stats.cuh); bf16 alpha and a built kind add a window's widened
    alpha and feature rows, F > 64 a window's likelihoods (0.13 GB at
    K = 256). Up to K = 64 past the tiled tier (:func:`wf_backward_tier`
    "window") it takes a window's w_t gamma_t and likelihoods, n K floats
    each for n = min(T B, max(B, 2^17)) rows (32 MiB each at K = 64,
    B = 1024), a row of acc partials a block, the carried beta, eacc's
    outer-sum partials and, for a built kind, a window's feature rows
    (n F floats: 0.43 GB at F = 820). Above K = 256 (the XL instances, at
    every F) it takes a window's dn, w_t gamma_t and likelihoods, n K floats
    each (0.54 GB each at K = 1024, B = 1024), the carried beta, the sums'
    partials and A~^T (K K floats); alpha and gamma are T B K floats each
    (4.2 GB each at K = 1024, B = 1024, T = 1000), all of which fits the
    H100's 80 GB. bf16 alpha and ``gamma_sel`` above 256 states raise
    ``NotImplementedError``."""
    return _launch_backward(None, A_t, W, feats, alpha, s, sh, emit_gamma, weights,
                            in_kernel_feats, gamma_sel)


def _launch_backward(S: int | None, A_t, W, feats, alpha, s, sh, emit_gamma=False,
                     weights=None, in_kernel_feats=None, gamma_sel=None):
    """:func:`fused_backward` with S sequences a block, as
    :func:`_launch_forward`."""
    T, B, Fin = feats.shape
    K = A_t.shape[0]
    dev = feats.device
    F = check_modes(W, feats, in_kernel_feats, emit_gamma, gamma_sel, alpha.dtype)
    args = [("A_t", A_t, (K, K)), ("W", W, (F, K)), ("feats", feats, (T, B, Fin)),
            ("s", s, (B, T)), ("sh", sh, (B, T))]
    if weights is not None:
        args.append(("weights", weights, (T, B)))
    for name, x, shape in args:
        check(name, x, shape, dev)
    check("alpha", alpha, (T, B, K), dev, alpha.dtype)
    sel = _sel_int32(gamma_sel, B, dev)
    if runs_plain_twin(feats):
        return backward_reference(A_t, W, feats, alpha, s, sh, emit_gamma, weights,
                                  in_kernel_feats, sel)
    _check_kernel_limits(K)
    check_xl_modes(K, "fused", bf16_alpha=alpha.dtype == torch.bfloat16,
                   gamma_sel=sel is not None)
    lib = _library()
    kernel = "backward" if weights is None else "gated backward"
    index = device_index(dev)
    kind = kind_code(in_kernel_feats)
    bf16 = alpha.dtype == torch.bfloat16
    S = _seqs(kernel, S, B, K, F, index, kind, bf16 or sel is not None)
    gamma = torch.empty((T, B, K), dtype=torch.float32, device=dev) if emit_gamma else None
    gamma0 = torch.empty((B, K), dtype=torch.float32, device=dev)
    stats = torch.empty(K * K + K * F, dtype=torch.float32, device=dev)  # acc, then eacc
    work = scratch(lib, "fused_fb_scratch", lib.fused_fb_error_string, dev, T, B, K, F, S, kind,
                   int(bf16))
    a32, a16 = (None, alpha) if bf16 else (alpha, None)
    code = lib.fused_fb_backward(
        ptr(A_t), ptr(W), ptr(feats), ptr(a32), ptr(a16), ptr(s), ptr(sh),
        ptr(weights), ptr(sel), ptr(gamma), ptr(gamma0), ptr(stats), ptr(work),
        T, B, K, F, S, kind, index, stream(dev),
    )
    acc, eacc = stats[: K * K].view(K, K), stats[K * K:].view(K, F)
    fused_backward.launches += 1
    count_xl(fused_backward, K)
    count_mode(fused_backward, in_kernel_feats, sel, alpha.dtype)
    width_tier = _wf_backward_tier(S, K, F) if F > FMAX and K <= KMAX_SEQS else None
    count_wide(fused_backward, K, F, in_kernel_feats, sel, alpha.dtype, width_tier)
    raise_on(lib.fused_fb_error_string, code, "fused_bwd_kernel")
    return gamma, gamma0, acc, eacc


fused_backward.launches = 0
fused_backward.mode_launches = {}
fused_backward.wf_launches = {}
fused_backward.wf_mode_launches = {}
fused_backward.xl_launches = {}


def wf_backward_tier(S: int, K: int, F: int) -> str:
    """The tier of the fused backward's WF instance with S sequences a block
    at K <= 64 states and F > :data:`FMAX` features (of any kind), as the
    library chooses it before launch from (S, F) alone: "tiled" where its
    shared memory (eacc, the feature and likelihood rings beside the
    chain's arrays) fits a block (up to F = 316 at S = 4, 308 at S = 2),
    else "window" (a likelihood tile, a chain launch and eacc's outer sums
    a window of 2^17 / B steps, at any F); the launches count under it in
    ``fused_backward.wf_launches``. Needs the library (the card's build)."""
    if K > KMAX_SEQS or F <= FMAX:
        raise ValueError(f"the WF backward's tiers are for K <= {KMAX_SEQS} and F > {FMAX}, "
                         f"got K={K}, F={F}")
    return _wf_backward_tier(S, K, F)


@functools.cache
def _wf_backward_tier(S: int, K: int, F: int) -> str:
    return "tiled" if _library().fused_fb_wf_tiled(S, K, F) else "window"


def forward_launches(clear: bool = False) -> int:
    """Launches of the forward's chain kernels by the library since the
    count was last cleared: one a call, one a window of time steps above
    K = 64 at F > 64. Clears the count when ``clear``. 0 before the library
    is loaded."""
    from .._build import loaded_library

    lib = loaded_library(_LIB)
    if lib is None:
        return 0
    fn = lib.fused_fb_forward_launches
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(int(clear))


def backward_launches(clear: bool = False) -> int:
    """Launches of the backward's chain kernels by the library since the
    count was last cleared: one a call up to K = 64 (the WF tiled tier
    included), one a window of time steps above and in the WF window tier.
    Clears the count when ``clear``. 0 before the library is loaded."""
    from .._build import loaded_library

    lib = loaded_library(_LIB)
    if lib is None:
        return 0
    fn = lib.fused_fb_backward_launches
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return fn(int(clear))


def reset_launch_counts() -> None:
    fused_forward.launches = 0
    fused_backward.launches = 0
    for fn in (fused_forward, fused_backward):
        fn.mode_launches.clear()
        fn.wf_launches.clear()
        fn.wf_mode_launches.clear()
        fn.xl_launches.clear()
    outer_sum.launches = 0
    feature_rows.launches = 0
    widen_alpha.launches = 0
    likelihood_tile.launches = 0


# ------------------------------------------------------------- outer sums

OUTER_MAX = 1024  # the widest X: K states (acc and eacc); Y takes any F (eacc's features)
# the libraries whose large-K launchers run the outer sums (csrc/fb_stats.cuh)
OUTER_LIBS = ("fused_fb", "split_fb", "duplex_fb")


def outer_sum_reference(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """Plain twin of the outer sums: X^T Y (I, J) for X (N, I), Y (N, J)."""
    return X.T @ Y


def outer_sum(X: torch.Tensor, Y: torch.Tensor) -> torch.Tensor:
    """The large-K statistics' outer sums alone: sum over the rows n of
    outer(X[n], Y[n]) = X^T Y, (I, J), for float32 X (N, I) and Y (N, J),
    contiguous on one device, N >= 1, 1 <= I <= :data:`OUTER_MAX` (1024, the
    XL tiers' K) and J >= 1.

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
    if N < 1 or not (1 <= I <= OUTER_MAX and J >= 1):
        raise ValueError(f"outer_sum takes N >= 1 rows, 1 to {OUTER_MAX} columns of X and at "
                         f"least one of Y, got "
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


# ----------------------------------------------- the large-K operand kernels

# the operand kernels of the large-K statistics and the WF likelihoods
# (csrc/fb_stats.cuh), by the libraries' index, and the libraries that run
# them: the fused pair all of them (the likelihood tile at F > 64: the
# forward up to K = 64 on its 64-state tile, the backward above on its
# 128-state one), the duplex combine the feature build, the split backward
# the widening
PREP_KERNELS = {"build_feats_kernel": 0, "widen_kernel": 1, "ll_tile_kernel<64>": 2,
                "ll_tile_kernel<128>": 3}
PREP_LIBS = ("fused_fb", "duplex_fb", "split_fb")


def feature_rows(obs: torch.Tensor, in_kernel_feats: str) -> torch.Tensor:
    """The built features of observation rows obs (N, D), float32 (N, F):
    ``csrc/fb_stats.cuh::build_feats_kernel``, which the large-K fused
    backward, the K <= 64 fused WF backward's window tier and the duplex
    combine run on each window of their statistics in a built kind, there
    the eacc sums' feature operand (and the window tier's likelihood tile's
    rows). Each product one float32 multiply kept as it is, so the rows are
    :func:`build_features`' (its plain twin's) bits. CPU tensors run the
    twin; CUDA tensors launch the kernel or raise."""
    if in_kernel_feats is None or obs.dim() != 2:
        raise ValueError(f"feature_rows takes a built kind and (N, D) rows, got "
                         f"{in_kernel_feats!r} and {tuple(obs.shape)}")
    N, D = obs.shape
    F = feature_width(in_kernel_feats, D)
    check("obs", obs, (N, D), obs.device)
    if runs_plain_twin(obs):
        return build_features(obs, in_kernel_feats)
    lib = _library()
    out = torch.empty((N, F), dtype=torch.float32, device=obs.device)
    index = device_index(obs.device)
    code = lib.fused_fb_build_feats(ptr(obs), ptr(out), N, D, F, kind_code(in_kernel_feats),
                                    index, stream(obs.device))
    feature_rows.launches += 1
    raise_on(lib.fused_fb_error_string, code, "build_feats_kernel")
    return out


def widen_alpha(alpha: torch.Tensor) -> torch.Tensor:
    """bf16 alpha widened to float32, same shape:
    ``csrc/fb_stats.cuh::widen_kernel``, which the large-K fused backward
    runs on each window of stored bf16 alpha, there the acc sums' alpha
    operand. Plain twin: ``alpha.to(torch.float32)``. CPU tensors run the
    twin; CUDA tensors launch the kernel or raise."""
    if alpha.dtype != torch.bfloat16 or alpha.numel() < 1:
        raise ValueError(f"widen_alpha takes a non-empty bf16 tensor, got {alpha.dtype} "
                         f"{tuple(alpha.shape)}")
    check("alpha", alpha, tuple(alpha.shape), alpha.device, torch.bfloat16)
    if runs_plain_twin(alpha):
        return alpha.to(torch.float32)
    lib = _library()
    out = torch.empty(alpha.shape, dtype=torch.float32, device=alpha.device)
    index = device_index(alpha.device)
    code = lib.fused_fb_widen(ptr(alpha), ptr(out), alpha.numel(), index, stream(alpha.device))
    widen_alpha.launches += 1
    raise_on(lib.fused_fb_error_string, code, "widen_kernel")
    return out


feature_rows.launches = 0
widen_alpha.launches = 0

LL_BLOCK = 64  # features a block of ll's sum (fbc::FMAX): the chain kernels' order


def likelihood_tile_reference(X: torch.Tensor, W: torch.Tensor,
                              in_kernel_feats: str | None = None) -> torch.Tensor:
    """Plain twin of the likelihood tile: the feature rows of X (N, F) --
    with ``in_kernel_feats`` "niw" or "nig" the raw observations (N, D),
    whose ``ell_features`` it builds -- times W (F, K), summed in blocks of
    :data:`LL_BLOCK` features, each block's product added to the blocks'
    before in order."""
    X = build_features(X, in_kernel_feats)
    out = X[:, :LL_BLOCK] @ W[:LL_BLOCK]
    for f0 in range(LL_BLOCK, X.shape[1], LL_BLOCK):
        out = out + X[:, f0:f0 + LL_BLOCK] @ W[f0:f0 + LL_BLOCK]
    return out


def likelihood_tile(X: torch.Tensor, W: torch.Tensor,
                    in_kernel_feats: str | None = None) -> torch.Tensor:
    """The fused WF instances' likelihoods alone: the feature rows of X
    (N, F) -- or with ``in_kernel_feats`` "niw" / "nig" of the raw
    observations (N, D), built where they are staged -- times W (F, K),
    float32 (N, K), for contiguous float32 X and W on one device.

    The kernel (``csrc/fb_stats.cuh::ll_tile_kernel``, the ll half of
    ``_fwd_kernel_fused`` and ``_bwd_kernel_fused``, pallas_fb.py:516 and
    :577) is the one the fused forward runs over all rows up to K = 64 at
    F > 64, before the chain that reads its output, and the fused backward
    over each window of its statistics above K = 64 at F > 64: each element
    the chain kernels' own sum (a fmaf chain over each block of 64
    features, from zero, in feature order, the blocks added in order),
    float32 FFMA. CPU tensors run :func:`likelihood_tile_reference`; CUDA
    tensors launch the kernel or raise."""
    if X.dim() != 2 or W.dim() != 2:
        raise ValueError(f"likelihood_tile takes X (N, F) and W (F, K), got {tuple(X.shape)} "
                         f"and {tuple(W.shape)}")
    (N, Fin), K = X.shape, W.shape[1]
    F = feature_width(in_kernel_feats, Fin)
    dev = X.device
    check("X", X, (N, Fin), dev)
    check("W", W, (F, K), dev)
    if N < 1 or K < 1:
        raise ValueError(f"likelihood_tile takes non-empty X and W, got {tuple(X.shape)}, "
                         f"{tuple(W.shape)}")
    if runs_plain_twin(X):
        return likelihood_tile_reference(X, W, in_kernel_feats)
    lib = _library()
    out = torch.empty((N, K), dtype=torch.float32, device=dev)
    index = device_index(dev)
    code = lib.fused_fb_ll_tile(ptr(X), ptr(W), ptr(out), N, F, K, kind_code(in_kernel_feats),
                                index, stream(dev))
    likelihood_tile.launches += 1
    raise_on(lib.fused_fb_error_string, code, "ll_tile_kernel")
    return out


likelihood_tile.launches = 0


def prep_launches(kernel: str, clear: bool = False) -> int:
    """Launches of one operand kernel (:data:`PREP_KERNELS`) since the
    counts were last cleared, over the libraries loaded so far
    (:data:`PREP_LIBS`): each library counts where it launches the kernel,
    inside the large-K backward and combine launchers and in
    :func:`feature_rows` and :func:`widen_alpha`. Clears that count when
    ``clear``."""
    from .._build import loaded_library

    total = 0
    for name in PREP_LIBS:
        lib = loaded_library(name)
        if lib is not None:
            fn = getattr(lib, f"{name}_prep_launches")
            fn.argtypes, fn.restype = [ctypes.c_int, ctypes.c_int], ctypes.c_int
            total += fn(PREP_KERNELS[kernel], int(clear))
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
    gamma_sel: torch.Tensor | None = None,
    in_kernel_feats: str | None = None,
    alpha_dtype: torch.dtype = torch.float32,
) -> tuple[FBResult, torch.Tensor]:
    """Fused batched E-step: likelihoods + forward-backward + all stats.

    log_pi (K,), log_A (K, K); W (F, K) float32 feature weights with
    ll = feats @ W; feats (T, B, F) float32, TIME-MAJOR and contiguous, or
    with ``in_kernel_feats`` "niw" / "nig" the raw observations (T, B, D)
    whose features the kernels build; weights: optional (T, B) float32
    kept-mask (SVI windows).
    Returns (FBResult, emit_stats (K, F)). FBResult holds log_c (B, T),
    log_z (B,), init_stats = w_0 gamma_0 (B, K) -- with ``gamma_sel`` (B,)
    each sequence's ungated gamma at t = gamma_sel[b] instead --,
    trans_stats summed over sequences and pair-gated (K, K) and gamma
    (T, B, K), ungated, when ``emit_gamma`` else None. emit_stats = sum over
    sequences and t of outer(w_t gamma_t, f_t). ``alpha_dtype`` is the
    stored alpha's (torch.bfloat16 rounds it; evaluation callers keep
    float32). The mode checks (:func:`check_modes`) raise ``ValueError``
    before anything runs.

    CPU tensors run the plain twins; CUDA tensors run the two kernels."""
    check_modes(W, feats, in_kernel_feats, emit_gamma, gamma_sel, alpha_dtype)
    pi_t, A_t = exp_params(log_pi, log_A)
    alpha, s, sh = fused_forward(pi_t, A_t, W, feats, in_kernel_feats, alpha_dtype)
    gamma, gamma0, acc, eacc = fused_backward(
        A_t, W, feats, alpha, s, sh, emit_gamma, weights, in_kernel_feats, gamma_sel
    )
    return assemble(A_t, s, sh, gamma, gamma0, acc, eacc)


def estep_fused_reference(
    log_pi: torch.Tensor,
    log_A: torch.Tensor,
    W: torch.Tensor,
    feats: torch.Tensor,
    emit_gamma: bool = False,
    weights: torch.Tensor | None = None,
    gamma_sel: torch.Tensor | None = None,
    in_kernel_feats: str | None = None,
    alpha_dtype: torch.dtype = torch.float32,
) -> tuple[FBResult, torch.Tensor]:
    """Plain PyTorch version of :func:`estep_fused` on any device."""
    check_modes(W, feats, in_kernel_feats, emit_gamma, gamma_sel, alpha_dtype)
    pi_t, A_t = exp_params(log_pi, log_A)
    alpha, s, sh = forward_reference(pi_t, A_t, W, feats, in_kernel_feats, alpha_dtype)
    gamma, gamma0, acc, eacc = backward_reference(
        A_t, W, feats, alpha, s, sh, emit_gamma, weights, in_kernel_feats, gamma_sel
    )
    return assemble(A_t, s, sh, gamma, gamma0, acc, eacc)
