"""Decompose the split forward's time on the card: the split kernels and the
probes of ``messages/split_probe.py``, each timed alone (port of
``scripts/debug_pallas_split.py``).

Usage, on a machine with an NVIDIA GPU and nvcc::

    python -m pysvihmm_tpu_torch.scripts.debug_split [B] [tile_b] [C] [which] [K]

with the JAX script's positions and defaults: B = 1024 sequences, tile_b =
1024, C = 8 steps a tile, which = "fb", K = 64 states, and T = 1000 steps.
K takes up to 256 states, as in the JAX script (:78): above 64 the kernels'
large-K instances run.
Each letter of ``which`` times one variant (:data:`VARIANTS`, in the JAX
script's order):

* ``f`` / ``b``: the split forward / backward kernels (``split_fb.py``) on
  ll = log(lik). The JAX script is stale there: it passes ``m=`` (:90),
  which ``_fwd_kernel`` no longer takes, and 1/s as the backward's scales
  (:288-289); the port runs the current launchers, the backward on the
  forward's own alpha, s and sh.
* ``n``: the forward with no scale output, renormalised every 4th step and
  per tile; ``s``: the same with each step's sum stored.
* ``1``: the products alone; ``2``: with their stores; ``3``: in bf16;
  ``4`` / ``5``: what ``2`` computes, with 8 / 4 sequences in one block (the
  TPU's interleaved chunks read as independent chains in flight on one SM).

tile_b must divide B, as the JAX grid's B // tile_b requires; it has no
other meaning on Hopper, where each kernel takes one sequence a block
(CHUNKED several). Inputs, as the JAX script draws them (:81-86), from
seeded ``torch.Generator`` s on the card: lik ~ U[0.01, 1) (T, B, K), pi =
1/K, A's rows Dirichlet(1). Each variant is timed with CUDA events over 20
launches after a warm-up (the JAX script chained 20 calls in one
``lax.scan``); each line gives ms per launch, the kernel's least time
(``utils/roofline.py``) and its share of it, and the last line is the
card's name and power limit. Without a card it raises: there is no CPU
fallback.
"""

from __future__ import annotations

import subprocess
import sys

import torch

from ..messages import split_fb, split_probe
from ..utils.roofline import MICRO_KERNELS, bound, kernel_work

T_STEPS = 1000  # debug_pallas_split.py:77
ITERS = 20  # debug_pallas_split.py:144

# letter -> (the JAX script's label, the kernel it times), in that script's order
VARIANTS = {
    "4": ("chunk8", MICRO_KERNELS["chunk8"]),
    "5": ("chunk4", MICRO_KERNELS["chunk4"]),
    "f": ("fwd", "split_fwd_kernel"),
    "n": ("fwd_nos", "probe_fwd_nos_kernel"),
    "s": ("fwd_stack", "probe_fwd_stack_kernel"),
    "1": ("dot_only", MICRO_KERNELS["dot_only"]),
    "2": ("dot_store", MICRO_KERNELS["dot_store"]),
    "3": ("dot_bf16", MICRO_KERNELS["dot_bf16"]),
    "b": ("bwd", "split_bwd_kernel"),
}


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 1) -> float:
    """Mean milliseconds per call on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def make_inputs(B: int, T: int, K: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(pi (K,), A (K, K), lik (T, B, K)) float32 on ``device``: lik ~
    U[0.01, 1) from seed 0, A's rows Dirichlet(1) (normalised Exp(1) draws)
    from seed 1, pi = 1/K."""
    g_lik = torch.Generator(device=device).manual_seed(0)
    g_A = torch.Generator(device=device).manual_seed(1)
    lik = 0.01 + 0.99 * torch.rand((T, B, K), generator=g_lik, device=device)
    e = torch.empty((K, K), device=device).exponential_(generator=g_A)
    A = (e / e.sum(dim=-1, keepdim=True)).contiguous()
    pi = torch.full((K,), 1.0 / K, device=device)
    return pi, A, lik


def variants(letters: str, pi, A, lik, C: int, plain: bool = False) -> dict[str, object]:
    """{label: a call of that variant}, for each letter in ``letters`` in
    :data:`VARIANTS` order: the kernel launchers, or their plain twins when
    ``plain``."""
    unknown = set(letters) - set(VARIANTS)
    if unknown:
        raise ValueError(f"unknown letters {sorted(unknown)}; expected some of {''.join(VARIANTS)}")
    sp = split_probe
    if plain:
        fwd, bwd = split_fb.split_forward_reference, split_fb.split_backward_reference
        nos, stack = sp.probe_fwd_nos_reference, sp.probe_fwd_stack_reference
        micro = sp.probe_micro_reference
    else:
        fwd, bwd = split_fb.split_forward, split_fb.split_backward
        nos, stack, micro = sp.probe_fwd_nos, sp.probe_fwd_stack, sp.probe_micro
    ll = torch.log(lik) if "f" in letters or "b" in letters else None
    fb_out = fwd(pi, A, ll) if "b" in letters else None  # the backward's inputs
    calls = {
        "fwd": lambda: fwd(pi, A, ll),
        "bwd": lambda: bwd(A, ll, *fb_out),
        "fwd_nos": lambda: nos(pi, A, lik, C),
        "fwd_stack": lambda: stack(pi, A, lik, C),
    }
    for body in sp.MICRO_BODIES:
        calls[body] = lambda body=body: micro(pi, A, lik, C, body)
    return {VARIANTS[c][0]: calls[VARIANTS[c][0]] for c in VARIANTS if c in letters}


def time_letters(letters: str, pi, A, lik, C: int, plain: bool = False, iters: int = ITERS,
                 warmup: int = 1) -> dict[str, float]:
    """{label: ms per call} of each variant in ``letters`` (kernels, or the
    twins when ``plain``) on the card, by CUDA events."""
    if lik.device.type != "cuda":
        raise RuntimeError("debug_split times the kernels on an NVIDIA GPU; lik is on "
                           f"{lik.device}")
    return {label: cuda_ms(call, iters, warmup)
            for label, call in variants(letters, pi, A, lik, C, plain).items()}


def bound_ms(label: str, B: int, T: int, K: int, C: int) -> tuple[float, str]:
    """A variant's least time on the card (ms) and what sets it."""
    kernel = {lab: name for lab, name in VARIANTS.values()}[label]
    return bound(*kernel_work(kernel, B, T, K, C=C))


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    B = int(argv[0]) if len(argv) > 0 else 1024
    tile_b = int(argv[1]) if len(argv) > 1 else 1024
    C = int(argv[2]) if len(argv) > 2 else 8
    which = argv[3] if len(argv) > 3 else "fb"
    K = int(argv[4]) if len(argv) > 4 else 64
    T = T_STEPS
    if not torch.cuda.is_available():
        raise RuntimeError("debug_split needs an NVIDIA GPU: the kernels it times run only there")
    if tile_b < 1 or B % tile_b:
        raise ValueError(f"tile_b={tile_b} must divide B={B}")
    pi, A, lik = make_inputs(B, T, K, torch.device("cuda", 0))
    print(f"B={B} tile_b={tile_b} C={C} T={T} K={K} which={which!r}", flush=True)
    for label, ms in time_letters(which, pi, A, lik, C).items():
        b_ms, by = bound_ms(label, B, T, K, C)
        print(f"{label:10s} {ms:8.3f} ms/it  bound {b_ms:.4f} ms ({by}), "
              f"{100 * b_ms / ms:.1f} % of it", flush=True)
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
