"""Time the split E-step pair on the card at the VB shape (B=1024, T=1000,
log-likelihoods ll = feats @ W of a Gaussian-NIW at D=8) for K = 64 and any
other K given (up to 256): the forward, the backward ungated and gated (kept
runs of 5T/7) and the whole split E-step, each with its share of the
kernel's bound (``utils/roofline.py``); where the checkout's launchers take
``S=`` (sequences a block), each kernel at every S it is built for too. Then
the pair at the SVI shape (the first W=70 steps, one kept run of L=50 a
sequence, the backward gated) for B = 32, 256 and 1024, and each backward
call's kernels by device time (torch.profiler), which parts the large-K
backward into its chain and its outer sums.

Usage, on a machine with an NVIDIA GPU and nvcc, from the repository root::

    PYTHONPATH=<checkout> python pysvihmm_tpu_torch/scripts/time_split.py [reps] [K ...]

It imports the ``pysvihmm_tpu_torch`` of ``<checkout>`` (``.`` for this one)
and calls only ``split_forward``, ``split_backward`` and ``estep_split``
with the signatures they have had since the split route was ported (the
backward's gate is the kept-mask where the checkout's launchers take ``S=``,
and the pair gate w_{t-1} w_t before), with ``time_fused.py``'s inputs, so
the same file times an earlier checkout too: two checkouts are compared in
one call, in turns. Each line gives ms per launch by CUDA events, 20
launches after 3 warm-ups, ``reps`` times (default 3), and their median and
minimum. The first lines of each K carry the sha256 of every output (the
forward's alpha, s, sh; the backward's gamma and acc, ungated and gated), so
that two checkouts' bits compare, and whether every S gave the same bits;
the last line is the card's name and power limit. Without a card it raises.
"""

from __future__ import annotations

import inspect
import sys

import torch

import pysvihmm_tpu_torch
from pysvihmm_tpu_torch.messages import split_fb
from pysvihmm_tpu_torch.scripts.debug_split import card_line, cuda_ms
from pysvihmm_tpu_torch.scripts.time_duplex import SVI_L, SVI_W, digest, report
from pysvihmm_tpu_torch.scripts.time_fused import B, T, inputs, profile_call
from pysvihmm_tpu_torch.utils.roofline import bound, kernel_work

SVI_BATCHES = (32, 256, 1024)
KINDS = ("forward", "backward", "gated backward")


def takes_seqs() -> bool:
    """The checkout's launchers take S= (and the backward a kept-mask)."""
    return "S" in inspect.signature(split_fb.split_forward).parameters


def gate(w: torch.Tensor) -> torch.Tensor:
    """The backward's gate argument for kept-mask w (T, B): w itself where
    the kernel forms the pair gate, else the pair gate w_{t-1} w_t."""
    if takes_seqs():
        return w
    return torch.cat([torch.zeros_like(w[:1]), w[:-1] * w[1:]], dim=0).contiguous()


def seqs(kind: str, k: int) -> tuple:
    """(None,) and every built S of ``kind`` at k where the checkout has S."""
    if not takes_seqs():
        return (None,)
    return (None, *split_fb.built_seqs(kind, k))


def calls(kind: str, S, pi_t, A_t, ll, fwd, g):
    """One launch of ``kind`` at S (None: the launcher's default)."""
    kw = {} if S is None else {"S": S}
    if kind == "forward":
        return lambda: split_fb.split_forward(pi_t, A_t, ll, **kw)
    if kind == "backward":
        return lambda: split_fb.split_backward(A_t, ll, *fwd, **kw)
    return lambda: split_fb.split_backward(A_t, ll, *fwd, g, **kw)


def work(kind: str, b: int, t: int, k: int) -> float:
    name = "split_fwd_kernel" if kind == "forward" else "split_bwd_kernel"
    return bound(*kernel_work(name, b, t, k, 0, gated=kind == "gated backward"))[0]


def time_at(k: int, reps: int, dev: torch.device) -> None:
    log_pi, log_A, W, feats, w = inputs(dev, k)
    ll = (feats @ W).contiguous()
    del feats
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    g = gate(w)
    fwd = split_fb.split_forward(pi_t, A_t, ll)
    print(f"package {pysvihmm_tpu_torch.__file__}; (B, T, K) = ({B}, {T}, {k}); "
          f"split_fwd_kernel's alpha, s, sh: sha256 {digest(*fwd)}", flush=True)
    for kind in KINDS[1:]:
        out = calls(kind, None, pi_t, A_t, ll, fwd, g)()
        same = []
        for S in seqs(kind, k)[1:]:
            same.append(all(torch.equal(x, y)
                            for x, y in zip(calls(kind, S, pi_t, A_t, ll, fwd, g)(), out)))
        print(f"split_bwd_kernel ({kind})'s gamma, acc: sha256 {digest(*out)}"
              + (f"; the same bits at every S {seqs(kind, k)[1:]}: {all(same)}" if same else ""),
              flush=True)
        del out
    same = [all(torch.equal(x, y) for x, y in zip(calls("forward", S, pi_t, A_t, ll, fwd, g)(),
                                                 fwd)) for S in seqs("forward", k)[1:]]
    if same:
        print(f"split_fwd_kernel: the same bits at every S {seqs('forward', k)[1:]}: {all(same)}",
              flush=True)
    for kind in KINDS:
        for S in seqs(kind, k):
            name = f"split {kind}" + ("" if S is None else f", S={S}")
            report(name, [cuda_ms(calls(kind, S, pi_t, A_t, ll, fwd, g), 20, warmup=3)
                          for _ in range(reps)], work(kind, B, T, k))
    e_ms = sum(work(kind, B, T, k) for kind in KINDS[:2])
    report("estep_split", [cuda_ms(lambda: split_fb.estep_split(log_pi, log_A, ll), 20, warmup=3)
                           for _ in range(reps)], e_ms)
    report("estep_split, gated", [cuda_ms(lambda: split_fb.estep_split(log_pi, log_A, ll, w), 20,
                                          warmup=3) for _ in range(reps)], e_ms)
    for kind in KINDS[1:]:
        profile_call(f"split {kind}", calls(kind, None, pi_t, A_t, ll, fwd, g))
    del fwd
    # the SVI shape: the first W steps, one kept run of L a sequence
    for bs in SVI_BATCHES:
        lw = ll[:SVI_W, :bs].contiguous()
        offs = torch.randint(0, SVI_W - SVI_L + 1, (bs,),
                             generator=torch.Generator(device=dev).manual_seed(5), device=dev)
        t = torch.arange(SVI_W, device=dev)[:, None]
        m = ((t >= offs) & (t < offs + SVI_L)).to(torch.float32).contiguous()
        fw = split_fb.split_forward(pi_t, A_t, lw)
        gw = gate(m)
        for kind in ("forward", "gated backward"):
            for S in seqs(kind, k):
                name = f"split {kind} at the SVI shape (B, W) = ({bs}, {SVI_W})" + (
                    "" if S is None else f", S={S}")
                report(name, [cuda_ms(calls(kind, S, pi_t, A_t, lw, fw, gw), 20, warmup=3)
                              for _ in range(reps)], work(kind, bs, SVI_W, k))


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("time_split needs an NVIDIA GPU: the kernels run only on the card")
    reps = int(argv[0]) if argv else 3
    dev = torch.device("cuda", 0)
    for k in dict.fromkeys([64, *map(int, argv[1:])]):
        time_at(k, reps, dev)
        torch.cuda.empty_cache()
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
