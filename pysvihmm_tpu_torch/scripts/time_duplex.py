"""Time the duplex E-step pair on the card at the VB shape (B=1024, T=1000,
a Gaussian-NIW at D=8: F=45, or at the D given: D=10 F=66, D=23 F=300, the
WF instances above F = 64) for K = 64 and any other K given (up to 256):
the chain (also at B=32), the combine ungated and gated (kept runs of 5T/7)
and the whole duplex E-step, each with its share of the kernel's bound
(``utils/roofline.py``); then each call's kernels by device time
(torch.profiler), which parts the combine at K > 64 into its row phase and
its outer sums. At K = 64 also the SVI shape (the first W=70 steps, kept
runs of L=50, the combine gated with ``emit_gamma``). Where the checkout's
chain is built for several S (``duplex_fb.built_seqs``), the chain at
every built S too. Where the checkout sums the WF instances' likelihoods
apart (``duplex_fb.likelihoods``, at F > 64), the combine also on the
likelihoods the E-step hands it, and the tile alone.

Usage, on a machine with an NVIDIA GPU and nvcc, from the repository root::

    PYTHONPATH=<checkout> python pysvihmm_tpu_torch/scripts/time_duplex.py [reps] [K ...] [D=<d>]

It imports the ``pysvihmm_tpu_torch`` of ``<checkout>`` (``.`` for this one)
and calls only ``duplex_chain``, ``duplex_combine`` and ``estep_duplex``
with the signatures they have had since the duplex route was ported, with
``time_fused.py``'s inputs, so the same file times an earlier checkout too
(at D = 8; the D of another width needs this checkout's ``inputs``):
two checkouts are compared in one call, in turns. Each line gives ms per
launch by CUDA events, 20 launches after 3 warm-ups, ``reps`` times
(default 3), and their median and minimum; the first lines of each K the
sha256 of the chain's outputs (at every built S) and of ``estep_duplex``'s
(ungated and gated, gamma emitted and not; at D > 8 also with the
Gaussian-NIW's features built in the kernels, and at F > 64 the diagonal
Gaussian's at D = 32, F = 65, built and not), so that two checkouts' bits
compare; the last line is the card's name and power limit. Without a card
it raises.
"""

from __future__ import annotations

import hashlib
import statistics
import sys

import torch

import pysvihmm_tpu_torch
from pysvihmm_tpu_torch.messages import duplex_fb
from pysvihmm_tpu_torch.scripts.debug_split import card_line, cuda_ms
from pysvihmm_tpu_torch.scripts.time_fused import B, T, inputs, profile_call, width_inputs
from pysvihmm_tpu_torch.utils.roofline import bound, kernel_work

SVI_W, SVI_L = 70, 50  # chip_smoke.py's SVI window and kept run
SMALL_B = 32  # the smallest batch chip_smoke.py times the SVI step at


def digest(*xs: torch.Tensor) -> str:
    """sha256 of the tensors' bytes, in order (time_fused.py's; an earlier
    checkout's time_fused.py lacks it): two checkouts' outputs on the same
    inputs compare bit for bit by their digests."""
    h = hashlib.sha256()
    for x in xs:
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def report(name: str, times: list[float], bound_ms: float) -> None:
    med = statistics.median(times)
    print(f"{name}: " + " / ".join(f"{x:.4f}" for x in times)
          + f" ms (median {med:.4f}, min {min(times):.4f}; bound {bound_ms:.4f} ms, "
          f"{100 * bound_ms / med:.1f} % of it)", flush=True)


def chain_seqs(k: int, F: int, dev: torch.device) -> tuple[int, ...]:
    """The chain's built S at K = k where the checkout has them
    (``duplex_fb.built_seqs``; an earlier one ran a sequence a block above
    64 states), else none; of those, the S the card holds a block of at F
    (an earlier checkout's WF chain took shared memory that grew with F)."""
    if not hasattr(duplex_fb, "built_seqs"):
        return ()
    return tuple(S for S in duplex_fb.built_seqs(k)
                 if duplex_fb.kernel_info("chain", S, F, dev, K=k)["blocks_per_sm"] > 0)


def estep_digests(tag: str, log_pi, log_A, W, x, w, ik=None) -> None:
    """The digests of ``estep_duplex`` on x (the feature array, or with
    ``ik`` a built kind's raw observations), ungated and gated, gamma
    emitted and not: log_c, log_z, trans_stats, init_stats, emit_stats and
    gamma."""
    kw = {} if ik is None else {"in_kernel_feats": ik}
    for name, weights in (("ungated", None), ("gated", w)):
        for emit in (False, True):
            fb, eacc = duplex_fb.estep_duplex(log_pi, log_A, W, x, emit, weights, **kw)
            outs = [fb.log_c, fb.log_z, fb.trans_stats, fb.init_stats, eacc]
            print(f"estep_duplex {tag}{name}, emit_gamma={emit}: log_c, log_z, trans_stats, "
                  f"init_stats, emit_stats{', gamma' if emit else ''}: sha256 "
                  f"{digest(*outs, *([fb.gamma] if emit else []))}", flush=True)
            del fb, eacc, outs


def time_at(k: int, reps: int, dev: torch.device, d: int = 8) -> None:
    log_pi, log_A, W, feats, w = inputs(dev, k) if d == 8 else inputs(dev, k, d)
    F = feats.shape[-1]
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    a, s, sh, beta = duplex_fb.duplex_chain(pi_t, A_t, W, feats)
    print(f"package {pysvihmm_tpu_torch.__file__}; (B, T, K, F) = ({B}, {T}, {k}, {F}); "
          f"duplex_chain_kernel's alpha, s, sh: sha256 {digest(a, s, sh)}, beta: "
          f"{digest(beta)}", flush=True)
    estep_digests("", log_pi, log_A, W, feats, w)
    if d > 8:  # the same observations, their features built in the kernels
        src = width_inputs(dev, k, "niw", d)[5]
        estep_digests("niw in-kernel ", log_pi, log_A, W, src, w, "niw")
        del src
    if F > 64:  # the diagonal Gaussian at D = 32 (F = 65), built and not
        nlp, nlA, nW, nfeats, nw, nsrc, _ = width_inputs(dev, k, "nig", 32)
        estep_digests("nig D=32 ", nlp, nlA, nW, nfeats, nw)
        estep_digests("nig D=32 in-kernel ", nlp, nlA, nW, nsrc, nw, "nig")
        del nlp, nlA, nW, nfeats, nw, nsrc
    # a small batch (the first SMALL_B sequences): the default S is the
    # smallest built, a block a sequence above 64 states
    fs = feats[:, :SMALL_B].contiguous()
    report(f"duplex_chain_kernel at B={SMALL_B}",
           [cuda_ms(lambda: duplex_fb.duplex_chain(pi_t, A_t, W, fs), 20, warmup=3)
            for _ in range(reps)], bound(*kernel_work("duplex_chain_kernel", SMALL_B, T, k, F))[0])
    del fs
    chain_b = bound(*kernel_work("duplex_chain_kernel", B, T, k, F))[0]
    for S in chain_seqs(k, F, dev):
        out = duplex_fb._launch_chain(S, pi_t, A_t, W, feats)
        print(f"duplex_chain_kernel S={S}: alpha, s, sh: sha256 {digest(*out[:3])}, beta: "
              f"{digest(out[3])}", flush=True)
        del out
        report(f"duplex_chain_kernel S={S}",
               [cuda_ms(lambda: duplex_fb._launch_chain(S, pi_t, A_t, W, feats), 20, warmup=3)
                for _ in range(reps)], chain_b)
    runs = {
        "duplex_chain_kernel": (lambda: duplex_fb.duplex_chain(pi_t, A_t, W, feats), {}),
        "duplex_combine_kernel": (lambda: duplex_fb.duplex_combine(W, feats, a, beta, sh), {}),
        "duplex_combine_kernel, gated": (
            lambda: duplex_fb.duplex_combine(W, feats, a, beta, sh, False, w), {"gated": True}),
        "estep_duplex": (lambda: duplex_fb.estep_duplex(log_pi, log_A, W, feats), None),
    }
    if F > 64 and hasattr(duplex_fb, "likelihoods"):  # the E-step's one sum of ll
        ll = duplex_fb.likelihoods(W, feats)
        runs["ll_tile_kernel"] = (lambda: duplex_fb.likelihoods(W, feats), None)
        runs["duplex_combine_kernel on the E-step's ll"] = (
            lambda: duplex_fb.duplex_combine(W, feats, a, beta, sh, False, None, None, ll), {})
        runs["duplex_combine_kernel, gated, on the E-step's ll"] = (
            lambda: duplex_fb.duplex_combine(W, feats, a, beta, sh, False, w, None, ll),
            {"gated": True})
    for name, (fn, kw) in runs.items():
        if name == "ll_tile_kernel":
            b_ms = bound(*kernel_work(name, B * T, 1, k, F))[0]
        elif kw is not None:
            b_ms = bound(*kernel_work(name.split(",")[0].split(" ")[0], B, T, k, F, **kw))[0]
        else:  # the E-step: both kernels' bounds
            b_ms = sum(bound(*kernel_work(n, B, T, k, F))[0]
                       for n in ("duplex_chain_kernel", "duplex_combine_kernel"))
        report(name, [cuda_ms(fn, 20, warmup=3) for _ in range(reps)], b_ms)
    for name in ("duplex_combine_kernel", "duplex_combine_kernel, gated", "estep_duplex"):
        profile_call(name, runs[name][0])
    if k == 64:
        # the SVI shape: the first W steps, one kept run of L a sequence
        fw = feats[:SVI_W].contiguous()
        offs = torch.randint(0, SVI_W - SVI_L + 1, (B,),
                             generator=torch.Generator(device=dev).manual_seed(5), device=dev)
        t = torch.arange(SVI_W, device=dev)[:, None]
        m = ((t >= offs) & (t < offs + SVI_L)).to(torch.float32).contiguous()
        aw, _, shw, bw = duplex_fb.duplex_chain(pi_t, A_t, W, fw)
        svi = {
            "duplex_chain_kernel": (lambda: duplex_fb.duplex_chain(pi_t, A_t, W, fw), {}),
            "duplex_combine_kernel": (
                lambda: duplex_fb.duplex_combine(W, fw, aw, bw, shw, True, m),
                {"gated": True, "emit_gamma": True}),
        }
        for name, (fn, kw) in svi.items():
            b_ms = bound(*kernel_work(name, B, SVI_W, k, F, **kw))[0]
            report(f"{name} at the SVI shape (B, W) = ({B}, {SVI_W}), {kw or 'plain'}",
                   [cuda_ms(fn, 20, warmup=3) for _ in range(reps)], b_ms)


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("time_duplex needs an NVIDIA GPU: the kernels run only on the card")
    dims = [int(a[2:]) for a in argv if a.startswith("D=")]
    argv = [a for a in argv if not a.startswith("D=")]
    reps = int(argv[0]) if argv else 3
    dev = torch.device("cuda", 0)
    for k in dict.fromkeys([64, *map(int, argv[1:])]):
        time_at(k, reps, dev, *dims[-1:])
        torch.cuda.empty_cache()
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
