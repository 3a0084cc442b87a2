"""Time the fused E-step pair on the card at the VB shape (B=1024, T=1000,
K=64, a Gaussian-NIW at D=8: F=45): the forward, the backward ungated and
gated (kept runs of 5T/7), and the whole fused E-step; then one windowed SVI
step (L=50, b=10, W=70, on one chain of T=100,000) on "auto" and on "split"
at B = 32, 256 and 1024. Given another K (65-256, the large-K instances),
the pair and the E-step at that K and the pair at one sequence a block (S =
1, what a small batch runs), and no SVI step (``time_split.py`` times the
split pair). Then the device time of each kernel one backward
call launches (torch.profiler), ungated and gated; at K > 64 last the
backward's outer sums alone (``fused_fb.outer_sum``, where the checkout
has it) beside torch.matmul on the same products, float32 and TF32.

Given feature widths (a comma-separated list of ``niw:D``, a Gaussian-NIW
at D dimensions, F = 1 + D + D (D + 1) / 2, ``nig:D``, a diagonal Gaussian,
F = 1 + 2 D, and ``onehot:V``, the one-hot rows of V symbols, F = V), it
times instead, at K (any the kernels take) and each width: the pair and the
backward gated, and each kernel of the forward and the backward by
torch.profiler, then the likelihood tile alone (where the checkout has
``likelihood_tile``) on the rows the pair gives it (all T B up to K = 64,
one window of 2^17 above) beside torch.matmul, with its output's digest
(``reps`` 0: no times); before, the digests at every built
S whose instances the card
holds at that F: the forward's alpha, s and sh on the feature array, on a
built kind's raw observations and with bf16 alpha (up to K = 64 beside the
duplex WF chain's, which must be the same bits), and the backward's gamma,
gamma0, acc and eacc, ungated and gated, on the array and the raw rows,
with the gamma pick and with bf16 alpha; up to K = 64, at S = 2 and 4
(acc's grouping follows S), eacc's largest difference from the float64 twin
on the same inputs, relative to the largest |eacc| (eacc's bits follow the
summation's grouping, which a redesign may change). Last,
either way, ``fused_fb.widen_alpha`` (where the checkout has it) beside
``.to(torch.float32)`` on the large-K SVI step's window of bf16 alpha (69 x
1024 rows of 128), and ``fused_fb.feature_rows`` (build_feats_kernel) beside
``build_features`` on the SVI step's window of NIW rows (70 x 1024 at D = 8)
and on a window of 2^17 rows at D = 39, with its output's digest.

Usage, on a machine with an NVIDIA GPU and nvcc, from the repository root::

    PYTHONPATH=<checkout> python pysvihmm_tpu_torch/scripts/time_fused.py [reps] [K] [widths]

It imports the ``pysvihmm_tpu_torch`` of ``<checkout>`` (``.`` for this one)
and calls only what every version of the port has had since windowed SVI
was ported (``fused_forward``, ``fused_backward``, ``estep_fused`` with
their default arguments, ``svi.make_step``) and, at K > 64,
``_launch_forward`` / ``_launch_backward`` (since the fused pair took S),
so the same file times
an earlier checkout too: two checkouts are compared in one call, in turns. Each
line gives ms per launch (per step for SVI, chained steps with nothing read
back) by CUDA events, 20 launches after 3 warm-ups, ``reps`` times (default
3), and their median and minimum (the host-bound SVI step varies by up to 2x
from one rep to the next); the last line is the card's name and power limit.
The first lines carry sha256 digests of the outputs on the same seeded
inputs: the forward's (alpha, s, sh) and the backward's (gamma, gamma0,
acc, eacc) with ``emit_gamma``, ungated and gated, so two checkouts' bits
compare.
Without a card it raises.
"""

from __future__ import annotations

import hashlib
import statistics
import subprocess
import sys

import torch

import pysvihmm_tpu_torch
from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
from pysvihmm_tpu_torch.distributions import GaussianNIW, dirichlet, niw
from pysvihmm_tpu_torch.engines import svi
from pysvihmm_tpu_torch.messages import fused_fb
from pysvihmm_tpu_torch.models.hmm import init_params, make_prior
from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms

B, T, K, D = 1024, 1000, 64, 8
SVI_T, SVI_L, SVI_BUF = 100_000, 50, 10  # chip_smoke.py's SVI shape
SVI_BATCHES = (32, 256, 1024)


def inputs(dev: torch.device, K: int = K, D: int = D):
    """chip_smoke.py's E-step inputs (overlapping states, NIW parameters
    near the generating ones) with K states and D observation dimensions
    (F = 1 + D + D (D + 1) / 2 features), from a seeded generator on the
    card."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    obs, _, truth = gen_gaussian_dataset(gen, K, D, B, T, mean_scale=0.5, cov_scale=1.0)
    mu = truth.theta[0]

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    eye = torch.eye(D, device=dev)
    q = niw.NIW(mean=mu + 0.3 * torch.randn(mu.shape, generator=gen, device=dev),
                kappa=u(K, lo=2.0, hi=20.0), nu=D + 2.0 + u(K, lo=3.0, hi=20.0),
                psi=5.0 * (u(K, 1, 1, lo=0.5, hi=2.0) * eye + 0.1))
    W = niw.ell_feature_matrix(q).contiguous()
    feats = niw.ell_features(obs.transpose(0, 1)).contiguous()
    log_pi = dirichlet.expected_log_probs(u(K, lo=1.0, hi=3.0))
    log_A = dirichlet.expected_log_probs(u(K, K, lo=1.0, hi=3.0)
                                         + 5.0 * torch.eye(K, device=dev))
    offs = torch.randint(0, T - (5 * T) // 7 + 1, (B,), generator=gen, device=dev)
    t = torch.arange(T, device=dev)[:, None]
    w = ((t >= offs) & (t < offs + (5 * T) // 7)).to(torch.float32).contiguous()
    return log_pi, log_A, W, feats, w


def onehot_inputs(dev: torch.device, K: int, V: int):
    """chip_smoke.py phase 15's multinomial inputs at V symbols: the (T, B,
    V) one-hot rows of symbols from sticky states and W = E[log phi]^T of a
    Dirichlet posterior near the generating one; the parameters and the
    kept-mask as :func:`inputs`'."""
    from pysvihmm_tpu_torch.data.synthetic import gen_multinomial_dataset

    gen = torch.Generator(device=dev).manual_seed(1234)
    obs, _, truth = gen_multinomial_dataset(gen, K, V, B, T)
    conc = 50.0 * truth.theta[0] + 0.5 + torch.rand((K, V), generator=gen, device=dev)
    W = dirichlet.expected_log_probs(conc).T.to(torch.float32).contiguous()
    feats = torch.nn.functional.one_hot(obs.transpose(0, 1).long(), V).to(torch.float32)
    u = lambda *shape, lo, hi: lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)  # noqa: E731
    log_pi = dirichlet.expected_log_probs(u(K, lo=1.0, hi=3.0))
    log_A = dirichlet.expected_log_probs(u(K, K, lo=1.0, hi=3.0) + 5.0 * torch.eye(K, device=dev))
    offs = torch.randint(0, T - (5 * T) // 7 + 1, (B,), generator=gen, device=dev)
    t = torch.arange(T, device=dev)[:, None]
    w = ((t >= offs) & (t < offs + (5 * T) // 7)).to(torch.float32).contiguous()
    return log_pi, log_A, W, feats.contiguous(), w


def parse_widths(arg: str) -> list[tuple[str, int]]:
    """``niw:10,nig:32,onehot:100`` -> [("niw", 10), ("nig", 32), ("onehot", 100)]."""
    out = []
    for item in arg.split(","):
        kind, size = item.split(":")
        if kind not in ("niw", "nig", "onehot"):
            raise ValueError(f"a width is niw:D, nig:D or onehot:V, got {item!r}")
        out.append((kind, int(size)))
    return out


def report(name: str, times: list[float]) -> None:
    print(f"{name}: " + " / ".join(f"{x:.3f}" for x in times)
          + f" ms (median {statistics.median(times):.3f}, min {min(times):.3f})", flush=True)


def profile_call(name: str, fn) -> None:
    """Device time by kernel of one call of ``fn`` (after a warm-up), from
    torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    parts = []
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            t = t if t is not None else e.self_cuda_time_total
            parts.append((t, e.count, e.key.replace("(anonymous namespace)::", "").split("(")[0]))
    total = sum(t for t, _, _ in parts)
    print(f"{name}, one call, device {total / 1e3:.3f} ms: " + "; ".join(
        f"{key} {t / 1e3:.3f} ms x{n}" for t, n, key in sorted(parts, reverse=True)), flush=True)


def digest(*xs: torch.Tensor) -> str:
    """sha256 of the tensors' bytes, in order: two checkouts' outputs on the
    same inputs compare bit for bit by their digests."""
    h = hashlib.sha256()
    for x in xs:
        x = x.view(torch.int16) if x.dtype == torch.bfloat16 else x  # numpy has no bf16
        h.update(x.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


def outer_products(alpha: torch.Tensor, feats: torch.Tensor, reps: int) -> None:
    """The large-K backward's outer sums alone: the products X^T Y of its
    windows of 2^17 / B steps (acc: (T - 1) B rows of K by K, eacc: T B rows
    of K by F), by ``fused_fb.outer_sum`` where the checkout has it and by
    torch.matmul in float32 (TF32 off, the yardstick) and in TF32. Operands
    of the backward's shapes: alpha's rows stand in for d n and gamma (the
    time does not depend on the values)."""
    T_, B_, k = alpha.shape
    steps = max(1, min(T_, (1 << 17) // B_))
    pairs = []
    for t1 in range(T_, 0, -steps):
        t0 = max(0, t1 - steps)
        ta = max(t0, 1)
        pairs.append((alpha[ta - 1:t1 - 1].reshape(-1, k), alpha[ta:t1].reshape(-1, k)))
        pairs.append((alpha[t0:t1].reshape(-1, k), feats[t0:t1].reshape(-1, feats.shape[-1])))
    runs = {"torch.matmul(X.T, Y), float32": lambda: [torch.matmul(x.T, y) for x, y in pairs]}
    if hasattr(fused_fb, "outer_sum"):
        runs["outer_sum"] = lambda: [fused_fb.outer_sum(x, y) for x, y in pairs]
    for name, fn in runs.items():
        report(f"{name} over the {len(pairs)} products of one backward",
               [cuda_ms(fn, 20, warmup=3) for _ in range(reps)])
    torch.backends.cuda.matmul.allow_tf32 = True
    report(f"torch.matmul(X.T, Y), TF32 (reference only) over the {len(pairs)} products",
           [cuda_ms(runs["torch.matmul(X.T, Y), float32"], 20, warmup=3) for _ in range(reps)])
    torch.backends.cuda.matmul.allow_tf32 = False


def nig_inputs(dev: torch.device, K: int, D: int):
    """Diagonal-Gaussian inputs at D dimensions (F = 1 + 2 D): the raw
    observations of diagonal Gaussian states (``gen_diag_gaussian_dataset``,
    so that a wide D needs no D x D factor a row) and W of a NIG posterior
    near the generating states (chip_smoke.py's mode_problem), the rest as
    :func:`inputs`'."""
    from pysvihmm_tpu_torch.data.synthetic import gen_diag_gaussian_dataset
    from pysvihmm_tpu_torch.distributions import diag_gaussian

    gen = torch.Generator(device=dev).manual_seed(1234)
    obs, _, truth = gen_diag_gaussian_dataset(gen, K, D, B, T, mean_scale=0.5, var_scale=1.0)

    def u(*shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    q = diag_gaussian.NIG(mean=truth.theta[0] + 0.3 * torch.randn(truth.theta[0].shape,
                                                                  generator=gen, device=dev),
                          kappa=u(K, D, lo=2.0, hi=20.0), a=u(K, D, lo=3.0, hi=20.0),
                          b=u(K, D, lo=2.0, hi=10.0))
    W = diag_gaussian.ell_feature_matrix(q).to(torch.float32).contiguous()
    raw = obs.transpose(0, 1).to(torch.float32).contiguous()
    log_pi = dirichlet.expected_log_probs(u(K, lo=1.0, hi=3.0))
    log_A = dirichlet.expected_log_probs(u(K, K, lo=1.0, hi=3.0) + 5.0 * torch.eye(K, device=dev))
    offs = torch.randint(0, T - (5 * T) // 7 + 1, (B,), generator=gen, device=dev)
    t = torch.arange(T, device=dev)[:, None]
    w = ((t >= offs) & (t < offs + (5 * T) // 7)).to(torch.float32).contiguous()
    return log_pi, log_A, W, diag_gaussian.ell_features(raw).contiguous(), w, raw


def width_inputs(dev: torch.device, k: int, kind: str, size: int):
    """(log_pi, log_A, W, feats, w, src, in_kernel_feats) at one width: src
    the raw (T, B, D) observations of a built kind ("niw", "nig"), else the
    feature array itself (in_kernel_feats None)."""
    if kind == "onehot":
        log_pi, log_A, W, feats, w = onehot_inputs(dev, k, size)
        return log_pi, log_A, W, feats, w, feats, None
    if kind == "nig":
        return (*nig_inputs(dev, k, size), "nig")
    log_pi, log_A, W, feats, w = inputs(dev, k, size)
    gen = torch.Generator(device=dev).manual_seed(1234)  # inputs()' observations again
    obs = gen_gaussian_dataset(gen, k, size, B, T, mean_scale=0.5, cov_scale=1.0)[0]
    return log_pi, log_A, W, feats, w, obs.transpose(0, 1).contiguous(), "niw"


def fitting_seqs(which: str, k: int, F: int, ik: str | None, modes: bool) -> list[int]:
    """The S this checkout builds at K whose instance the card holds a block
    of at F (a WF instance's shared memory may grow with F)."""
    dev = torch.device("cuda", 0)
    return [S for S in fused_fb.built_seqs(k)
            if fused_fb.kernel_info(which, S, F, dev, K=k, in_kernel_feats=ik,
                                    modes=modes)["blocks_per_sm"] > 0]


def width_digests(tag: str, k: int, pi_t, A_t, W, feats, w, src, ik) -> None:
    """The digests of one width at every S that fits: the forward's (alpha,
    s, sh) on the array and the kind's raw rows and with bf16 alpha; the
    backward's (gamma, gamma0, acc, eacc) ungated and gated on the array and
    the raw rows, with the pick and with bf16 alpha (gated); at K <= 64 the
    duplex WF chain's alpha, s and sh against the fused forward's."""
    from pysvihmm_tpu_torch.messages import duplex_fb

    F = W.shape[0]
    gen = torch.Generator(device=feats.device).manual_seed(77)
    offs = torch.randint(0, T, (B,), generator=gen, device=feats.device)
    for S in fitting_seqs("forward", k, F, ik, True):
        fwd = fused_fb._launch_forward(S, pi_t, A_t, W, feats)
        line = f"{tag}: forward S={S}: alpha, s, sh sha256 {digest(*fwd)}"
        if ik is not None:
            line += f", {ik} {digest(*fused_fb._launch_forward(S, pi_t, A_t, W, src, ik))}"
        fwd16 = fused_fb._launch_forward(S, pi_t, A_t, W, src, ik, torch.bfloat16)
        line += f", bf16 alpha {digest(*fwd16)}"
        if k <= 64 and S in duplex_fb.built_seqs(k):
            chain = duplex_fb._launch_chain(S, pi_t, A_t, W, feats)
            line += (", the duplex WF chain's alpha, s, sh the same bits: "
                     f"{all(torch.equal(x, r) for x, r in zip(chain[:3], fwd))}")
            del chain
        print(line, flush=True)
        if S not in fitting_seqs("gated backward", k, F, ik, True):
            continue
        for name, weights in (("ungated", None), ("gated", w)):
            out = fused_fb._launch_backward(S, A_t, W, feats, *fwd, True, weights)
            line = f"{tag}: backward S={S}, {name}: gamma, gamma0, acc, eacc sha256 {digest(*out)}"
            if ik is not None:
                out = fused_fb._launch_backward(S, A_t, W, src, *fwd, True, weights, ik)
                line += f", {ik} {digest(*out)}"
            print(line, flush=True)
            del out
        picked = fused_fb._launch_backward(S, A_t, W, src, *fwd, False, w, ik, offs)
        b16 = fused_fb._launch_backward(S, A_t, W, src, *fwd16, False, w, ik)
        print(f"{tag}: backward S={S}, gated: the pick's gamma0, acc, eacc sha256 "
              f"{digest(*picked[1:])}; bf16 alpha's {digest(*b16[1:])}", flush=True)
        del fwd, fwd16, picked, b16


def wide_width(dev: torch.device, k: int, kind: str, size: int, reps: int) -> None:
    """The fused pair at one feature width above 64 (``kind`` "niw" or "nig"
    at D = size, "onehot" at V = size): digests (:func:`width_digests`), up to
    K = 64 eacc against float64, and with ``reps`` > 0 the times and each
    backward's kernels (the module docstring)."""
    log_pi, log_A, W, feats, w, src, ik = width_inputs(dev, k, kind, size)
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    F = feats.shape[-1]
    tag = f"{kind}:{size} (F = {F}), K = {k}"
    width_digests(tag, k, pi_t, A_t, W, feats, w, src, ik)
    alpha, s, sh = fused_fb.fused_forward(pi_t, A_t, W, feats)
    d = lambda x: None if x is None else x.double()  # noqa: E731
    if k <= 64:  # eacc's grouping follows S there: against float64
        for name, weights in (("fused_bwd_kernel", None), ("fused_bwd_kernel, gated", w)):
            ref = fused_fb.backward_reference(d(A_t), d(W), d(feats), d(alpha), d(s), d(sh),
                                              False, d(weights))[3]
            for S in (2, 4):
                eacc = fused_fb._launch_backward(S, A_t, W, feats, alpha, s, sh, True,
                                                 weights)[3]
                rel = ((eacc.double() - ref).abs().max() / ref.abs().max()).item()
                print(f"{tag}: {name}, S={S}: max |eacc - float64| / max |float64| = {rel:.3e}",
                      flush=True)
                del eacc
            del ref
    if reps < 1:
        return
    runs = {
        "fused_fwd_kernel": lambda: fused_fb.fused_forward(pi_t, A_t, W, feats),
        "fused_bwd_kernel": lambda: fused_fb.fused_backward(A_t, W, feats, alpha, s, sh),
        "fused_bwd_kernel, gated": lambda: fused_fb.fused_backward(A_t, W, feats, alpha, s,
                                                                   sh, False, w),
    }
    for name, fn in runs.items():
        report(f"{tag}: {name}", [cuda_ms(fn, 20, warmup=3) for _ in range(reps)])
    for name in runs:
        profile_call(f"{tag}: {name}", runs[name])
    if hasattr(fused_fb, "likelihood_tile"):  # the tile alone, on the rows the pair gives it
        X = feats.reshape(-1, F) if k <= 64 else feats[:(1 << 17) // B].reshape(-1, F)
        print(f"{tag}: ll_tile_kernel over {X.shape[0]} rows: sha256 "
              f"{digest(fused_fb.likelihood_tile(X, W))}", flush=True)
        for name, fn in (("ll_tile_kernel", lambda: fused_fb.likelihood_tile(X, W)),
                         ("torch.matmul", lambda: torch.matmul(X, W))):
            report(f"{tag}: {name} over {X.shape[0]} rows",
                   [cuda_ms(fn, 20, warmup=3) for _ in range(reps)])
        del X


def widen_window(dev: torch.device, reps: int) -> None:
    """widen_alpha (where the checkout has it) beside .to(torch.float32) on
    the large-K SVI step's window of bf16 alpha: 69 x 1024 rows of 128, by
    CUDA events around runs of launches and by the device time of 50 calls
    (torch.profiler): the kernels are shorter than a launch on the host."""
    gen = torch.Generator(device=dev).manual_seed(53)
    a16 = torch.rand((69 * 1024, 128), generator=gen, device=dev).to(torch.bfloat16)
    runs = {".to(torch.float32)": lambda: a16.to(torch.float32)}
    if hasattr(fused_fb, "widen_alpha"):
        same = torch.equal(fused_fb.widen_alpha(a16).view(torch.int32),
                           a16.to(torch.float32).view(torch.int32))
        print(f"widen_alpha over {tuple(a16.shape)} bf16: the twin's bits: {same}", flush=True)
        runs["widen_alpha"] = lambda: fused_fb.widen_alpha(a16)
    for name, fn in runs.items():
        report(f"{name} over {tuple(a16.shape)} bf16, CUDA events", [cuda_ms(fn, 50, warmup=5)
                                                                     for _ in range(reps)])
        # the kernel is shorter than its launch on the host: its device time
        profile_call(f"{name} over {tuple(a16.shape)} bf16, 50 calls",
                     lambda fn=fn: [fn() for _ in range(50)])


# build_feats_kernel's windows: (rows, D) of the K = 128 SVI step's window
# (B = 1024, W = 70; NIW D = 8, F = 45) and of one window of 2^17 rows at the
# NIW D = 39 (F = 820), the K = 64 WF backward's window tier on raw rows
BUILD_WINDOWS = ((70 * 1024, 8), (1 << 17, 39))


def build_windows(dev: torch.device, reps: int) -> None:
    """feature_rows (where the checkout has it) on BUILD_WINDOWS for the NIW:
    its digest and whether it is ``build_features``' bits, then its time by
    CUDA events around runs of launches and its device time over 50 calls
    (torch.profiler), beside ``build_features`` (the twin)."""
    if not hasattr(fused_fb, "feature_rows"):
        return
    for rows, d in BUILD_WINDOWS:
        obs = torch.randn((rows, d), generator=torch.Generator(device=dev).manual_seed(rows + d),
                          device=dev)
        got = fused_fb.feature_rows(obs, "niw")
        tag = f"build_feats_kernel over {rows} rows, NIW D={d} (F = {got.shape[1]})"
        same = torch.equal(got.view(torch.int32),
                           fused_fb.build_features(obs, "niw").view(torch.int32))
        print(f"{tag}: sha256 {digest(got)}, build_features' bits: {same}", flush=True)
        del got
        if reps < 1:
            continue
        for name, fn in (("feature_rows", lambda: fused_fb.feature_rows(obs, "niw")),
                         ("build_features", lambda: fused_fb.build_features(obs, "niw"))):
            report(f"{tag}: {name}, CUDA events", [cuda_ms(fn, 50, warmup=5) for _ in range(reps)])
            profile_call(f"{tag}: {name}, 50 calls", lambda fn=fn: [fn() for _ in range(50)])
        del obs


def svi_steps(dev: torch.device, reps: int) -> None:
    """ms per windowed SVI step on "auto" and "split", as chip_smoke.py's
    phase 5 times it (its chain of overlapping states)."""
    gen = torch.Generator(device=dev).manual_seed(2)
    chain = gen_gaussian_dataset(gen, K, D, 1, SVI_T, mean_scale=0.5, cov_scale=1.0)[0][0]
    prior = make_prior(K, GaussianNIW, obs_dim=D, device=dev)
    p0 = init_params(gen, prior, GaussianNIW, chain)
    for Bs in SVI_BATCHES:
        cfg = svi.SVIConfig(batch_size=Bs, subchain_len=SVI_L, buffer=SVI_BUF)
        for route in ("auto", "split"):
            step = svi.make_step(GaussianNIW, cfg, chain.shape[0], method=route)
            state = svi.init_state(p0, torch.Generator(device=dev).manual_seed(3))

            def one():
                nonlocal state
                state, _ = step(state, prior, chain)

            report(f"SVI step, B={Bs}, {route}", [cuda_ms(one, 20, warmup=3) for _ in range(reps)])


def main(argv: list[str]) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("time_fused needs an NVIDIA GPU: the kernels run only on the card")
    reps = int(argv[0]) if argv else 3
    k = int(argv[1]) if len(argv) > 1 else K
    dev = torch.device("cuda", 0)
    if len(argv) > 2:
        print(f"package {pysvihmm_tpu_torch.__file__}; (B, T) = ({B}, {T})", flush=True)
        for kind, size in parse_widths(argv[2]):
            wide_width(dev, k, kind, size, reps)
            torch.cuda.empty_cache()
        if reps > 0:
            widen_window(dev, reps)
        build_windows(dev, reps)
        return card_line()
    log_pi, log_A, W, feats, w = inputs(dev, k)
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    alpha, s, sh = fused_fb.fused_forward(pi_t, A_t, W, feats)
    print(f"package {pysvihmm_tpu_torch.__file__}; (B, T, K, F) = ({B}, {T}, {k}, "
          f"{feats.shape[-1]}); fused_fwd_kernel's alpha, s, sh: sha256 {digest(alpha, s, sh)}",
          flush=True)
    for name, weights in (("fused_bwd_kernel", None), ("fused_bwd_kernel, gated", w)):
        out = fused_fb.fused_backward(A_t, W, feats, alpha, s, sh, True, weights)
        print(f"{name}'s gamma, gamma0, acc, eacc: sha256 {digest(*out)}", flush=True)
        del out
    runs = {
        "fused_fwd_kernel": lambda: fused_fb.fused_forward(pi_t, A_t, W, feats),
        "fused_bwd_kernel": lambda: fused_fb.fused_backward(A_t, W, feats, alpha, s, sh),
        "fused_bwd_kernel, gated": lambda: fused_fb.fused_backward(A_t, W, feats, alpha, s,
                                                                   sh, False, w),
        "estep_fused": lambda: fused_fb.estep_fused(log_pi, log_A, W, feats),
    }
    if k != K:
        # the one-sequence-a-block instances a small B runs (an earlier
        # checkout's launcher takes S and ignores it above K = 64)
        runs["fused_fwd_kernel, S=1"] = lambda: fused_fb._launch_forward(1, pi_t, A_t, W, feats)
        runs["fused_bwd_kernel, S=1"] = lambda: fused_fb._launch_backward(
            1, A_t, W, feats, alpha, s, sh)
        runs["fused_bwd_kernel, S=1, gated"] = lambda: fused_fb._launch_backward(
            1, A_t, W, feats, alpha, s, sh, False, w)
    for name, fn in runs.items():
        report(name, [cuda_ms(fn, 20, warmup=3) for _ in range(reps)])
    for name in ("fused_bwd_kernel", "fused_bwd_kernel, gated"):
        profile_call(name, runs[name])
    if k != K:
        outer_products(alpha, feats, reps)
    del alpha, s, sh, feats, w, runs
    if k == K:
        svi_steps(dev, reps)
    widen_window(dev, reps)
    build_windows(dev, reps)
    return card_line()


def card_line() -> int:
    """Print the card's name and power limit (nvidia-smi); returns 0."""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
