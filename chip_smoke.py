#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port's main paths once on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one card, ``nvcc`` and PyTorch built for CUDA, and imports nothing
of JAX. Phases, each of which raises (exit code 1, no result line) when it
fails:

1. device:  the card's name and power limit from nvidia-smi; the float32
            matmul policy.
2. build:   compile ``pysvihmm_tpu_torch/csrc/fused_fb.cu``,
            ``split_fb.cu``, ``duplex_fb.cu`` and ``split_probe.cu`` with
            nvcc, all at once; ptxas's registers, shared memory and spills
            for every kernel.
3. kernels: both fused E-step kernels against their plain PyTorch twins on
            the card, at a small shape and at B=1024, T=1000, K=64, D=8,
            with ``emit_gamma`` True and False and the backward gated and
            not; the gated fused backward with SVI-shaped kept-masks
            (B=1024, W=70, K=64, F=45); both
            split kernels, gated and not, at a small shape, at B=1024,
            W=70, K=64 and at B=1024, T=1000, K=64; both duplex kernels at
            a small shape (the combine's chunks of 16 steps do not divide
            T=50) and at B=1024, T=1000, K=64 (``emit_gamma`` True and
            False), gated at B=1024, W=70, K=64, and the chain's alpha, s
            and sh against the fused forward's, bit for bit; all under
            stated tolerances.
4. VB:      5 batch-VB iterations at B=1024, T=1000, K=64, D=8 through
            ``method="auto"``; each kernel must launch once per iteration
            and the ELBO must be finite and non-decreasing. Then the small
            canonical fit (K=4, D=2, 20 x 200, 50 iterations) must decode
            at Hamming error <= 0.05. Then the same 5 iterations through
            ``method="duplex"``: each duplex kernel once per iteration, no
            other E-step kernel, and the ELBOs those of "auto".
5. times:   each kernel against its twin; the fused pair's block layout
            (for every built S, sequences a block: registers, shared bytes,
            spills, resident blocks an SM from the library's occupancy
            query, waves at B=1024, time and share of the bound; the
            default S must run in one wave and every S give the default's
            outputs); the pair at every S for B = 2048 and 4096; the gated
            fused pair at the SVI shape for B in {32, 256, 1024}; the
            E-step of the benchmark shape (need_gamma=False) on the kernel
            and plain routes, and the SVI step at B in {32, 256, 1024} on
            "fused", "split", "duplex" and "scan", timed with CUDA events;
            a profile of the SVI step.
6. SVI:     windowed subchain SVI at full width (K=64, D=8, one chain of
            T=100,000 with overlapping states, B=1024, L=50, b=10): 20
            steps through ``method="auto"``, then 20 through "split" and 20
            through "duplex"; each kernel of the route launches exactly once
            a step, the noisy ELBO and every parameter stay finite and every
            NIW psi has a Cholesky factor after every step; one step's
            statistics agree across the routes on the same windows, with
            soft posteriors (median max_k gamma < 0.99). Then the small SVI
            fit (K=4, D=2, T=3000, B=16, 300 steps) through "auto" must
            decode at Hamming error < 0.05.
7. families: the diagonal Gaussian and Poisson at K=64, D=8 and the
            multinomial at K=32, V=64, each at B=1024, T=1000: 5 batch-VB
            iterations on each of "fused", "split" and "duplex" (each
            route's kernels once per iteration, ELBO finite and
            non-decreasing, the three routes' ELBOs within a stated
            tolerance); at the fitted params, each kernel pair's E-step
            against its twins on the family's own features (the
            multinomial's one-hot at F = 64, the kernels' limit) and
            batch_local_step on each kernel route against "scan", gated
            and not; features wider than the fused and duplex kernels take
            (F > 64: the multinomial at V=1000 and V=100, K=32, and the
            Gaussian-NIW at D=10, K=64, F=66, each at B=1024, T=1000) run
            the split kernels once on "fused" and on "duplex", and no other
            kernel, with statistics that agree with "scan"'s, gated and
            not; and a small fit per family (best ELBO of a few restarts)
            decodes at Hamming error <= 0.05.
8. split path decomposition: the profiling script
            ``pysvihmm_tpu_torch/scripts/debug_split.py``. Each probe kernel
            of ``csrc/split_probe.cu`` (every micro instance) against its
            twin at (T, B, K, C) = (16, 4, 8, 8), (24, 3, 33, 4),
            (16, 1024, 64, 8) and (1000, 1024, 64, 8); then the script's
            timing function over the letters f b n s 1-5 at the full shape
            (the kernels, whose launches are counted, then the twins), one
            line per variant with its bound and share, and the split
            forward's time split into products, stores, likelihood loads,
            sums and the shift and exp.

The last lines are the card line, one JSON line describing the kernels and,
last, ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import sys
import time

B, T, K, D = 1024, 1000, 64, 8  # the benchmark shape (bench.py:29)
VB_ITERS = 5
TIMED_ITERS = 20
MAX_REL_DROP = -1e-5  # ELBO monotonicity in float32
SVI_T, SVI_L, SVI_BUF = 100_000, 50, 10  # scripts/bench_svi_step.py:46-53
SVI_W = SVI_L + 2 * SVI_BUF
SVI_STEPS = 20
SVI_BATCHES = (32, 256, 1024)
ELBO_RTOL = 1e-5  # one route's VB ELBO against another's (float32, other summation orders)


def log(msg: str = "") -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def compare(name, got, ref, rtol: float, atol: float) -> float:
    """Max |got - ref|; raises unless finite and <= atol + rtol * max|ref|."""
    import torch

    require(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    require(bool(torch.isfinite(got).all()), f"{name}: non-finite values from the kernel")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    bound = atol + rtol * scale
    log(f"    {name}: max_abs_err {err:.3e} (max|ref| {scale:.3e}, bound {bound:.3e})")
    require(err <= bound, f"{name}: kernel and plain version disagree")
    return err


def compare_estep(name, fk, fr, Sk=None, Sr=None) -> None:
    """A whole E-step on a kernel route against its plain twin's on the same
    inputs: gamma (when the twin returns it), init_stats, log_c, log_z,
    trans_stats and the emission statistics (when given). gamma, gamma0 and
    init are probabilities; log_c and log_z are in nats and carry the
    likelihood dot's rounding; trans and emit are sums over B*T terms whose
    cross-sequence order the kernels' atomics change (relative bounds)."""
    log(f"   {name}")
    if fr.gamma is None:
        require(fk.gamma is None, f"{name}: gamma returned with emit_gamma=False")
    else:
        compare("gamma", fk.gamma, fr.gamma, 0.0, 5e-5)
    compare("init_stats", fk.init_stats, fr.init_stats, 0.0, 5e-5)
    compare("log_c", fk.log_c, fr.log_c, 2e-6, 1e-4)
    compare("log_z", fk.log_z, fr.log_z, 2e-6, 0.0)
    compare("trans_stats", fk.trans_stats, fr.trans_stats, 1e-4, 1e-3)
    if Sk is not None:
        compare("emit_stats", Sk, Sr, 3e-3, 2e-3)


def compare_local_stats(sk, ss) -> None:
    """batch_local_step's summed statistics on a kernel route against the
    "scan" route's: every emission statistic of the family, trans, init
    (summed over B sequences) and log Z (summed)."""
    emit_k = sk.emit if isinstance(sk.emit, tuple) else (sk.emit,)
    emit_s = ss.emit if isinstance(ss.emit, tuple) else (ss.emit,)
    for name, a, b in zip(getattr(ss.emit, "_fields", ("counts",)), emit_k, emit_s):
        compare(f"emit {name}", a, b, 3e-3, 2e-3)
    compare("trans_stats", sk.trans, ss.trans, 1e-4, 1e-3)
    compare("init_stats", sk.init, ss.init, 0.0, 5e-4)
    compare("log_z", sk.log_z, ss.log_z, 2e-6, 0.0)


def svi_masks(gen, B_, W_, L_):
    """(W, B) float32 kept-masks as SVI windows make them on the card: one
    kept run of L steps per window at a random offset from ``gen``; window 0
    keeps its first step and window 1 drops it (when W > L)."""
    import torch

    offs = torch.randint(0, W_ - L_ + 1, (B_,), generator=gen, device=gen.device)
    offs[0], offs[1] = 0, W_ - L_
    t = torch.arange(W_, device=gen.device)[:, None]
    return ((t >= offs) & (t < offs + L_)).to(torch.float32).contiguous()


def random_problem(gen, B_, T_, K_, D_):
    """Valid float32 E-step inputs on the card: Gaussian HMM data and NIW
    variational params near the generating states, from the seeded ``gen``.

    The states overlap (means 0.5 apart in scale, unit noise), so posteriors
    are spread over several states: with well-separated states every sum is
    dominated by one term, and the kernels agree with their twins bit for
    bit whatever their summation order, which checks much less."""
    import torch

    from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu_torch.distributions import dirichlet, niw

    dev = gen.device
    obs, _, truth = gen_gaussian_dataset(gen, K_, D_, B_, T_, mean_scale=0.5, cov_scale=1.0)
    mu = truth.theta[0]

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    eye = torch.eye(D_, device=dev)
    q = niw.NIW(
        mean=mu + 0.3 * torch.randn(mu.shape, generator=gen, device=dev),
        kappa=u(K_, lo=2.0, hi=20.0),
        nu=D_ + 2.0 + u(K_, lo=3.0, hi=20.0),
        psi=5.0 * (u(K_, 1, 1, lo=0.5, hi=2.0) * eye + 0.1),
    )
    W = niw.ell_feature_matrix(q).contiguous()
    feats = niw.ell_features(obs.transpose(0, 1)).contiguous()
    log_pi = dirichlet.expected_log_probs(u(K_, lo=1.0, hi=3.0))
    log_A = dirichlet.expected_log_probs(u(K_, K_, lo=1.0, hi=3.0) + 5.0 * torch.eye(K_, device=dev))
    return log_pi, log_A, W, feats


def check_kernels(gen, shape):
    """Phase 3 at one shape: each kernel against its twin on the same inputs,
    then the whole fused E-step in both gamma modes. Returns the forward's
    max log_c error and the backward's max gamma error."""
    import torch

    from pysvihmm_tpu_torch.messages import fused_fb as ff

    log(f"  shape (B, T, K, D) = {shape}")
    log_pi, log_A, W, feats = random_problem(gen, *shape)
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()

    n_fwd, n_bwd = ff.fused_forward.launches, ff.fused_backward.launches
    alpha, s, sh = ff.fused_forward(pi_t, A_t, W, feats)
    torch.cuda.synchronize()
    require(ff.fused_forward.launches == n_fwd + 1, "forward launch was not counted")
    a_r, s_r, sh_r = ff.forward_reference(pi_t, A_t, W, feats)
    # alpha and s are probabilities (<= 1); sh and log c are in nats and
    # carry the likelihood dot's rounding (terms up to ~1e2, float32)
    log("   fused_fwd_kernel vs forward_reference")
    compare("alpha", alpha, a_r, 0.0, 5e-5)
    compare("s", s, s_r, 0.0, 5e-5)
    compare("sh", sh, sh_r, 2e-6, 1e-4)
    fwd_err = compare("log_c", torch.log(s) + sh, torch.log(s_r) + sh_r, 2e-6, 1e-4)

    log("   fused_bwd_kernel vs backward_reference (the same forward outputs in)")
    gam, g0, acc, eacc = ff.fused_backward(A_t, W, feats, a_r, s_r, sh_r, emit_gamma=True)
    torch.cuda.synchronize()
    require(ff.fused_backward.launches == n_bwd + 1, "backward launch was not counted")
    gam_r, g0_r, acc_r, eacc_r = ff.backward_reference(A_t, W, feats, a_r, s_r, sh_r, True)
    # gamma in probability units; acc and eacc are sums over B*T terms whose
    # cross-sequence order the kernel's atomics change (relative bounds)
    bwd_err = compare("gamma", gam, gam_r, 0.0, 5e-5)
    compare("gamma0", g0, g0_r, 0.0, 5e-5)
    compare("acc", acc, acc_r, 1e-4, 1e-3)
    compare("eacc", eacc, eacc_r, 3e-3, 2e-3)

    B_, T_ = shape[:2]
    w = svi_masks(gen, B_, T_, max(1, (5 * T_) // 7))
    log("   gated fused_bwd_kernel vs backward_reference (kept runs of 5T/7)")
    got = ff.fused_backward(A_t, W, feats, a_r, s_r, sh_r, emit_gamma=True, weights=w)
    torch.cuda.synchronize()
    ref = ff.backward_reference(A_t, W, feats, a_r, s_r, sh_r, True, weights=w)
    for name, x, r, rtol, atol in zip(("gamma", "gamma0", "acc", "eacc"), got, ref,
                                      (0.0, 0.0, 1e-4, 3e-3), (5e-5, 5e-5, 1e-3, 2e-3)):
        compare(name, x, r, rtol, atol)
    require(torch.equal(got[0], gam), "the gated kernel's gamma is not the ungated one")
    del got, ref

    for emit_gamma in (True, False):
        fk, Sk = ff.estep_fused(log_pi, log_A, W, feats, emit_gamma=emit_gamma)
        torch.cuda.synchronize()
        fr, Sr = ff.estep_fused_reference(log_pi, log_A, W, feats, emit_gamma=emit_gamma)
        compare_estep(f"estep_fused vs estep_fused_reference, emit_gamma={emit_gamma}",
                      fk, fr, Sk, Sr)
    return fwd_err, bwd_err, (pi_t, A_t, W, feats, a_r, s_r, sh_r)


def check_gated_fused(gen, B_, W_, K_, D_, L_):
    """Phase 3: the gated fused backward (SVI kept-masks, emit_gamma=True)
    against its twin on the same forward outputs, then the whole gated
    E-step. Returns the backward's max gamma error."""
    import torch

    from pysvihmm_tpu_torch.messages import fused_fb as ff

    log(f"  gated fused backward, (B, W, K, D) = {(B_, W_, K_, D_)}, kept runs of {L_}")
    log_pi, log_A, W, feats = random_problem(gen, B_, W_, K_, D_)
    w = svi_masks(gen, B_, W_, L_)
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    a_r, s_r, sh_r = ff.forward_reference(pi_t, A_t, W, feats)
    n_bwd = ff.fused_backward.launches
    got = ff.fused_backward(A_t, W, feats, a_r, s_r, sh_r, emit_gamma=True, weights=w)
    torch.cuda.synchronize()
    require(ff.fused_backward.launches == n_bwd + 1, "gated backward launch was not counted")
    ref = ff.backward_reference(A_t, W, feats, a_r, s_r, sh_r, True, weights=w)
    err = 0.0
    for name, x, r, rtol, atol in zip(("gamma", "gamma0", "acc", "eacc"), got, ref,
                                      (0.0, 0.0, 1e-4, 3e-3), (5e-5, 5e-5, 1e-3, 2e-3)):
        e = compare(name, x, r, rtol, atol)
        err = e if name == "gamma" else err
    ungated = ff.fused_backward(A_t, W, feats, a_r, s_r, sh_r, emit_gamma=True)
    torch.cuda.synchronize()
    require(torch.equal(ungated[0], got[0]), "the gated kernel's gamma is not the ungated one")
    fk, Sk = ff.estep_fused(log_pi, log_A, W, feats, emit_gamma=True, weights=w)
    torch.cuda.synchronize()
    fr, Sr = ff.estep_fused_reference(log_pi, log_A, W, feats, emit_gamma=True, weights=w)
    compare_estep("gated estep_fused vs estep_fused_reference", fk, fr, Sk, Sr)
    return err


def check_split(gen, B_, T_, K_, D_, gated):
    """Phase 3: each split kernel against its twin on the same inputs (the
    backward on the twin's forward outputs), then the whole split E-step.
    Returns (the forward's max log_c error, the backward's max gamma error,
    the inputs)."""
    import torch

    from pysvihmm_tpu_torch.messages import split_fb as sf

    log(f"  split kernels, (B, T, K, D) = {(B_, T_, K_, D_)}, gated={gated}")
    log_pi, log_A, W, feats = random_problem(gen, B_, T_, K_, D_)
    ll = (feats @ W).contiguous()
    w = svi_masks(gen, B_, T_, max(1, (5 * T_) // 7)) if gated else None
    g = None if w is None else sf.pair_gate(w)
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    n_fwd, n_bwd = sf.split_forward.launches, sf.split_backward.launches
    alpha, s, sh = sf.split_forward(pi_t, A_t, ll)
    torch.cuda.synchronize()
    require(sf.split_forward.launches == n_fwd + 1, "split forward launch was not counted")
    a_r, s_r, sh_r = sf.split_forward_reference(pi_t, A_t, ll)
    compare("alpha", alpha, a_r, 0.0, 5e-5)
    compare("s", s, s_r, 0.0, 5e-5)
    require(torch.equal(sh, sh_r), "sh is a max: kernel and twin must agree exactly")
    fwd_err = compare("log_c", torch.log(s) + sh, torch.log(s_r) + sh_r, 2e-6, 1e-4)
    gam, acc = sf.split_backward(A_t, ll, a_r, s_r, sh_r, g)
    torch.cuda.synchronize()
    require(sf.split_backward.launches == n_bwd + 1, "split backward launch was not counted")
    gam_r, acc_r = sf.split_backward_reference(A_t, ll, a_r, s_r, sh_r, g)
    bwd_err = compare("gamma", gam, gam_r, 0.0, 5e-5)
    compare("acc", acc, acc_r, 1e-4, 1e-3)
    fk = sf.estep_split(log_pi, log_A, ll, w)
    torch.cuda.synchronize()
    fr = sf.estep_split_reference(log_pi, log_A, ll, w)
    compare_estep("estep_split vs estep_split_reference", fk, fr)
    return fwd_err, bwd_err, (pi_t, A_t, ll, a_r, s_r, sh_r, g)


def check_duplex(gen, B_, T_, K_, D_, gated):
    """Phase 3: each duplex kernel against its twin (the combine on the
    twin's chain outputs, its pair at every chunk's first step read from
    memory), the chain's forward against the fused forward kernel on the
    same inputs, then the whole duplex E-step. Returns (the chain's max
    log_c error, the combine's max gamma error, the inputs)."""
    import torch

    from pysvihmm_tpu_torch.messages import duplex_fb as df
    from pysvihmm_tpu_torch.messages import fused_fb as ff

    log(f"  duplex kernels, (B, T, K, D) = {(B_, T_, K_, D_)}, gated={gated}")
    log_pi, log_A, W, feats = random_problem(gen, B_, T_, K_, D_)
    w = svi_masks(gen, B_, T_, max(1, (5 * T_) // 7)) if gated else None
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    n_chain, n_comb = df.duplex_chain.launches, df.duplex_combine.launches
    alpha, s, sh, beta = df.duplex_chain(pi_t, A_t, W, feats)
    torch.cuda.synchronize()
    require(df.duplex_chain.launches == n_chain + 1, "duplex chain launch was not counted")
    a_r, s_r, sh_r, b_r = df.duplex_chain_reference(pi_t, A_t, W, feats)
    log("   duplex_chain_kernel vs duplex_chain_reference")
    compare("alpha", alpha, a_r, 0.0, 5e-5)
    compare("s", s, s_r, 0.0, 5e-5)
    compare("sh", sh, sh_r, 2e-6, 1e-4)
    compare("beta", beta, b_r, 0.0, 5e-5)  # raw, <= 1 in every entry
    chain_err = compare("log_c", torch.log(s) + sh, torch.log(s_r) + sh_r, 2e-6, 1e-4)
    fa, fs, fsh = ff.fused_forward(pi_t, A_t, W, feats)
    torch.cuda.synchronize()
    same = [torch.equal(x, y) for x, y in ((alpha, fa), (s, fs), (sh, fsh))]
    log(f"   chain forward vs fused_fwd_kernel: alpha, s, sh equal bit for bit: {same}")
    require(all(same), "the duplex chain's alpha, s and sh are not the fused forward's")

    log("   duplex_combine_kernel vs duplex_combine_reference (the same chain outputs in)")
    got = df.duplex_combine(W, feats, a_r, b_r, sh_r, True, w)
    torch.cuda.synchronize()
    require(df.duplex_combine.launches == n_comb + 1, "duplex combine launch was not counted")
    ref = df.duplex_combine_reference(W, feats, a_r, b_r, sh_r, True, w)
    comb_err = 0.0
    for name, x, r, rtol, atol in zip(("gamma", "gamma0", "acc", "eacc"), got, ref,
                                      (0.0, 0.0, 1e-4, 3e-3), (5e-5, 5e-5, 1e-3, 2e-3)):
        e = compare(name, x, r, rtol, atol)
        comb_err = e if name == "gamma" else comb_err
    if gated:
        ungated = df.duplex_combine(W, feats, a_r, b_r, sh_r, True)
        torch.cuda.synchronize()
        require(torch.equal(ungated[0], got[0]), "the gated combine's gamma is not the ungated one")

    for emit_gamma in (True, False):
        fk, Sk = df.estep_duplex(log_pi, log_A, W, feats, emit_gamma=emit_gamma, weights=w)
        torch.cuda.synchronize()
        fr, Sr = df.estep_duplex_reference(log_pi, log_A, W, feats, emit_gamma, w)
        compare_estep(f"estep_duplex vs estep_duplex_reference, emit_gamma={emit_gamma}",
                      fk, fr, Sk, Sr)
    return chain_err, comb_err, (pi_t, A_t, W, feats, a_r, s_r, sh_r, b_r)


def kernel_counts() -> dict[str, int]:
    """Launches of every kernel since the last reset, by kernel (instance)."""
    from pysvihmm_tpu_torch.messages import duplex_fb as df
    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.messages import split_fb as sf
    from pysvihmm_tpu_torch.messages import split_probe as sp
    from pysvihmm_tpu_torch.utils.roofline import MICRO_KERNELS

    return {"fused_fwd_kernel": ff.fused_forward.launches,
            "fused_bwd_kernel": ff.fused_backward.launches,
            "split_fwd_kernel": sf.split_forward.launches,
            "split_bwd_kernel": sf.split_backward.launches,
            "duplex_chain_kernel": df.duplex_chain.launches,
            "duplex_combine_kernel": df.duplex_combine.launches,
            "probe_fwd_nos_kernel": sp.probe_fwd_nos.launches,
            "probe_fwd_stack_kernel": sp.probe_fwd_stack.launches,
            **{MICRO_KERNELS[body]: n for body, n in sp.probe_micro.launches.items()}}


def reset_kernel_counts() -> None:
    from pysvihmm_tpu_torch.messages import duplex_fb as df
    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.messages import split_fb as sf
    from pysvihmm_tpu_torch.messages import split_probe as sp

    ff.reset_launch_counts()
    sf.reset_launch_counts()
    df.reset_launch_counts()
    sp.reset_launch_counts()


ROUTE_KERNELS = {"auto": ("fused_fwd_kernel", "fused_bwd_kernel"),
                 "fused": ("fused_fwd_kernel", "fused_bwd_kernel"),
                 "split": ("split_fwd_kernel", "split_bwd_kernel"),
                 "duplex": ("duplex_chain_kernel", "duplex_combine_kernel")}


def require_launches(counts, route, calls: int, what: str) -> None:
    """Each kernel of ``route`` launched ``calls`` times, every other none."""
    for name, n in counts.items():
        want = calls if name in ROUTE_KERNELS[route] else 0
        require(n == want, f"{what}: {name} launched {n} times, expected {want}")


def require_ascending(elbos, what: str) -> None:
    """A VB ELBO history: finite and non-decreasing (relative drops above
    MAX_REL_DROP, float32)."""
    import torch

    e = elbos.double().cpu()
    require(bool(torch.isfinite(e).all()), f"{what}: non-finite ELBO")
    rel = (e[1:] - e[:-1]) / e[:-1].abs()
    require(bool((rel > MAX_REL_DROP).all()), f"{what}: ELBO decreased ({rel.min().item():.3e})")


def require_sane_params(params, what: str) -> None:
    """Every parameter finite and every NIW psi with a Cholesky factor (a
    NaN on the next step is the symptom of bad statistics)."""
    import torch

    for x in (params.init, params.trans, *params.emit):
        require(bool(torch.isfinite(x).all()), f"{what}: a non-finite parameter")
    info = torch.linalg.cholesky_ex(params.emit.psi).info
    require(bool((info == 0).all()), f"{what}: an NIW psi without a Cholesky factor")


def svi_run(route, cfg, p0, prior, chain, seed, steps):
    """Phase 6: ``steps`` SVI steps through ``route`` from p0, checked after
    every step. Returns (final state, noisy ELBOs, the kernels' launches)."""
    import torch

    from pysvihmm_tpu_torch.distributions import GaussianNIW
    from pysvihmm_tpu_torch.engines import svi

    step = svi.make_step(GaussianNIW, cfg, chain.shape[0], method=route)
    state = svi.init_state(p0, torch.Generator(device=chain.device).manual_seed(seed))
    elbos = []
    reset_kernel_counts()
    for i in range(steps):
        before = kernel_counts()
        state, m = step(state, prior, chain)
        after = kernel_counts()
        require_launches({k: after[k] - before[k] for k in after}, route, 1, f"{route} step {i}")
        torch.cuda.synchronize()
        require(bool(torch.isfinite(m["noisy_elbo"])) and bool(torch.isfinite(m["rho"])),
                f"{route} step {i}: non-finite noisy ELBO or rho")
        require_sane_params(state.params, f"{route} step {i}")
        elbos.append(m["noisy_elbo"].item())
    return state, elbos, kernel_counts()


def svi_step_ms(route, cfg, p0, prior, chain, iters: int) -> float:
    """Phase 5: mean ms per SVI step over ``iters`` chained steps (after two
    warm-up steps), by CUDA events; nothing is read back in between."""
    import torch

    from pysvihmm_tpu_torch.distributions import GaussianNIW
    from pysvihmm_tpu_torch.engines import svi
    from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms

    step = svi.make_step(GaussianNIW, cfg, chain.shape[0], method=route)
    state = svi.init_state(p0, torch.Generator(device=chain.device).manual_seed(3))

    def one():
        nonlocal state
        state, _ = step(state, prior, chain)

    ms = cuda_ms(one, iters, warmup=2)
    require_sane_params(state.params, f"timed {route} SVI")
    return ms


def profile_svi(cfg, p0, prior, chain, steps: int) -> None:
    """Phase 5: torch.profiler over ``steps`` SVI steps on "auto": device
    time by kernel and the device's busy share of the wall time (the
    profiler's own host overhead inflates the idle share)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from pysvihmm_tpu_torch.distributions import GaussianNIW
    from pysvihmm_tpu_torch.engines import svi

    step = svi.make_step(GaussianNIW, cfg, chain.shape[0])
    state = svi.init_state(p0, torch.Generator(device=chain.device).manual_seed(4))
    state, _ = step(state, prior, chain)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state, _ = step(state, prior, chain)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device_us = {}
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            device_us[e.key] = t if t is not None else e.self_cuda_time_total
    busy = sum(device_us.values())
    log(f"  profile, B={cfg.batch_size}, {steps} steps on auto: wall {wall_us / 1e3:.3f} ms, "
        f"device busy {busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f} %), "
        f"{len(device_us)} kernel names")
    for name, t in sorted(device_us.items(), key=lambda kv: -kv[1])[:6]:
        log(f"    {t / 1e3:9.3f} ms  {100 * t / max(busy, 1e-9):5.1f} %  {name[:90]}")


FUSED_KERNELS = {"fused_fwd_kernel": "forward", "fused_bwd_kernel": "backward"}


def fused_layout(full_inputs, ms) -> None:
    """Phase 5: the fused pair's block layout at the VB shape. For every
    built S (sequences a block): the library's registers, shared bytes,
    spills and resident blocks an SM (the CUDA occupancy calculator), the
    waves of ceil(B/S) blocks, the time, and the outputs against the default
    S's: alpha, s, sh, gamma and gamma0 bit for bit (each sequence's
    arithmetic does not depend on S), acc and eacc to their tolerances. The
    default S (``default_seqs``) must run in one wave."""
    import torch

    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms
    from pysvihmm_tpu_torch.utils.roofline import bound, kernel_work

    pi_t, A_t, W, feats, a_r, s_r, sh_r = full_inputs
    F = feats.shape[-1]
    ref_f = ff.fused_forward(pi_t, A_t, W, feats)
    ref_b = ff.fused_backward(A_t, W, feats, a_r, s_r, sh_r, True)
    for name, kind in FUSED_KERNELS.items():
        b_ms = bound(*kernel_work(name, B, T, K, F))[0]
        chosen = ff.default_seqs(kind, B, F, feats.device)
        for S in ff.SEQS:
            info = ff.kernel_info(kind, S, F)
            blocks = -(-B // S)
            waves = blocks / (info["blocks_per_sm"] * info["sms"])
            if name == "fused_fwd_kernel":
                run = lambda S=S: ff._launch_forward(S, pi_t, A_t, W, feats)
                got = run()
                same = all(torch.equal(x, y) for x, y in zip(got, ref_f))
            else:
                run = lambda S=S: ff._launch_backward(S, A_t, W, feats, a_r, s_r, sh_r, False)
                got = ff._launch_backward(S, A_t, W, feats, a_r, s_r, sh_r, True)
                torch.cuda.synchronize()
                same = torch.equal(got[0], ref_b[0]) and torch.equal(got[1], ref_b[1])
                compare(f"acc, S={S} vs S={chosen}", got[2], ref_b[2], 1e-4, 1e-3)
                compare(f"eacc, S={S} vs S={chosen}", got[3], ref_b[3], 3e-3, 2e-3)
            del got
            require(same, f"{name}: S={S} differs from S={chosen} where it must not")
            t_ms = cuda_ms(run, 20, warmup=3)
            log(f"{name} S={S}{' (default)' if S == chosen else ''}: {info['registers']} "
                f"registers, {info['local_bytes']} spilled bytes, "
                f"{info['static_smem'] + info['dynamic_smem']} shared bytes a block, "
                f"{info['blocks_per_sm']} blocks an SM of {info['sms']}, {blocks} blocks = "
                f"{waves:.3f} waves at B={B}; {t_ms:.3f} ms, bound {b_ms:.3f} ms, "
                f"{100 * b_ms / t_ms:.1f} % of it")
            if S == chosen:
                default = (info["blocks_per_sm"], waves)
                require(waves <= 1.0, f"{name}: B={B} takes {waves:.3f} waves at S={S}")
        log(f"{name}: S={chosen}, {default[0]} blocks an SM, {default[1]:.3f} waves at B={B}; "
            f"{ms[name]:.3f} ms (timed above), bound {b_ms:.3f} ms, "
            f"{100 * b_ms / ms[name]:.1f} % of it")


def fused_large_batches(gen) -> None:
    """Phase 5: the fused pair at the VB shape for B past one wave at S = 2
    (2048 and 4096 sequences), at every built S, the default S marked: the
    measurements the launchers' choice of S rests on beyond B = 1024."""
    import torch

    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms

    for Bs in (2048, 4096):
        lp, lA, W, feats = random_problem(gen, Bs, T, K, D)
        pi_t, A_t = torch.exp(lp).contiguous(), torch.exp(lA).contiguous()
        a, s, sh = ff.fused_forward(pi_t, A_t, W, feats)
        F = feats.shape[-1]
        c_f = ff.default_seqs("forward", Bs, F, feats.device)
        c_b = ff.default_seqs("backward", Bs, F, feats.device)
        parts = []
        for S in ff.SEQS:
            t_f = cuda_ms(lambda: ff._launch_forward(S, pi_t, A_t, W, feats), 10, warmup=2)
            t_b = cuda_ms(lambda: ff._launch_backward(S, A_t, W, feats, a, s, sh), 10, warmup=2)
            parts.append(f"S={S} {t_f:.3f}{'*' if S == c_f else ''} + {t_b:.3f}"
                         f"{'*' if S == c_b else ''} ms")
        log(f"fused pair at (B, T, K, F) = ({Bs}, {T}, {K}, {F}): " + "; ".join(parts)
            + " (* the default S)")
        del a, s, sh, feats


def svi_shape_pair(gen) -> None:
    """Phase 5: the fused pair at the SVI step's shape (W=70 windows, kept
    runs of L, the gated backward with emit_gamma on) for B in SVI_BATCHES,
    at every built S; the default S marked."""
    import torch

    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms
    from pysvihmm_tpu_torch.utils.roofline import bound, kernel_work

    for Bs in SVI_BATCHES:
        lp, lA, W, feats = random_problem(gen, Bs, SVI_W, K, D)
        m = svi_masks(gen, Bs, SVI_W, SVI_L)
        pi_t, A_t = torch.exp(lp).contiguous(), torch.exp(lA).contiguous()
        a, s, sh = ff.fused_forward(pi_t, A_t, W, feats)
        F = feats.shape[-1]
        b_f = bound(*kernel_work("fused_fwd_kernel", Bs, SVI_W, K, F))[0]
        b_b = bound(*kernel_work("fused_bwd_kernel", Bs, SVI_W, K, F, gated=True,
                                 emit_gamma=True))[0]
        c_f = ff.default_seqs("forward", Bs, F, feats.device)
        c_b = ff.default_seqs("gated backward", Bs, F, feats.device)
        parts = []
        for S in ff.SEQS:
            t_f = cuda_ms(lambda: ff._launch_forward(S, pi_t, A_t, W, feats), 20, warmup=3)
            t_b = cuda_ms(lambda: ff._launch_backward(S, A_t, W, feats, a, s, sh, True, m),
                          20, warmup=3)
            parts.append(f"S={S} {t_f:.4f}{'*' if S == c_f else ''} + {t_b:.4f}"
                         f"{'*' if S == c_b else ''} = {t_f + t_b:.4f} ms")
        log(f"gated fused pair at the SVI shape (B, W, K, F) = ({Bs}, {SVI_W}, {K}, {F}), "
            f"bounds {b_f:.4f} + {b_b:.4f} ms: " + "; ".join(parts) + " (* the default S)")


def family_vb(fam, obs, prior, p0, label):
    """Phase 7: 5 VB iterations on each kernel route from p0, each route's
    kernels once per iteration; the ELBOs non-decreasing and within
    ELBO_RTOL of the "fused" route's. Returns (the launch counts by route,
    the "fused" route's final params)."""
    import torch

    from pysvihmm_tpu_torch.engines import batch_vb

    elbos, launches = {}, {}
    for route in ("fused", "split", "duplex"):
        torch.cuda.synchronize()
        reset_kernel_counts()
        t0 = time.perf_counter()
        p, e = batch_vb.fit(p0, prior, obs, fam, num_iters=VB_ITERS, method=route)
        if route == "fused":
            fitted = p
        torch.cuda.synchronize()
        launches[route] = kernel_counts()
        require_launches(launches[route], route, VB_ITERS, f"{label} VB on {route}")
        require_ascending(e, f"{label} VB on {route}")
        elbos[route] = e.double().cpu()
        log(f"  {label}, {route}: {time.perf_counter() - t0:.3f} s; ELBO "
            + ", ".join(f"{x:.6e}" for x in elbos[route].tolist()))
    for route in ("split", "duplex"):
        rel = ((elbos[route] - elbos["fused"]).abs() / elbos["fused"].abs()).max().item()
        log(f"  {label}: max relative ELBO difference {route} vs fused {rel:.3e}")
        require(rel <= ELBO_RTOL, f"{label}: {route} and fused ELBOs differ by {rel:.3e}")
    return launches, fitted


def check_family_routes(fam, obs, params, gen, label) -> None:
    """Phase 7: one family's kernel routes at full width against plain code,
    at the params of its VB fit. Each kernel pair's E-step against its twins
    on the family's own features and weights (the feature width F and the
    state count K the family gives: the multinomial's one-hot is F = 64,
    the kernels' limit, at K = 32), then batch_local_step on "fused",
    "split" and "duplex" against "scan"; both ungated and gated with SVI-like
    kept-masks."""
    import torch

    from pysvihmm_tpu_torch.engines.base import _fused_W, batch_local_step, prepare_fused_obs
    from pysvihmm_tpu_torch.messages import duplex_fb as df
    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.messages import split_fb as sf
    from pysvihmm_tpu_torch.models.hmm import expected_log_params

    feats = prepare_fused_obs(params, fam, obs)
    W = _fused_W(fam, params.emit)
    log_pi, log_A = expected_log_params(params)
    ll = (feats @ W).contiguous()
    T_, B_, F_ = feats.shape
    w = svi_masks(gen, B_, T_, (5 * T_) // 7)  # (T, B), the kernels' layout
    for weights in (None, w):
        log(f"  {label}: kernels vs twins, (B, T, K, F) = ({B_}, {T_}, {W.shape[1]}, {F_}), "
            f"gated={weights is not None}")
        fk, Sk = ff.estep_fused(log_pi, log_A, W, feats, emit_gamma=True, weights=weights)
        torch.cuda.synchronize()
        fr, Sr = ff.estep_fused_reference(log_pi, log_A, W, feats, True, weights)
        top = fr.gamma.max(dim=-1).values
        log(f"   max_k gamma: median {top.median().item():.4f}, min {top.min().item():.4f}")
        compare_estep("estep_fused vs estep_fused_reference", fk, fr, Sk, Sr)
        fk, Sk = df.estep_duplex(log_pi, log_A, W, feats, emit_gamma=True, weights=weights)
        torch.cuda.synchronize()
        fr, Sr = df.estep_duplex_reference(log_pi, log_A, W, feats, True, weights)
        compare_estep("estep_duplex vs estep_duplex_reference", fk, fr, Sk, Sr)
        fk = sf.estep_split(log_pi, log_A, ll, weights)
        torch.cuda.synchronize()
        fr = sf.estep_split_reference(log_pi, log_A, ll, weights)
        compare_estep("estep_split vs estep_split_reference", fk, fr)
    del fk, fr, feats, ll
    for weights in (None, w.transpose(0, 1).contiguous()):
        ss, _ = batch_local_step(params, fam, obs, "scan", weights=weights, need_gamma=False)
        for route in ("fused", "split", "duplex"):
            sk, _ = batch_local_step(params, fam, obs, route, weights=weights, need_gamma=False)
            torch.cuda.synchronize()
            log(f"  {label}: batch_local_step on {route} vs scan, gated={weights is not None}")
            compare_local_stats(sk, ss)


def check_wide(fam, obs, params, gen, label) -> None:
    """Phase 7: a family whose features are wider than the fused and duplex
    kernels take (F > FMAX = 64). On "fused" and on "duplex" each split
    kernel launches once and no other kernel does, and the statistics agree
    with "scan"'s, ungated and gated."""
    import torch

    from pysvihmm_tpu_torch.engines.base import (
        batch_local_step,
        feature_width,
        wider_than_fused_kernels,
    )

    require(wider_than_fused_kernels(fam, params.emit, obs), f"{label}: not wider than FMAX")
    B_, T_ = obs.shape[:2]
    w = svi_masks(gen, B_, T_, (5 * T_) // 7).transpose(0, 1).contiguous()
    for weights in (None, w):
        ss, _ = batch_local_step(params, fam, obs, "scan", weights=weights, need_gamma=False)
        for route in ("fused", "duplex"):
            torch.cuda.synchronize()
            reset_kernel_counts()
            sk, _ = batch_local_step(params, fam, obs, route, weights=weights, need_gamma=False)
            torch.cuda.synchronize()
            counts = kernel_counts()
            log(f"  {label}, F={feature_width(fam, params.emit, obs)}, B={B_}, T={T_}, on {route}, "
                f"gated={weights is not None}: the split kernels, against scan")
            require_launches(counts, "split", 1, f"{label} on {route}")
            compare_local_stats(sk, ss)


def small_family_fit(fam, gen_fn, kw, prior_kw, iters, restarts, dev, label):
    """Phase 7: VB on "auto" from ``restarts`` seeds on a small CPU-made
    dataset moved to the card; the fit of best final ELBO must decode at
    Hamming error <= 0.05 (single-seed VB can stop in a merged-state
    optimum; JAX's tests take the best of several restarts the same way)."""
    import torch

    from pysvihmm_tpu_torch.engines import batch_vb
    from pysvihmm_tpu_torch.engines.base import decode
    from pysvihmm_tpu_torch.eval.metrics import hamming_error
    from pysvihmm_tpu_torch.models.hmm import init_params, make_prior

    o, z, _ = gen_fn(torch.Generator().manual_seed(0), **kw)
    o = o.to(dev)
    K_ = kw["K"]
    prior = make_prior(K_, fam, device=dev, **prior_kw)
    best = None
    for r in range(restarts):
        p = init_params(torch.Generator().manual_seed(100 + r), prior, fam, o)
        p, e = batch_vb.fit(p, prior, o, fam, num_iters=iters)
        require_ascending(e, f"{label} small fit, restart {r}")
        if best is None or e[-1].item() > best[1]:
            best = (p, e[-1].item())
    ham = hamming_error(decode(best[0], fam, o), z, K_)
    log(f"  {label} small fit ({kw}, best of {restarts} x {iters} iterations): "
        f"ELBO {best[1]:.6e}, Hamming error {ham:.4f}")
    require(ham <= 0.05, f"{label}: Hamming error {ham} > 0.05 after the small fit")


def families_phase(dev) -> dict[str, dict[str, int]]:
    """Phase 7: the diagonal-Gaussian, Poisson and multinomial families at
    full width on every kernel route, the large-vocabulary multinomial, and
    a small fit per family. Returns the VB launch counts by family and route."""
    import torch

    from pysvihmm_tpu_torch.data import synthetic
    from pysvihmm_tpu_torch.distributions import (
        DiagonalGaussianNIG,
        GaussianNIW,
        MultinomialDirichlet,
        PoissonGamma,
    )
    from pysvihmm_tpu_torch.models.hmm import init_params, make_prior

    gen = torch.Generator(device=dev).manual_seed(7)
    launches = {}
    # the diagonal Gaussian's states overlap as phase 3's do, so that its
    # posteriors stay soft and the checks against plain code see rounding
    for label, fam, gen_fn, size, data_kw, prior_kw in (
        ("diag_gaussian", DiagonalGaussianNIG, synthetic.gen_diag_gaussian_dataset, D,
         dict(mean_scale=0.5, var_scale=1.0), dict(obs_dim=D)),
        ("poisson", PoissonGamma, synthetic.gen_poisson_dataset, D, {}, dict(obs_dim=D)),
        ("multinomial", MultinomialDirichlet, synthetic.gen_multinomial_dataset, 64, {},
         dict(num_symbols=64)),
    ):
        K_ = 32 if fam is MultinomialDirichlet else K
        obs, _, _ = gen_fn(gen, K_, size, B, T, **data_kw)
        prior = make_prior(K_, fam, device=dev, **prior_kw)
        p0 = init_params(gen, prior, fam, obs)
        log(f"  {label}: K={K_}, {'V' if fam is MultinomialDirichlet else 'D'}={size}, "
            f"B={B}, T={T}")
        launches[label], fitted = family_vb(fam, obs, prior, p0, label)
        check_family_routes(fam, obs, fitted, gen, label)

    # features wider than the fused and duplex kernels' FMAX: those routes
    # run the split kernels (the segment-sum above 256 symbols, the one-hot
    # product of the statistics below; the Gaussian's F = 66 at D = 10)
    for label, fam, size, K_, make in (
        ("multinomial V=1000", MultinomialDirichlet, 1000, 32, synthetic.gen_multinomial_dataset),
        ("multinomial V=100", MultinomialDirichlet, 100, 32, synthetic.gen_multinomial_dataset),
        ("gaussian_niw D=10", GaussianNIW, 10, K,
         lambda *a: synthetic.gen_gaussian_dataset(*a, mean_scale=0.5, cov_scale=1.0)),
    ):
        obs, _, _ = make(gen, K_, size, B, T)
        kw = dict(num_symbols=size) if fam is MultinomialDirichlet else dict(obs_dim=size)
        prior = make_prior(K_, fam, device=dev, **kw)
        check_wide(fam, obs, init_params(gen, prior, fam, obs), gen, f"{label} (K={K_})")

    small_family_fit(DiagonalGaussianNIG, synthetic.gen_diag_gaussian_dataset,
                     dict(K=4, D=2, num_seqs=20, T=200, mean_scale=6.0, var_scale=0.3),
                     dict(obs_dim=2), 50, 4, dev, "diag_gaussian")
    small_family_fit(PoissonGamma, synthetic.gen_poisson_dataset,
                     dict(K=4, D=8, num_seqs=20, T=200, rate_scale=25.0),
                     dict(obs_dim=8), 50, 4, dev, "poisson")
    small_family_fit(MultinomialDirichlet, synthetic.gen_multinomial_dataset,
                     dict(K=4, V=16, num_seqs=20, T=200, concentration=0.1, self_prob=0.95),
                     dict(num_symbols=16), 100, 8, dev, "multinomial")
    return launches


PROBE_C = 8  # steps a tile, debug_pallas_split.py:76
# (T, B, K, C) of phase 8's checks: small, an odd K with C = 4, full B, full
PROBE_SHAPES = ((16, 4, 8, 8), (24, 3, 33, 4), (16, 1024, 64, 8), (T, B, K, PROBE_C))
PROBE_LETTERS = "fbns12345"  # every variant of the profiling script


def compare_elementwise(name, got, ref, rtol: float, atol: float) -> float:
    """Max |got - ref|; raises unless got is finite and every element is
    within atol + rtol * |ref| (the probes' values span many decades, down
    to subnormals, so the bound is per element)."""
    import torch

    require(got.shape == ref.shape and got.dtype == ref.dtype,
            f"{name}: {tuple(got.shape)} {got.dtype} != {tuple(ref.shape)} {ref.dtype}")
    g, r = got.float(), ref.float()
    require(bool(torch.isfinite(g).all()), f"{name}: non-finite values from the kernel")
    err = (g - r).abs()
    worst = (err - rtol * r.abs()).max().item()
    log(f"    {name}: max_abs_err {err.max().item():.3e}, worst excess over rtol "
        f"{worst:.3e} (rtol {rtol:g}, atol {atol:g})")
    require(worst <= atol, f"{name}: kernel and plain version disagree")
    return err.max().item()


def check_probes(dev) -> dict[str, float]:
    """Phase 8, step 1: each probe kernel (every micro instance) against its
    twin on the same inputs at every shape of PROBE_SHAPES, one launch each.
    float32 to rtol 1e-5 per element with atol 1e-30 (another summation
    order; the micro bodies' third tile is subnormal); bf16 in its own
    dtype to rtol 1.6e-2, two bf16 ulps; "dot_only" on its written rows
    t % C == 0 only. Returns the max abs error of each at the full shape."""
    import torch

    from pysvihmm_tpu_torch.messages import split_probe as sp
    from pysvihmm_tpu_torch.scripts.debug_split import make_inputs
    from pysvihmm_tpu_torch.utils.roofline import MICRO_KERNELS

    errs = {}
    for T_, B_, K_, C_ in PROBE_SHAPES:
        log(f"  probes vs twins, (T, B, K, C) = {(T_, B_, K_, C_)}")
        pi, A, lik = make_inputs(B_, T_, K_, dev)
        checks = {
            "probe_fwd_nos_kernel": (lambda: [sp.probe_fwd_nos(pi, A, lik, C_)],
                                     lambda: [sp.probe_fwd_nos_reference(pi, A, lik, C_)],
                                     "alpha"),
            "probe_fwd_stack_kernel": (lambda: sp.probe_fwd_stack(pi, A, lik, C_),
                                       lambda: sp.probe_fwd_stack_reference(pi, A, lik, C_),
                                       "alpha s"),
        }
        for body, name in MICRO_KERNELS.items():
            checks[name] = (lambda b=body: [sp.probe_micro(pi, A, lik, C_, b)],
                            lambda b=body: [sp.probe_micro_reference(pi, A, lik, C_, b)],
                            "alpha")
        reset_kernel_counts()
        for name, (kernel, plain, outs) in checks.items():
            got = kernel()
            torch.cuda.synchronize()
            ref = plain()
            rows = slice(None, None, C_) if name == MICRO_KERNELS["dot_only"] else slice(None)
            bf16 = name == MICRO_KERNELS["dot_bf16"]
            log(f"   {name}")
            err = max(compare_elementwise(out, g[rows], r[rows], 1.6e-2 if bf16 else 1e-5, 1e-30)
                      for out, g, r in zip(outs.split(), got, ref))
            if (T_, B_) == (T, B):
                errs[name] = err
        counts = kernel_counts()
        for name, n in counts.items():
            want = 1 if name in checks else 0
            require(n == want, f"probe checks: {name} launched {n} times, expected {want}")
    return errs


def probe_phase(dev) -> tuple[dict, dict, dict, dict, dict]:
    """Phase 8: the split path's profiling script (pysvihmm_tpu_torch/
    scripts/debug_split.py) at its full shape. Checks every probe against
    its twin (:func:`check_probes`), then times the letters f b n s 1-5
    through the script's own timing function, the kernels (the counted run)
    and then their twins, and prints the breakdown of the split forward's
    time. Returns (max abs errors, kernel ms, twin ms, bounds, launches),
    each by kernel name."""
    from pysvihmm_tpu_torch.scripts.debug_split import (
        VARIANTS,
        bound_ms,
        make_inputs,
        time_letters,
    )

    errs = check_probes(dev)
    pi, A, lik = make_inputs(B, T, K, dev)
    reset_kernel_counts()
    ms = time_letters(PROBE_LETTERS, pi, A, lik, PROBE_C)
    counts = kernel_counts()
    twin = time_letters(PROBE_LETTERS, pi, A, lik, PROBE_C, plain=True, iters=1)
    # each variant: a warm-up and 20 timed launches; "b" takes one forward more
    runs = 1 + 20
    for name, n in counts.items():
        want = {"split_fwd_kernel": runs + 1}.get(name, runs)
        if name not in {kernel for _, kernel in VARIANTS.values()}:
            want = 0
        require(n == want, f"phase 8 timing: {name} launched {n} times, expected {want}")
    log(f"  launches in the timed run: {counts}")
    by_kernel = {kernel: label for label, kernel in VARIANTS.values()}
    kms, tms, bounds = {}, {}, {}
    for kernel, label in by_kernel.items():
        kms[kernel], tms[kernel] = ms[label], twin[label]
        bounds[kernel] = bound_ms(label, B, T, K, PROBE_C)
        b_ms, b_by = bounds[kernel]
        log(f"{label:10s} {kernel:32s} {ms[label]:8.3f} ms, twin {twin[label]:9.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), {100 * b_ms / ms[label]:.1f} % of it, at (T, B, K, C) = "
            f"({T}, {B}, {K}, {PROBE_C})")
    d = ms
    store = d["dot_store"]
    log(f"split_fwd_kernel {d['fwd']:.3f} ms = products {d['dot_only']:.3f} + stores "
        f"{store - d['dot_only']:.3f} + lik loads and products, renorm every 4th "
        f"{d['fwd_nos'] - store:.3f} + per-step sums {d['fwd_stack'] - d['fwd_nos']:.3f} "
        f"+ shift, exp and per-step renorm {d['fwd'] - d['fwd_stack']:.3f}; against dot_store: "
        f"bf16 {d['dot_bf16'] - store:+.3f}, interleaving x8 {d['chunk8'] - store:+.3f}, "
        f"x4 {d['chunk4'] - store:+.3f}")
    return errs, kms, tms, bounds, counts


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 1

    from pysvihmm_tpu_torch import _build
    from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu_torch.distributions import GaussianNIW
    from pysvihmm_tpu_torch.distributions.niw import NIW
    from pysvihmm_tpu_torch.engines import batch_vb, svi
    from pysvihmm_tpu_torch.engines.base import (
        batch_local_step,
        decode,
        lower_bound,
        windowed_local_step,
    )
    from pysvihmm_tpu_torch.eval.metrics import hamming_error
    from pysvihmm_tpu_torch.messages import duplex_fb as df
    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.messages import resolve_method
    from pysvihmm_tpu_torch.messages import split_fb as sf
    from pysvihmm_tpu_torch.models.hmm import HMMParams, init_params, make_prior
    from pysvihmm_tpu_torch.scripts.debug_split import card_line, cuda_ms
    from pysvihmm_tpu_torch.utils.precision import f32_matmuls
    from pysvihmm_tpu_torch.utils.roofline import bound, kernel_work

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)

    log("== phase 1: device")
    card = card_line()
    log(card)
    kind = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {kind}, "
        f"{torch.cuda.device_count()} visible")
    log(f"precision policy: {f32_matmuls()}")

    log("== phase 2: build")
    libs = ("fused_fb", "split_fb", "duplex_fb", "split_probe")
    t0 = time.perf_counter()
    _build.build(list(libs))
    for name in libs:
        _build.load_library(name)
    log(f"built and loaded {', '.join(_build.library_path(n).name for n in libs)} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc, in parallel: "
        + ", ".join(f"{n} {_build.build_seconds.get(n, 0.0):.2f} s" for n in libs) + ")")
    for name in libs:
        for line in _build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas ({name}): {line.strip()}")

    log("== phase 3: kernels against their plain versions")
    gen = torch.Generator(device=dev).manual_seed(1234)
    check_kernels(gen, (8, 50, 4, 2))
    fwd_err, bwd_err, full_inputs = check_kernels(gen, (B, T, K, D))
    check_gated_fused(gen, 8, SVI_W, 4, 2, SVI_L)
    check_gated_fused(gen, B, SVI_W, K, D, SVI_L)
    split_err = {"split_fwd_kernel": 0.0, "split_bwd_kernel": 0.0}
    for shape in ((8, 50, 4, 2), (B, SVI_W, K, D), (B, T, K, D)):
        for gated in (False, True):
            e_f, e_b, inputs = check_split(gen, *shape, gated)
            if shape[1] == T and shape[0] == B:
                split_err["split_fwd_kernel"] = max(split_err["split_fwd_kernel"], e_f)
                split_err["split_bwd_kernel"] = max(split_err["split_bwd_kernel"], e_b)
                if not gated:
                    split_inputs = inputs
    check_duplex(gen, 8, 50, 4, 2, False)
    check_duplex(gen, 8, 50, 4, 2, True)
    chain_err, comb_err, duplex_inputs = check_duplex(gen, B, T, K, D, False)
    check_duplex(gen, B, SVI_W, K, D, True)

    log("== phase 4: batch VB at B=1024, T=1000, K=64, D=8")
    gen = torch.Generator(device=dev).manual_seed(0)
    obs, _, _ = gen_gaussian_dataset(gen, K, D, B, T)
    prior = make_prior(K, GaussianNIW, obs_dim=D, device=dev)
    p0 = init_params(gen, prior, GaussianNIW, obs)
    method = resolve_method("auto", obs.device)
    require(method == "fused", f'method="auto" resolved to {method!r} on the card')
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    params, elbos = batch_vb.fit(p0, prior, obs, GaussianNIW, num_iters=VB_ITERS, method="auto")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    vb_launches = kernel_counts()
    log(f"launches during the {VB_ITERS}-iteration fit: {vb_launches}")
    require_launches(vb_launches, "auto", VB_ITERS, f"{VB_ITERS}-iteration fit")
    e = elbos.double().cpu()
    log("ELBO per iteration: " + ", ".join(f"{x:.6e}" for x in e.tolist()))
    require(bool(torch.isfinite(e).all()), "non-finite ELBO")
    rel = (e[1:] - e[:-1]) / e[:-1].abs()
    log(f"smallest relative ELBO change: {rel.min().item():.3e}")
    require(bool((rel > MAX_REL_DROP).all()), "ELBO decreased")
    log(f"VB, first fit: {fit_s:.3f} s for {VB_ITERS} iterations (host clock, synchronised; "
        "includes first-use costs of the CUDA libraries and the one-off feature build)")
    t0 = time.perf_counter()
    _, elbos_again = batch_vb.fit(p0, prior, obs, GaussianNIW, num_iters=VB_ITERS)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    log(f"VB, same fit again: {warm_s:.3f} s, {1e3 * warm_s / VB_ITERS:.3f} ms per iteration "
        f"(ELBO after {VB_ITERS}: {elbos_again[-1].item():.6e})")
    lb = lower_bound(params, prior, GaussianNIW, obs).item()
    require(math.isfinite(lb), "non-finite lower bound")
    log(f"lower_bound (exact) after the fit: {lb:.6e}")

    log(f"  the same {VB_ITERS} iterations through method=\"duplex\"")
    torch.cuda.synchronize()
    reset_kernel_counts()
    t0 = time.perf_counter()
    params_d, elbos_d = batch_vb.fit(p0, prior, obs, GaussianNIW, num_iters=VB_ITERS,
                                     method="duplex")
    torch.cuda.synchronize()
    duplex_s = time.perf_counter() - t0
    vb_duplex_launches = kernel_counts()
    log(f"  launches: {vb_duplex_launches}")
    require_launches(vb_duplex_launches, "duplex", VB_ITERS, f"{VB_ITERS}-iteration duplex fit")
    require_ascending(elbos_d, "duplex VB")
    ed = elbos_d.double().cpu()
    rel = ((ed - e).abs() / e.abs()).max().item()
    log("  ELBO per iteration: " + ", ".join(f"{x:.6e}" for x in ed.tolist())
        + f"; max relative difference from auto {rel:.3e} ({duplex_s:.3f} s)")
    require(rel <= ELBO_RTOL, f"duplex and auto ELBOs differ by {rel:.3e}")
    lb_d = lower_bound(params, prior, GaussianNIW, obs, "duplex").item()
    log(f"  lower_bound on duplex {lb_d:.6e} (fused {lb:.6e})")
    require(abs(lb_d - lb) <= ELBO_RTOL * abs(lb), "duplex and fused lower bounds differ")

    log("  canonical small fit: K=4, D=2, 20 x 200, mean_scale=6, cov_scale=0.3, 50 iterations")
    g_small = torch.Generator().manual_seed(0)
    o_s, z_s, _ = gen_gaussian_dataset(g_small, 4, 2, 20, 200, mean_scale=6.0, cov_scale=0.3)
    o_s = o_s.to(dev)
    prior_s = make_prior(4, GaussianNIW, obs_dim=2, device=dev)
    p_s = init_params(torch.Generator().manual_seed(0), prior_s, GaussianNIW, o_s)
    p_s, el_s = batch_vb.fit(p_s, prior_s, o_s, GaussianNIW, num_iters=50)
    n_bwd = ff.fused_backward.launches
    z_hat = decode(p_s, GaussianNIW, o_s)
    torch.cuda.synchronize()
    require(ff.fused_backward.launches == n_bwd + 1, "decode did not run the backward kernel")
    ham = hamming_error(z_hat, z_s, 4)
    log(f"  final ELBO {el_s[-1].item():.6e}, Hamming error {ham:.4f}")
    require(ham <= 0.05, f"Hamming error {ham} > 0.05")

    log(f"== phase 5: times (CUDA events; {card})")
    pi_t, A_t, W, feats, a_r, s_r, sh_r = full_inputs
    F = feats.shape[-1]
    spi_t, A_s, ll, sa_r, ss_r, ssh_r, _ = split_inputs
    dpi_t, A_d, W_d, feats_d, da_r, ds_r, dsh_r, db_r = duplex_inputs
    timed = {
        "fused_fwd_kernel": (lambda: ff.fused_forward(pi_t, A_t, W, feats),
                             lambda: ff.forward_reference(pi_t, A_t, W, feats)),
        "fused_bwd_kernel": (lambda: ff.fused_backward(A_t, W, feats, a_r, s_r, sh_r, False),
                             lambda: ff.backward_reference(A_t, W, feats, a_r, s_r, sh_r, False)),
        "split_fwd_kernel": (lambda: sf.split_forward(spi_t, A_s, ll),
                             lambda: sf.split_forward_reference(spi_t, A_s, ll)),
        "split_bwd_kernel": (lambda: sf.split_backward(A_s, ll, sa_r, ss_r, ssh_r),
                             lambda: sf.split_backward_reference(A_s, ll, sa_r, ss_r, ssh_r)),
        "duplex_chain_kernel": (lambda: df.duplex_chain(dpi_t, A_d, W_d, feats_d),
                                lambda: df.duplex_chain_reference(dpi_t, A_d, W_d, feats_d)),
        "duplex_combine_kernel": (
            lambda: df.duplex_combine(W_d, feats_d, da_r, db_r, dsh_r),
            lambda: df.duplex_combine_reference(W_d, feats_d, da_r, db_r, dsh_r)),
    }
    ms, plain_ms, bounds = {}, {}, {}
    for name, (kernel, plain) in timed.items():
        # a longer warm-up: the first kernel timed after the light small fit
        # read 20 % slow once with a single warm-up call
        ms[name] = cuda_ms(kernel, 20, warmup=5)
        plain_ms[name] = cuda_ms(plain, 3)
        bounds[name] = bound(*kernel_work(name, B, T, K, F))
        log(f"{name}: {ms[name]:.3f} ms, plain twin {plain_ms[name]:.3f} ms, bound "
            f"{bounds[name][0]:.3f} ms ({bounds[name][1]}) at (B, T, K, F) = ({B}, {T}, {K}, {F})")
    fused_layout(full_inputs, ms)
    fused_large_batches(torch.Generator(device=dev).manual_seed(80))
    svi_shape_pair(torch.Generator(device=dev).manual_seed(79))

    # what the gates cost at the same shape (kept runs of 5T/7 per sequence)
    w_full = svi_masks(torch.Generator(device=dev).manual_seed(78), B, T, (5 * T) // 7)
    g_full = sf.pair_gate(w_full)
    gated_ms = {
        "fused_bwd_kernel": cuda_ms(
            lambda: ff.fused_backward(A_t, W, feats, a_r, s_r, sh_r, False, w_full), 10),
        "split_bwd_kernel": cuda_ms(
            lambda: sf.split_backward(A_s, ll, sa_r, ss_r, ssh_r, g_full), 10),
        "duplex_combine_kernel": cuda_ms(
            lambda: df.duplex_combine(W_d, feats_d, da_r, db_r, dsh_r, False, w_full), 10),
    }
    for name, t_ms in gated_ms.items():
        log(f"{name}, gated: {t_ms:.3f} ms (ungated {ms[name]:.3f} ms) at (B, T, K, F) = "
            f"({B}, {T}, {K}, {F})")

    # the SVI route's shape: W=70 windows, gated, emit_gamma on the fused route
    gen = torch.Generator(device=dev).manual_seed(77)
    lp_w, lA_w, W_w, f_w = random_problem(gen, B, SVI_W, K, D)
    m_w = svi_masks(gen, B, SVI_W, SVI_L)
    pi_w, A_w = torch.exp(lp_w).contiguous(), torch.exp(lA_w).contiguous()
    ll_w = (f_w @ W_w).contiguous()
    fa, fs, fsh = ff.fused_forward(pi_w, A_w, W_w, f_w)
    sa, ss, ssh = sf.split_forward(pi_w, A_w, ll_w)
    da, _, dsh, db = df.duplex_chain(pi_w, A_w, W_w, f_w)
    g_w = sf.pair_gate(m_w)
    at_w = {
        "fused_fwd_kernel": (lambda: ff.fused_forward(pi_w, A_w, W_w, f_w), {}),
        "fused_bwd_kernel": (lambda: ff.fused_backward(A_w, W_w, f_w, fa, fs, fsh, True, m_w),
                             {"gated": True, "emit_gamma": True}),
        "split_fwd_kernel": (lambda: sf.split_forward(pi_w, A_w, ll_w), {}),
        "split_bwd_kernel": (lambda: sf.split_backward(A_w, ll_w, sa, ss, ssh, g_w),
                             {"gated": True}),
        "duplex_chain_kernel": (lambda: df.duplex_chain(pi_w, A_w, W_w, f_w), {}),
        "duplex_combine_kernel": (lambda: df.duplex_combine(W_w, f_w, da, db, dsh, True, m_w),
                                  {"gated": True, "emit_gamma": True}),
    }
    for name, (kernel, kw) in at_w.items():
        t_ms = cuda_ms(kernel, 20)
        b_ms, b_by = bound(*kernel_work(name, B, SVI_W, K, F, **kw))
        log(f"{name} at the SVI shape (B, W, K, F) = ({B}, {SVI_W}, {K}, {F}), {kw or 'plain'}: "
            f"{t_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")

    carry = torch.zeros((), device=dev)

    def estep(route):
        # bench.py:62-84: perturb every parameter group, consume every stat
        nonlocal carry
        eps = carry * 1e-30
        p = HMMParams(init=params.init + eps, trans=params.trans + eps,
                      emit=NIW(*(x + eps for x in params.emit)))
        stats, _ = batch_local_step(p, GaussianNIW, obs, route, need_gamma=False)
        tot = stats.log_z + stats.trans.sum() + stats.init.sum()
        tot = tot + sum(x.sum() for x in stats.emit)
        carry = tot * 0.0 + carry
        return tot

    estep_ms = {}
    for route in ("fused", "split", "duplex", "scan"):
        estep_ms[route] = cuda_ms(lambda: estep(route), TIMED_ITERS, warmup=2)
        require(bool(torch.isfinite(estep(route))), f"non-finite statistics on route {route}")
        log(f"E-step route {route}: {estep_ms[route]:.3f} ms, {B / (estep_ms[route] / 1e3):.1f} "
            f"seq/s (B={B}, T={T}, K={K}, D={D}, need_gamma=False, features built per call)")
    del obs, params

    # overlapping states (as random_problem), so that posteriors stay soft and
    # the cross-route comparison of phase 6 sees more than saturated gammas
    log(f"  flagship chain: K={K}, D={D}, one chain of T={SVI_T}, mean_scale=0.5, cov_scale=1")
    gen = torch.Generator(device=dev).manual_seed(2)
    t0 = time.perf_counter()
    chain = gen_gaussian_dataset(gen, K, D, 1, SVI_T, mean_scale=0.5, cov_scale=1.0)[0][0]
    prior = make_prior(K, GaussianNIW, obs_dim=D, device=dev)
    p0 = init_params(gen, prior, GaussianNIW, chain)
    torch.cuda.synchronize()
    log(f"  chain and init made in {time.perf_counter() - t0:.2f} s (set-up)")
    for Bs in SVI_BATCHES:
        cfg = svi.SVIConfig(batch_size=Bs, subchain_len=SVI_L, buffer=SVI_BUF)
        line = []
        for route in ("fused", "split", "duplex", "scan"):
            t_ms = svi_step_ms(route, cfg, p0, prior, chain, SVI_STEPS)
            line.append(f"{route} {t_ms:.3f} ms ({Bs * SVI_W / t_ms * 1e3:.4g} window obs/s)")
        log(f"SVI step, B={Bs}, L={SVI_L}, b={SVI_BUF}, W={SVI_W}, {SVI_STEPS} chained steps: "
            + "; ".join(line))
    for Bs in (SVI_BATCHES[0], SVI_BATCHES[-1]):
        profile_svi(svi.SVIConfig(batch_size=Bs, subchain_len=SVI_L, buffer=SVI_BUF),
                    p0, prior, chain, 10)

    log(f"== phase 6: windowed SVI at K={K}, D={D}, T={SVI_T}, B={B}, L={SVI_L}, b={SVI_BUF}")
    cfg = svi.SVIConfig(batch_size=B, subchain_len=SVI_L, buffer=SVI_BUF)
    svi_launches = {}
    for route in ("auto", "split", "duplex"):
        t0 = time.perf_counter()
        state, ne, counts = svi_run(route, cfg, p0, prior, chain, seed=11, steps=SVI_STEPS)
        log(f"  {route}: {SVI_STEPS} steps checked in {time.perf_counter() - t0:.2f} s; "
            f"launches {counts}")
        log(f"  {route}: noisy ELBO " + ", ".join(f"{x:.6e}" for x in ne[:3]) + " ... "
            + ", ".join(f"{x:.6e}" for x in ne[-3:]))
        for name in ROUTE_KERNELS[route]:
            svi_launches[name] = counts[name]

    log("  one step's statistics on every kernel route, same windows (the duplex run's final "
        "params)")
    starts = torch.randint(0, SVI_T - SVI_L + 1, (B,), generator=gen, device=dev)
    ws = torch.clamp(starts - SVI_BUF, 0, SVI_T - SVI_W)
    offs = starts - ws
    windows = svi._gather_windows(chain, ws, SVI_W)
    pos = torch.arange(SVI_W, device=dev)[None, :]
    maskf = ((pos >= offs[:, None]) & (pos < offs[:, None] + SVI_L)).float()
    out = {r: windowed_local_step(state.params, GaussianNIW, windows, maskf, offs, r)
           for r in ("fused", "split", "duplex")}
    top = out["split"][2].max(dim=1).values
    log(f"  max_k gamma at the window starts: min {top.min().item():.4f}, "
        f"median {top.median().item():.4f}")
    require(top.median().item() < 0.99, "phase-6 posteriors are saturated; the check sees little")
    # the fused route computes ll in-kernel (an fmaf chain), the split route
    # as one cuBLAS float32 product: another rounding of the same numbers
    for other in ("split", "duplex"):
        log(f"   fused vs {other}")
        for name, a, b in zip(("n", "sum_y", "sum_yyT"), out["fused"][0], out[other][0]):
            compare(f"emit {name}", a, b, 3e-3, 2e-3)
        compare("trans_stats", out["fused"][1], out[other][1], 1e-4, 1e-3)
        compare("gamma_at_start", out["fused"][2], out[other][2], 0.0, 5e-5)
        compare("log_c", out["fused"][3], out[other][3], 2e-6, 1e-4)

    log("  small SVI fit on auto: K=4, D=2, T=3000, B=16, L=50, b=10, tau=10, kappa=0.6, "
        "300 steps")
    o_c, z_c, _ = gen_gaussian_dataset(torch.Generator().manual_seed(5), 4, 2, 1, 3000,
                                       mean_scale=6.0, cov_scale=0.3)
    c_small = o_c[0].to(dev)
    prior_c = make_prior(4, GaussianNIW, obs_dim=2, device=dev)
    p_c = init_params(torch.Generator().manual_seed(6), prior_c, GaussianNIW, c_small)
    cfg_c = svi.SVIConfig(batch_size=16, subchain_len=50, buffer=10, tau=10.0, kappa=0.6)
    reset_kernel_counts()
    t0 = time.perf_counter()
    # the starts drawn on the host from the seed of tests/test_torch_svi.py
    st_c, m_c = svi.fit(svi.init_state(p_c, torch.Generator().manual_seed(7)),
                        prior_c, c_small, GaussianNIW, cfg_c, 300)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    require(kernel_counts()["fused_bwd_kernel"] == 300, "the small fit did not run the kernels")
    require_sane_params(st_c.params, "small SVI fit")
    ham = hamming_error(decode(st_c.params, GaussianNIW, c_small[None]), z_c, 4)
    ne = m_c["noisy_elbo"].cpu()
    log(f"  300 steps in {fit_s:.3f} s (host clock, synchronised); noisy ELBO first 20 mean "
        f"{ne[:20].mean().item():.6e}, last 50 mean {ne[-50:].mean().item():.6e}; "
        f"Hamming error {ham:.4f}")
    require(bool(torch.isfinite(ne).all()), "non-finite noisy ELBO in the small fit")
    require(ham < 0.05, f"Hamming error {ham} >= 0.05 after the small SVI fit")

    log(f"== phase 7: the other emission families at B={B}, T={T}")
    t0 = time.perf_counter()
    fam_launches = families_phase(dev)
    launched = {fam: {route: {k: n for k, n in counts.items() if n}
                      for route, counts in by_route.items()}
                for fam, by_route in fam_launches.items()}
    log(f"  phase 7 took {time.perf_counter() - t0:.1f} s; VB launches by family and route: "
        + json.dumps(launched))

    log(f"== phase 8: split path decomposition (scripts/debug_split.py) at (T, B, K, C) = "
        f"({T}, {B}, {K}, {PROBE_C})")
    t0 = time.perf_counter()
    probe_errs, probe_ms, probe_twin_ms, probe_bounds, probe_launches = probe_phase(dev)
    log(f"  phase 8 took {time.perf_counter() - t0:.1f} s")

    errs = {"fused_fwd_kernel": fwd_err, "fused_bwd_kernel": bwd_err, **split_err,
            "duplex_chain_kernel": chain_err, "duplex_combine_kernel": comb_err}
    kernels = []
    for name, src, replaces in (
        ("fused_fwd_kernel", "fused_fb.cu", "pallas_fb.py:516"),
        ("fused_bwd_kernel", "fused_fb.cu", "pallas_fb.py:577"),
        ("split_fwd_kernel", "split_fb.cu", "pallas_fb.py:339"),
        ("split_bwd_kernel", "split_fb.cu", "pallas_fb.py:406"),
        ("duplex_chain_kernel", "duplex_fb.cu", "pallas_duplex.py:82"),
        ("duplex_combine_kernel", "duplex_fb.cu", "pallas_duplex.py:175"),
    ):
        kernels.append({
            "name": name, "route": "cuda", "source": f"pysvihmm_tpu_torch/csrc/{src}",
            "replaces": f"pysvihmm_tpu/messages/{replaces}",
            "launches": svi_launches[name], "max_abs_err": errs[name],
            "ms": ms[name], "plain_ms": plain_ms[name], "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1], "library_ms": None,
        })
    # the probes: the kernel body each replaces in scripts/debug_pallas_split.py
    for name, line in (("probe_fwd_nos_kernel", 25), ("probe_fwd_stack_kernel", 48),
                       ("probe_micro_kernel<DOT_ONLY>", 229),
                       ("probe_micro_kernel<DOT_STORE>", 235),
                       ("probe_micro_kernel<BF16>", 241),
                       ("probe_micro_kernel<CHUNKED, 8>", 250),
                       ("probe_micro_kernel<CHUNKED, 4>", 250)):
        kernels.append({
            "name": name, "route": "cuda", "source": "pysvihmm_tpu_torch/csrc/split_probe.cu",
            "replaces": f"scripts/debug_pallas_split.py:{line}",
            "launches": probe_launches[name], "max_abs_err": probe_errs[name],
            "ms": probe_ms[name], "plain_ms": probe_twin_ms[name],
            "bound_ms": probe_bounds[name][0], "bound_by": probe_bounds[name][1],
            "library_ms": None,
        })
    log(f"total {time.perf_counter() - t_start:.1f} s; in the kernels line: launches over the "
        f"{SVI_STEPS} SVI steps of each kernel's route (phase 6) and, for the probes, in phase "
        f"8's timed run; max_abs_err the forward's and the chain's log_c (nats), the backward's "
        f"and the combine's gamma at B={B}, T={T}, each probe's alpha (and s) at (T, B, K, C) = "
        f"({T}, {B}, {K}, {PROBE_C}); ms, plain_ms and bound_ms at (B, T, K, F) = ({B}, {T}, {K}, "
        f"{F}), ungated, and for the probes at C={PROBE_C}")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
