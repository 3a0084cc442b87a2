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
            a small shape (the combine's stages of 8 steps do not divide
            T=50) and at B=1024, T=1000, K=64 (``emit_gamma`` True and
            False), gated at B=1024, W=70, K=64, and the chain's alpha, s
            and sh against the fused forward's, bit for bit; the duplex
            kernels again at the combine's tile edges (T = 1, T and B not
            multiples of its 8 x 8 tiles, windows of the large-K statistics
            whose edges cut a block's chunk at K = 256), gated and not, and
            the chain at every S against the fused forward at every S, bit
            for bit, at B = 1, 3, 32, 1024 and 2048 and K = 64, 65, 128,
            129 and 256 (the large-K chain built for S = 1, 2, 4, 8); all
            under stated tolerances. Then the large-K instances of all six
            kernels the same way at K = 65, 128, 129 and 256 on a small
            shape and at B=1024, T=1000, D=8 for K = 128 and 256, gated and
            not (the duplex chain bit for bit there too); the large-K fused
            pair at every built S (sequences a block: 1, 2, 4, 8) at that
            full shape, K = 128 and 256: alpha, s, sh, gamma, gamma0, acc
            and eacc (ungated and gated) the same bits at every S, and the
            duplex chain at every S: alpha, s and sh those of the forward
            at that S, beta the same bits at every S; and each
            backward kernel (fused, split, duplex combine), gated and not,
            5 times on one full-shape input at K = 64, 128 and 256: acc and
            eacc must be the same bits every time. The split pair at every
            built S (sequences a block, ``split_fb.built_seqs``) against its
            twins, gated and not, at B = 1, 3, 32, 1024, 2048 and K = 64,
            128, 129, 256 (T = 300, 150 at B = 2048: three windows of the
            large-K statistics): every output the same bits at every S and
            over the backward's five calls at each S. Last, the precision gate
            of the large-K outer sums (3xTF32 on the tensor cores): on every
            window of one backward at B=1024, T=1000, D=8, K = 128 and 256
            (the operands from plain PyTorch), acc's and eacc's max |err| /
            max |ref| against float64 at most twice float32 torch.matmul's
            (TF32 off), and the same bits over 5 calls.
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
            outputs); the same for the duplex chain (waves of its 2
            ceil(B/S) blocks) and the combine's registers, shared bytes and
            blocks an SM; the large-K fused pair at K = 128 and 256 for every
            (KP, S) and kernel (forward, backward, gated backward):
            registers, spills, static and dynamic shared bytes, blocks an
            SM, waves at B=1024, time and share of the bound (the default S
            in one wave); the large-K duplex chain the same way at K = 128
            and 256 (waves of its 2 ceil(B/S) blocks; the default S the
            one-wave rule's pick, which at KP = 256 takes two waves); the
            split pair the same way at K = 64, 128 and 256
            (every built S of the forward, the backward and the gated
            backward; the default S in one wave); the pair at every S for B =
            2048 and 4096; the gated
            fused pair at the SVI shape for B in {32, 256, 1024}; the
            E-step of the benchmark shape (need_gamma=False) on the kernel
            and plain routes, and the SVI step at B in {32, 256, 1024} on
            "fused", "split", "duplex" and "scan", timed with CUDA events;
            a profile of the SVI step. Each route kernel's large-K
            instances at K = 128 and 256 (B=1024, T=1000, F=45) against
            its twin and bound (their registers, spills and shared bytes
            are phase 2's ptxas lines). The large-K outer sums alone over
            the products of one backward at K = 128 and 256, beside one
            torch.matmul a product in float32 (and TF32, for reference).
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
            and not; features wider than 64 (the multinomial at V=1000 and
            V=100, K=32, and the Gaussian-NIW at D=10, K=64, F=66, each at
            B=1024, T=1000), routed as JAX routes them: "fused" runs the
            fused pair (its WF instances) but above 256 symbols the split
            kernels, "duplex" and "split" the split kernels, each route's
            kernels once and no other kernel, with statistics that agree
            with "scan"'s, gated and not; the wide-feature path on "auto",
            timed by CUDA events beside explicit "split" and "scan": batch
            VB's E-step for the Gaussian-NIW at D = 10 (F = 66; K = 64 and
            256) and the multinomial at V = 1000 and V = 100 (K = 64) at
            B=1024, T=1000, each kernel of the route once an E-step and the
            statistics those of "scan" (the device time of one "auto" call
            by kernel from torch.profiler), and windowed SVI steps for the
            multinomial at V = 100, K = 64, W = 70, B = 1024 (the gated fused
            backward, each fused kernel once a step, one step's statistics
            on "auto" and "split" against "scan"'s); and a small fit per
            family (best ELBO of a few restarts) decodes at Hamming error
            <= 0.05.
8. split path decomposition: the profiling script
            ``pysvihmm_tpu_torch/scripts/debug_split.py``. Each probe kernel
            of ``csrc/split_probe.cu`` (every micro instance) against its
            twin at (T, B, K, C) = (16, 4, 8, 8), (24, 3, 33, 4),
            (16, 1024, 64, 8) and (1000, 1024, 64, 8); then the script's
            timing function over the letters f b n s 1-5 at the full shape
            (the kernels, whose launches are counted, then the twins), one
            line per variant with its bound and share, and the split
            forward's time split into products, stores, likelihood loads,
            sums and the shift and exp. The large-K probes are checked at
            K = 65, 128 (B=1024) and 256, and at the full shape at K = 128
            and 256, where they are timed too.
9. large K: batch VB at K=256, B=1024, T=1000, D=8, 5 iterations on
            "auto", "split" and "duplex" (each route's kernels once an
            iteration, ELBO non-decreasing, the routes' ELBOs within 1e-5
            relative, each route's local step against "scan"); then 10 SVI
            steps on "auto" at K=128, W=70, B=1024 on a T=100,000 chain and
            3 on "split" and "duplex", every parameter finite after every
            step; the outer sums launched once a window for acc and once for
            eacc in every backward of those runs.
10. engines: the engines and decoders beyond batch VB and SVI at K=64,
            D=8 on the card. Batch SGD, 5 iterations at B=1024, T=1000 on
            "auto" (one fused pair an iteration, finite ELBOs, step 0 with
            rho = 1 batch VB's step to 1e-5 relative); Viterbi decoding and
            predictive scoring (plug-in and exact) at its params against
            float64 on the CPU (path scores and values to 1e-5 relative);
            3 blocked-Gibbs sweeps at B=1024, T=1000 and one sweep fed the
            same draws on the card and in float64 on the CPU (at least
            99.9 % of the paths the same, theta to 1e-4 relative);
            meta-observation SVI on a T=100,000 chain of overlapping states,
            Lm=50, b=10, M=1024 (W=70): 10 steps on "auto", one gated fused
            pair a step, sane params, one block set's statistics on "auto"
            against "scan"; select_buffer at L=50 with 1024 probes (the
            split pair only); best-of-4 batch-VB restarts (the index
            returned is the argmax of the final ELBOs).
11. surface: the training loop and the user surface at K=64, D=8.
            Windowed SVI through ``engines/trainer.py`` on the phase-6
            chain (B=1024, L=50, b=10, "auto"): 20 steps uninterrupted
            against 11 with checkpoints every 4 and a fresh state resumed
            to 20, with power and adaptive step sizes; every leaf (params,
            step, adaptive state, generator state) the same sha256. The
            streamed step (``parallel.make_dp_streamed_svi_step``, adaptive)
            over a .npy corpus of 4096 x 1000 x 8 streamed by
            ``data/loader.py`` (4 batches of 1024 an epoch): 10 steps
            against 5 and a resume across the epoch boundary, the same
            sha256; the prefetched batches the resident corpus' bits; ms a
            step streamed and resident, torch.profiler's busy share. The
            CLI in-process (``__main__.main``): ``experiment`` with each of
            the five engines (JSONL records finite, Hamming in [0, 1], the
            svi checkpoint restored) and ``baseline --scale 1 --configs
            1,2,3`` (its asserts). The compat classes: VBHMM at B=1024,
            T=1000 (one fused pair an iteration, ELBO non-decreasing), the
            small canonical fit (Hamming <= 0.05), SVIHMM(buffer="auto")
            (select_buffer's split pair only, then the fused pair a step)
            and a GibbsHMM sweep at B=1024. hamming_error_long at T=10^7,
            K=64 equal to hamming_error on the CPU.

12. long chains: the long-chain tiers (plain PyTorch, as in JAX: no
            kernel) on config 4's Gaussian chain, K=64, D=8. At T = 10^5
            ``long_chain_local_stats`` "fused", "twophase" and "assoc" and
            ``batch_local_step`` "assoc" and "blocked" against the fused
            kernels at B = 1 (log Z to 1e-5 relative, init, trans and each
            emission leaf to 1e-4 of its max) and log Z against the
            two-phase tier in float64 (1e-6); at T = 10^6 the fused tier with
            stored and rematerialised alphas, statistics and decode the same
            sha256; at T = 10^5 ``long_chain_decode`` against argmax gamma
            of the fused pair (99.99 %, the rest ties); at T = 10^7 the fused
            E-step timed, its three phases apart (phase 2 as CUDA graphs and
            eagerly, the same bits), torch.profiler's busy share, 3
            long-chain VB iterations (ELBO non-decreasing), the decode at
            the generating params (Hamming <= 0.05) and the time-minor
            layout against time-major (1e-6, both sha256 and times); then a
            multinomial chain, K=32, V=64, T = 5 x 10^7 (int32 tokens, block
            1024): the E-step's time, log Z finite, the decode's Hamming.

13. parallel: the parallel paths (``parallel/``, the time- and state-sharded
            tiers: plain PyTorch, no kernel of their own; the data-parallel
            steps run the fused pair on every rank). (a) NCCL in a world of
            one in this process at B=1024, T=1000, K=64, D=8 on "auto":
            ``sharded_local_step`` and 5 DP VB iterations the same sha256 as
            ``batch_local_step`` and batch VB's step; the minibatch,
            streamed and metaobs steps on the same indices, batch and blocks
            the single-process steps' bits, then 10 steps each (the fused
            pair once a step, params finite, every psi factorises); the
            collective-isolation reading of bench_scaling.py (t_local /
            t_psum). (b) Four gloo ranks spawned on the one card (the
            kernels built here, loaded there): DP VB at B=1024, 256 a rank,
            against (a) (ELBOs 1e-5 relative, statistics 1e-4 of each
            leaf's max); time-sharded streaming VB on phase 12's T = 10^7
            chain in 4 tiles (log Z against phase 12's to 1e-5, 3
            iterations non-decreasing, the decode at the generating params
            Hamming <= 0.05); state-sharded forward-backward at K=256,
            T=1024 (64 states a rank) against the fused kernels at B = 1 and
            a VB step against batch VB's; the (2, 2) (data, time) batched
            forward-backward at B=64, T=4096 against the fused kernels; the
            streamed trainer over a .npy corpus killed at 5 of 10 steps and
            resumed on every rank (the same sha256). A rank that raises or
            outlives 300 s fails the phase. One card measures no scaling.
14. kernel modes: the fused kernels' three modes (``in_kernel_feats``,
            ``gamma_sel``, bf16-stored alpha). (a) NIW and NIG at D=8 on the
            raw observations: the fused pair at every built S, the duplex
            chain at every built S and the combine, gated and not,
            emit_gamma both ways, at K = 64, 65, 128, 256 and B = 1, 3,
            1024 (T = 1000, 300 at K = 256), every output the array mode's
            on ``ell_features(obs)`` by sha256, and the default S against
            the twins in the mode. (b) The gated fused backward at W=70,
            B = 32, 256, 1024, K = 64 and 128 with the pick at each window's
            kept offset: emit_gamma's gamma there bit for bit, acc, eacc
            and the E-step's log_c those without the pick. (c) bf16 alpha:
            float32's alpha rounded bit for bit at every S, s the rounded
            sums, statistics and log Z in JAX's band, ``exact=True`` the
            float32 bits; config 4's windowed SVI with bf16 alpha (params
            finite and psi factorisable after every step, Hamming printed).
            The main path in the modes: VB with in-kernel features for both
            Gaussian families on "fused" and "duplex" (the array mode's
            ELBOs bit for bit) and SVI with the pick (the gather's params).
            (d) Times by CUDA events: each mode's kernels beside their
            twins and bounds, bench.py's E-step array against in-kernel at
            K = 64, 128, 256, the SVI step with and without the pick.
15. wide features: the fused pair at F > 64 (its WF instances: W^T in
            shared memory up to K = 64 and eacc summed off the chain, W read
            from L2 above) and the split pair's bf16 alpha. (a) At F = 65,
            66, 100, 153, 256, 300 (NIG D=32, NIW D=10, one-hot V=100, NIW
            D=16, one-hot V=256, NIW D=23), K = 64 and 256 at B = 1024 and
            K = 4 and 128 at B = 3 (T = 150): every S that fits the card,
            alpha, s, sh, gamma, gamma0 and eacc the same bits at every S
            (acc too above K = 64) and over a second call, a built kind's
            outputs the array mode's, the pick emit_gamma's gamma, bf16
            alpha float32's rounded, bit for bit; the default S against the
            twins, bf16 in JAX's band. (b) The split pair's bf16 alpha at K
            = 64, 128, 256: float32's rounded at every S, against the bf16
            twins, ``exact=True`` float32's bits. The main path on "auto" at
            B=1024, T=1000: the E-step for the Gaussian-NIW at D=10 (K = 64
            and 256, and in-kernel at 64), the multinomial at V=100 and at
            V=1000 with bf16 alpha (the split pair), windowed SVI at V=100
            with and without the pick and bf16 alpha; every instance counted.
            (d) Times: the WF pair at F = 66-300 (K = 64) and 66, 256 (K =
            128, 256), ungated and gated, beside twins, bounds and the split
            route's E-step; in-kernel NIW at D = 10, 16, 23; the pick at W =
            70; bf16 against float32 (the fused pair at F = 66, the split
            pair at K = 64 and 256).

The last lines are the card line, one JSON line describing the kernels (every
kernel and instance tier: K <= 64, KP = 128, KP = 256, the split and duplex
chain rows with the S their times ran at; the outer sums at K = 128 and 256, the one entry
with a library call) and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import os
import sys
import tempfile
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
    likelihood dot's rounding; trans and emit are sums over B*T terms that
    the kernels group otherwise than the twins (relative bounds)."""
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
    keeps its first step and window 1, where B > 1, drops it (when W > L)."""
    import torch

    offs = torch.randint(0, W_ - L_ + 1, (B_,), generator=gen, device=gen.device)
    offs[0] = 0
    if B_ > 1:
        offs[1] = W_ - L_
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
    # gamma in probability units; acc and eacc are sums over B*T terms that
    # the kernel groups otherwise than the twin (relative bounds)
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
    gam, acc = sf.split_backward(A_t, ll, a_r, s_r, sh_r, w)
    torch.cuda.synchronize()
    require(sf.split_backward.launches == n_bwd + 1, "split backward launch was not counted")
    gam_r, acc_r = sf.split_backward_reference(A_t, ll, a_r, s_r, sh_r, w)
    bwd_err = compare("gamma", gam, gam_r, 0.0, 5e-5)
    compare("acc", acc, acc_r, 1e-4, 1e-3)
    fk = sf.estep_split(log_pi, log_A, ll, w)
    torch.cuda.synchronize()
    fr = sf.estep_split_reference(log_pi, log_A, ll, w)
    compare_estep("estep_split vs estep_split_reference", fk, fr)
    return fwd_err, bwd_err, (pi_t, A_t, ll, a_r, s_r, sh_r, w)


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


# (B, T, K) at the duplex combine's tile edges: T = 1, T and B not multiples
# of its 8 x 8 tiles, and at K = 256 windows of the large-K statistics (131
# steps at B = 1000, 64 at B = 2048) whose edges cut a block's chunk
COMBINE_EDGES = ((1, 1, 64), (13, 19, 64), (9, 23, 33), (7, 9, 128), (1000, 300, 256),
                 (2048, 150, 256))
CHAIN_BATCHES = (1, 3, 32, 1024, 2048)  # the last block short, one wave and two at S = 2


def check_duplex_edges(gen) -> None:
    """Phase 3: the duplex kernels against their twins at COMBINE_EDGES,
    gated and not (D = 3), and the chain at every built S against the fused
    forward at that S, alpha, s and sh bit for bit and beta the same bits
    at every S, at CHAIN_BATCHES (T = 40, K = 64 and each K of
    SMALL_LARGE_K)."""
    import torch

    from pysvihmm_tpu_torch.messages import duplex_fb as df
    from pysvihmm_tpu_torch.messages import fused_fb as ff

    for B_, T_, K_ in COMBINE_EDGES:
        for gated in (False, True):
            check_duplex(gen, B_, T_, K_, 3, gated)
    for K_ in (K, *SMALL_LARGE_K):
        for B_ in CHAIN_BATCHES:
            log_pi, log_A, W, feats = random_problem(gen, B_, 40, K_, D)
            pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
            first = df.duplex_chain(pi_t, A_t, W, feats)
            same = []
            for S in df.built_seqs(K_):
                got = df._launch_chain(S, pi_t, A_t, W, feats)
                fwd = ff._launch_forward(S, pi_t, A_t, W, feats)
                same.append(all(torch.equal(x, y) for x, y in zip(got[:3], fwd))
                            and torch.equal(got[3], first[3]))
            torch.cuda.synchronize()
            log(f"  duplex chain at (B, T, K, D) = ({B_}, 40, {K_}, {D}), S in "
                f"{df.built_seqs(K_)}: alpha, s, sh the fused forward's and beta the same at "
                f"every S, bit for bit: {same}")
            require(all(same), f"the duplex chain at B={B_}, K={K_} is not the fused forward's "
                               "bit for bit")


LARGE_K = (128, 256)  # the large-K tiers: 65-128 states run KP = 128, 129-256 KP = 256
SMALL_LARGE_K = (65, 128, 129, 256)  # both ends of both tiers


def check_large_k(gen) -> dict[tuple[str, int], float]:
    """Phase 3 above K = 64: every route kernel against its twin at each K of
    SMALL_LARGE_K on a small shape and at B=1024, T=1000, D=8 for each K of
    LARGE_K, gated and not (the duplex chain's alpha, s and sh the fused
    forward's bit for bit, a ``require``). Returns the max errors at full
    width by (kernel, K): the forwards' log_c, the backwards' gamma."""
    import torch

    errs = {}
    for K_ in SMALL_LARGE_K:
        check_kernels(gen, (8, 50, K_, 2))
        for gated in (False, True):
            check_split(gen, 8, 50, K_, 2, gated)
            check_duplex(gen, 8, 50, K_, 2, gated)
    for K_ in LARGE_K:
        e_f, e_b, _ = check_kernels(gen, (B, T, K_, D))
        errs["fused_fwd_kernel", K_], errs["fused_bwd_kernel", K_] = e_f, e_b
        for gated in (False, True):
            e_f, e_b, _ = check_split(gen, B, T, K_, D, gated)
            errs["split_fwd_kernel", K_] = max(errs.get(("split_fwd_kernel", K_), 0.0), e_f)
            errs["split_bwd_kernel", K_] = max(errs.get(("split_bwd_kernel", K_), 0.0), e_b)
            e_c, e_m, _ = check_duplex(gen, B, T, K_, D, gated)
            errs["duplex_chain_kernel", K_] = max(errs.get(("duplex_chain_kernel", K_), 0.0), e_c)
            errs["duplex_combine_kernel", K_] = max(errs.get(("duplex_combine_kernel", K_), 0.0),
                                                    e_m)
        torch.cuda.empty_cache()
    return errs


def check_wide_seqs(gen) -> None:
    """Phase 3: the large-K fused pair and duplex chain at every built S
    (sequences a block, ``fused_fb.WIDE_SEQS``) at B=1024, T=1000, D=8 for
    each K of LARGE_K: the forward's alpha, s and sh, and the backward's
    gamma, gamma0, acc and eacc (emit_gamma, ungated and gated), must be the
    same bits at every S (each sequence's arithmetic and the statistics'
    order do not depend on S), the duplex chain's alpha, s and sh at each S
    those of the fused forward at that S and its beta the same bits at
    every S; then the default chain's alpha, s and sh those of the forward;
    all ``require``s."""
    import torch

    from pysvihmm_tpu_torch.messages import duplex_fb as df
    from pysvihmm_tpu_torch.messages import fused_fb as ff

    for K_ in LARGE_K:
        log_pi, log_A, W, feats = random_problem(gen, B, T, K_, D)
        w = svi_masks(gen, B, T, (5 * T) // 7)
        pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
        ref = None
        for S in ff.WIDE_SEQS:
            fwd = ff._launch_forward(S, pi_t, A_t, W, feats)
            if ref is None:
                ref = {"fwd": fwd}
            outs = {"fwd": fwd}
            for name, weights in (("bwd", None), ("gated bwd", w)):
                outs[name] = ff._launch_backward(S, A_t, W, feats, *ref["fwd"], True, weights)
                ref.setdefault(name, outs[name])
            torch.cuda.synchronize()
            same = {name: all(torch.equal(x, y) for x, y in zip(got, ref[name]))
                    for name, got in outs.items()}
            del outs
            log(f"  fused pair at (B, T, K, F) = ({B}, {T}, {K_}, {feats.shape[-1]}), S={S}: "
                f"the same bits as S={ff.WIDE_SEQS[0]} (alpha, s, sh; gamma, gamma0, acc, eacc "
                f"ungated and gated): {same}")
            require(all(same.values()), f"the large-K fused pair at K={K_}, S={S} differs "
                                        f"from S={ff.WIDE_SEQS[0]}")
            chain = df._launch_chain(S, pi_t, A_t, W, feats)
            ref.setdefault("beta", chain[3])
            torch.cuda.synchronize()
            same = [all(torch.equal(x, y) for x, y in zip(chain[:3], fwd)),
                    torch.equal(chain[3], ref["beta"])]
            del chain, fwd
            log(f"  duplex chain at K={K_}, S={S}: alpha, s, sh the fused forward's at S={S}, "
                f"beta the bits of S={ff.WIDE_SEQS[0]}: {same}")
            require(all(same), f"the duplex chain at K={K_}, S={S} is not the fused forward's "
                               f"or its beta differs from S={ff.WIDE_SEQS[0]}")
        chain = df.duplex_chain(pi_t, A_t, W, feats)
        torch.cuda.synchronize()
        same = (all(torch.equal(x, y) for x, y in zip(chain[:3], ref["fwd"]))
                and torch.equal(chain[3], ref["beta"]))
        log(f"  duplex chain at K={K_}, the default S="
            f"{df.default_seqs(B, feats.shape[-1], feats.device, K=K_)}: alpha, s, sh the fused "
            f"forward's and beta the bits of every S: {same}")
        require(same, f"the duplex chain at K={K_} is not the fused forward's bit for bit")
        del chain, ref, feats, w
        torch.cuda.empty_cache()


# (B, K) of the split pair's checks at every S: one sequence, the last block
# short, a small SVI batch, one wave and two; both tiers at their ends and a
# K that is not a power of two; T takes three windows of the large-K
# statistics at B = 1024 and 2048
SPLIT_SEQ_B = (1, 3, 32, 1024, 2048)
SPLIT_SEQ_K = (64, 128, 129, 256)
SPLIT_KINDS = ("forward", "backward", "gated backward")


def check_split_seqs(gen) -> None:
    """Phase 3: each split instance at every built S (``split_fb.built_seqs``)
    against its twins, ungated and gated, for B in SPLIT_SEQ_B and K in
    SPLIT_SEQ_K (T = 300, 150 at B = 2048; D = 3). ``require``s: alpha, s, sh,
    gamma and acc the same bits at every S (each sequence's arithmetic and
    acc's order do not depend on S), and each backward's five calls at each
    S the same bits."""
    import torch

    from pysvihmm_tpu_torch.messages import split_fb as sf

    def within(name, got, ref, rtol, atol):
        err = (got - ref).abs().max().item()
        require(bool(torch.isfinite(got).all()) and err <= atol + rtol * ref.abs().max().item(),
                f"{name}: kernel and plain version disagree ({err:.3e})")
        return err

    for K_ in SPLIT_SEQ_K:
        for B_ in SPLIT_SEQ_B:
            T_ = 150 if B_ > 1024 else 300
            log_pi, log_A, W, feats = random_problem(gen, B_, T_, K_, 3)
            ll = (feats @ W).contiguous()
            del feats
            w = svi_masks(gen, B_, T_, (3 * T_) // 4)
            pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
            ref = sf.split_forward_reference(pi_t, A_t, ll)
            errs, first = {}, {}
            for kind, weights in zip(SPLIT_KINDS, (None, None, w)):
                ref_b = None if kind == "forward" else sf.split_backward_reference(
                    A_t, ll, *ref, weights)
                for S in sf.built_seqs(kind, K_):
                    if kind == "forward":
                        got = sf.split_forward(pi_t, A_t, ll, S=S)
                        torch.cuda.synchronize()
                        e = max(within("alpha", got[0], ref[0], 0.0, 5e-5),
                                within("s", got[1], ref[1], 0.0, 5e-5))
                        require(torch.equal(got[2], ref[2]), "sh is a max: kernel and twin agree")
                    else:
                        calls = [sf.split_backward(A_t, ll, *ref, weights, S=S) for _ in range(5)]
                        torch.cuda.synchronize()
                        got = calls[0]
                        require(all(torch.equal(x, y) for c in calls[1:] for x, y in zip(c, got)),
                                f"split {kind} at K={K_}, B={B_}, S={S}: five calls differ")
                        e = within("gamma", got[0], ref_b[0], 0.0, 5e-5)
                        within("acc", got[1], ref_b[1], 1e-4, 1e-3)
                        del calls
                    errs[kind] = max(errs.get(kind, 0.0), e)
                    first.setdefault(kind, got)
                    require(all(torch.equal(x, y) for x, y in zip(got, first[kind])),
                            f"split {kind} at K={K_}, B={B_}: S={S} differs from "
                            f"S={sf.built_seqs(kind, K_)[0]}")
                    del got
            log(f"  split pair at (B, T, K) = ({B_}, {T_}, {K_}): every S the same bits, the "
                "backward's five calls the same bits; " + ", ".join(
                    f"{kind} S={sf.built_seqs(kind, K_)} max err {e:.2e}"
                    for kind, e in errs.items()))
            del ref, ll, first
        torch.cuda.empty_cache()


def check_repeatable(gen, K_) -> None:
    """Phase 3: each backward kernel (the fused backward, the split backward,
    the duplex combine), gated and not, 5 times on one input at B=1024,
    T=1000, D=8: acc and eacc must be the same bits every time (a
    ``require``), since the sums across blocks run in an order fixed by the
    shapes."""
    import torch

    from pysvihmm_tpu_torch.messages import duplex_fb as df
    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.messages import split_fb as sf

    log_pi, log_A, W, feats = random_problem(gen, B, T, K_, D)
    w = svi_masks(gen, B, T, (5 * T) // 7)
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    a, s, sh, beta = df.duplex_chain(pi_t, A_t, W, feats)
    ll = (feats @ W).contiguous()
    for weights in (None, w):
        calls = {
            "fused_bwd_kernel": lambda: ff.fused_backward(A_t, W, feats, a, s, sh, False, weights)[2:],
            "split_bwd_kernel": lambda: sf.split_backward(A_t, ll, a, s, sh, weights)[1:],
            "duplex_combine_kernel": lambda: df.duplex_combine(W, feats, a, beta, sh, False,
                                                               weights)[2:],
        }
        for name, call in calls.items():
            first = [x.clone() for x in call()]
            same = [all(torch.equal(x, y) for x, y in zip(call(), first)) for _ in range(4)]
            torch.cuda.synchronize()
            log(f"  {name} at (B, T, K, F) = ({B}, {T}, {K_}, {feats.shape[-1]}), gated="
                f"{weights is not None}: acc and eacc equal bit for bit over 5 calls: {all(same)}")
            require(all(same), f"{name}: acc or eacc changed between identical calls at K={K_}")
    del a, beta, ll, feats


WIDE_ROWS = 1 << 17  # (t, b) rows a window of the large-K statistics (csrc/fb_stats.cuh)
OUTER_NAME = "outer_partial_kernel"  # the outer sums' kernel (+ sum_partials_kernel)
OUTER_RATIO = 2.0  # the outer sums' error against float64, at most this times float32 matmul's


def stat_windows(A_t, W, feats, alpha, s, sh):
    """The operands the large-K backward's outer sums take, window by window,
    from plain PyTorch: windows of WIDE_ROWS // B steps, the last first
    (``fb_stats.cuh::WideStats``), each a pair ((X, Y) of acc, (X, Y) of
    eacc): acc over the window's steps t >= 1, X = alpha_{t-1} and Y = d_t
    n_t (the split backward twin's dn); eacc over its steps, X = gamma_t and
    Y = f_t; rows (t, b) in order, ungated."""
    import torch

    from pysvihmm_tpu_torch.messages.split_fb import SUM_FLOOR

    T_, B_, F_ = feats.shape
    K_ = A_t.shape[0]
    lik = torch.exp(feats @ W - sh.T[..., None])
    r = 1.0 / torch.clamp_min(s, SUM_FLOOR)
    beta = r[:, T_ - 1, None].expand(B_, K_)
    dn, gamma = torch.zeros_like(alpha), torch.empty_like(alpha)
    for t in range(T_ - 1, -1, -1):  # split_fb.split_backward_reference's recursion
        graw = alpha[t] * beta
        n = 1.0 / torch.clamp_min(graw.sum(dim=-1), SUM_FLOOR)
        gamma[t] = graw * n[:, None]
        if t >= 1:
            d = (lik[t] * r[:, t - 1, None]) * beta
            dn[t] = d * n[:, None]
            beta = d @ A_t.T
    steps = max(1, min(T_, WIDE_ROWS // B_))
    wins = []
    for t1 in range(T_, 0, -steps):
        t0 = max(0, t1 - steps)
        ta = max(t0, 1)
        wins.append(((alpha[ta - 1:t1 - 1].reshape(-1, K_), dn[ta:t1].reshape(-1, K_)),
                     (gamma[t0:t1].reshape(-1, K_), feats[t0:t1].reshape(-1, F_))))
    return wins


def outer_errors(X, Y) -> tuple[float, float, float]:
    """(the kernel's max |err| / max |ref|, float32 torch.matmul's, the
    kernel's max |err|) of X^T Y against float64 on the same operands."""
    import torch

    from pysvihmm_tpu_torch.messages import fused_fb as ff

    ref = X.double().T @ Y.double()
    got, mm = ff.outer_sum(X, Y), torch.matmul(X.T, Y)
    scale = ref.abs().max().item()
    err = (got.double() - ref).abs().max().item()
    return err / scale, (mm.double() - ref).abs().max().item() / scale, err


def check_outer_sums(gen) -> dict[int, float]:
    """Phase 3, the precision gate of the large-K outer sums (3xTF32 on the
    tensor cores), at B=1024, T=1000, D=8 (F=45) for each K of LARGE_K, on
    the windows one backward sums (:func:`stat_windows` of the fused
    forward's outputs): on every window, acc's and eacc's max |err| / max
    |ref| against float64 at most OUTER_RATIO times float32 torch.matmul's
    (TF32 off) on the same operands; and five calls on one window the same
    bits. Returns acc's largest max |err| by K."""
    import torch

    from pysvihmm_tpu_torch.messages import fused_fb as ff

    errs = {}
    for K_ in LARGE_K:
        log_pi, log_A, W, feats = random_problem(gen, B, T, K_, D)
        pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
        wins = stat_windows(A_t, W, feats, *ff.fused_forward(pi_t, A_t, W, feats))
        worst = {}
        for w, pair in enumerate(wins):
            for name, (X, Y) in zip(("acc", "eacc"), pair):
                e_k, e_m, e_abs = outer_errors(X, Y)
                log(f"    K={K_}, window {w} ({X.shape[0]} rows), {name}: kernel {e_k:.3e}, "
                    f"float32 matmul {e_m:.3e} (of max|ref|), ratio {e_k / max(e_m, 1e-30):.2f}")
                require(e_k <= OUTER_RATIO * e_m,
                        f"K={K_}, window {w}, {name}: the outer sums' error {e_k:.3e} is above "
                        f"{OUTER_RATIO} x float32 matmul's {e_m:.3e}")
                prev = worst.get(name, (0.0, 0.0, 0.0))
                worst[name] = tuple(max(a, b) for a, b in zip(prev, (e_k, e_m, e_abs)))
        for name, (e_k, e_m, _) in worst.items():
            log(f"  K={K_}, {name} over {len(wins)} windows: kernel at most {e_k:.3e}, float32 "
                f"matmul at most {e_m:.3e} of max|ref| against float64")
        errs[K_] = worst["acc"][2]
        for name, (X, Y) in zip(("acc", "eacc"), wins[0]):
            first = ff.outer_sum(X, Y)
            same = all(torch.equal(ff.outer_sum(X, Y), first) for _ in range(4))
            torch.cuda.synchronize()
            log(f"  K={K_}, {name} of window 0: the same bits over 5 calls: {same}")
            require(same, f"the outer sums changed between identical calls at K={K_}")
        del wins, feats
        torch.cuda.empty_cache()
    return errs


def time_outer_sums(gen) -> tuple[dict, dict, dict, dict]:
    """Phase 5: the outer sums alone over every window of one backward (acc
    and eacc, :func:`stat_windows`) at B=1024, T=1000, F=45 for each K of
    LARGE_K, by CUDA events, beside their twin and one torch.matmul(X.T, Y)
    a window in float32 (TF32 off, the yardstick; TF32 on is logged for
    reference). Returns (ms, twin ms, matmul ms, bounds) by K."""
    import torch

    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms
    from pysvihmm_tpu_torch.utils.precision import f32_matmuls
    from pysvihmm_tpu_torch.utils.roofline import bound, kernel_work

    ms, plain_ms, lib_ms, bounds = {}, {}, {}, {}
    for K_ in LARGE_K:
        log_pi, log_A, W, feats = random_problem(gen, B, T, K_, D)
        pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
        wins = stat_windows(A_t, W, feats, *ff.fused_forward(pi_t, A_t, W, feats))
        pairs = [xy for pair in wins for xy in pair]
        ms[K_] = cuda_ms(lambda: [ff.outer_sum(X, Y) for X, Y in pairs], 20, warmup=3)
        plain_ms[K_] = cuda_ms(lambda: [ff.outer_sum_reference(X, Y) for X, Y in pairs], 20)
        lib_ms[K_] = cuda_ms(lambda: [torch.matmul(X.T, Y) for X, Y in pairs], 20)
        torch.backends.cuda.matmul.allow_tf32 = True
        tf32_ms = cuda_ms(lambda: [torch.matmul(X.T, Y) for X, Y in pairs], 20)
        f32_matmuls()
        bounds[K_] = bound(*kernel_work("outer_sums", B, T, K_, feats.shape[-1]))
        log(f"outer sums (outer_partial_kernel + sum_partials_kernel), the {len(pairs)} products "
            f"of one backward at (B, T, K, F) = ({B}, {T}, {K_}, {feats.shape[-1]}): "
            f"{ms[K_]:.3f} ms, twin {plain_ms[K_]:.3f} ms, torch.matmul float32 {lib_ms[K_]:.3f} "
            f"ms (TF32 {tf32_ms:.3f} ms, reference only), bound {bounds[K_][0]:.3f} ms "
            f"({bounds[K_][1]}), {100 * bounds[K_][0] / ms[K_]:.1f} % of it")
        del wins, pairs, feats
        torch.cuda.empty_cache()
    return ms, plain_ms, lib_ms, bounds


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
    ff.outer_launches(clear=True)
    for name in ff.PREP_KERNELS:
        ff.prep_launches(name, clear=True)


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

    emit = params.emit if isinstance(params.emit, tuple) else (params.emit,)
    for x in (params.init, params.trans, *emit):
        require(bool(torch.isfinite(x).all()), f"{what}: a non-finite parameter")
    if hasattr(params.emit, "psi"):
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


def duplex_layout(duplex_inputs, chain_ms: float) -> None:
    """Phase 5: the duplex chain's block layout at the VB shape. For every
    built S: the library's registers, shared bytes, spills and resident
    blocks an SM, the waves of 2 ceil(B/S) blocks (a forward and a backward
    block a group), the time and share of the bound, and the outputs against
    the default S's, bit for bit. Then the combine's instances (ungated and
    gated): registers, shared bytes, spills, blocks an SM and the blocks of
    the launch."""
    import torch

    from pysvihmm_tpu_torch.messages import duplex_fb as df
    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms
    from pysvihmm_tpu_torch.utils.roofline import bound, kernel_work

    pi_t, A_t, W, feats = duplex_inputs[:4]
    F = feats.shape[-1]
    b_ms = bound(*kernel_work("duplex_chain_kernel", B, T, K, F))[0]
    chosen = df.default_seqs(B, F, feats.device)
    ref = df.duplex_chain(pi_t, A_t, W, feats)
    for S in ff.SEQS:
        info = df.kernel_info("chain", S, F)
        blocks = 2 * -(-B // S)
        waves = blocks / (info["blocks_per_sm"] * info["sms"])
        got = df._launch_chain(S, pi_t, A_t, W, feats)
        torch.cuda.synchronize()
        require(all(torch.equal(x, y) for x, y in zip(got, ref)),
                f"duplex_chain_kernel: S={S} differs from S={chosen}")
        del got
        t_ms = cuda_ms(lambda S=S: df._launch_chain(S, pi_t, A_t, W, feats), 20, warmup=3)
        log(f"duplex_chain_kernel S={S}{' (default)' if S == chosen else ''}: "
            f"{info['registers']} registers, {info['local_bytes']} spilled bytes, "
            f"{info['static_smem'] + info['dynamic_smem']} shared bytes a block, "
            f"{info['blocks_per_sm']} blocks an SM of {info['sms']}, {blocks} blocks = "
            f"{waves:.3f} waves at B={B}; {t_ms:.3f} ms, bound {b_ms:.3f} ms, "
            f"{100 * b_ms / t_ms:.1f} % of it")
    log(f"duplex_chain_kernel: S={chosen} at B={B}; {chain_ms:.3f} ms (timed above), "
        f"{100 * b_ms / chain_ms:.1f} % of the bound")
    groups = -(-B // 8)
    for kind in ("combine", "gated combine"):
        info = df.kernel_info(kind, 0, F)
        log(f"duplex_combine_kernel ({kind}, K <= {K}, F={F}): {info['registers']} registers, "
            f"{info['local_bytes']} spilled bytes, {info['static_smem'] + info['dynamic_smem']} "
            f"shared bytes a block of {info['threads']} threads, {info['blocks_per_sm']} blocks "
            f"an SM of {info['sms']}; {groups} groups of 8 sequences at B={B}")


def duplex_wide_layout(gen) -> None:
    """Phase 5: the large-K duplex chain's block layout at B=1024, T=1000,
    D=8 for each K of LARGE_K. For every built S (``duplex_fb.built_seqs``):
    the library's registers, spills, static and dynamic shared bytes and
    resident blocks an SM, the waves of 2 ceil(B/S) blocks (a forward and a
    backward block a group), the time (CUDA events) and share of the bound.
    The default S must be the one-wave rule's pick over those instances
    (``fused_fb.seqs_per_block``, two blocks a group)."""
    import torch

    from pysvihmm_tpu_torch.messages import duplex_fb as df
    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms
    from pysvihmm_tpu_torch.utils.roofline import bound, kernel_work

    name = "duplex_chain_kernel"
    for K_ in LARGE_K:
        log_pi, log_A, W, feats = random_problem(gen, B, T, K_, D)
        pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
        F_ = feats.shape[-1]
        b_ms = bound(*kernel_work(name, B, T, K_, F_))[0]
        chosen = df.default_seqs(B, F_, feats.device, K=K_)
        seqs = df.built_seqs(K_)
        infos = {S: df.kernel_info("chain", S, F_, K=K_) for S in seqs}
        rule = ff.seqs_per_block(B, {S: i["blocks_per_sm"] * i["sms"] for S, i in infos.items()},
                                 2, seqs)
        require(chosen == rule, f"{name} at K={K_}: the default S={chosen} is not the rule's "
                                f"S={rule}")
        for S, info in infos.items():
            blocks = 2 * -(-B // S)
            waves = blocks / (info["blocks_per_sm"] * info["sms"])
            t_ms = cuda_ms(lambda: df._launch_chain(S, pi_t, A_t, W, feats), 10, warmup=2)
            log(f"{tier_name(name, K_)} S={S}{' (default)' if S == chosen else ''}: "
                f"{info['registers']} registers, {info['local_bytes']} spilled bytes, "
                f"{info['static_smem']} static + {info['dynamic_smem']} dynamic shared bytes "
                f"a block of {info['threads']} threads, {info['blocks_per_sm']} blocks an SM "
                f"of {info['sms']}, {blocks} blocks = {waves:.3f} waves at B={B}; "
                f"{t_ms:.3f} ms, bound {b_ms:.3f} ms, {100 * b_ms / t_ms:.1f} % of it")
        del feats
        torch.cuda.empty_cache()


def wide_layout(gen) -> None:
    """Phase 5: the large-K fused pair's block layout at B=1024, T=1000, D=8
    for each K of LARGE_K. For every built S (``fused_fb.WIDE_SEQS``) and
    kernel (forward, backward, gated backward): the library's registers,
    spills, static and dynamic shared bytes and resident blocks an SM, the
    waves of ceil(B/S) blocks, the time (CUDA events) and share of the bound.
    The default S must run in one wave."""
    import torch

    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms
    from pysvihmm_tpu_torch.utils.roofline import bound, kernel_work

    for K_ in LARGE_K:
        log_pi, log_A, W, feats = random_problem(gen, B, T, K_, D)
        w = svi_masks(gen, B, T, (5 * T) // 7)
        pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
        F_ = feats.shape[-1]
        a, s, sh = ff.fused_forward(pi_t, A_t, W, feats)
        runs = {
            "forward": (lambda S: ff._launch_forward(S, pi_t, A_t, W, feats),
                        "fused_fwd_kernel", {}),
            "backward": (lambda S: ff._launch_backward(S, A_t, W, feats, a, s, sh),
                         "fused_bwd_kernel", {}),
            "gated backward": (
                lambda S: ff._launch_backward(S, A_t, W, feats, a, s, sh, False, w),
                "fused_bwd_kernel", {"gated": True}),
        }
        for kind, (run, name, kw) in runs.items():
            b_ms = bound(*kernel_work(name, B, T, K_, F_, **kw))[0]
            chosen = ff.default_seqs(kind, B, F_, feats.device, K=K_)
            for S in ff.WIDE_SEQS:
                info = ff.kernel_info(kind, S, F_, K=K_)
                blocks = -(-B // S)
                waves = blocks / (info["blocks_per_sm"] * info["sms"])
                t_ms = cuda_ms(lambda: run(S), 10, warmup=2)
                log(f"{tier_name(name, K_)} {kind} S={S}{' (default)' if S == chosen else ''}: "
                    f"{info['registers']} registers, {info['local_bytes']} spilled bytes, "
                    f"{info['static_smem']} static + {info['dynamic_smem']} dynamic shared bytes "
                    f"a block of {info['threads']} threads, {info['blocks_per_sm']} blocks an SM "
                    f"of {info['sms']}, {blocks} blocks = {waves:.3f} waves at B={B}; "
                    f"{t_ms:.3f} ms, bound {b_ms:.3f} ms, {100 * b_ms / t_ms:.1f} % of it")
                if S == chosen:
                    require(waves <= 1.0, f"{name} at K={K_}: B={B} takes {waves:.3f} waves at "
                                          f"S={S}")
        del a, s, sh, feats, w, runs
        torch.cuda.empty_cache()


def split_layout(gen) -> None:
    """Phase 5: the split pair's block layout at B=1024, T=1000 for K = 64,
    128 and 256. For every built S (``split_fb.built_seqs``) and kernel
    (forward, backward, gated backward): the library's registers, spills,
    static and dynamic shared bytes and resident blocks an SM, the waves of
    ceil(B/S) blocks, the time (CUDA events) and share of the bound. The
    default S must run in one wave."""
    import torch

    from pysvihmm_tpu_torch.messages import split_fb as sf
    from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms
    from pysvihmm_tpu_torch.utils.roofline import bound, kernel_work

    for K_ in (K, *LARGE_K):
        log_pi, log_A, W, feats = random_problem(gen, B, T, K_, D)
        ll = (feats @ W).contiguous()
        del feats
        w = svi_masks(gen, B, T, (5 * T) // 7)
        pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
        fwd = sf.split_forward(pi_t, A_t, ll)
        runs = {"forward": lambda S: sf.split_forward(pi_t, A_t, ll, S=S),
                "backward": lambda S: sf.split_backward(A_t, ll, *fwd, S=S),
                "gated backward": lambda S: sf.split_backward(A_t, ll, *fwd, w, S=S)}
        for kind, run in runs.items():
            name = "split_fwd_kernel" if kind == "forward" else "split_bwd_kernel"
            b_ms = bound(*kernel_work(name, B, T, K_, 0, gated=kind == "gated backward"))[0]
            chosen = sf.default_seqs(kind, B, ll.device, K=K_)
            for S in sf.built_seqs(kind, K_):
                info = sf.kernel_info(kind, S, ll.device, K=K_)
                blocks = -(-B // S)
                waves = blocks / (info["blocks_per_sm"] * info["sms"])
                t_ms = cuda_ms(lambda: run(S), 10, warmup=2)
                log(f"{tier_name(name, K_)} {kind} S={S}{' (default)' if S == chosen else ''}: "
                    f"{info['registers']} registers, {info['local_bytes']} spilled bytes, "
                    f"{info['static_smem']} static + {info['dynamic_smem']} dynamic shared bytes "
                    f"a block of {info['threads']} threads, {info['blocks_per_sm']} blocks an SM "
                    f"of {info['sms']}, {blocks} blocks = {waves:.3f} waves at B={B}; "
                    f"{t_ms:.3f} ms, bound {b_ms:.3f} ms, {100 * b_ms / t_ms:.1f} % of it")
                if S == chosen:
                    require(waves <= 1.0, f"split {kind} at K={K_}: B={B} takes {waves:.3f} "
                                          f"waves at the default S={S}")
        del fwd, ll, w, runs
        torch.cuda.empty_cache()


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
    """Phase 7: a family whose features are wider than 64 (the duplex
    kernels' limit), routed as JAX routes them: "fused" runs the fused pair
    (its WF instances) but for a multinomial above 256 symbols, which runs
    the split kernels; "duplex" the split kernels; "split" its own. Each
    route's kernels launch once and no other kernel does, and the
    statistics agree with "scan"'s, ungated and gated."""
    import torch

    from pysvihmm_tpu_torch.engines.base import (
        batch_local_step,
        feature_width,
        wider_than_fused_kernels,
    )
    from pysvihmm_tpu_torch.messages.fused_fb import FMAX

    F_ = feature_width(fam, params.emit, obs)
    require(F_ > FMAX, f"{label}: not wider than FMAX")
    fused = "split" if wider_than_fused_kernels(fam, params.emit, obs) else "fused"
    B_, T_ = obs.shape[:2]
    w = svi_masks(gen, B_, T_, (5 * T_) // 7).transpose(0, 1).contiguous()
    for weights in (None, w):
        ss, _ = batch_local_step(params, fam, obs, "scan", weights=weights, need_gamma=False)
        for route, runs in (("fused", fused), ("duplex", "split"), ("split", "split")):
            torch.cuda.synchronize()
            reset_kernel_counts()
            sk, _ = batch_local_step(params, fam, obs, route, weights=weights, need_gamma=False)
            torch.cuda.synchronize()
            counts = kernel_counts()
            log(f"  {label}, F={F_}, B={B_}, T={T_}, on {route}, gated={weights is not None}: "
                f"the {runs} kernels, against scan")
            require_launches(counts, runs, 1, f"{label} on {route}")
            compare_local_stats(sk, ss)


# the wide-feature path on "auto" (F > 64: the fused pair, the split kernels
# above 256 symbols), timed beside "split": (label, family, D or V, K); the
# multinomial at V = 1000 takes the segment-sum statistics
WIDE_PATH = (("gaussian_niw D=10", "niw", 10, K), ("gaussian_niw D=10", "niw", 10, 256),
             ("multinomial V=1000", "multinomial", 1000, K),
             ("multinomial V=100", "multinomial", 100, K))
WIDE_SVI_V = 100  # the windowed SVI steps on the wide path: the multinomial at V = 100, K = 64


def wide_path_phase(dev) -> dict[str, float]:
    """Phase 7: the wide-feature path on "auto", timed by CUDA events beside
    explicit "split" and "scan". For each case of WIDE_PATH at B=1024,
    T=1000: batch VB's E-step (batch_local_step, need_gamma=False) on "auto"
    launches each fused kernel once (each split kernel for the multinomial
    above 256 symbols) and no other kernel, and "split" each split kernel
    once; both agree with "scan"'s statistics, all three routes are timed,
    with the device time of one "auto" call by kernel (torch.profiler).
    Then windowed SVI steps on "auto" for the multinomial at V =
    WIDE_SVI_V, K = 64, W = 70, B = 1024 (the gated fused backward): each
    fused kernel once a step, every parameter finite, one step's local
    statistics on "auto" and "split" against "scan"'s on the same windows,
    and the step timed on "auto", "split" and "scan". Returns ms by case."""
    import torch

    from pysvihmm_tpu_torch.data import synthetic
    from pysvihmm_tpu_torch.distributions import GaussianNIW, MultinomialDirichlet
    from pysvihmm_tpu_torch.engines import svi
    from pysvihmm_tpu_torch.engines.base import (
        batch_local_step,
        feature_width,
        wider_than_fused_kernels,
        windowed_local_step,
    )
    from pysvihmm_tpu_torch.models.hmm import init_params, make_prior
    from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms
    from pysvihmm_tpu_torch.scripts.time_fused import profile_call

    gen = torch.Generator(device=dev).manual_seed(10)
    ms = {}
    for label, family, size, K_ in WIDE_PATH:
        if family == "niw":
            fam, kw = GaussianNIW, dict(obs_dim=size)
            obs = synthetic.gen_gaussian_dataset(gen, K_, size, B, T, mean_scale=0.5,
                                                 cov_scale=1.0)[0]
        else:
            fam, kw = MultinomialDirichlet, dict(num_symbols=size)
            obs = synthetic.gen_multinomial_dataset(gen, K_, size, B, T)[0]
        prior = make_prior(K_, fam, device=dev, **kw)
        params = init_params(gen, prior, fam, obs)
        F_ = feature_width(fam, params.emit, obs)
        auto = "split" if wider_than_fused_kernels(fam, params.emit, obs) else "fused"
        ss, _ = batch_local_step(params, fam, obs, "scan", need_gamma=False)
        for route, runs in (("auto", auto), ("split", "split")):
            torch.cuda.synchronize()
            reset_kernel_counts()
            sk, _ = batch_local_step(params, fam, obs, route, need_gamma=False)
            torch.cuda.synchronize()
            require_launches(kernel_counts(), runs, 1, f"{label}, K={K_}, E-step on {route}")
            log(f"  {label}, K={K_}, F={F_}, B={B}, T={T}: the E-step on {route} (each {runs} "
                "kernel once) against scan")
            compare_local_stats(sk, ss)
            del sk
        del ss
        t_auto = cuda_ms(lambda: batch_local_step(params, fam, obs, "auto", need_gamma=False),
                         10, warmup=2)
        t_split = cuda_ms(lambda: batch_local_step(params, fam, obs, "split", need_gamma=False),
                          10, warmup=2)
        t_scan = cuda_ms(lambda: batch_local_step(params, fam, obs, "scan", need_gamma=False),
                         2, warmup=1)
        ms[f"{label}, K={K_}"] = t_auto
        ms[f"{label}, K={K_} on split"] = t_split
        log(f"  {label}, K={K_}: E-step on auto ({auto}) {t_auto:.3f} ms ({B / t_auto * 1e3:.1f} "
            f"seq/s), on split {t_split:.3f} ms, on scan {t_scan:.3f} ms")
        profile_call(f"  {label}, K={K_}, one E-step on auto",
                     lambda: batch_local_step(params, fam, obs, "auto", need_gamma=False))
        del obs, params
        torch.cuda.empty_cache()

    V_ = WIDE_SVI_V
    chain = synthetic.gen_multinomial_dataset(gen, K, V_, 1, SVI_T)[0][0]
    prior = make_prior(K, MultinomialDirichlet, num_symbols=V_, device=dev)
    p0 = init_params(gen, prior, MultinomialDirichlet, chain)
    cfg = svi.SVIConfig(batch_size=B, subchain_len=SVI_L, buffer=SVI_BUF)
    step = svi.make_step(MultinomialDirichlet, cfg, chain.shape[0], method="auto")
    state = svi.init_state(p0, torch.Generator(device=dev).manual_seed(21))
    reset_kernel_counts()
    for i in range(5):
        before = kernel_counts()
        state, m = step(state, prior, chain)
        after = kernel_counts()
        require_launches({k: after[k] - before[k] for k in after}, "auto", 1,
                         f"multinomial V={V_} SVI step {i} on auto")
        torch.cuda.synchronize()
        require(bool(torch.isfinite(m["noisy_elbo"])), f"multinomial SVI step {i}: non-finite")
        require_sane_params(state.params, f"multinomial V={V_} SVI step {i}")
    starts = torch.randint(0, SVI_T - SVI_L + 1, (B,), generator=gen, device=dev)
    ws = torch.clamp(starts - SVI_BUF, 0, SVI_T - SVI_W)
    offs = starts - ws
    windows = svi._gather_windows(chain, ws, SVI_W)
    pos = torch.arange(SVI_W, device=dev)[None, :]
    maskf = ((pos >= offs[:, None]) & (pos < offs[:, None] + SVI_L)).float()
    ref = windowed_local_step(state.params, MultinomialDirichlet, windows, maskf, offs, "scan")
    for route in ("auto", "split"):
        got = windowed_local_step(state.params, MultinomialDirichlet, windows, maskf, offs, route)
        log(f"  multinomial V={V_}, K={K}: one SVI step's local statistics on {route} vs scan, "
            f"W={SVI_W}, B={B}")
        compare("emit counts", got[0], ref[0], 3e-3, 2e-3)
        compare("trans_stats", got[1], ref[1], 1e-4, 1e-3)
        compare("gamma_at_start", got[2], ref[2], 0.0, 5e-5)
        compare("log_c", got[3], ref[3], 2e-6, 1e-4)
    for route in ("auto", "split", "scan"):
        step_r = svi.make_step(MultinomialDirichlet, cfg, chain.shape[0], method=route)
        st = svi.init_state(p0, torch.Generator(device=dev).manual_seed(22))

        def one():
            nonlocal st
            st, _ = step_r(st, prior, chain)

        ms[f"multinomial V={V_} SVI step on {route}"] = cuda_ms(one, 20, warmup=2)
        require_sane_params(st.params, f"timed multinomial SVI on {route}")
    log(f"  multinomial V={V_}, K={K}, W={SVI_W}, B={B}: SVI step on auto "
        f"{ms[f'multinomial V={V_} SVI step on auto']:.3f} ms, on split "
        f"{ms[f'multinomial V={V_} SVI step on split']:.3f} ms, on scan "
        f"{ms[f'multinomial V={V_} SVI step on scan']:.3f} ms (chained steps, CUDA events)")
    return ms


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

    # features wider than 64: "fused" runs the fused pair's WF instances but
    # above 256 symbols (the split kernels, a segment-sum of the statistics),
    # "duplex" the split kernels (the Gaussian's F = 66 at D = 10)
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

    log("  the wide-feature path on auto, timed")
    wide_path_phase(dev)

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


LARGE_VB_K = 256  # the large-K phase: batch VB at K=256, SVI at K=128
LARGE_SVI_K, LARGE_SVI_STEPS, LARGE_SVI_SIDE_STEPS = 128, 10, 3


def large_k_phase(dev) -> dict[tuple[str, int], int]:
    """The large-K phase: batch VB at K=256, B=1024, T=1000, D=8, 5
    iterations on "auto", "split" and "duplex" (each route's kernels once an
    iteration, the ELBO non-decreasing, the routes' ELBOs within ELBO_RTOL,
    each route's local step at the fitted params against "scan"); then 10
    SVI steps on "auto" at K=128, W=70, B=1024 on a T=100,000 chain, and 3
    on "split" and "duplex" (one launch of each route kernel a step, every
    parameter finite after every step). The outer sums must launch once a
    window for acc and once for eacc (acc only on "split") in every backward
    of those runs. Returns the launches by (kernel, K), the outer sums' under
    OUTER_NAME."""
    import torch

    from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu_torch.distributions import GaussianNIW
    from pysvihmm_tpu_torch.engines import batch_vb, svi
    from pysvihmm_tpu_torch.engines.base import batch_local_step
    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.models.hmm import init_params, make_prior

    def outer_want(route, T_, calls):
        windows = -(-T_ // max(1, min(T_, WIDE_ROWS // B)))
        return calls * windows * (1 if route == "split" else 2)

    launches = {(OUTER_NAME, K_): 0 for K_ in LARGE_K}
    gen = torch.Generator(device=dev).manual_seed(256)
    K_ = LARGE_VB_K
    obs, _, _ = gen_gaussian_dataset(gen, K_, D, B, T)
    prior = make_prior(K_, GaussianNIW, obs_dim=D, device=dev)
    p0 = init_params(gen, prior, GaussianNIW, obs)
    elbos, fitted = {}, {}
    for route in ("auto", "split", "duplex"):
        torch.cuda.synchronize()
        reset_kernel_counts()
        t0 = time.perf_counter()
        fitted[route], e = batch_vb.fit(p0, prior, obs, GaussianNIW, num_iters=VB_ITERS,
                                        method=route)
        torch.cuda.synchronize()
        counts = kernel_counts()
        require_launches(counts, route, VB_ITERS, f"K={K_} VB on {route}")
        for name in ROUTE_KERNELS[route]:
            launches[name, K_] = counts[name]
        n_outer, want = ff.outer_launches(), outer_want(route, T, VB_ITERS)
        require(n_outer == want, f"K={K_} VB on {route}: the outer sums launched {n_outer} "
                                 f"times, expected {want}")
        launches[OUTER_NAME, K_] += n_outer
        require_ascending(e, f"K={K_} VB on {route}")
        elbos[route] = e.double().cpu()
        log(f"  K={K_}, B={B}, T={T}, D={D}, {route}: {time.perf_counter() - t0:.3f} s; ELBO "
            + ", ".join(f"{x:.6e}" for x in elbos[route].tolist()))
    for route in ("split", "duplex"):
        rel = ((elbos[route] - elbos["auto"]).abs() / elbos["auto"].abs()).max().item()
        log(f"  K={K_}: max relative ELBO difference {route} vs auto {rel:.3e}")
        require(rel <= ELBO_RTOL, f"K={K_}: {route} and auto ELBOs differ by {rel:.3e}")
    ss, _ = batch_local_step(fitted["auto"], GaussianNIW, obs, "scan", need_gamma=False)
    for route in ("auto", "split", "duplex"):
        sk, _ = batch_local_step(fitted["auto"], GaussianNIW, obs, route, need_gamma=False)
        torch.cuda.synchronize()
        log(f"  K={K_}: batch_local_step on {route} vs scan at the fitted params")
        compare_local_stats(sk, ss)
    del obs, ss, sk, fitted
    torch.cuda.empty_cache()

    K_ = LARGE_SVI_K
    gen = torch.Generator(device=dev).manual_seed(128)
    chain = gen_gaussian_dataset(gen, K_, D, 1, SVI_T, mean_scale=0.5, cov_scale=1.0)[0][0]
    prior = make_prior(K_, GaussianNIW, obs_dim=D, device=dev)
    p0 = init_params(gen, prior, GaussianNIW, chain)
    cfg = svi.SVIConfig(batch_size=B, subchain_len=SVI_L, buffer=SVI_BUF)
    for route, steps in (("auto", LARGE_SVI_STEPS), ("split", LARGE_SVI_SIDE_STEPS),
                         ("duplex", LARGE_SVI_SIDE_STEPS)):
        t0 = time.perf_counter()
        _, ne, counts = svi_run(route, cfg, p0, prior, chain, seed=13, steps=steps)
        for name in ROUTE_KERNELS[route]:
            launches[name, K_] = counts[name]
        n_outer, want = ff.outer_launches(), outer_want(route, SVI_W, steps)
        require(n_outer == want, f"SVI at K={K_} on {route}: the outer sums launched {n_outer} "
                                 f"times, expected {want}")
        launches[OUTER_NAME, K_] += n_outer
        log(f"  SVI at K={K_}, W={SVI_W}, B={B}, T={SVI_T} on {route}: {steps} steps checked in "
            f"{time.perf_counter() - t0:.2f} s; noisy ELBO " + ", ".join(f"{x:.6e}" for x in ne))
    return launches


ENGINE_SWEEPS = 3  # phase 10: Gibbs sweeps at B=1024, T=1000
ENGINE_META_STEPS = 10  # phase 10: meta-observation steps (M = B blocks of SVI_L)
ENGINE_SGD_RTOL = 1e-5  # batch SGD's step 0 (rho = 1) against batch VB's step
GIBBS_SAME_Z = 0.999  # the card's fed sweep against float64 on the CPU: paths
GIBBS_THETA_RTOL = 1e-4  # ... and theta, max |err| / max |ref| a leaf
DECODE_RTOL = 1e-5  # Viterbi path scores and predictive values against float64


def cpu64(x):
    """A tensor, or a (named) tuple of them, on the CPU with floats in float64."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.detach().cpu().double() if x.is_floating_point() else x.detach().cpu()
    vals = [cpu64(v) for v in x]
    return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)


def path_scores(log_pi, log_A, ll, z):
    """log p(z, y) of paths z (B, T) under (log_pi, log_A, ll (B, T, K)), per
    sequence."""
    emit = ll.gather(2, z[..., None])[..., 0].sum(dim=1)
    return log_pi[z[:, 0]] + log_A[z[:, :-1], z[:, 1:]].sum(dim=1) + emit


def flat_leaves(x) -> list:
    """The tensors of a tensor or of (named) tuples of them, depth first."""
    return [y for v in x for y in flat_leaves(v)] if isinstance(x, tuple) else [x]


def rel_max_err(got, ref) -> float:
    """max |got - ref| / max |ref| over the leaves of two like structures,
    each leaf on its own; ``got`` must be finite."""
    import torch

    err = 0.0
    for a, b in zip(flat_leaves(cpu64(got)), flat_leaves(cpu64(ref)), strict=True):
        require(bool(torch.isfinite(a).all()), "a non-finite value")
        err = max(err, (a - b).abs().max().item() / max(b.abs().max().item(), 1e-30))
    return err


def device_busy(fn) -> tuple[float, float, int]:
    """One call of fn under torch.profiler: (wall ms, device busy ms, kernel
    launches). The profiler's own host overhead inflates the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    busy, launches = 0.0, 0
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            t = getattr(e, "self_device_time_total", None)
            busy += (t if t is not None else e.self_cuda_time_total) / 1e3
            launches += e.count
    return wall, busy, launches


def engines_phase(dev) -> dict[str, float]:
    """Phase 10: the engines and decoders of PR 12 at bench.py's width (K=64,
    D=8), everything built on the card. Batch SGD (5 iterations at B=1024,
    T=1000 on "auto": one fused pair an iteration, finite ELBOs, step 0
    the batch-VB step); meta-observation SVI on the phase-6 kind of chain
    (T=100,000, Lm=50, b=10, M=1024, W=70: 10 steps on "auto", one gated
    fused pair a step, sane params; one with_blocks' statistics on "auto"
    against "scan"); 3 Gibbs sweeps at B=1024, T=1000 and one fed sweep
    against float64 on the CPU; Viterbi and predictive scoring against
    float64 on the CPU; best-of-4 batch VB restarts; select_buffer at the
    SVI shape. Returns the host-clock times (ms, synchronised) it logs."""
    import torch

    from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu_torch.distributions import GaussianNIW, dirichlet
    from pysvihmm_tpu_torch.engines import batch_sgd, batch_vb, gibbs, metaobs, svi
    from pysvihmm_tpu_torch.engines.base import predictive_log_likelihood, viterbi_decode
    from pysvihmm_tpu_torch.messages import scan_fb
    from pysvihmm_tpu_torch.models.hmm import (
        emission_flat_stats,
        expected_log_params,
        init_params,
        make_prior,
    )

    def clock(fn, warm=False):
        """fn's result and its ms; with ``warm``, after one untimed call."""
        if warm:
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    def busy(name, fn):
        wall, dev_ms, n = device_busy(fn)
        log(f"    {name} under torch.profiler: wall {wall:.1f} ms, device busy {dev_ms:.2f} ms "
            f"({100 * dev_ms / wall:.1f} %), {n} kernel launches")

    times = {}
    gen = torch.Generator(device=dev).manual_seed(1210)
    obs, _, _ = gen_gaussian_dataset(gen, K, D, B, T)
    prior = make_prior(K, GaussianNIW, obs_dim=D, device=dev)
    p0 = init_params(gen, prior, GaussianNIW, obs)

    log(f"  batch SGD: {VB_ITERS} iterations at B={B}, T={T}, K={K}, D={D} on auto")
    reset_kernel_counts()
    (sgd, elbos), ms = clock(lambda: batch_sgd.fit_state(batch_sgd.init_state(p0), prior, obs,
                                                         GaussianNIW, VB_ITERS))
    require_launches(kernel_counts(), "auto", VB_ITERS, "batch SGD")
    require(bool(torch.isfinite(elbos).all()), "batch SGD: a non-finite ELBO")
    require_sane_params(sgd.params, "batch SGD")
    times["batch SGD iteration"] = ms / VB_ITERS
    first, _ = batch_sgd.make_step(GaussianNIW)(batch_sgd.init_state(p0), prior, obs)
    vb, _ = batch_vb.make_step(GaussianNIW)(p0, prior, obs)
    err = rel_max_err(first.params, vb)
    log(f"  {ms:.1f} ms ({ms / VB_ITERS:.2f} ms an iteration, the feature build included); ELBO "
        + ", ".join(f"{x:.6e}" for x in elbos.double().cpu().tolist())
        + f"; step 0 against batch VB's step: max rel err {err:.3e}")
    require(err <= ENGINE_SGD_RTOL, f"batch SGD step 0 differs from batch VB's by {err:.3e}")

    log("  Viterbi and predictive scoring at the SGD params against float64 on the CPU")
    params = sgd.params
    path, ms = clock(lambda: viterbi_decode(params, GaussianNIW, obs), warm=True)
    times["viterbi_decode"] = ms
    busy("viterbi_decode", lambda: viterbi_decode(params, GaussianNIW, obs))
    p64, o64 = cpu64(params), cpu64(obs)
    lp, lA = expected_log_params(p64)
    ll = GaussianNIW.expected_log_likelihood(p64.emit, o64)
    t0 = time.perf_counter()
    ref_path = scan_fb.viterbi(lp, lA, ll)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    got, ref = path_scores(lp, lA, ll, path.cpu()), path_scores(lp, lA, ll, ref_path)
    rel = ((got - ref).abs() / ref.abs()).max().item()
    same = (path.cpu() == ref_path).double().mean().item()
    log(f"  viterbi_decode: {ms:.1f} ms on the card, {cpu_ms:.1f} ms float64 on the CPU; path "
        f"scores max rel diff {rel:.3e} ({100 * same:.4f} % of positions the same state)")
    require(bool((got <= ref + 1e-9 * ref.abs()).all()), "a card path scores above the MAP")
    require(rel <= DECODE_RTOL, f"Viterbi path scores differ by {rel:.3e}")
    del ll, ref_path
    for exact in (False, True):
        val, ms = clock(lambda: predictive_log_likelihood(params, GaussianNIW, obs, exact=exact),
                        warm=True)
        ref = predictive_log_likelihood(p64, GaussianNIW, o64, exact=exact).item()
        rel = abs(val.item() - ref) / abs(ref)
        times[f"predictive exact={exact}"] = ms
        log(f"  predictive_log_likelihood(exact={exact}): {val.item():.9e} in {ms:.1f} ms; "
            f"float64 CPU {ref:.9e}, rel diff {rel:.3e}")
        require(math.isfinite(val.item()) and rel <= DECODE_RTOL,
                f"predictive exact={exact}: rel diff {rel:.3e}")

    log(f"  Gibbs: {ENGINE_SWEEPS} sweeps at B={B}, T={T}")
    sweep = gibbs.make_sweep(GaussianNIW, K)
    gstate = gibbs.init_state(torch.Generator(device=dev).manual_seed(1211), prior, GaussianNIW,
                              obs, K)
    sweep_ms = []
    for i in range(ENGINE_SWEEPS):
        (gstate, gm), ms = clock(lambda: sweep(gstate, prior, obs))
        sweep_ms.append(ms)
        mll = gm["marginal_loglik"].item()
        require(math.isfinite(mll), f"Gibbs sweep {i}: non-finite marginal log-likelihood")
        require(all(bool(torch.isfinite(x).all()) for x in flat_leaves(gstate.theta)),
                f"Gibbs sweep {i}: a non-finite parameter")
        log(f"    sweep {i}: {ms:.1f} ms, marginal log-likelihood {mll:.6e}")
    times["Gibbs sweep"] = min(sweep_ms)
    busy("a Gibbs sweep", lambda: sweep(gstate, prior, obs))
    # one fed sweep on the card and in float64 on the CPU, draws made on the card
    g = torch.Generator(device=dev).manual_seed(1212)
    init_c, trans_c, oh = gibbs._count_stats(gstate.z, K, torch.float32)
    post = GaussianNIW.posterior(prior.emit, emission_flat_stats(GaussianNIW, prior.emit, oh, obs))
    draws = gibbs.GibbsDraws(scan_fb.gumbel(g, (B, T, K), torch.float32),
                             dirichlet.log_gamma(g, prior.init + init_c),
                             dirichlet.log_gamma(g, prior.trans + trans_c),
                             GaussianNIW.sample_draws(g, post))
    del oh
    card, _ = sweep.with_draws(gstate, prior, obs, draws)
    t0 = time.perf_counter()
    cpu, _ = gibbs.make_sweep(GaussianNIW, K).with_draws(
        gibbs.GibbsState(gstate.z.cpu(), cpu64(gstate.theta), torch.Generator()), cpu64(prior),
        o64, cpu64(draws))
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    same = (card.z.cpu() == cpu.z).double().mean().item()
    errs = [rel_max_err(a, b) for a, b in zip(flat_leaves(card.theta), flat_leaves(cpu.theta))]
    err = max(errs)
    log(f"  fed sweep: {100 * same:.4f} % of positions the same state as float64 on the CPU "
        f"({cpu_ms:.0f} ms there); theta max rel err {err:.3e} (pi, A, mu, sigma: "
        + ", ".join(f"{e:.2e}" for e in errs) + ")")
    require(same >= GIBBS_SAME_Z, f"the fed Gibbs sweep's paths agree on {same:.6f} only")
    require(err <= GIBBS_THETA_RTOL, f"the fed Gibbs sweep's theta differs by {err:.3e}")
    del obs, o64, draws, card, cpu, gstate
    torch.cuda.empty_cache()

    log(f"  meta-observation SVI: T={SVI_T}, Lm={SVI_L}, b={SVI_BUF}, M={B} (W={SVI_W}), "
        f"{ENGINE_META_STEPS} steps on auto")
    chain = gen_gaussian_dataset(gen, K, D, 1, SVI_T, mean_scale=0.5, cov_scale=1.0)[0][0]
    p_c = init_params(gen, prior, GaussianNIW, chain)
    cfg = metaobs.MetaObsConfig(minibatch=B, block_len=SVI_L, buffer=SVI_BUF)
    step = metaobs.make_step(GaussianNIW, cfg, SVI_T)
    state = svi.init_state(p_c, torch.Generator(device=dev).manual_seed(1213))
    reset_kernel_counts()
    step_ms = []
    for i in range(ENGINE_META_STEPS):
        before = kernel_counts()
        (state, m), ms = clock(lambda: step(state, prior, chain))
        after = kernel_counts()
        require_launches({k: after[k] - before[k] for k in after}, "auto", 1, f"metaobs step {i}")
        require(bool(torch.isfinite(m["noisy_elbo"])), f"metaobs step {i}: non-finite noisy ELBO")
        require_sane_params(state.params, f"metaobs step {i}")
        step_ms.append(ms)
    times["metaobs step"] = min(step_ms)
    log(f"  {ENGINE_META_STEPS} steps: min {min(step_ms):.2f} ms, median "
        f"{sorted(step_ms)[len(step_ms) // 2]:.2f} ms a step; noisy ELBO {m['noisy_elbo']:.6e}")
    ids = torch.randperm(SVI_T // SVI_L, generator=gen, device=dev)[:B]
    log("  one with_blocks' statistics on auto against scan, same block ids")
    compare_local_stats(step.block_stats(state.params, chain, ids),
                        metaobs.make_step(GaussianNIW, cfg, SVI_T, "scan").block_stats(
                            state.params, chain, ids))

    log(f"  select_buffer at the SVI shape: L={SVI_L}, {B} probes, tol 1e-3, on the chain "
        "above at the metaobs params")
    reset_kernel_counts()
    b_sel, ms = clock(lambda: svi.select_buffer(state.params, chain, GaussianNIW, SVI_L,
                                                torch.Generator(device=dev).manual_seed(1214),
                                                probes=B))
    counts = {k: n for k, n in kernel_counts().items() if n}
    require(set(counts) <= {"split_fwd_kernel", "split_bwd_kernel"} and counts,
            f"select_buffer launched {counts}")
    times["select_buffer"] = ms
    log(f"  b = {b_sel} in {ms:.1f} ms; launches {counts} (two E-steps a candidate b)")
    del chain

    log("  batch VB restarts: best of 4 at K=4, D=2, 20 x 200, 20 iterations on auto")
    o_s, _, _ = gen_gaussian_dataset(torch.Generator(device=dev).manual_seed(1215), 4, 2, 20, 200,
                                     mean_scale=6.0, cov_scale=0.3)
    prior_s = make_prior(4, GaussianNIW, obs_dim=2, device=dev)
    (best, e_r, idx), ms = clock(lambda: batch_vb.fit_restarts(
        torch.Generator(device=dev).manual_seed(1216), prior_s, o_s, GaussianNIW, 20, 4))
    final = e_r[:, -1].double().cpu()
    log(f"  {ms:.0f} ms; final ELBOs " + ", ".join(f"{x:.6e}" for x in final.tolist())
        + f"; best {idx}")
    require(idx == int(torch.argmax(final)), f"fit_restarts returned {idx}, not the argmax")
    require_sane_params(best, "the best restart")
    return times


SURFACE_STEPS, SURFACE_KILL, SURFACE_EVERY = 20, 11, 4  # phase 11: windowed-SVI kill-and-resume
STREAM_N, STREAM_T, STREAM_STEPS, STREAM_KILL = 4096, 1000, 10, 5  # phase 11: the streamed run
HAMMING_T = 10**7  # phase 11: hamming_error_long's labels
CLI_ITERS = {"batch_vb": 4, "batch_sgd": 4, "svi": 10, "metaobs": 10, "gibbs": 2}


def state_digests(state) -> dict[str, str]:
    """sha256 of every leaf of a state (checkpoint.flatten's paths: params,
    step, adaptive state, the generator's state and device type)."""
    import hashlib

    import torch

    from pysvihmm_tpu_torch.utils.checkpoint import flatten

    return {k: hashlib.sha256(v.numpy().tobytes()).hexdigest()[:16]
            if isinstance(v, torch.Tensor) else v for k, v in flatten(state).items()}


def require_same_state(ref, got, what: str) -> None:
    a, b = state_digests(ref), state_digests(got)
    require(a == b, f"{what}: leaves differ: "
            + ", ".join(k for k in a if a[k] != b.get(k)))
    log(f"    {what}: all {len(a)} leaves the same bits (sha256 of params.emit.psi "
        f"{a['params.emit.psi']}, generator {a['generator']})")


def surface_phase(dev, tmp: str) -> dict[str, float]:
    """Phase 11: the training loop and the user surface at K=64, D=8 on the
    card, scratch files under ``tmp``. Windowed SVI (the phase-6 chain,
    B=1024, L=50, b=10 on "auto") killed at step 11 of 20 and resumed from
    its checkpoint, power and adaptive step sizes: the uninterrupted run's
    bits. The streamed step over a .npy corpus of 4096 x 1000 (4 batches of
    1024 an epoch, adaptive) killed at 5 of 10 and resumed across the epoch
    boundary: the same bits; the prefetched stream's batches those of the
    resident corpus; ms a step streamed and resident, and the device's busy
    share of the streamed steps. The CLI in-process: ``experiment`` with
    every engine and ``baseline --scale 1 --configs 1,2,3``. The compat
    classes: VBHMM at bench.py's shape (one fused pair an iteration), the
    small canonical fit, SVIHMM(buffer="auto") (the split pair in
    select_buffer) and one GibbsHMM sweep. hamming_error_long at T = 10^7
    against hamming_error on the CPU. Returns the times it logs (ms)."""
    import contextlib
    import io
    import os

    import numpy as np
    import torch

    from pysvihmm_tpu_torch import __main__ as cli
    from pysvihmm_tpu_torch import compat
    from pysvihmm_tpu_torch.data.loader import ShardedSequenceLoader
    from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu_torch.distributions import GaussianNIW
    from pysvihmm_tpu_torch.engines import svi, trainer
    from pysvihmm_tpu_torch.eval.metrics import hamming_error, hamming_error_long
    from pysvihmm_tpu_torch.models.hmm import init_params, make_prior
    from pysvihmm_tpu_torch.parallel import make_dp_streamed_svi_step
    from pysvihmm_tpu_torch.utils import checkpoint

    def clock(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    times = {}
    gen = torch.Generator(device=dev).manual_seed(1301)
    prior = make_prior(K, GaussianNIW, obs_dim=D, device=dev)

    log(f"  windowed SVI kill-and-resume: T={SVI_T}, B={B}, L={SVI_L}, b={SVI_BUF} on auto; "
        f"{SURFACE_STEPS} steps against {SURFACE_KILL}, checkpoints every {SURFACE_EVERY}, "
        f"then a fresh state resumed to {SURFACE_STEPS}")
    chain = gen_gaussian_dataset(gen, K, D, 1, SVI_T, mean_scale=0.5, cov_scale=1.0)[0][0]
    p0 = init_params(gen, prior, GaussianNIW, chain)
    for adaptive in (False, True):
        cfg = svi.SVIConfig(batch_size=B, subchain_len=SVI_L, buffer=SVI_BUF, adaptive=adaptive)
        step = svi.make_step(GaussianNIW, cfg, SVI_T)

        def fresh():
            return svi.init_state(p0, torch.Generator(device=dev).manual_seed(1302), adaptive)

        reset_kernel_counts()
        ref, ms = clock(lambda: trainer.train(step, fresh(), prior, chain, SURFACE_STEPS,
                                              watchdog_every=5))
        require_launches(kernel_counts(), "auto", SURFACE_STEPS, f"SVI adaptive={adaptive}")
        require_sane_params(ref.params, f"SVI adaptive={adaptive}")
        d = os.path.join(tmp, f"svi_{adaptive}")
        killed = trainer.train(step, fresh(), prior, chain, SURFACE_KILL, checkpoint_dir=d,
                               checkpoint_every=SURFACE_EVERY, watchdog_every=5)
        require(int(killed.step) == SURFACE_KILL, "the killed run stopped elsewhere")
        require(sorted(os.listdir(d)) == ["ckpt_11.pt", "ckpt_4.pt", "ckpt_8.pt"],
                f"checkpoints {sorted(os.listdir(d))}")
        resumed, ms_r = clock(lambda: trainer.train(step, fresh(), prior, chain, SURFACE_STEPS,
                                                    checkpoint_dir=d,
                                                    checkpoint_every=SURFACE_EVERY,
                                                    watchdog_every=5))
        require(int(resumed.step) == SURFACE_STEPS, "the resumed run stopped elsewhere")
        times[f"SVI step, adaptive={adaptive}"] = ms / SURFACE_STEPS
        log(f"    adaptive={adaptive}: {SURFACE_STEPS} steps in {ms:.1f} ms "
            f"({ms / SURFACE_STEPS:.2f} ms a step, the trainer's watchdog every 5); the resume "
            f"(restore + {SURFACE_STEPS - SURFACE_KILL} steps + 3 checkpoint writes) {ms_r:.1f} ms")
        require_same_state(ref, resumed, f"SVI adaptive={adaptive}, resumed against uninterrupted")
    del chain

    log(f"  streamed kill-and-resume: a .npy corpus of N={STREAM_N} x T={STREAM_T} x D={D}, "
        f"batch_per_host={B}, adaptive; {STREAM_STEPS} steps against {STREAM_KILL} + resume")
    obs, _, _ = gen_gaussian_dataset(gen, K, D, STREAM_N, STREAM_T)
    path = os.path.join(tmp, "corpus.npy")
    t0 = time.perf_counter()
    np.save(path, obs.cpu().numpy())
    log(f"    {os.path.getsize(path) / 1e6:.1f} MB written in {time.perf_counter() - t0:.2f} s "
        "(set-up)")
    loader = ShardedSequenceLoader.from_npy(path, dev, batch_per_host=B, seed=5)
    require(loader.batches_per_epoch() == STREAM_N // B, "batches an epoch")
    cfg = svi.SVIConfig(batch_size=B, tau=5.0, kappa=0.6, adaptive=True)
    step = make_dp_streamed_svi_step(GaussianNIW, cfg, num_seqs=STREAM_N)
    p_s = init_params(gen, prior, GaussianNIW, obs[:B])

    def fresh_s():
        return svi.init_state(p_s, torch.Generator(device=dev).manual_seed(1303), adaptive=True)

    trainer.train_streamed(step, fresh_s(), prior, loader, 2)  # warm: pinned pool, streams
    reset_kernel_counts()
    ref, ms = clock(lambda: trainer.train_streamed(step, fresh_s(), prior, loader, STREAM_STEPS))
    require_launches(kernel_counts(), "auto", STREAM_STEPS, "streamed steps")
    require_sane_params(ref.params, "streamed steps")
    times["streamed step"] = ms / STREAM_STEPS
    d = os.path.join(tmp, "streamed")
    trainer.train_streamed(step, fresh_s(), prior, loader, STREAM_KILL, checkpoint_dir=d,
                           checkpoint_every=4)
    resumed = trainer.train_streamed(step, fresh_s(), prior, loader, STREAM_STEPS,
                                     checkpoint_dir=d, checkpoint_every=4)
    require_same_state(ref, resumed, "streamed, resumed at 5 across the epoch boundary at 4")

    # the same steps on the resident corpus: the batches gathered on the card
    orders = [torch.from_numpy(loader.epoch_order(e)).to(dev) for e in range(3)]
    resident = [obs[orders[s // 4][(s % 4) * B:(s % 4 + 1) * B]] for s in range(STREAM_STEPS)]
    stream = loader.stream(0)
    for s in range(STREAM_STEPS):
        require(torch.equal(next(stream), resident[s]),
                f"prefetched batch {s} differs from the resident corpus' batch")
    stream.close()
    log(f"    the prefetched stream's {STREAM_STEPS} batches: the resident corpus' bits")

    def resident_steps():
        st = fresh_s()
        for s in range(STREAM_STEPS):
            st, _ = step(st, prior, obs[orders[s // 4][(s % 4) * B:(s % 4 + 1) * B]])
        return st

    res_state, ms_res = clock(resident_steps)
    require_same_state(ref, res_state, "resident steps against streamed")
    times["resident step"] = ms_res / STREAM_STEPS
    wall, busy_ms, n = device_busy(lambda: trainer.train_streamed(step, fresh_s(), prior, loader,
                                                                  STREAM_STEPS))
    times["streamed busy share"] = busy_ms / wall
    log(f"    {STREAM_STEPS} steps: streamed {ms:.1f} ms ({ms / STREAM_STEPS:.2f} ms a step), "
        f"resident {ms_res:.1f} ms ({ms_res / STREAM_STEPS:.2f} ms a step); streamed under "
        f"torch.profiler: wall {wall:.1f} ms, device busy {busy_ms:.2f} ms "
        f"({100 * busy_ms / wall:.1f} %), {n} device events")
    del obs, resident, loader

    log(f"  the CLI in-process: experiment with every engine at K={K}, D={D} (64 x 500 "
        "synthetic sequences), then baseline --scale 1 --configs 1,2,3")
    for engine, iters in CLI_ITERS.items():
        jsonl = os.path.join(tmp, f"{engine}.jsonl")
        argv = ["experiment", "--engine", engine, "--K", str(K), "--obs-dim", str(D),
                "--num-iters", str(iters), "--log-every", "1", "--log-path", jsonl]
        if engine != "gibbs":
            argv += ["--pred-ll-every", str(iters // 2)]
        if engine == "svi":
            argv += ["--svi-batch-size", str(B), "--checkpoint-dir", os.path.join(tmp, "cli_ck")]
        with contextlib.redirect_stderr(io.StringIO()):  # the logger's echo
            rc, ms = clock(lambda: cli.main(argv))
        require(rc == 0, f"experiment {engine} returned {rc}")
        recs = [json.loads(x) for x in open(jsonl).read().splitlines()]
        done = recs[-1]
        require(done.get("event") == "done", f"experiment {engine}: no done record")
        values = [v for r in recs for k, v in r.items() if isinstance(v, float)]
        require(all(math.isfinite(v) for v in values), f"experiment {engine}: a non-finite value")
        require(0.0 <= done["hamming"] <= 1.0, f"experiment {engine}: Hamming {done['hamming']}")
        want_none = {"final_elbo"} if engine == "gibbs" else set()
        if engine == "gibbs":
            want_none.add("final_pred_ll")
        require(all((done[k] is None) == (k in want_none) for k in ("final_elbo", "final_pred_ll")),
                f"experiment {engine}: done record {done}")
        times[f"experiment {engine}"] = ms
        log(f"    {engine} ({iters} iterations): {ms:.0f} ms, Hamming {done['hamming']:.4f}, "
            f"final ELBO {done['final_elbo']}, final pred-LL {done['final_pred_ll']}")
    ck = checkpoint.latest_step_path(os.path.join(tmp, "cli_ck"))
    require(ck is not None and ck.endswith(f"ckpt_{CLI_ITERS['svi']}.pt"), f"svi checkpoint {ck}")
    target = svi.init_state(init_params(gen, prior, GaussianNIW), torch.Generator(device=dev))
    restored = checkpoint.restore(ck, target)
    require(int(restored.step) == CLI_ITERS["svi"], "the CLI checkpoint's step")
    require_sane_params(restored.params, "the CLI checkpoint")
    log(f"    {ck.rsplit('/', 1)[-1]} restored: step {int(restored.step)}, generator on "
        f"{restored.generator.device}")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc, ms = clock(lambda: cli.main(["baseline", "--scale", "1", "--configs", "1,2,3"]))
    require(rc == 0, f"baseline returned {rc}")
    times["baseline 1,2,3 at scale 1"] = ms
    for line in out.getvalue().splitlines():
        log(f"    baseline: {line}")
    log(f"    baseline: {ms / 1e3:.1f} s, every config's check held")

    log(f"  compat: VBHMM at B={B}, T={T}, K={K}, D={D}, {VB_ITERS} iterations")
    obs, _, _ = gen_gaussian_dataset(gen, K, D, B, T)
    m = compat.VBHMM(obs, K=K)
    reset_kernel_counts()
    _, ms = clock(lambda: m.infer(maxit=VB_ITERS, tol=0.0))
    require_launches(kernel_counts(), "auto", VB_ITERS, "compat VBHMM")
    require_ascending(torch.tensor(m.elbo_history, dtype=torch.float64), "compat VBHMM")
    times["compat VBHMM iteration"] = ms / VB_ITERS
    log(f"    {ms:.1f} ms ({ms / VB_ITERS:.2f} ms an iteration, one fused pair each); ELBO "
        + ", ".join(f"{x:.6e}" for x in m.elbo_history))
    g = compat.GibbsHMM(obs, K=K)
    _, ms = clock(lambda: g.infer(maxit=1))
    require(math.isfinite(g.elbo_history[0]) and g.decode().shape == (B, T), "compat GibbsHMM")
    times["compat GibbsHMM sweep"] = ms
    log(f"    GibbsHMM: one sweep at B={B}, T={T} in {ms:.1f} ms, marginal log-likelihood "
        f"{g.elbo_history[0]:.6e}")
    del obs, m, g
    o_s, z_s, _ = gen_gaussian_dataset(torch.Generator().manual_seed(0), 4, 2, 20, 200,
                                       mean_scale=6.0, cov_scale=0.3)
    m = compat.VBHMM(o_s.numpy(), K=4).infer(maxit=50)
    ham = m.hamming_dist(z_s.numpy())
    log(f"    VBHMM small canonical fit (K=4, D=2, 20 x 200, 50 iterations): "
        f"{len(m.elbo_history)} iterations (tol stop), Hamming error {ham:.4f}")
    require(ham <= 0.05, f"compat VBHMM small fit: Hamming error {ham}")
    chain = gen_gaussian_dataset(gen, K, D, 1, SVI_T, mean_scale=0.5, cov_scale=1.0)[0][0]
    reset_kernel_counts()
    (m, ms) = clock(lambda: compat.SVIHMM(chain, K=K, batch_size=B, subchain_len=SVI_L,
                                          buffer="auto"))
    counts = {k: n for k, n in kernel_counts().items() if n}
    require(set(counts) == {"split_fwd_kernel", "split_bwd_kernel"},
            f"SVIHMM(buffer='auto') launched {counts}")
    reset_kernel_counts()
    _, ms_i = clock(lambda: m.infer(maxit=5))
    require_launches(kernel_counts(), "auto", 5, "compat SVIHMM")
    require_sane_params(m.params, "compat SVIHMM")
    times["compat SVIHMM select_buffer"] = ms
    log(f"    SVIHMM(buffer='auto') on the phase-6 chain: b = {m.cfg.buffer} in {ms:.1f} ms "
        f"(launches {counts}); 5 steps {ms_i:.1f} ms")
    del chain

    log(f"  hamming_error_long at T={HAMMING_T}, K={K} against hamming_error on the CPU")
    true = torch.randint(0, K, (HAMMING_T,), generator=gen, device=dev)
    perm = torch.randperm(K, generator=gen, device=dev)
    noise = torch.rand(HAMMING_T, generator=gen, device=dev) < 0.2
    est = torch.where(noise, torch.randint(0, K, (HAMMING_T,), generator=gen, device=dev),
                      perm[true])
    h_long, ms = clock(lambda: hamming_error_long(est, true, K))
    t0 = time.perf_counter()
    h_ref = hamming_error(est.cpu(), true.cpu(), K)
    cpu_ms = 1e3 * (time.perf_counter() - t0)
    times["hamming_error_long"] = ms
    log(f"    {h_long!r} in {ms:.1f} ms on the card; hamming_error {h_ref!r} in {cpu_ms:.0f} ms "
        "on the CPU")
    require(h_long == h_ref, "hamming_error_long differs from hamming_error")
    return times


LC_K, LC_D, LC_BLOCK = 64, 8, 256  # phase 12: config 4's chain, long_chain_local_stats' block
LC_T_EXACT, LC_T_REMAT, LC_T_SCALE = 10**5, 10**6, 10**7
LC_MULTI_K, LC_MULTI_V, LC_MULTI_T, LC_MULTI_BLOCK = 32, 64, 5 * 10**7, 1024
LC_VB_ITERS = 3
LC_LOGZ_RTOL = 1e-5  # each float32 tier's log Z against the fused kernels' at B = 1
LC_LEAF_RTOL = 1e-4  # init, trans and each emission leaf: max |err| / the leaf's max
LC_F64_RTOL = 1e-6  # each float32 log Z against the float64 two-phase tier's
LC_DECODE_AGREE = 0.9999  # the streaming decode against argmax gamma of the fused pair
LC_TIE = 1e-3  # ... and where they differ, gamma's two values at most this apart
LC_LAYOUT_RTOL = 1e-6  # time-minor against time-major statistics
LC_FLOOR_HAMMING = 0.05  # the decode at the generating params (the Bayes floor)


def digest(x) -> str:
    """sha256 of the bytes of a tensor or of the leaves of a (named) tuple."""
    import hashlib

    h = hashlib.sha256()
    for leaf in flat_leaves(x):
        h.update(leaf.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def tree_to(x, **kw):
    """A tensor, or a (named) tuple of them, through ``Tensor.to(**kw)``."""
    import torch

    if isinstance(x, torch.Tensor):
        return x.to(**kw)
    vals = [tree_to(v, **kw) for v in x]
    return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)


def synced_s(fn):
    """(result, seconds) of fn on the host clock between two synchronises."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def kineto_busy(fn) -> tuple[float, float, int]:
    """:func:`device_busy` for calls of some 10^5 kernels: one call of fn
    under torch.profiler (the card's activity only), the device time summed
    over the profiler's raw events instead of its parsed function events,
    which take about a minute to build at 3 x 10^5 kernels. (wall ms, device
    busy ms, kernel launches)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    return wall, sum(e.duration_ns() for e in dev) / 1e6, len(dev)


def lc_stats_err(got, ref) -> tuple[float, float]:
    """(log Z's relative error, the largest leaf error relative to the
    leaf's max over init, trans and the emission statistics)."""
    lz = abs(float(got.log_z) - float(ref.log_z)) / abs(float(ref.log_z))
    return lz, rel_max_err((got.init, got.trans, got.emit), (ref.init, ref.trans, ref.emit))


def store_remat_digests(dev, T_: int) -> tuple[str, str, str, str]:
    """``forward_backward_fused_twophase`` on a Gaussian chain of T_ steps
    (K=64, D=8) with store_alphas True and False, statistics and decode:
    (the stored run's statistics and decode sha256, the rematerialised
    run's)."""
    import torch

    from pysvihmm_tpu_torch.distributions import GaussianNIW
    from pysvihmm_tpu_torch.engines.base import _long_chain_ell_fn
    from pysvihmm_tpu_torch.messages.stream_fused import forward_backward_fused_twophase
    from pysvihmm_tpu_torch.models.hmm import (
        emission_flat_stats,
        expected_log_params,
        init_params,
        make_prior,
    )
    from pysvihmm_tpu_torch.scripts.run_fused_scale import make_chain

    obs, _, _ = make_chain("gaussian", T_, LC_K, LC_D, 0, seed=4)
    chain = torch.from_numpy(obs).to(dev)
    prior = make_prior(LC_K, GaussianNIW, obs_dim=LC_D, device=dev)
    p = init_params(torch.Generator(dev).manual_seed(5), prior, GaussianNIW, chain[:100_000])
    log_pi, log_A = expected_log_params(p)
    out = []
    for store in (True, False):
        r = forward_backward_fused_twophase(
            log_pi, log_A, chain, _long_chain_ell_fn(p, GaussianNIW), store_alphas=store,
            stat_fn=lambda g, y: emission_flat_stats(GaussianNIW, p.emit, g, y),
            stat_init=GaussianNIW.zero_stats(p.emit), emit_argmax=True)
        require(r.z.shape == (T_,) and r.z.dtype == torch.int32, "the decode's shape or dtype")
        out += [digest((r.log_z, r.init_stats, r.trans_stats, r.acc)), digest(r.z)]
    return tuple(out)


def longchain_phase(dev, share: str | None = None) -> tuple[dict[str, float], dict]:
    """Phase 12: the long-chain tiers on the card (config 4's Gaussian chain,
    K=64, D=8). (a) At T = 10^5 every float32 tier against the fused
    kernels at B = 1 (log Z to 1e-5, each leaf to 1e-4 of its max) and log Z
    against the two-phase tier in float64 (1e-6); (b) the fused tier at T =
    10^6 with stored and rematerialised alphas, the same sha256; (c) the
    streaming decode at T = 10^5 against argmax gamma of the fused pair;
    (d) at T = 10^7 the fused tier's E-step (its phases timed apart, phase 2
    as CUDA graphs and eagerly, the same bits), 3 long-chain VB iterations,
    the decode at the generating params, the card's busy share and the
    time-minor layout; (e) a multinomial chain, K=32, V=64, T = 5 x 10^7.
    Returns times in ms (host clock, synchronised) and, with a ``share``
    directory, what phase 13 needs of (d): the chain and its states saved
    there, the E-step's params, its log Z and the generating params."""
    import numpy as np
    import torch

    from pysvihmm_tpu_torch.distributions import GaussianNIW, MultinomialDirichlet
    from pysvihmm_tpu_torch.engines import batch_vb
    from pysvihmm_tpu_torch.engines.base import (
        _long_chain_ell_fn,
        batch_local_step,
        long_chain_decode,
        long_chain_local_stats,
    )
    from pysvihmm_tpu_torch.eval.metrics import hamming_error_long
    from pysvihmm_tpu_torch.messages import blocked as blk
    from pysvihmm_tpu_torch.messages import stream_fused as sfz
    from pysvihmm_tpu_torch.models.hmm import (
        emission_flat_stats,
        expected_log_params,
        init_params,
        make_prior,
    )
    from pysvihmm_tpu_torch.scripts.run_fused_scale import bayes_floor_params, make_chain

    ms: dict[str, float] = {}
    t_phase = time.perf_counter()

    # (a) exactness at T = 10^5
    obs, _, _ = make_chain("gaussian", LC_T_EXACT, LC_K, LC_D, 0, seed=8)
    chain = torch.from_numpy(obs).to(dev)
    prior = make_prior(LC_K, GaussianNIW, obs_dim=LC_D, device=dev)
    p = init_params(torch.Generator(dev).manual_seed(9), prior, GaussianNIW, chain)
    ref, gamma = batch_local_step(p, GaussianNIW, chain[None], method="fused", need_gamma=True)
    p64 = tree_to(p, dtype=torch.float64)
    lz64 = float(long_chain_local_stats(p64, GaussianNIW, chain.double(), LC_BLOCK,
                                        impl="twophase").log_z)
    log(f"  (a) [{time.perf_counter() - t_phase:.1f} s] T={LC_T_EXACT}: the fused kernels at B = 1 log Z {float(ref.log_z):.6f}, "
        f"two-phase in float64 {lz64:.6f}")
    tiers = {f"long_chain[{impl}]": (lambda impl=impl: long_chain_local_stats(
        p, GaussianNIW, chain, LC_BLOCK, impl=impl)) for impl in ("fused", "twophase", "assoc")}
    tiers.update({f"batch_local_step[{m}]": (lambda m=m: batch_local_step(
        p, GaussianNIW, chain[None], method=m, need_gamma=False)[0])
        for m in ("assoc", "blocked")})
    for name, fn in tiers.items():
        got, s = synced_s(fn)
        lz_err, leaf_err = lc_stats_err(got, ref)
        lz64_err = abs(float(got.log_z) - lz64) / abs(lz64)
        log(f"    {name}: {1e3 * s:.1f} ms; log Z rel err {lz_err:.2e} (fused kernels), "
            f"{lz64_err:.2e} (float64); leaves {leaf_err:.2e} of their max")
        require(lz_err <= LC_LOGZ_RTOL and leaf_err <= LC_LEAF_RTOL and lz64_err <= LC_F64_RTOL,
                f"phase 12 (a): {name} disagrees with the fused kernels or float64")
        ms[f"exact_{name}"] = 1e3 * s
    ref_err64 = abs(float(ref.log_z) - lz64) / abs(lz64)
    require(ref_err64 <= LC_F64_RTOL, f"phase 12 (a): the fused kernels' log Z {ref_err64:.2e} "
            "from float64")

    # (c) the streaming decode against argmax gamma of the fused pair
    z, s = synced_s(lambda: long_chain_decode(p, GaussianNIW, chain))
    g = gamma[0]
    z_ref = g.argmax(dim=-1)
    diff = torch.nonzero(z.long() != z_ref)[:, 0]
    agree = 1.0 - diff.numel() / LC_T_EXACT
    gap = (g[diff, z_ref[diff]] - g[diff, z.long()[diff]]).abs().max().item() if diff.numel() \
        else 0.0
    log(f"  (c) [{time.perf_counter() - t_phase:.1f} s] long_chain_decode at T={LC_T_EXACT}: {1e3 * s:.1f} ms, {100 * agree:.4f} % of "
        f"steps argmax gamma of the fused pair; the {diff.numel()} others gamma gaps <= {gap:.2e}")
    require(agree >= LC_DECODE_AGREE and gap <= LC_TIE, "phase 12 (c): decode differs beyond ties")
    ms["decode_1e5"] = 1e3 * s

    # (b) stored and rematerialised alphas at T = 10^6
    d = store_remat_digests(dev, LC_T_REMAT)
    log(f"  (b) [{time.perf_counter() - t_phase:.1f} s] T={LC_T_REMAT}: stored alphas stats {d[0]} decode {d[1]}; rematerialised stats "
        f"{d[2]} decode {d[3]}")
    require(d[0] == d[2] and d[1] == d[3], "phase 12 (b): store and remat differ")

    # (d) scale: Gaussian K=64, D=8, T = 10^7, "fused", block 256
    t0 = time.perf_counter()
    obs, z_true, tp = make_chain("gaussian", LC_T_SCALE, LC_K, LC_D, 0, seed=0)
    ms["gen_1e7_host"] = 1e3 * (time.perf_counter() - t0)
    chain = torch.from_numpy(obs).to(dev)
    p = init_params(torch.Generator(dev).manual_seed(2), prior, GaussianNIW, chain[:100_000])
    estep = lambda c=chain, tm=False: long_chain_local_stats(  # noqa: E731
        p, GaussianNIW, c, LC_BLOCK, impl="fused", time_minor=tm)
    estep()
    torch.cuda.reset_peak_memory_stats(dev)
    st, s = synced_s(estep)
    ms["estep_1e7"] = 1e3 * s
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    require(math.isfinite(float(st.log_z)), "phase 12 (d): non-finite log Z")
    shared = {}
    if share is not None:
        shared = {"chain": os.path.join(share, "lc_chain.npy"),
                  "z_true": os.path.join(share, "lc_z.npy"), "p": tree_to(p, device="cpu"),
                  "floor": tree_to(bayes_floor_params(tp, "gaussian", "cpu"), device="cpu"),
                  "log_z": float(st.log_z)}
        np.save(shared["chain"], obs)
        np.save(shared["z_true"], z_true)
    del obs
    # the E-step's phases apart, on the same inputs as the call above
    log_pi, log_A = expected_log_params(p)
    A = torch.exp(log_A)
    lik_fn = sfz._lik_factory(_long_chain_ell_fn(p, GaussianNIW), torch.float32)
    S = LC_BLOCK
    n_trans = LC_T_SCALE - 1
    pad = blk._pad_count(n_trans, S)
    nB = (n_trans + pad) // S
    obs_blocks = sfz._transition_rows(chain, False, nB, S, pad)
    valid = (torch.arange(n_trans + pad, device=dev) < n_trans).reshape(nB, S)
    Q, s1 = synced_s(lambda: sfz._block_products_fused(A, obs_blocks, valid, nB, S, lik_fn))
    lik0, sh0 = lik_fn(chain[:1])
    a0 = torch.exp(log_pi) * lik0[0]
    alpha0 = a0 / a0.sum()
    seeds_g, s2g = synced_s(lambda: blk.boundary_seeds(Q, alpha0, graphs=True))
    seeds_e, s2e = synced_s(lambda: blk.boundary_seeds(Q, alpha0, graphs=False))
    same = digest(seeds_g) == digest(seeds_e)
    del Q
    sweeps, s3 = synced_s(lambda: sfz._seeded_sweeps(
        A, lik_fn, obs_blocks, valid, *seeds_g, 8, time_minor=False, store_alphas=False,
        stat_fn=lambda g, y: emission_flat_stats(GaussianNIW, p.emit, g, y),
        stat_init=GaussianNIW.zero_stats(p.emit)))
    log_z3 = float(torch.log(a0.sum()) + sh0[0] + sweeps[0])
    require(abs(log_z3 - float(st.log_z)) <= LC_LOGZ_RTOL * abs(float(st.log_z)),
            "phase 12 (d): phase 3 alone does not give the E-step's log Z")
    log(f"  (d) [{time.perf_counter() - t_phase:.1f} s] T={LC_T_SCALE}, K={LC_K}, D={LC_D}, block {S} ({nB} blocks): data on the host "
        f"{ms['gen_1e7_host'] / 1e3:.1f} s; the fused E-step {1e3 * s:.1f} ms "
        f"({LC_T_SCALE / s:,.0f} steps/s, peak {peak:.2f} GiB): phase 1 {1e3 * s1:.1f} ms, "
        f"phase 2 {1e3 * s2g:.1f} ms as CUDA graphs of {blk.GRAPH_STEPS} steps "
        f"({1e3 * s2e:.1f} ms eagerly; the same bits: {same}, sha256 {digest(seeds_g)}), "
        f"phase 3 {1e3 * s3:.1f} ms (each timed alone on the E-step's inputs)")
    require(same, "phase 12 (d): graph replay and the eager loop differ")
    ms.update({"phase1_1e7": 1e3 * s1, "phase2_graphs_1e7": 1e3 * s2g,
               "phase2_eager_1e7": 1e3 * s2e, "phase3_1e7": 1e3 * s3})
    del obs_blocks, seeds_g, seeds_e, sweeps
    wall, busy, launches = kineto_busy(estep)
    log(f"    [{time.perf_counter() - t_phase:.1f} s] torch.profiler over one E-step: wall {wall:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / wall:.1f} %), {launches} kernel launches")
    ms["estep_busy_share_pct"] = 100 * busy / wall

    step = batch_vb.make_long_chain_step(GaussianNIW, block_size=LC_BLOCK)
    params, elbos, walls = p, [], []
    for _ in range(LC_VB_ITERS):
        (params, e), s = synced_s(lambda q=params: step(q, prior, chain))
        elbos.append(e)
        walls.append(s)
    require_ascending(torch.stack(elbos), "phase 12 (d): long-chain VB")
    log(f"    [{time.perf_counter() - t_phase:.1f} s] {LC_VB_ITERS} long-chain VB iterations: ELBO "
        + " -> ".join(f"{float(e):.6e}" for e in elbos)
        + ", s an iteration " + ", ".join(f"{w:.3f}" for w in walls))
    ms["vb_iter_1e7"] = 1e3 * min(walls)

    z_star, s = synced_s(lambda: long_chain_decode(bayes_floor_params(tp, "gaussian", dev),
                                                   GaussianNIW, chain))
    ham = hamming_error_long(z_star, torch.from_numpy(z_true).to(dev), LC_K)
    log(f"    [{time.perf_counter() - t_phase:.1f} s] long_chain_decode at the generating params: {1e3 * s:.1f} ms, Hamming {ham:.6f}")
    require(ham <= LC_FLOOR_HAMMING, f"phase 12 (d): the Bayes-floor decode's Hamming {ham}")
    ms["decode_1e7"] = 1e3 * s

    chain_fm = chain.T.contiguous()
    st_tm, s_tm = synced_s(lambda: estep(chain_fm, True))
    st_tmj, s_tmj = synced_s(estep)
    lz_err, leaf_err = lc_stats_err(st_tm, st_tmj)
    log(f"    [{time.perf_counter() - t_phase:.1f} s] time-minor (D, T) against time-major: {1e3 * s_tm:.1f} against {1e3 * s_tmj:.1f} "
        f"ms; log Z {lz_err:.2e}, leaves {leaf_err:.2e}; sha256 time-minor {digest(st_tm)}, "
        f"time-major {digest(st_tmj)}")
    require(lz_err <= LC_LAYOUT_RTOL and leaf_err <= LC_LAYOUT_RTOL,
            "phase 12 (d): the layouts' statistics differ")
    ms["estep_1e7_time_minor"], ms["estep_1e7_time_major"] = 1e3 * s_tm, 1e3 * s_tmj
    del chain, chain_fm, z_star

    # (e) the multinomial, K=32, V=64, T = 5 x 10^7, block 1024
    t0 = time.perf_counter()
    tokens, z_true, tp = make_chain("multinomial", LC_MULTI_T, LC_MULTI_K, 0, LC_MULTI_V, seed=0)
    ms["gen_multi_host"] = 1e3 * (time.perf_counter() - t0)
    chain = torch.from_numpy(tokens).to(dev)  # int32, as JAX's tokens
    del tokens
    mprior = make_prior(LC_MULTI_K, MultinomialDirichlet, num_symbols=LC_MULTI_V, device=dev)
    p = init_params(torch.Generator(dev).manual_seed(2), mprior, MultinomialDirichlet,
                    chain[:100_000])
    mstep = lambda: long_chain_local_stats(  # noqa: E731
        p, MultinomialDirichlet, chain, LC_MULTI_BLOCK, impl="fused")
    mstep()
    st, s = synced_s(mstep)
    require(math.isfinite(float(st.log_z)), "phase 12 (e): non-finite log Z")
    z_star, sd = synced_s(lambda: long_chain_decode(
        bayes_floor_params(tp, "multinomial", dev), MultinomialDirichlet, chain,
        block_size=LC_MULTI_BLOCK))
    ham = hamming_error_long(z_star, torch.from_numpy(z_true).to(dev), LC_MULTI_K)
    require(0.0 <= ham < 1.0, "phase 12 (e): Hamming out of range")
    log(f"  (e) [{time.perf_counter() - t_phase:.1f} s] multinomial K={LC_MULTI_K}, V={LC_MULTI_V}, T={LC_MULTI_T} ({chain.dtype} tokens), "
        f"block {LC_MULTI_BLOCK}: data on the host {ms['gen_multi_host'] / 1e3:.1f} s; E-step "
        f"{1e3 * s:.1f} ms ({LC_MULTI_T / s:,.0f} steps/s), log Z {float(st.log_z):.6e}; decode at "
        f"the generating params {1e3 * sd:.1f} ms, Hamming {ham:.6f}")
    ms.update({"estep_multi_5e7": 1e3 * s, "decode_multi_5e7": 1e3 * sd})
    del chain, z_star
    log(f"  phase 12 took {time.perf_counter() - t_phase:.1f} s")
    return ms, shared


PAR_WORLD = 4  # phase 13 (b): gloo ranks sharing the one card
PAR_VB_ITERS = 5
PAR_STEPS = 10  # the minibatch, streamed and metaobs steps of (a)
PAR_SVI_B = 256  # sequences a minibatch / streamed step in (a)
PAR_ELBO_RTOL = 1e-5  # (b)'s DP VB ELBOs against (a)'s
PAR_STAT_RTOL = 1e-4  # ... and each statistic: max |err| / the leaf's max
PAR_LC_T, PAR_LC_ITERS = LC_T_SCALE, 3  # the time-sharded streaming VB's chain and iterations
# the state-sharded tier: 4 all-reduces a step, each some 4 ms with four
# ranks time-sliced on one H100 (66 s a pass at T = 4096), so T is sized
# for the phase's budget
PAR_SS_K, PAR_SS_T = 256, 1024
PAR_2D_B, PAR_2D_T = 64, 4096  # the (data, time) batched forward-backward
PAR_CORPUS_N = 2048  # the streamed trainer's corpus: N x T x D, B sequences a step
PAR_KILL = 5
PAR_TIMEOUT_S = 300.0  # a rank's run and every collective; then the phase fails


def tree_scale(x, c):
    """A tensor, or a (named) tuple of them, times c."""
    import torch

    if isinstance(x, torch.Tensor):
        return x * c
    vals = [tree_scale(v, c) for v in x]
    return type(x)(*vals) if hasattr(x, "_fields") else tuple(vals)


def collective_isolation(step, local_step, args, iters: int = 10) -> tuple[float, float]:
    """(ms of the data-parallel step, ms of its twin with the all-reduce
    replaced by a local scale): bench_scaling.py's reading, t_local / t_psum
    the share of a step left to scaling. Host clock, synchronised, the
    minimum over iters."""
    import torch

    out = []
    for fn in (step, local_step):
        fn(*args)
        best = float("inf")
        for _ in range(iters):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        out.append(1e3 * best)
    return out[0], out[1]


def parallel_world_of_one(dev, tmp: str) -> dict:
    """Phase 13 (a): NCCL in a world of one, in this process, at bench.py's
    shape on "auto" (the fused pair). Every data-parallel step against the
    single-process step on the same batch, indices or blocks: the same
    sha256; the fused pair once a step; the collective-isolation reading.
    Returns what (b) is held to and the times (ms)."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu_torch.distributions import GaussianNIW
    from pysvihmm_tpu_torch.engines import batch_vb, metaobs, svi
    from pysvihmm_tpu_torch.engines.base import batch_local_step, elbo_from_stats
    from pysvihmm_tpu_torch.models.hmm import init_params, make_prior
    from pysvihmm_tpu_torch.parallel import (
        make_dp_metaobs_step,
        make_dp_minibatch_svi_step,
        make_dp_streamed_svi_step,
        make_dp_vb_step,
        make_mesh,
        shard_batch,
        sharded_local_step,
    )

    out: dict = {"ms": {}}
    gen = torch.Generator(device=dev).manual_seed(1313)
    obs, _, _ = gen_gaussian_dataset(gen, K, D, B, T)
    prior = make_prior(K, GaussianNIW, obs_dim=D, device=dev)
    p0 = init_params(gen, prior, GaussianNIW, obs)
    np.save(os.path.join(tmp, "obs.npy"), obs.cpu().numpy())
    out["p0"], out["obs"] = tree_to(p0, device="cpu"), os.path.join(tmp, "obs.npy")

    dist.init_process_group("nccl", init_method="file://" + os.path.join(tmp, "nccl1"),
                            world_size=1, rank=0, device_id=dev)
    try:
        mesh = make_mesh(1, "cuda")
        shard = shard_batch(obs, mesh)
        reset_kernel_counts()
        s_dp = sharded_local_step(p0, GaussianNIW, shard, mesh)
        s_1 = batch_local_step(p0, GaussianNIW, obs, need_gamma=False)[0]
        require_launches(kernel_counts(), "auto", 2, "(a) local steps")
        require(digest(s_dp) == digest(s_1), "(a) sharded_local_step differs from "
                "batch_local_step")
        out["stats"] = tree_to(s_dp, device="cpu")

        reset_kernel_counts()
        step, step1 = make_dp_vb_step(GaussianNIW, mesh), batch_vb.make_step(GaussianNIW)
        p, q, elbos, elbos1 = p0, p0, [], []
        for _ in range(PAR_VB_ITERS):
            p, e = step(p, prior, shard)
            q, e1 = step1(q, prior, obs)
            elbos.append(e)
            elbos1.append(e1)
        require_launches(kernel_counts(), "auto", 2 * PAR_VB_ITERS, "(a) DP VB and batch VB")
        require(digest((p, torch.stack(elbos))) == digest((q, torch.stack(elbos1))),
                "(a) DP VB differs from batch VB")
        require_ascending(torch.stack(elbos), "(a) DP VB")
        out["elbos"] = torch.stack(elbos).cpu()
        log(f"  (a) NCCL, a world of one, B={B}, T={T}, K={K}, D={D}, auto: sharded_local_step "
            f"= batch_local_step (sha256 {digest(s_dp)}); {PAR_VB_ITERS} DP VB iterations = batch "
            f"VB's (sha256 {digest(p)}), ELBO " + " -> ".join(f"{float(e):.6e}" for e in elbos))

        # the steps' statistics: the single-process step's on the same input
        cfg = svi.SVIConfig(batch_size=PAR_SVI_B, tau=5.0, kappa=0.6, adaptive=True)
        s0 = svi.init_state(p0, torch.Generator(dev).manual_seed(5), adaptive=True)
        idx = torch.randint(0, B, (PAR_SVI_B,), generator=gen, device=dev)
        mb = make_dp_minibatch_svi_step(GaussianNIW, cfg, B, mesh)
        base = svi.make_minibatch_step(GaussianNIW, cfg, B)
        require_same_state(base.with_indices(s0, prior, obs, idx)[0],
                           mb.with_indices(s0, prior, shard, idx)[0], "(a) minibatch on indices")
        stream = make_dp_streamed_svi_step(GaussianNIW, cfg, B, mesh)
        require_same_state(base.with_batch(s0, prior, obs[:PAR_SVI_B])[0],
                           stream(s0, prior, obs[:PAR_SVI_B])[0], "(a) streamed on a batch")
        chain = gen_gaussian_dataset(gen, K, D, 1, SVI_T, mean_scale=0.5, cov_scale=1.0)[0][0]
        mcfg = metaobs.MetaObsConfig(minibatch=B, block_len=SVI_L, buffer=SVI_BUF)
        meta = make_dp_metaobs_step(GaussianNIW, mcfg, SVI_T, mesh)
        ids = torch.randperm(SVI_T // SVI_L, generator=gen, device=dev)[:B]
        require_same_state(metaobs.make_step(GaussianNIW, mcfg, SVI_T).with_blocks(
            s0, prior, chain, ids)[0], meta.with_blocks(s0, prior, chain, ids)[0],
            "(a) metaobs on blocks")

        for name, fn, data in (("minibatch", mb, shard), ("metaobs", meta, chain),
                               ("streamed", stream, None)):
            st = s0
            reset_kernel_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(PAR_STEPS):
                x = data if data is not None else obs[(i % 4) * PAR_SVI_B:(i % 4 + 1) * PAR_SVI_B]
                st, m = fn(st, prior, x)
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / PAR_STEPS
            require_launches(kernel_counts(), "auto", PAR_STEPS, f"(a) {name} steps")
            require_sane_params(st.params, f"(a) {name} steps")
            require(bool(torch.isfinite(m["noisy_elbo"])), f"(a) {name}: non-finite noisy ELBO")
            out["ms"][f"{name}_step"] = ms
            log(f"    {PAR_STEPS} {name} steps on auto: {ms:.2f} ms a step, the fused pair once "
                f"a step, params finite, every psi factorises")

        def local_vb(p_, pr, o):  # the all-reduce replaced by a local scale
            st_ = tree_scale(batch_local_step(p_, GaussianNIW, o, need_gamma=False)[0], 1)
            return batch_vb.conjugate_update(GaussianNIW, pr, st_), elbo_from_stats(
                p_, pr, GaussianNIW, st_.log_z)

        t_psum, t_local = collective_isolation(step, local_vb, (p0, prior, shard))
        out["ms"].update(dp_vb_step=t_psum, dp_vb_local=t_local)
        log(f"    collective isolation (bench_scaling.py): the DP VB step {t_psum:.3f} ms with "
            f"the NCCL all-reduce, {t_local:.3f} ms with a local scale: t_local / t_psum = "
            f"{t_local / t_psum:.4f} (a world of one: no scaling is measured)")
    finally:
        dist.destroy_process_group()
    return out


def parallel_rank(rank: int, world: int, a: dict) -> dict:
    """Phase 13 (b): one gloo rank on the shared card (a spawned process that
    loads the kernels the parent built). Returns its results and times."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from pysvihmm_tpu_torch.data.loader import ShardedSequenceLoader
    from pysvihmm_tpu_torch.distributions import GaussianNIW
    from pysvihmm_tpu_torch.engines import svi, trainer
    from pysvihmm_tpu_torch.messages import (
        state_sharded_forward_backward,
        time_sharded_forward_backward_batched,
    )
    from pysvihmm_tpu_torch.models.hmm import expected_log_params, make_prior
    from pysvihmm_tpu_torch.parallel import (
        collectives,
        make_dp_streamed_svi_step,
        make_dp_vb_step,
        make_mesh,
        make_ss_vb_step,
        make_time_mesh,
        make_ts_stream_vb_step,
        run_vb_scan,
        shard_params_by_state,
        sharded_local_step,
        time_sharded_decode,
        time_sharded_stream_stats,
    )

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    out: dict = {"ms": {}}

    def timed(name, fn):
        res, s = synced_s(fn)
        out["ms"][name] = 1e3 * s
        return res

    def rows(path, n):
        return torch.from_numpy(np.load(path, mmap_mode="r")[rank * n:(rank + 1) * n].copy())

    # data-parallel VB, B / world sequences a rank
    mesh = make_mesh(world, "cuda")
    obs = rows(a["obs"], B // world).to(dev)
    prior = make_prior(K, GaussianNIW, obs_dim=D, device=dev)
    p0 = tree_to(a["p0"], device=dev)
    reset_kernel_counts()
    out["stats"] = tree_to(timed("dp_local_step", lambda: sharded_local_step(
        p0, GaussianNIW, obs, mesh)), device="cpu")
    step = make_dp_vb_step(GaussianNIW, mesh)
    p, elbos = timed("dp_vb", lambda: run_vb_scan(step, p0, prior, obs, PAR_VB_ITERS))
    require_launches(kernel_counts(), "auto", PAR_VB_ITERS + 1, f"rank {rank}: DP VB")
    out["elbos"] = elbos.cpu()
    del obs

    # time-sharded streaming VB on config 4's chain: this rank's tile
    tmesh = make_time_mesh(world, "cuda")
    tile = rows(a["chain"], PAR_LC_T // world).to(dev)
    p_lc = tree_to(a["p_lc"], device=dev)
    lc_prior = make_prior(LC_K, GaussianNIW, obs_dim=LC_D, device=dev)
    out["lc_log_z"] = float(timed("ts_stream_stats", lambda: time_sharded_stream_stats(
        p_lc, GaussianNIW, tile, tmesh, block_size=LC_BLOCK)).log_z)
    ts_step = make_ts_stream_vb_step(GaussianNIW, tmesh, block_size=LC_BLOCK)
    _, lc_elbos = timed("ts_stream_vb", lambda: run_vb_scan(ts_step, p_lc, lc_prior, tile,
                                                            PAR_LC_ITERS))
    out["lc_elbos"] = lc_elbos.cpu()
    out["lc_z"] = timed("ts_decode", lambda: time_sharded_decode(
        tree_to(a["floor"], device=dev), GaussianNIW, tile, tmesh)).cpu().numpy()
    del tile

    # state-sharded forward-backward and VB at K = 256: this rank's K / world states
    smesh = make_mesh(world, "cuda", axis="state")
    p256 = tree_to(a["p256"], device=dev)
    chain = a["ss_chain"].to(dev)
    Kd = PAR_SS_K // world
    blk = slice(rank * Kd, (rank + 1) * Kd)
    log_pi, log_A = expected_log_params(p256)
    pb = shard_params_by_state(p256, smesh)
    fb = timed("ss_fb", lambda: state_sharded_forward_backward(
        log_pi[blk], log_A[blk], GaussianNIW.expected_log_likelihood(pb.emit, chain), smesh))
    out["ss"] = {"log_z": float(fb.log_z), "trans": fb.trans_stats.cpu()}
    ss_prior = make_prior(PAR_SS_K, GaussianNIW, obs_dim=D, device=dev)
    _, ss_elbo = timed("ss_vb", lambda: make_ss_vb_step(GaussianNIW, smesh)(
        pb, shard_params_by_state(ss_prior, smesh), chain))
    out["ss_elbo"] = float(ss_elbo)

    # the (data, time) = (2, 2) batched forward-backward
    m2 = init_device_mesh("cuda", (2, world // 2), mesh_dim_names=("data", "time"))
    bi, ti = (collectives.axis_index(m2.get_group(x)) for x in ("data", "time"))
    nb, nt = PAR_2D_B // 2, PAR_2D_T // (world // 2)
    o2 = a["obs2"][bi * nb:(bi + 1) * nb, ti * nt:(ti + 1) * nt].to(dev)
    p2 = tree_to(a["p2"], device=dev)
    lp2, lA2 = expected_log_params(p2)
    r = timed("fb_2d", lambda: time_sharded_forward_backward_batched(
        lp2, lA2, GaussianNIW.expected_log_likelihood(p2.emit, o2), m2))
    out["b2"] = {"bi": bi, "ti": ti, "log_z": r.log_z.cpu(), "init": r.init_stats.cpu(),
                 "trans": r.trans_stats.cpu()}

    # the streamed trainer killed and resumed across the ranks
    cfg = svi.SVIConfig(batch_size=B, tau=5.0, kappa=0.6, adaptive=True)

    def run(num_steps, **kw):
        loader = ShardedSequenceLoader.from_npy(a["corpus"], dev, B // world, seed=3)
        state = svi.init_state(p0, torch.Generator(dev).manual_seed(4), adaptive=True)
        return trainer.train_streamed(make_dp_streamed_svi_step(GaussianNIW, cfg, PAR_CORPUS_N),
                                      state, prior, loader, num_steps, **kw)

    ref = timed("trainer_uninterrupted", lambda: run(PAR_STEPS))
    run(PAR_KILL, checkpoint_dir=a["ckpt"], checkpoint_every=2)
    got = run(PAR_STEPS, checkpoint_dir=a["ckpt"], checkpoint_every=2)
    out["trainer"] = (state_digests(ref), state_digests(got))
    return out


def parallel_phase(dev, tmp: str, lc: dict) -> dict[str, float]:
    """Phase 13: the parallel paths. (a) NCCL in a world of one in this
    process (:func:`parallel_world_of_one`); (b) four gloo ranks on the one
    card, spawned (:func:`parallel_rank`): data-parallel VB at B=1024 (256 a
    rank) against (a) (ELBOs to 1e-5 relative, statistics to 1e-4 of each
    leaf's max: the fused backward groups its sums by S, and S follows the
    per-rank B); time-sharded streaming VB on phase 12's T = 10^7 chain in 4
    tiles (log Z against phase 12's to 1e-5, 3 iterations non-decreasing,
    the decode at the generating params Hamming <= 0.05); state-sharded
    forward-backward at K=256, T=1024 (64 states a rank) against the fused
    kernels at B = 1 (log Z 1e-5, trans 1e-4 of its max) and a VB step
    against batch VB's (ELBO 1e-5); the (2, 2) (data, time) batched forward-backward at B=64,
    T=4096 against the fused kernels; the streamed trainer killed at 5 of
    10 steps and resumed (the same sha256). A rank that raises, or a run past
    PAR_TIMEOUT_S, fails the phase. One card measures no scaling: the ranks
    share it, and gloo stages every collective through the host. Returns
    the times (ms)."""
    import numpy as np
    import torch

    from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu_torch.distributions import GaussianNIW
    from pysvihmm_tpu_torch.engines import batch_vb
    from pysvihmm_tpu_torch.engines.base import batch_local_step
    from pysvihmm_tpu_torch.eval.metrics import hamming_error_long
    from pysvihmm_tpu_torch.models.hmm import init_params, make_prior
    from pysvihmm_tpu_torch.parallel import spawn_local

    t_phase = time.perf_counter()
    a_res = parallel_world_of_one(dev, tmp)
    ms = {f"a_{k}": v for k, v in a_res["ms"].items()}
    log(f"  (a) took {time.perf_counter() - t_phase:.1f} s")

    # (b)'s inputs, and their single-process references on the card
    gen = torch.Generator(device=dev).manual_seed(1414)
    ss_chain = gen_gaussian_dataset(gen, PAR_SS_K, D, 1, PAR_SS_T)[0][0]
    ss_prior = make_prior(PAR_SS_K, GaussianNIW, obs_dim=D, device=dev)
    p256 = init_params(gen, ss_prior, GaussianNIW, ss_chain)
    ss_ref = batch_local_step(p256, GaussianNIW, ss_chain[None], method="fused",
                              need_gamma=False)[0]
    ss_ref_elbo = float(batch_vb.make_step(GaussianNIW, "fused")(p256, ss_prior,
                                                                 ss_chain[None])[1])
    obs2, _, _ = gen_gaussian_dataset(gen, K, D, PAR_2D_B, PAR_2D_T)
    p2 = init_params(gen, make_prior(K, GaussianNIW, obs_dim=D, device=dev), GaussianNIW, obs2)
    ref2 = batch_local_step(p2, GaussianNIW, obs2, method="fused", need_gamma=False)[0]
    corpus = gen_gaussian_dataset(gen, K, D, PAR_CORPUS_N, T)[0]
    np.save(os.path.join(tmp, "corpus.npy"), corpus.cpu().numpy())
    del corpus
    args = {"obs": a_res["obs"], "p0": a_res["p0"], "chain": lc["chain"], "p_lc": lc["p"],
            "floor": lc["floor"], "p256": tree_to(p256, device="cpu"),
            "ss_chain": ss_chain.cpu(), "p2": tree_to(p2, device="cpu"), "obs2": obs2.cpu(),
            "corpus": os.path.join(tmp, "corpus.npy"), "ckpt": os.path.join(tmp, "ckpt13")}
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ranks = spawn_local(parallel_rank, PAR_WORLD, args, backend="gloo", timeout=PAR_TIMEOUT_S)
    ms["b_spawned_s"] = 1e3 * (time.perf_counter() - t0)
    per_rank = {k: max(r["ms"][k] for r in ranks) for k in ranks[0]["ms"]}
    log(f"  (b) {PAR_WORLD} gloo ranks on the card ran in {ms['b_spawned_s'] / 1e3:.1f} s "
        "(spawn, imports and every check); the slowest rank's ms: "
        + json.dumps({k: round(v, 1) for k, v in per_rank.items()}))
    ms.update({f"b_{k}": v for k, v in per_rank.items()})

    for r in ranks[1:]:
        require(digest(r["elbos"]) == digest(ranks[0]["elbos"]), "(b) DP VB: ranks differ")
    e_err = rel_max_err(ranks[0]["elbos"], a_res["elbos"])
    s_err = rel_max_err(ranks[0]["stats"], a_res["stats"])
    log(f"    DP VB, B={B} ({B // PAR_WORLD} a rank): ELBOs {e_err:.2e} from (a)'s, the local "
        f"step's statistics {s_err:.2e} of each leaf's max")
    require(e_err <= PAR_ELBO_RTOL and s_err <= PAR_STAT_RTOL, "(b) DP VB differs from (a)")

    lz = ranks[0]["lc_log_z"]
    lz_err = abs(lz - lc["log_z"]) / abs(lc["log_z"])
    ham = hamming_error_long(torch.from_numpy(np.concatenate([r["lc_z"] for r in ranks])).to(dev),
                             torch.from_numpy(np.load(lc["z_true"])).to(dev), LC_K)
    log(f"    time-sharded streaming VB, T={PAR_LC_T} in {PAR_WORLD} tiles: log Z {lz:.6e}, "
        f"{lz_err:.2e} from phase 12's one-rank E-step; ELBO "
        + " -> ".join(f"{float(e):.6e}" for e in ranks[0]["lc_elbos"])
        + f"; the decode at the generating params Hamming {ham:.6f}")
    require(lz_err <= LC_LOGZ_RTOL, "(b) time-sharded log Z differs from phase 12's")
    require_ascending(ranks[0]["lc_elbos"], "(b) time-sharded streaming VB")
    require(ham <= LC_FLOOR_HAMMING, f"(b) time-sharded decode Hamming {ham}")

    ss_lz = ranks[0]["ss"]["log_z"]
    ss_lz_err = abs(ss_lz - float(ss_ref.log_z)) / abs(float(ss_ref.log_z))
    tr_err = rel_max_err(torch.cat([r["ss"]["trans"] for r in ranks]), ss_ref.trans)
    elbo_err = abs(ranks[0]["ss_elbo"] - ss_ref_elbo) / abs(ss_ref_elbo)
    log(f"    state-sharded, K={PAR_SS_K}, T={PAR_SS_T}, {PAR_SS_K // PAR_WORLD} states a rank: "
        f"log Z {ss_lz_err:.2e} from the fused kernels' at B = 1, trans {tr_err:.2e} of its max; "
        f"a VB step's ELBO {ranks[0]['ss_elbo']:.6e}, {elbo_err:.2e} from batch VB's on the "
        "fused kernels")
    require(ss_lz_err <= LC_LOGZ_RTOL and tr_err <= PAR_STAT_RTOL and elbo_err <= PAR_ELBO_RTOL,
            "(b) the state-sharded tier differs from the fused kernels")

    by = {(r["b2"]["bi"], r["b2"]["ti"]): r["b2"] for r in ranks}
    lz2 = sum(float(by[(i, 0)]["log_z"].double().sum()) for i in range(2))
    init2 = sum(by[(i, 0)]["init"].sum(dim=0) for i in range(2))
    lz2_err = abs(lz2 - float(ref2.log_z)) / abs(float(ref2.log_z))
    tr2_err = rel_max_err(ranks[0]["b2"]["trans"], ref2.trans)
    in2_err = rel_max_err(init2, ref2.init)
    log(f"    (data, time) = (2, 2) batched forward-backward, B={PAR_2D_B}, T={PAR_2D_T}: log Z "
        f"{lz2_err:.2e}, trans {tr2_err:.2e}, init {in2_err:.2e} from the fused kernels'")
    require(lz2_err <= LC_LOGZ_RTOL and tr2_err <= PAR_STAT_RTOL and in2_err <= PAR_STAT_RTOL,
            "(b) the 2-D tier differs from the fused kernels")

    for rank, r in enumerate(ranks):
        ref, got = r["trainer"]
        require(ref == got, f"(b) rank {rank}: the resumed trainer differs: "
                + ", ".join(k for k in ref if ref[k] != got.get(k)))
    log(f"    the streamed trainer over a {PAR_CORPUS_N} x {T} x {D} corpus, killed at "
        f"{PAR_KILL} of {PAR_STEPS} steps and resumed on every rank: the uninterrupted run's "
        f"sha256 (psi {ranks[0]['trainer'][0]['params.emit.psi']})")
    log(f"  phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return ms


# ---------------------------------------------------------------- phase 14

MODE_D = 8  # the observations' width of phase 14 (NIW F = 45, NIG F = 17)
MODE_KINDS = ("niw", "nig")
MODE_KS = (64, 65, 128, 256)  # both tiers, both ends of the first large-K one
MODE_BS = (1, 3, 1024)
SEL_BS, SEL_KS = SVI_BATCHES, (64, 128)  # (b): the gamma pick at the SVI shape
BF16_PROBE_STEPS = 20  # (c): config 4's windowed SVI with bf16 alpha
MODE_VB_ITERS = 3  # the main path in the modes: VB iterations a family and route
MODE_SVI_STEPS = 10  # and SVI steps with the gamma pick
MODE_WIDE_K = 128  # the main path's large-K runs in the modes (the operand kernels)
MODE_REPS, MODE_ITERS = 7, 5  # (d): the median of MODE_REPS means of MODE_ITERS calls
# the kernels line's rows of the modes: (row, kernel, mode, source, replaces)
MODE_ROWS = (
    ("fused_fwd_kernel<niw>", "fused_fwd_kernel", "niw", "fused_fb.cu", "pallas_fb.py:516"),
    ("fused_bwd_kernel<niw>", "fused_bwd_kernel", "niw", "fused_fb.cu", "pallas_fb.py:577"),
    ("fused_fwd_kernel<nig>", "fused_fwd_kernel", "nig", "fused_fb.cu", "pallas_fb.py:516"),
    ("fused_bwd_kernel<nig>", "fused_bwd_kernel", "nig", "fused_fb.cu", "pallas_fb.py:577"),
    ("fused_bwd_kernel<gamma_sel>", "fused_bwd_kernel", "gamma_sel", "fused_fb.cu",
     "pallas_fb.py:577"),
    ("fused_fwd_kernel<bf16 alpha>", "fused_fwd_kernel", "bf16", "fused_fb.cu",
     "pallas_fb.py:516"),
    ("fused_bwd_kernel<bf16 alpha>", "fused_bwd_kernel", "bf16", "fused_fb.cu",
     "pallas_fb.py:577"),
    ("duplex_chain_kernel<niw>", "duplex_chain_kernel", "niw", "duplex_fb.cu",
     "pallas_duplex.py:82"),
    ("duplex_combine_kernel<niw>", "duplex_combine_kernel", "niw", "duplex_fb.cu",
     "pallas_duplex.py:175"),
    ("duplex_chain_kernel<nig>", "duplex_chain_kernel", "nig", "duplex_fb.cu",
     "pallas_duplex.py:82"),
    ("duplex_combine_kernel<nig>", "duplex_combine_kernel", "nig", "duplex_fb.cu",
     "pallas_duplex.py:175"),
)


def mode_T(K_: int) -> int:
    """T of phase 14 (a) at K_: 300 at K = 256, where B = 1024 then cuts
    three windows of the large-K statistics (128, 128 and 44 steps)."""
    return 300 if K_ == 256 else T


def mode_problem(gen, B_, T_, K_, D_, kind):
    """E-step inputs of a built feature kind from the seeded ``gen``:
    (log_pi, log_A, W (F, K), obs (T, B, D)) float32 on the card, the raw
    observations time-major. W of a posterior near the generating states:
    random_problem's NIW for "niw", a diagonal NIG for "nig"."""
    import torch

    from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu_torch.distributions import diag_gaussian, dirichlet, niw

    dev = gen.device
    obs, _, truth = gen_gaussian_dataset(gen, K_, D_, B_, T_, mean_scale=0.5, cov_scale=1.0)
    mu = truth.theta[0]

    def u(*shape, lo=0.0, hi=1.0):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    mean = mu + 0.3 * torch.randn(mu.shape, generator=gen, device=dev)
    if kind == "niw":
        q = niw.NIW(mean=mean, kappa=u(K_, lo=2.0, hi=20.0), nu=D_ + 2.0 + u(K_, lo=3.0, hi=20.0),
                    psi=5.0 * (u(K_, 1, 1, lo=0.5, hi=2.0) * torch.eye(D_, device=dev) + 0.1))
        W = niw.ell_feature_matrix(q)
    else:
        q = diag_gaussian.NIG(mean=mean, kappa=u(K_, D_, lo=2.0, hi=20.0),
                              a=u(K_, D_, lo=3.0, hi=20.0), b=u(K_, D_, lo=2.0, hi=10.0))
        W = diag_gaussian.ell_feature_matrix(q)
    log_pi = dirichlet.expected_log_probs(u(K_, lo=1.0, hi=3.0))
    log_A = dirichlet.expected_log_probs(u(K_, K_, lo=1.0, hi=3.0)
                                         + 5.0 * torch.eye(K_, device=dev))
    return (log_pi, log_A, W.to(torch.float32).contiguous(),
            obs.transpose(0, 1).to(torch.float32).contiguous())


def same_bits(a, b) -> bool:
    """Two kernels' outputs (tensors or tuples of them, None for a gamma not
    emitted) hold the same bits, compared on the card: each pair of leaves
    of one dtype and shape, viewed as integers of their width (so -0 and +0
    differ, and a NaN equals only its own bits)."""
    import torch

    xs, ys = flat_leaves(tuple(a)), flat_leaves(tuple(b))
    if len(xs) != len(ys):
        return False
    for x, y in zip(xs, ys):
        if x is None or y is None:
            if x is not y:
                return False
            continue
        if x.dtype != y.dtype or x.shape != y.shape:
            return False
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[x.element_size()]
        if not torch.equal(x.contiguous().view(ints), y.contiguous().view(ints)):
            return False
    return True


def require_same(what: str, a, b) -> None:
    require(same_bits(a, b), f"{what}: not the same bits")


def check_mode_features(gen, kind, K_, B_, T_, twins: bool = True) -> dict[str, float]:
    """Phase 14 (a) at one shape: the fused pair at every built S, the
    duplex chain at every built S and the combine, each on the raw
    observations of ``kind`` against the array mode on ``ell_features(obs)``
    (gated and not, emit_gamma both ways), bit for bit; with ``twins`` the
    default S against the plain twins in the mode. Returns the twins' max
    errors: the forward's and the chain's log_c, the backward's and the
    combine's gamma (0 without twins)."""
    import torch

    from pysvihmm_tpu_torch.messages import duplex_fb as df
    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.messages.split_fb import exp_params

    log_pi, log_A, W, obs = mode_problem(gen, B_, T_, K_, MODE_D, kind)
    feats = ff.build_features(obs, kind)
    pi_t, A_t = exp_params(log_pi, log_A)
    w = svi_masks(gen, B_, T_, max(1, (5 * T_) // 7))
    fwd = None
    for S in ff.built_seqs(K_):
        fwd = ff._launch_forward(S, pi_t, A_t, W, feats)
        require_same(f"fused forward {kind} K={K_} B={B_} S={S}", fwd,
                     ff._launch_forward(S, pi_t, A_t, W, obs, kind))
        for wg in (None, w):
            for emit in (True, False):
                require_same(f"fused backward {kind} K={K_} B={B_} S={S} gated={wg is not None} "
                             f"emit_gamma={emit}",
                             ff._launch_backward(S, A_t, W, feats, *fwd, emit, wg),
                             ff._launch_backward(S, A_t, W, obs, *fwd, emit, wg, kind))
    for S in df.built_seqs(K_):
        chain = df._launch_chain(S, pi_t, A_t, W, feats)
        require_same(f"duplex chain {kind} K={K_} B={B_} S={S}", chain,
                     df._launch_chain(S, pi_t, A_t, W, obs, kind))
    a_c, _, sh_c, b_c = chain
    for wg in (None, w):
        for emit in (True, False):
            require_same(f"duplex combine {kind} K={K_} B={B_} gated={wg is not None} "
                         f"emit_gamma={emit}",
                         df.duplex_combine(W, feats, a_c, b_c, sh_c, emit, wg),
                         df.duplex_combine(W, obs, a_c, b_c, sh_c, emit, wg, kind))
    torch.cuda.synchronize()
    errs = {"fwd": 0.0, "bwd": 0.0, "chain": 0.0, "combine": 0.0}
    if not twins:
        return errs
    log(f"   {kind} K={K_} B={B_} T={T_}: the default S against the twins")
    alpha, s, sh = ff.fused_forward(pi_t, A_t, W, obs, kind)
    a_r, s_r, sh_r = ff.forward_reference(pi_t, A_t, W, obs, kind)
    compare("alpha", alpha, a_r, 0.0, 5e-5)
    errs["fwd"] = compare("log_c", torch.log(s) + sh, torch.log(s_r) + sh_r, 2e-6, 1e-4)
    got = ff.fused_backward(A_t, W, obs, a_r, s_r, sh_r, True, w, kind)
    ref = ff.backward_reference(A_t, W, obs, a_r, s_r, sh_r, True, w, kind)
    for name, x, r, rtol, atol in zip(("gamma", "gamma0", "acc", "eacc"), got, ref,
                                      (0.0, 0.0, 1e-4, 3e-3), (5e-5, 5e-5, 1e-3, 2e-3)):
        e = compare(name, x, r, rtol, atol)
        errs["bwd"] = e if name == "gamma" else errs["bwd"]
    alpha, s, sh, beta = df.duplex_chain(pi_t, A_t, W, obs, kind)
    a_r, s_r, sh_r, b_r = df.duplex_chain_reference(pi_t, A_t, W, obs, kind)
    compare("chain beta", beta, b_r, 0.0, 5e-5)
    errs["chain"] = compare("chain log_c", torch.log(s) + sh, torch.log(s_r) + sh_r, 2e-6, 1e-4)
    got = df.duplex_combine(W, obs, a_r, b_r, sh_r, True, w, kind)
    ref = df.duplex_combine_reference(W, obs, a_r, b_r, sh_r, True, w, kind)
    for name, x, r, rtol, atol in zip(("gamma", "gamma0", "acc", "eacc"), got, ref,
                                      (0.0, 0.0, 1e-4, 3e-3), (5e-5, 5e-5, 1e-3, 2e-3)):
        e = compare(f"combine {name}", x, r, rtol, atol)
        errs["combine"] = e if name == "gamma" else errs["combine"]
    return errs


def check_gamma_sel(gen, B_, K_) -> float:
    """Phase 14 (b) at one shape: the gated fused backward with the pick at
    each window's kept offset gives the emit_gamma run's gamma gathered
    there, bit for bit, and its acc and eacc are the run's without the pick;
    the E-step's log_c likewise (s and sh are the forward's). Returns the
    pick's max error against the twin's."""
    import torch

    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.messages.split_fb import exp_params

    W_, L_ = SVI_W, SVI_L
    log_pi, log_A, W, obs = mode_problem(gen, B_, W_, K_, MODE_D, "niw")
    feats = ff.build_features(obs, "niw")
    offs = torch.randint(0, W_ - L_ + 1, (B_,), generator=gen, device=gen.device)
    t = torch.arange(W_, device=gen.device)[:, None]
    w = ((t >= offs) & (t < offs + L_)).to(torch.float32).contiguous()
    pi_t, A_t = exp_params(log_pi, log_A)
    fwd = ff.fused_forward(pi_t, A_t, W, feats)
    full = ff.fused_backward(A_t, W, feats, *fwd, True, w)
    plain = ff.fused_backward(A_t, W, feats, *fwd, False, w)
    picked = ff.fused_backward(A_t, W, feats, *fwd, False, w, gamma_sel=offs)
    rows = torch.arange(B_, device=gen.device)
    require(picked[0] is None, "(b): gamma written with the pick")
    require(torch.equal(picked[1], full[0][offs, rows]),
            f"(b) B={B_} K={K_}: the pick is not emit_gamma's gamma at offs")
    require(same_bits(picked[2:], plain[2:]),
            f"(b) B={B_} K={K_}: acc and eacc differ with the pick")
    fk, Sk = ff.estep_fused(log_pi, log_A, W, obs, weights=w, gamma_sel=offs,
                            in_kernel_feats="niw")
    fp, Sp = ff.estep_fused(log_pi, log_A, W, feats, weights=w)
    require(torch.equal(fk.log_c, fp.log_c) and torch.equal(Sk, Sp)
            and torch.equal(fk.trans_stats, fp.trans_stats),
            f"(b) B={B_} K={K_}: the E-step's log_c or statistics differ with the pick")
    ref = ff.backward_reference(A_t, W, feats, *fwd, False, w, gamma_sel=offs)
    return compare(f"pick B={B_} K={K_}", picked[1], ref[1], 0.0, 5e-5)


def check_bf16_alpha(gen, B_, T_, K_) -> dict[str, float]:
    """Phase 14 (c) at one shape: the bf16-stored alpha is the float32
    kernel's rounded, bit for bit (the chain carries float32), s the sum of
    the rounded values (against the twin's sum), sh the float32 run's;
    statistics and log Z within JAX's band of float32
    (tests/test_precision.py:251-270); ``exact=True`` gives the float32 bits.
    Returns the forward's alpha and the backward's gamma errors against the
    bf16 twins."""
    import torch

    from pysvihmm_tpu_torch.distributions import GaussianNIW
    from pysvihmm_tpu_torch.engines.base import batch_local_step
    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.messages.split_fb import exp_params
    from pysvihmm_tpu_torch.models.hmm import init_params, make_prior

    log_pi, log_A, W, obs = mode_problem(gen, B_, T_, K_, MODE_D, "niw")
    pi_t, A_t = exp_params(log_pi, log_A)
    for S in ff.built_seqs(K_):
        a32, s32, sh32 = ff._launch_forward(S, pi_t, A_t, W, obs, "niw")
        a16, s16, sh16 = ff._launch_forward(S, pi_t, A_t, W, obs, "niw", torch.bfloat16)
        require(a16.dtype == torch.bfloat16 and torch.equal(a16, a32.to(torch.bfloat16)),
                f"(c) K={K_} S={S}: the stored alpha is not float32's rounded")
        require(torch.equal(sh16, sh32), f"(c) K={K_} S={S}: sh differs")
    compare("s: the sum of the rounded alpha", s16, a16.float().sum(-1).T, 1e-6, 0.0)
    a_r, s_r, sh_r = ff.forward_reference(pi_t, A_t, W, obs, "niw", torch.bfloat16)
    # the kernel's and the twin's float32 alpha differ by their summation
    # order (~1e-8), so near a rounding boundary their bf16 values differ by
    # one bf16 ulp: 2^-8 of the largest alpha
    errs = {"fwd": compare("bf16 alpha against the twin", a16.float(), a_r.float(), 2.0 ** -8,
                           5e-5)}
    got = ff.fused_backward(A_t, W, obs, a16, s16, sh16, True, None, "niw")
    ref = ff.backward_reference(A_t, W, obs, a16, s16, sh16, True, None, "niw")
    for name, x, r, rtol, atol in zip(("gamma", "gamma0", "acc", "eacc"), got, ref,
                                      (0.0, 0.0, 1e-4, 3e-3), (5e-5, 5e-5, 1e-3, 2e-3)):
        e = compare(f"bf16 {name}", x, r, rtol, atol)
        errs["bwd"] = e if name == "gamma" else errs.get("bwd", 0.0)
    bf, bS = ff.estep_fused(log_pi, log_A, W, obs, in_kernel_feats="niw",
                            alpha_dtype=torch.bfloat16)
    f32, fS = ff.estep_fused(log_pi, log_A, W, obs, in_kernel_feats="niw")
    dz = abs(bf.log_z.double().sum().item() - f32.log_z.double().sum().item())
    rel_z = dz / abs(f32.log_z.double().sum().item())
    rel_s = ((bS - fS).abs().max() / fS.abs().max()).item()
    rel_t = ((bf.trans_stats - f32.trans_stats).abs().max() / f32.trans_stats.abs().max()).item()
    log(f"   bf16 against float32 at K={K_}: log Z {rel_z:.3e}, emit {rel_s:.3e}, trans "
        f"{rel_t:.3e} relative (JAX's band: log Z < 1e-3, the statistics < 2e-2)")
    require(rel_z < 1e-3 and rel_s < 2e-2 and rel_t < 2e-2, "(c): bf16 alpha outside the band")
    y = obs.transpose(0, 1).contiguous()
    prior = make_prior(K_, GaussianNIW, obs_dim=MODE_D, device=gen.device)
    p = init_params(gen, prior, GaussianNIW, y)
    ex = batch_local_step(p, GaussianNIW, y, "fused", need_gamma=False, exact=True,
                          bf16_alpha=True)[0]
    ref32 = batch_local_step(p, GaussianNIW, y, "fused", need_gamma=False)[0]
    require(same_bits(ex, ref32), "(c): exact=True is not float32's bits")
    return errs


def median_ms(fn) -> float:
    """The median over MODE_REPS of the mean ms of MODE_ITERS calls (CUDA
    events, one warm-up call first)."""
    from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms

    xs = sorted(cuda_ms(fn, MODE_ITERS, warmup=1 if i == 0 else 0) for i in range(MODE_REPS))
    return xs[len(xs) // 2]


def modes_main_path(dev) -> tuple[dict, float]:
    """The main path in the modes, the counts set to 0 just before and read
    just after: batch VB (B, T, K, D = 1024, 1000, 64, 8) with in-kernel
    features for both Gaussian families on "fused" and "duplex" (the ELBOs
    the array mode's, bit for bit), then windowed SVI at B = 1024 with the
    gamma pick (the parameters the gather's, bit for bit); then at K =
    MODE_WIDE_K, where the statistics' operands are made a window at a
    time, VB on "duplex" with in-kernel NIW features (the array mode's
    ELBOs, bit for bit) and windowed SVI on "fused" with in-kernel NIW
    features and bf16 alpha (every parameter finite and factorisable).
    Returns the launches by (kernel, mode), and by name for the operand
    kernels, and the set-up seconds."""
    import torch

    from pysvihmm_tpu_torch.data.synthetic import gen_diag_gaussian_dataset, gen_gaussian_dataset
    from pysvihmm_tpu_torch.distributions import DiagonalGaussianNIG, GaussianNIW
    from pysvihmm_tpu_torch.engines import batch_vb, svi
    from pysvihmm_tpu_torch.engines.base import prepare_fused_obs
    from pysvihmm_tpu_torch.models.hmm import init_params, make_prior

    t0 = time.perf_counter()
    data = {}
    for fam, make, kw in ((GaussianNIW, gen_gaussian_dataset, {"cov_scale": 1.0}),
                          (DiagonalGaussianNIG, gen_diag_gaussian_dataset, {"var_scale": 1.0})):
        g = torch.Generator(device=dev).manual_seed(41)
        obs = make(g, K, MODE_D, B, T, mean_scale=0.5, **kw)[0]
        prior = make_prior(K, fam, obs_dim=MODE_D, device=dev)
        data[fam] = (obs, prior, init_params(g, prior, fam, obs))
    g = torch.Generator(device=dev).manual_seed(42)
    chain = gen_gaussian_dataset(g, K, MODE_D, 1, SVI_T, mean_scale=0.5, cov_scale=1.0)[0][0]
    prior_c = make_prior(K, GaussianNIW, obs_dim=MODE_D, device=dev)
    p_c = init_params(g, prior_c, GaussianNIW, chain)
    g = torch.Generator(device=dev).manual_seed(51)
    obs_w = gen_gaussian_dataset(g, MODE_WIDE_K, MODE_D, B, T, mean_scale=0.5,
                                 cov_scale=1.0)[0]
    prior_w = make_prior(MODE_WIDE_K, GaussianNIW, obs_dim=MODE_D, device=dev)
    data_w = (obs_w, prior_w, init_params(g, prior_w, GaussianNIW, obs_w))
    chain_w = gen_gaussian_dataset(g, MODE_WIDE_K, MODE_D, 1, SVI_T, mean_scale=0.5,
                                   cov_scale=1.0)[0][0]
    p_cw = init_params(g, prior_w, GaussianNIW, chain_w)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def vb(fam, route, ik, problem=None):
        obs, prior, p = problem or data[fam]
        step = batch_vb.make_step(fam, route, in_kernel_feats=ik)
        prepared = prepare_fused_obs(p, fam, obs, in_kernel_feats=ik)
        elbos = []
        for _ in range(MODE_VB_ITERS):
            p, e = step(p, prior, obs, prepared)
            elbos.append(e)
        return torch.stack(elbos)

    cfg = svi.SVIConfig(batch_size=B, subchain_len=SVI_L, buffer=SVI_BUF)

    def svi_steps(pick):
        step = svi.make_step(GaussianNIW, cfg, SVI_T, "fused", gamma_sel=pick)
        state = svi.init_state(p_c, torch.Generator(device=dev).manual_seed(43))
        for _ in range(MODE_SVI_STEPS):
            state, _ = step(state, prior_c, chain)
        return state.params

    def svi_wide():
        step = svi.make_step(GaussianNIW, cfg, SVI_T, "fused", in_kernel_feats=True,
                             bf16_alpha=True)
        state = svi.init_state(p_cw, torch.Generator(device=dev).manual_seed(52))
        for i in range(MODE_SVI_STEPS):
            state, _ = step(state, prior_w, chain_w)
            require_sane_params(state.params, f"(main path) K={MODE_WIDE_K} SVI step {i} with "
                                "in-kernel features and bf16 alpha")

    reset_kernel_counts()
    with_modes = {(fam, route): vb(fam, route, True) for fam in data
                  for route in ("fused", "duplex")}
    picked = svi_steps(True)
    wide_elbos = vb(GaussianNIW, "duplex", True, data_w)
    svi_wide()
    torch.cuda.synchronize()
    counts = {}
    for kernel, fn in mode_launchers().items():
        for mode, n in fn.mode_launches.items():
            counts[kernel, mode] = n
    from pysvihmm_tpu_torch.messages import fused_fb as ff

    for name in ff.PREP_KERNELS:
        counts[name] = ff.prep_launches(name)
    log(f"  the main path in the modes: launches by (kernel, mode) {counts}")
    require(torch.equal(wide_elbos, vb(GaussianNIW, "duplex", False, data_w)),
            f"(main path) K={MODE_WIDE_K} duplex: the in-kernel VB ELBOs are not the array "
            "mode's")
    log(f"   GaussianNIW duplex at K={MODE_WIDE_K}: {MODE_VB_ITERS} VB iterations with in-kernel "
        f"features, ELBO {wide_elbos[-1].item():.6e}, the array mode's bit for bit; "
        f"{MODE_SVI_STEPS} SVI steps on fused with in-kernel features and bf16 alpha, finite "
        "and factorisable")
    for (fam, route), e in with_modes.items():
        ref = vb(fam, route, False)
        require_ascending(e, f"(main path) {fam.__name__} {route} in-kernel VB")
        require(torch.equal(e, ref), f"(main path) {fam.__name__} {route}: the in-kernel VB "
                "ELBOs are not the array mode's")
        log(f"   {fam.__name__} {route}: {MODE_VB_ITERS} VB iterations with in-kernel features, "
            f"ELBO {e[-1].item():.6e}, the array mode's bit for bit")
    require(same_bits(picked, svi_steps(False)),
            "(main path) SVI with the gamma pick is not the gather's, bit for bit")
    log(f"   {MODE_SVI_STEPS} SVI steps at B={B} with the gamma pick: the gather's parameters "
        "bit for bit")
    return counts, setup_s


def mode_launchers() -> dict:
    from pysvihmm_tpu_torch.messages import duplex_fb as df
    from pysvihmm_tpu_torch.messages import fused_fb as ff

    return {"fused_fwd_kernel": ff.fused_forward, "fused_bwd_kernel": ff.fused_backward,
            "duplex_chain_kernel": df.duplex_chain, "duplex_combine_kernel": df.duplex_combine}


def bf16_probe(dev) -> str:
    """Phase 14 (c): config 4's windowed-SVI probe with bf16 alpha (K = 64,
    D = 8, one chain of SVI_T steps, B = 1024, L, b as phase 6): every
    parameter finite and every NIW psi factorisable after each of
    BF16_PROBE_STEPS steps, and the Hamming error of the final posterior's
    decode beside the float32 run's. Returns a summary line."""
    import torch

    from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu_torch.distributions import GaussianNIW
    from pysvihmm_tpu_torch.engines import svi
    from pysvihmm_tpu_torch.engines.base import decode
    from pysvihmm_tpu_torch.eval.metrics import hamming_error
    from pysvihmm_tpu_torch.models.hmm import init_params, make_prior

    g = torch.Generator(device=dev).manual_seed(44)
    obs, z, _ = gen_gaussian_dataset(g, K, MODE_D, 1, SVI_T)
    chain = obs[0]
    prior = make_prior(K, GaussianNIW, obs_dim=MODE_D, device=dev)
    p0 = init_params(g, prior, GaussianNIW, chain)
    cfg = svi.SVIConfig(batch_size=B, subchain_len=SVI_L, buffer=SVI_BUF)
    hams = {}
    for bf16 in (True, False):
        step = svi.make_step(GaussianNIW, cfg, SVI_T, "fused", bf16_alpha=bf16)
        state = svi.init_state(p0, torch.Generator(device=dev).manual_seed(45))
        for i in range(BF16_PROBE_STEPS):
            state, m = step(state, prior, chain)
            require(bool(torch.isfinite(m["noisy_elbo"])), f"(c) probe step {i}: noisy ELBO")
            require_sane_params(state.params, f"(c) probe step {i} bf16={bf16}")
        torch.cuda.synchronize()
        hams[bf16] = hamming_error(decode(state.params, GaussianNIW, chain[None]), z, K)
    line = (f"config-4 probe, {BF16_PROBE_STEPS} windowed SVI steps at K={K}, D={MODE_D}, "
            f"T={SVI_T}, B={B}: finite and factorisable after every step; Hamming bf16 alpha "
            f"{hams[True]:.4f}, float32 {hams[False]:.4f}")
    log(f"  {line}")
    return line


def time_modes(dev) -> tuple[dict, dict, dict, list[str]]:
    """Phase 14 (d): by CUDA events, the median of MODE_REPS means of
    MODE_ITERS calls, at (B, T, K, D) = (1024, 1000, 64, 8): each mode's
    kernels, their plain twins and their bounds; bench.py's E-step on
    "fused" and "duplex", array against in-kernel features at K = 64, 128,
    256; the SVI step at SVI_BATCHES with and without the gamma pick; the
    fused pair with float32 and bf16 alpha. Returns (ms, plain_ms, bounds)
    by row of MODE_ROWS (and the array mode's kernels) and the log lines."""
    import torch

    from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu_torch.distributions import GaussianNIW
    from pysvihmm_tpu_torch.distributions.niw import NIW
    from pysvihmm_tpu_torch.engines import svi
    from pysvihmm_tpu_torch.engines.base import batch_local_step
    from pysvihmm_tpu_torch.messages import duplex_fb as df
    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.messages.split_fb import exp_params
    from pysvihmm_tpu_torch.models.hmm import HMMParams, init_params, make_prior
    from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms
    from pysvihmm_tpu_torch.utils.roofline import bound, kernel_work

    ms, plain_ms, bounds, lines = {}, {}, {}, []
    gen = torch.Generator(device=dev).manual_seed(46)
    for kind in (None, *MODE_KINDS):
        log_pi, log_A, W, obs = mode_problem(gen, B, T, K, MODE_D, kind or "niw")
        F_ = W.shape[0]
        src = obs if kind else ff.build_features(obs, "niw")
        Dk = MODE_D if kind else 0
        pi_t, A_t = exp_params(log_pi, log_A)
        fwd = ff.fused_forward(pi_t, A_t, W, src, kind)
        chain = df.duplex_chain(pi_t, A_t, W, src, kind)
        a_c, _, sh_c, b_c = chain
        runs = {
            "fused_fwd_kernel": (lambda: ff.fused_forward(pi_t, A_t, W, src, kind),
                                 lambda: ff.forward_reference(pi_t, A_t, W, src, kind), {}),
            "fused_bwd_kernel": (lambda: ff.fused_backward(A_t, W, src, *fwd, False, None, kind),
                                 lambda: ff.backward_reference(A_t, W, src, *fwd, False, None,
                                                               kind), {}),
            "duplex_chain_kernel": (lambda: df.duplex_chain(pi_t, A_t, W, src, kind),
                                    lambda: df.duplex_chain_reference(pi_t, A_t, W, src, kind),
                                    {}),
            "duplex_combine_kernel": (
                lambda: df.duplex_combine(W, src, a_c, b_c, sh_c, False, None, kind),
                lambda: df.duplex_combine_reference(W, src, a_c, b_c, sh_c, False, None, kind),
                {}),
        }
        if kind == "niw":
            a16 = ff.fused_forward(pi_t, A_t, W, src, kind, torch.bfloat16)
            runs["fused_fwd_kernel<bf16 alpha>"] = (
                lambda: ff.fused_forward(pi_t, A_t, W, src, kind, torch.bfloat16),
                lambda: ff.forward_reference(pi_t, A_t, W, src, kind, torch.bfloat16),
                {"bf16_alpha": True})
            runs["fused_bwd_kernel<bf16 alpha>"] = (
                lambda: ff.fused_backward(A_t, W, src, *a16, False, None, kind),
                lambda: ff.backward_reference(A_t, W, src, *a16, False, None, kind),
                {"bf16_alpha": True})
        for name, (kernel, twin, kw) in runs.items():
            row = name if "<" in name else (f"{name}<{kind}>" if kind else name)
            base = name.split("<")[0]
            ms[row] = median_ms(kernel)
            plain_ms[row] = cuda_ms(twin, 1, warmup=1)
            bounds[row] = bound(*kernel_work(base, B, T, K, F_, D=Dk, **kw))
            lines.append(f"{row} at (B, T, K, F) = ({B}, {T}, {K}, {F_}): {ms[row]:.4f} ms, "
                         f"twin {plain_ms[row]:.2f} ms, bound {bounds[row][0]:.4f} ms "
                         f"({bounds[row][1]})")
            log(f"  {lines[-1]}")
        del fwd, chain, a_c, b_c, sh_c
        torch.cuda.empty_cache()

    # the gamma pick at the SVI shape: the gated backward, W = 70, K = 64
    log_pi, log_A, W, obs = mode_problem(gen, B, SVI_W, K, MODE_D, "niw")
    feats = ff.build_features(obs, "niw")
    offs = torch.randint(0, SVI_W - SVI_L + 1, (B,), generator=gen, device=dev)
    tt = torch.arange(SVI_W, device=dev)[:, None]
    w = ((tt >= offs) & (tt < offs + SVI_L)).to(torch.float32).contiguous()
    pi_t, A_t = exp_params(log_pi, log_A)
    fwd = ff.fused_forward(pi_t, A_t, W, feats)
    rows = torch.arange(B, device=dev)
    row = "fused_bwd_kernel<gamma_sel>"
    ms[row] = median_ms(lambda: ff.fused_backward(A_t, W, feats, *fwd, False, w, gamma_sel=offs))
    gather_ms = median_ms(lambda: ff.fused_backward(A_t, W, feats, *fwd, True, w)[0][offs, rows])
    plain_ms[row] = cuda_ms(lambda: ff.backward_reference(A_t, W, feats, *fwd, False, w,
                                                          gamma_sel=offs), 1, warmup=1)
    bounds[row] = bound(*kernel_work("fused_bwd_kernel", B, SVI_W, K, W.shape[0], gated=True))
    lines.append(f"{row} at the SVI shape (B, W, K, F) = ({B}, {SVI_W}, {K}, {W.shape[0]}), "
                 f"gated: {ms[row]:.4f} ms against emit_gamma and the gather {gather_ms:.4f} ms; "
                 f"twin {plain_ms[row]:.2f} ms, bound {bounds[row][0]:.4f} ms ({bounds[row][1]})")
    log(f"  {lines[-1]}")

    carry = torch.zeros((), device=dev)
    for K_ in (K, *LARGE_K):
        g = torch.Generator(device=dev).manual_seed(47)
        obs = gen_gaussian_dataset(g, K_, MODE_D, B, T)[0]
        prior = make_prior(K_, GaussianNIW, obs_dim=MODE_D, device=dev)
        params = init_params(g, prior, GaussianNIW, obs)

        def estep(route, ik, bf16=False):
            # bench.py:62-84: perturb every parameter group, consume every stat
            nonlocal carry
            eps = carry * 1e-30
            p = HMMParams(init=params.init + eps, trans=params.trans + eps,
                          emit=NIW(*(x + eps for x in params.emit)))
            stats, _ = batch_local_step(p, GaussianNIW, obs, route, need_gamma=False,
                                        in_kernel_feats=ik, bf16_alpha=bf16)
            tot = stats.log_z + stats.trans.sum() + stats.init.sum()
            tot = tot + sum(x.sum() for x in stats.emit)
            carry = tot * 0.0 + carry
            return tot

        parts = []
        for route in ("fused", "duplex"):
            for ik in (False, True):
                t_ms = median_ms(lambda: estep(route, ik))
                parts.append(f"{route} {'in-kernel' if ik else 'array'} {t_ms:.3f} ms")
                ms[f"estep {route} {'in-kernel' if ik else 'array'} K={K_}"] = t_ms
        if K_ == K:
            t_ms = median_ms(lambda: estep("fused", True, True))
            parts.append(f"fused in-kernel, bf16 alpha {t_ms:.3f} ms")
        lines.append(f"bench.py's E-step at (B, T, K, D) = ({B}, {T}, {K_}, {MODE_D}), "
                     "need_gamma=False, features (array) or observations (in-kernel) prepared "
                     "per call: " + "; ".join(parts))
        log(f"  {lines[-1]}")
        del obs, params
        torch.cuda.empty_cache()

    g = torch.Generator(device=dev).manual_seed(48)
    chain = gen_gaussian_dataset(g, K, MODE_D, 1, SVI_T, mean_scale=0.5, cov_scale=1.0)[0][0]
    prior = make_prior(K, GaussianNIW, obs_dim=MODE_D, device=dev)
    p0 = init_params(g, prior, GaussianNIW, chain)
    for Bs in SVI_BATCHES:
        cfg = svi.SVIConfig(batch_size=Bs, subchain_len=SVI_L, buffer=SVI_BUF)
        parts = []
        for pick in (False, True):
            step = svi.make_step(GaussianNIW, cfg, SVI_T, "fused", gamma_sel=pick)
            state = [svi.init_state(p0, torch.Generator(device=dev).manual_seed(49))]

            def one():
                state[0] = step(state[0], prior, chain)[0]

            t_ms = median_ms(one)
            ms[f"svi B={Bs} gamma_sel={pick}"] = t_ms
            parts.append(f"{'gamma_sel' if pick else 'gather'} {t_ms:.3f} ms")
        lines.append(f"SVI step on fused at B={Bs}, L={SVI_L}, b={SVI_BUF}: " + "; ".join(parts))
        log(f"  {lines[-1]}")
    f32 = ms["fused_fwd_kernel<niw>"] + ms["fused_bwd_kernel<niw>"]
    b16 = ms["fused_fwd_kernel<bf16 alpha>"] + ms["fused_bwd_kernel<bf16 alpha>"]
    lines.append(f"the fused pair with in-kernel NIW features at (B, T, K, D) = ({B}, {T}, {K}, "
                 f"{MODE_D}): float32 alpha {f32:.4f} ms, bf16 alpha {b16:.4f} ms")
    log(f"  {lines[-1]}")
    return ms, plain_ms, bounds, lines


# the kernels line's rows of the large-K statistics' operand kernels in the
# modes: (kernel, replaces)
OPERAND_ROWS = (("build_feats_kernel", "pallas_fb.py:287"), ("widen_kernel", "pallas_fb.py:656"))


def operand_kernels(dev) -> tuple[dict, list[str]]:
    """Phase 14 (d): the large-K statistics' two operand kernels at the
    shapes the main path's K = MODE_WIDE_K SVI step gives them (one window:
    B = 1024 windows of W = SVI_W steps): build_feats_kernel over the W B
    observation rows of D = MODE_D for both kinds, widen_kernel over the
    (W - 1) B rows of K bf16 alphas (acc's rows t >= 1). Each output is its
    twin's bit for bit; timed by CUDA events (NIW for the build) beside the
    twin and, for the widening, the one PyTorch call that computes it
    (``.to(torch.float32)``, which is also its twin). Returns the kernels
    line's numbers by kernel and the log lines."""
    import torch

    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.utils.roofline import bound, kernel_work

    gen = torch.Generator(device=dev).manual_seed(53)
    rows, a_rows = SVI_W * B, (SVI_W - 1) * B
    obs = torch.randn((rows, MODE_D), generator=gen, device=dev)
    a16 = torch.rand((a_rows, MODE_WIDE_K), generator=gen, device=dev).to(torch.bfloat16)
    errs = {}
    for kind in MODE_KINDS:
        got, ref = ff.feature_rows(obs, kind), ff.build_features(obs, kind)
        require_same(f"(d) build_feats_kernel {kind}", (got,), (ref,))
        errs[kind] = (got - ref).abs().max().item()
    wide = ff.widen_alpha(a16)
    require_same("(d) widen_kernel", (wide,), (a16.to(torch.float32),))
    F_ = ff.feature_width("niw", MODE_D)
    build = {"ms": median_ms(lambda: ff.feature_rows(obs, "niw")),
             "plain_ms": median_ms(lambda: ff.build_features(obs, "niw")), "library_ms": None,
             "max_abs_err": max(errs.values())}
    build["bound_ms"], build["bound_by"] = bound(*kernel_work("build_feats_kernel", rows, 1, 0,
                                                              F_, D=MODE_D))
    lib_ms = median_ms(lambda: a16.to(torch.float32))
    widen = {"ms": median_ms(lambda: ff.widen_alpha(a16)), "plain_ms": lib_ms,
             "library_ms": lib_ms, "max_abs_err": (wide - a16.to(torch.float32)).abs().max().item()}
    widen["bound_ms"], widen["bound_by"] = bound(*kernel_work("widen_kernel", a_rows, 1,
                                                              MODE_WIDE_K))
    lines = [f"build_feats_kernel over one window's {rows} rows (NIW, D = {MODE_D} -> F = {F_}; "
             f"both kinds the twin's bits): {build['ms']:.4f} ms, twin {build['plain_ms']:.4f} "
             f"ms, bound {build['bound_ms']:.4f} ms ({build['bound_by']})",
             f"widen_kernel over one window's {a_rows} x {MODE_WIDE_K} bf16 alphas (the twin's "
             f"bits): {widen['ms']:.4f} ms, .to(torch.float32) {lib_ms:.4f} ms, bound "
             f"{widen['bound_ms']:.4f} ms ({widen['bound_by']})"]
    for line in lines:
        log(f"  {line}")
    return {"build_feats_kernel": build, "widen_kernel": widen}, lines


def kernel_modes_phase(dev) -> tuple[list[dict], list[str]]:
    """Phase 14: the fused kernels' three modes -- in-kernel NIW and NIG
    features on the fused pair and the duplex kernels, the fused backward's
    in-kernel gamma pick and bf16-stored alpha -- against the array mode,
    the emit-gamma run and float32 bit for bit and against their twins
    ((a)-(c)), the main path run in the modes, config 4's probe with bf16
    alpha, and their times (d). Returns the kernels line's rows of the modes
    and the timing lines."""
    t_phase = time.perf_counter()
    import torch

    gen = torch.Generator(device=dev).manual_seed(50)
    errs = {}
    log(f"  (a) in-kernel features, K in {MODE_KS}, B in {MODE_BS}, T = {T} ({mode_T(256)} at "
        f"K = 256): every built S, gated and not, emit_gamma both ways, bit for bit against "
        "the array mode; the default S against the twins")
    for kind in MODE_KINDS:
        for K_ in MODE_KS:
            for B_ in MODE_BS:
                e = check_mode_features(gen, kind, K_, B_, mode_T(K_))
                if (K_, B_) == (K, B):
                    errs[kind] = e
    log(f"  (a) took {time.perf_counter() - t_phase:.1f} s")
    log(f"  (b) the gamma pick: the gated fused backward at W={SVI_W}, B in {SEL_BS}, K in "
        f"{SEL_KS}")
    sel_err = 0.0
    for K_ in SEL_KS:
        for B_ in SEL_BS:
            e = check_gamma_sel(gen, B_, K_)
            sel_err = e if (K_, B_) == (K, B) else sel_err
    log(f"  (c) bf16 alpha at (B, T) = ({B}, {T}), K = {K} and 128")
    bf16_err = check_bf16_alpha(gen, B, T, K)
    check_bf16_alpha(gen, B, mode_T(128), 128)
    bf16_probe(dev)
    log(f"  (a)-(c) took {time.perf_counter() - t_phase:.1f} s")
    counts, setup_s = modes_main_path(dev)
    log(f"  the main path took {time.perf_counter() - t_phase:.1f} s ({setup_s:.1f} s of it the "
        "data on the card)")
    ms, plain_ms, bounds, lines = time_modes(dev)
    operands, operand_lines = operand_kernels(dev)
    lines += operand_lines
    max_err = {"fused_fwd_kernel<niw>": errs["niw"]["fwd"],
               "fused_bwd_kernel<niw>": errs["niw"]["bwd"],
               "fused_fwd_kernel<nig>": errs["nig"]["fwd"],
               "fused_bwd_kernel<nig>": errs["nig"]["bwd"],
               "fused_bwd_kernel<gamma_sel>": sel_err,
               "fused_fwd_kernel<bf16 alpha>": bf16_err["fwd"],
               "fused_bwd_kernel<bf16 alpha>": bf16_err["bwd"],
               "duplex_chain_kernel<niw>": errs["niw"]["chain"],
               "duplex_combine_kernel<niw>": errs["niw"]["combine"],
               "duplex_chain_kernel<nig>": errs["nig"]["chain"],
               "duplex_combine_kernel<nig>": errs["nig"]["combine"]}
    rows = []
    for row, kernel, mode, src, replaces in MODE_ROWS:
        n = counts.get((kernel, mode), 0)
        require(n > 0, f"phase 14: {row} was not launched on the main path")
        rows.append({"name": row, "route": "cuda", "source": f"pysvihmm_tpu_torch/csrc/{src}",
                     "replaces": f"pysvihmm_tpu/messages/{replaces}", "launches": n,
                     "max_abs_err": max_err[row], "ms": ms[row], "plain_ms": plain_ms[row],
                     "bound_ms": bounds[row][0], "bound_by": bounds[row][1],
                     "library_ms": None})
    for kernel, replaces in OPERAND_ROWS:
        n = counts.get(kernel, 0)
        require(n > 0, f"phase 14: {kernel} was not launched on the main path")
        rows.append({"name": kernel, "route": "cuda",
                     "source": "pysvihmm_tpu_torch/csrc/fb_stats.cuh",
                     "replaces": f"pysvihmm_tpu/messages/{replaces}", "launches": n,
                     **operands[kernel]})
    log(f"  phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return rows, lines


# ---------------------------------------------------------------- phase 15
# The fused pair at every feature width (the WF instances, F > 64), the
# split pair's bf16 alpha. The widths: (kind, D or V) -> F = 65 (NIG D = 32),
# 66 (NIW D = 10), 100 (one-hot V = 100), 153 (NIW D = 16), 256 (one-hot V =
# 256), 300 (NIW D = 23), 820 (NIW D = 39, full-covariance 39-dim MFCCs: up
# to K = 64 W^T no longer fits shared memory, and its last groups come from
# L2).
WF_CASES = (("nig", 32), ("niw", 10), ("onehot", 100), ("niw", 16), ("onehot", 256),
            ("niw", 23), ("niw", 39))
WF_KS = (4, 64, 128, 256)
WF_BS = (1, 3, 1024)
WF_T = 150  # B = 1024 cuts it into two windows of the statistics (128 and 22 steps)


def wf_problem(gen, B_, T_, K_, kind, size):
    """E-step inputs at a width of WF_CASES from the seeded ``gen``: (log_pi,
    log_A, W (F, K), src, feats, in_kernel_feats). A built kind's src is the
    raw (T, B, D) observations (mode_problem) and feats their
    ``ell_features``; "onehot" is the (T, B, V) one-hot of symbols from
    sticky states (src = feats, no built kind) with W = E[log phi]^T of a
    Dirichlet posterior near the generating one."""
    import torch

    from pysvihmm_tpu_torch.data.synthetic import gen_multinomial_dataset
    from pysvihmm_tpu_torch.distributions import dirichlet
    from pysvihmm_tpu_torch.messages import fused_fb as ff

    if kind != "onehot":
        log_pi, log_A, W, obs = mode_problem(gen, B_, T_, K_, size, kind)
        return log_pi, log_A, W, obs, ff.build_features(obs, kind), kind
    dev = gen.device
    obs, _, truth = gen_multinomial_dataset(gen, K_, size, B_, T_)
    conc = 50.0 * truth.theta[0] + 0.5 + torch.rand((K_, size), generator=gen, device=dev)
    W = dirichlet.expected_log_probs(conc).T.to(torch.float32).contiguous()
    feats = torch.nn.functional.one_hot(obs.transpose(0, 1).long(), size)
    feats = feats.to(torch.float32).contiguous()

    def u(*shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    log_pi = dirichlet.expected_log_probs(u(K_, lo=1.0, hi=3.0))
    log_A = dirichlet.expected_log_probs(u(K_, K_, lo=1.0, hi=3.0)
                                         + 5.0 * torch.eye(K_, device=dev))
    return log_pi, log_A, W, feats, feats, None


def wf_seqs(K_, F_, ik, dev) -> list[int]:
    """The built S of the fused pair at (K, F) whose forward and backward
    (gated and not, default and modes' instances) the card holds a block of:
    the WF instances' shared memory grows with F."""
    from pysvihmm_tpu_torch.messages import fused_fb as ff

    return [S for S in ff.built_seqs(K_)
            if all(ff.kernel_info(k, S, F_, dev, K=K_, in_kernel_feats=ik,
                                  modes=m)["blocks_per_sm"] > 0
                   for k in ("forward", "backward", "gated backward") for m in (False, True))]


def check_wide_f(gen, K_, kind, size, B_, T_=WF_T, twins: bool = True) -> dict[str, float]:
    """Phase 15 (a) at one shape: the fused pair's WF instances at every S
    that fits. Bit for bit: alpha, s and sh the same at every S; gamma,
    gamma0 and eacc the same at every S (acc too above K = 64, where it is
    summed off the chain), gated and not, emit_gamma both ways, and acc and
    eacc the same over a second call; a built kind's outputs on the raw
    observations the array mode's; the pick (gated) emit_gamma's gamma at
    the offsets, acc and eacc unchanged; bf16 alpha float32's rounded, sh
    unchanged, the bf16 backward repeatable. With ``twins`` the default S
    against the plain twins run in float64 on the same inputs
    (tests/test_pallas.py's tolerances; bf16 alpha within 2^-8 of float64's
    alpha) and bf16's statistics and log Z within JAX's band of float32's. Returns the twins' max errors: the forward's log_c and the
    backward's gamma, each mode's too."""
    import torch

    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.messages.split_fb import exp_params

    dev = gen.device
    log_pi, log_A, W, src, feats, ik = wf_problem(gen, B_, T_, K_, kind, size)
    F_ = W.shape[0]
    pi_t, A_t = exp_params(log_pi, log_A)
    w = svi_masks(gen, B_, T_, max(1, (5 * T_) // 7))
    offs = torch.randint(0, T_, (B_,), generator=gen, device=dev)
    rows = torch.arange(B_, device=dev)
    seqs = wf_seqs(K_, F_, ik, dev)
    require(len(seqs) > 0, f"(a) K={K_} F={F_}: no S fits the card")
    what = f"(a) {kind} F={F_} K={K_} B={B_}"
    first_fwd, first_bwd = None, {}
    for S in seqs:
        fwd = ff._launch_forward(S, pi_t, A_t, W, feats)
        if first_fwd is None:
            first_fwd = fwd
        require_same(f"{what} forward S={S} vs S={seqs[0]}", fwd, first_fwd)
        if ik:
            require_same(f"{what} in-kernel forward S={S}",
                         ff._launch_forward(S, pi_t, A_t, W, src, ik), fwd)
        outs = {}
        for wg in (None, w):
            for emit in (True, False):
                key = (wg is not None, emit)
                out = ff._launch_backward(S, A_t, W, feats, *fwd, emit, wg)
                outs[key] = out
                tag = f"{what} backward S={S} gated={key[0]} emit_gamma={emit}"
                require_same(f"{tag}: a second call", out,
                             ff._launch_backward(S, A_t, W, feats, *fwd, emit, wg))
                if ik:
                    require_same(f"{tag} in-kernel", out,
                                 ff._launch_backward(S, A_t, W, src, *fwd, emit, wg, ik))
                ref = first_bwd.setdefault(key, out)
                same = (0, 1, 2, 3) if K_ > 64 else (0, 1, 3)
                require_same(f"{tag} vs S={seqs[0]}", [out[i] for i in same],
                             [ref[i] for i in same])
        picked = ff._launch_backward(S, A_t, W, src, *fwd, False, w, ik, offs)
        full = outs[True, True]
        require(picked[0] is None and torch.equal(picked[1], full[0][offs, rows]),
                f"{what} S={S}: the pick is not emit_gamma's gamma at the offsets")
        require_same(f"{what} S={S}: acc and eacc with the pick", picked[2:],
                     outs[True, False][2:])
        fwd16 = ff._launch_forward(S, pi_t, A_t, W, src, ik, torch.bfloat16)
        require(fwd16[0].dtype == torch.bfloat16 and torch.equal(fwd16[0],
                                                                 fwd[0].to(torch.bfloat16)),
                f"{what} S={S}: bf16 alpha is not float32's rounded")
        require(torch.equal(fwd16[2], fwd[2]), f"{what} S={S}: sh differs with bf16 alpha")
        b16 = ff._launch_backward(S, A_t, W, src, *fwd16, False, w, ik)
        require_same(f"{what} S={S}: the bf16 backward, a second call", b16,
                     ff._launch_backward(S, A_t, W, src, *fwd16, False, w, ik))
    torch.cuda.synchronize()
    errs = {}
    if not twins:
        return errs
    log(f"   {what} T={T_}: S in {seqs} bit for bit; the default S against the twins")
    alpha, s, sh = ff.fused_forward(pi_t, A_t, W, src, ik)
    a_r, s_r, sh_r = ff.forward_reference(pi_t, A_t, W, src, ik)
    # the twins run in float64 on the same inputs (a built kind's float32
    # feature rows, which the kernels form bit for bit): at F = 820 the
    # float32 twin's own f @ W errs by as much as alpha's tolerance
    d = lambda *xs: [None if x is None else x.double() for x in xs]  # noqa: E731
    a_o, s_o, sh_o = ff.forward_reference(*d(pi_t, A_t, W, feats))
    compare("alpha", alpha, a_o, 0.0, 5e-5)
    errs["fwd"] = compare("log_c", torch.log(s) + sh, torch.log(s_o) + sh_o, 2e-6, 1e-4)
    for wg in (None, w):
        got = ff.fused_backward(A_t, W, src, a_r, s_r, sh_r, True, wg, ik)
        ref = ff.backward_reference(*d(A_t, W, feats, a_r, s_r, sh_r), True, *d(wg))
        for name, x, r, rtol, atol in zip(("gamma", "gamma0", "acc", "eacc"), got, ref,
                                          (0.0, 0.0, 1e-4, 3e-3), (5e-5, 5e-5, 1e-3, 2e-3)):
            e = compare(f"{name} gated={wg is not None}", x, r, rtol, atol)
            if name == "gamma":
                errs["bwd"] = max(errs.get("bwd", 0.0), e)
    got = ff.fused_backward(A_t, W, src, a_r, s_r, sh_r, False, w, ik, offs)
    ref = ff.backward_reference(*d(A_t, W, feats, a_r, s_r, sh_r), False, *d(w), None, offs)
    errs["pick"] = compare("the pick", got[1], ref[1], 0.0, 5e-5)
    a16, s16, sh16 = ff.fused_forward(pi_t, A_t, W, src, ik, torch.bfloat16)
    # float32's alpha rounded (bit for bit above): within half a bf16 ulp, at
    # most 2^-8 of its value, of that alpha, itself within 5e-5 of float64's
    errs["bf16 fwd"] = compare("bf16 alpha", a16.float(), a_o, 2.0 ** -8, 5e-5)
    compare("s: the sum of the rounded alpha", s16, a16.float().sum(-1).T, 1e-6, 0.0)
    got = ff.fused_backward(A_t, W, src, a16, s16, sh16, True, None, ik)
    ref = ff.backward_reference(*d(A_t, W, feats, a16, s16, sh16), True, None)
    errs["bf16 bwd"] = compare("bf16 gamma", got[0], ref[0], 0.0, 5e-5)
    bf, bS = ff.estep_fused(log_pi, log_A, W, src, in_kernel_feats=ik, alpha_dtype=torch.bfloat16)
    f32, fS = ff.estep_fused(log_pi, log_A, W, src, in_kernel_feats=ik)
    rel_z = abs(bf.log_z.double().sum().item() - f32.log_z.double().sum().item()) / abs(
        f32.log_z.double().sum().item())
    rel_s = ((bS - fS).abs().max() / fS.abs().max()).item()
    rel_t = ((bf.trans_stats - f32.trans_stats).abs().max() / f32.trans_stats.abs().max()).item()
    log(f"    bf16 against float32: log Z {rel_z:.3e}, emit {rel_s:.3e}, trans {rel_t:.3e} "
        "relative (JAX's band: log Z < 1e-3, the statistics < 2e-2)")
    require(rel_z < 1e-3 and rel_s < 2e-2 and rel_t < 2e-2, f"{what}: bf16 outside the band")
    return errs


SPLIT_BF16_KS = (64, 128, 256)


def check_split_bf16(gen, K_, B_, T_) -> dict[str, float]:
    """Phase 15 (b) at one shape: the split pair with bf16 alpha at every
    built S, gated and not. Bit for bit: the stored alpha float32's rounded,
    sh float32's, s, gamma and acc the same at every S and over a second
    call. Against the bf16 twins (the default S): alpha within one bf16 ulp,
    s the sum of the rounded values, gamma and acc at the float32 twins'
    tolerances; log Z and trans within JAX's band of float32's. Returns the
    forward's alpha and the backward's gamma errors."""
    import torch

    from pysvihmm_tpu_torch.messages import split_fb as sf
    from pysvihmm_tpu_torch.messages.split_fb import exp_params

    log_pi, log_A, W, feats = random_problem(gen, B_, T_, K_, D)
    ll = (feats @ W).contiguous()
    pi_t, A_t = exp_params(log_pi, log_A)
    w = svi_masks(gen, B_, T_, max(1, (5 * T_) // 7))
    what = f"(b) split K={K_} B={B_} T={T_}"
    first = {}
    for S in sf.built_seqs("forward", K_):
        a32, s32, sh32 = sf.split_forward(pi_t, A_t, ll, S)
        a16, s16, sh16 = sf.split_forward(pi_t, A_t, ll, S, torch.bfloat16)
        require(a16.dtype == torch.bfloat16 and torch.equal(a16, a32.to(torch.bfloat16)),
                f"{what} S={S}: bf16 alpha is not float32's rounded")
        require(torch.equal(sh16, sh32), f"{what} S={S}: sh differs")
        require_same(f"{what} forward S={S}", (a16, s16),
                     first.setdefault("fwd", (a16, s16)))
    for wg in (None, w):
        kind = "backward" if wg is None else "gated backward"
        for S in sf.built_seqs(kind, K_):
            out = sf.split_backward(A_t, ll, a16, s16, sh16, wg, S)
            require_same(f"{what} {kind} S={S}: a second call", out,
                         sf.split_backward(A_t, ll, a16, s16, sh16, wg, S))
            require_same(f"{what} {kind} S={S}", out, first.setdefault(kind, out))
    torch.cuda.synchronize()
    log(f"   {what}: every S bit for bit; against the bf16 twins")
    a_r, s_r, sh_r = sf.split_forward_reference(pi_t, A_t, ll, torch.bfloat16)
    errs = {"fwd": compare("bf16 alpha", a16.float(), a_r.float(), 2.0 ** -8, 5e-5)}
    compare("s: the sum of the rounded alpha", s16, a16.float().sum(-1).T, 1e-6, 0.0)
    g, acc = sf.split_backward(A_t, ll, a16, s16, sh16, w)
    g_r, acc_r = sf.split_backward_reference(A_t, ll, a16, s16, sh16, w)
    errs["bwd"] = compare("bf16 gamma", g, g_r, 0.0, 5e-5)
    compare("bf16 acc", acc, acc_r, 1e-4, 1e-3)
    bf = sf.estep_split(log_pi, log_A, ll, w, torch.bfloat16)
    f32 = sf.estep_split(log_pi, log_A, ll, w)
    rel_z = abs(bf.log_z.double().sum().item() - f32.log_z.double().sum().item()) / abs(
        f32.log_z.double().sum().item())
    rel_t = ((bf.trans_stats - f32.trans_stats).abs().max() / f32.trans_stats.abs().max()).item()
    log(f"    bf16 against float32: log Z {rel_z:.3e}, trans {rel_t:.3e} relative")
    require(rel_z < 1e-3 and rel_t < 2e-2, f"{what}: bf16 outside JAX's band")
    return errs


def check_split_exact(gen, dev) -> None:
    """Phase 15 (b): ``exact=True`` with ``bf16_alpha=True`` on the split
    route (and on "fused" at V > 256, the split pair) gives float32's bits
    (log Z, trans and init; the multinomial's emission counts, a
    segment-sum by ``index_add_`` whose float atomics add in no fixed order,
    to 1e-6 of the largest: two float32 runs, whose gamma is the same bits,
    differ there too, and the log shows by how much) and launches no bf16
    instance; without ``exact`` the bf16 instances run."""
    import torch

    from pysvihmm_tpu_torch.data.synthetic import gen_gaussian_dataset, gen_multinomial_dataset
    from pysvihmm_tpu_torch.distributions import GaussianNIW, MultinomialDirichlet
    from pysvihmm_tpu_torch.engines.base import batch_local_step
    from pysvihmm_tpu_torch.messages import split_fb as sf
    from pysvihmm_tpu_torch.models.hmm import init_params, make_prior

    y = gen_gaussian_dataset(gen, K, D, 64, 100, mean_scale=0.5, cov_scale=1.0)[0]
    prior = make_prior(K, GaussianNIW, obs_dim=D, device=dev)
    p = init_params(gen, prior, GaussianNIW, y)
    sym = gen_multinomial_dataset(gen, 32, 300, 64, 100)[0]
    prior_m = make_prior(32, MultinomialDirichlet, num_symbols=300, device=dev)
    p_m = init_params(gen, prior_m, MultinomialDirichlet, sym)
    for route, fam, pp, data in (("split", GaussianNIW, p, y),
                                 ("fused", MultinomialDirichlet, p_m, sym)):
        sf.reset_launch_counts()
        ex = batch_local_step(pp, fam, data, route, need_gamma=False, exact=True,
                              bf16_alpha=True)[0]
        ref = batch_local_step(pp, fam, data, route, need_gamma=False)[0]
        chain = (ex.log_z, ex.trans, ex.init), (ref.log_z, ref.trans, ref.init)
        require(same_bits(*chain), f"(b) exact=True on {route} ({fam.__name__}) is not "
                "float32's bits")
        if fam is GaussianNIW:
            require(same_bits(ex.emit, ref.emit), f"(b) exact=True on {route}: emit differs")
        else:
            again = batch_local_step(pp, fam, data, route, need_gamma=False)[0]
            require(same_bits((again.log_z, again.trans, again.init), chain[1]),
                    "(b) float32 on fused at V = 300 does not repeat its chain's bits")
            rel = [((x.emit - ref.emit).abs().max() / ref.emit.abs().max()).item()
                   for x in (again, ex)]
            log(f"   emission counts at V = 300, relative to float32's: a second float32 run "
                f"{rel[0]:.3e} ({'the same' if same_bits(again.emit, ref.emit) else 'not the same'}"
                f" bits), exact=True with bf16_alpha {rel[1]:.3e}")
            compare("exact=True: emission counts", ex.emit, ref.emit, 1e-6, 0.0)
        require(sf.split_forward.bf16_launches == 0, f"(b) exact=True on {route} stored bf16")
        bf = batch_local_step(pp, fam, data, route, need_gamma=False, bf16_alpha=True)[0]
        torch.cuda.synchronize()
        require(sf.split_forward.bf16_launches == 1 and sf.split_backward.bf16_launches == 1,
                f"(b) bf16_alpha on {route} ({fam.__name__}) did not run the bf16 split pair")
        require(not same_bits(bf, ref), f"(b) bf16_alpha on {route} changed nothing")
    log("   exact=True with bf16_alpha on split and on fused at V = 300: float32's bits")


# the timed shapes of phase 15 (d), at B = 1024, T = 1000: (K, kind, D or V);
# F = 66, 100, 153, 256, 300, 820 at K = 64, 66 and 256 at K = 128 and 256
WF_TIMED = ((64, "niw", 10), (64, "onehot", 100), (64, "niw", 16), (64, "onehot", 256),
            (64, "niw", 23), (64, "niw", 39), (128, "niw", 10), (128, "onehot", 256),
            (256, "niw", 10), (256, "onehot", 256))
WF_INKERNEL_D = (10, 16, 23)  # the in-kernel NIW timed (F = 66, 153, 300)
WF_V, WF_BIG_V = 100, 1000  # the multinomials of the main path: the fused pair, the split pair
WF_SVI_STEPS = 5  # windowed SVI steps a variant on the main path
# the kernels line's rows of phase 15: (row, launcher, tier, mode, source, replaces)
WF_ROWS = (
    ("fused_fwd_wf_kernel", "fused_fwd_kernel", 64, None, "fused_fb_wide.cu", "pallas_fb.py:516"),
    ("fused_bwd_wf_kernel", "fused_bwd_kernel", 64, None, "fused_fb_wide.cu", "pallas_fb.py:577"),
    ("fused_fwd_wide_wf_kernel<KP=256>", "fused_fwd_kernel", 256, None, "fused_fb_wide.cu",
     "pallas_fb.py:516"),
    ("fused_bwd_wide_wf_kernel<KP=256>", "fused_bwd_kernel", 256, None, "fused_fb_wide.cu",
     "pallas_fb.py:577"),
    ("fused_fwd_wf_kernel<niw>", "fused_fwd_kernel", 64, "niw", "fused_fb_wide.cu",
     "pallas_fb.py:516"),
    ("fused_bwd_wf_kernel<niw>", "fused_bwd_kernel", 64, "niw", "fused_fb_wide.cu",
     "pallas_fb.py:577"),
    ("fused_bwd_wf_kernel<gamma_sel>", "fused_bwd_kernel", 64, "gamma_sel",
     "fused_fb_wide_modes.cu", "pallas_fb.py:577"),
    ("fused_fwd_wf_kernel<bf16 alpha>", "fused_fwd_kernel", 64, "bf16", "fused_fb_wide_modes.cu",
     "pallas_fb.py:516"),
    ("fused_bwd_wf_kernel<bf16 alpha>", "fused_bwd_kernel", 64, "bf16", "fused_fb_wide_modes.cu",
     "pallas_fb.py:577"),
    ("split_fwd_kernel<bf16 alpha>", "split_fwd_kernel", 64, "bf16", "split_fb.cu",
     "pallas_fb.py:339"),
    ("split_bwd_kernel<bf16 alpha>", "split_bwd_kernel", 64, "bf16", "split_fb.cu",
     "pallas_fb.py:406"),
)


def wf_counts() -> dict:
    """Launches since the last reset: the fused pair's WF instances by (kernel,
    tier), their modes by (kernel, mode), the split pair's bf16 instances by
    (kernel, "bf16")."""
    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.messages import split_fb as sf

    counts = {}
    for name, fn in (("fused_fwd_kernel", ff.fused_forward),
                     ("fused_bwd_kernel", ff.fused_backward)):
        counts.update({(name, t): n for t, n in fn.wf_launches.items()})
        counts.update({(name, m): n for m, n in fn.wf_mode_launches.items()})
    counts["split_fwd_kernel", "bf16"] = sf.split_forward.bf16_launches
    counts["split_bwd_kernel", "bf16"] = sf.split_backward.bf16_launches
    return counts


def wf_main_path(dev) -> tuple[dict, float]:
    """Phase 15's main path on "auto" at full width, the counts set to 0
    just before and read just after: batch VB's E-step (batch_local_step,
    need_gamma=False) at B = 1024, T = 1000 for the Gaussian-NIW at D = 10
    (F = 66) at K = 64 and 256, with in-kernel features at K = 64, and the
    multinomial at V = WF_V (the fused pair) and WF_BIG_V with bf16 alpha
    (the split pair) at K = 64; windowed SVI on the V = WF_V multinomial at
    W = SVI_W, B = 1024, WF_SVI_STEPS steps gathering gamma and as many
    with the pick and bf16 alpha. Then each E-step against "scan" and every
    SVI parameter finite. Returns the launches (wf_counts) and the set-up
    seconds."""
    import torch

    from pysvihmm_tpu_torch.data import synthetic
    from pysvihmm_tpu_torch.distributions import GaussianNIW, MultinomialDirichlet
    from pysvihmm_tpu_torch.engines import svi
    from pysvihmm_tpu_torch.engines.base import batch_local_step
    from pysvihmm_tpu_torch.models.hmm import init_params, make_prior

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(60)
    cases = []
    for label, fam, size, K_, kw in (
        ("gaussian_niw D=10", GaussianNIW, 10, K, {}),
        ("gaussian_niw D=10", GaussianNIW, 10, 256, {}),
        ("gaussian_niw D=10, in-kernel", GaussianNIW, 10, K, {"in_kernel_feats": True}),
        (f"multinomial V={WF_V}", MultinomialDirichlet, WF_V, K, {}),
        (f"multinomial V={WF_BIG_V}, bf16 alpha", MultinomialDirichlet, WF_BIG_V, K,
         {"bf16_alpha": True}),
    ):
        if fam is GaussianNIW:
            obs = synthetic.gen_gaussian_dataset(gen, K_, size, B, T, mean_scale=0.5,
                                                 cov_scale=1.0)[0]
            prior = make_prior(K_, fam, obs_dim=size, device=dev)
        else:
            obs = synthetic.gen_multinomial_dataset(gen, K_, size, B, T)[0]
            prior = make_prior(K_, fam, num_symbols=size, device=dev)
        cases.append((f"{label}, K={K_}", fam, obs, init_params(gen, prior, fam, obs), kw))
    chain = synthetic.gen_multinomial_dataset(gen, K, WF_V, 1, SVI_T)[0][0]
    prior_c = make_prior(K, MultinomialDirichlet, num_symbols=WF_V, device=dev)
    p_c = init_params(gen, prior_c, MultinomialDirichlet, chain)
    cfg = svi.SVIConfig(batch_size=B, subchain_len=SVI_L, buffer=SVI_BUF)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    reset_kernel_counts()
    stats = [batch_local_step(p, fam, obs, "auto", need_gamma=False, **kw)[0]
             for _, fam, obs, p, kw in cases]
    finals = {}
    for modes in ({}, {"gamma_sel": True, "bf16_alpha": True}):
        step = svi.make_step(MultinomialDirichlet, cfg, SVI_T, "auto", **modes)
        state = svi.init_state(p_c, torch.Generator(device=dev).manual_seed(61))
        for _ in range(WF_SVI_STEPS):
            state, m = step(state, prior_c, chain)
        finals[bool(modes)] = (state, m)
    torch.cuda.synchronize()
    counts = wf_counts()
    log(f"  the main path: launches {counts}")
    for (label, fam, obs, p, kw), st in zip(cases, stats):
        ref = batch_local_step(p, fam, obs, "scan", need_gamma=False)[0]
        log(f"   {label} ({kw or 'plain'}): the E-step on auto against scan")
        if kw.get("bf16_alpha"):  # JAX's band of float32
            rel = abs(st.log_z.item() - ref.log_z.item()) / abs(ref.log_z.item())
            rel_t = ((st.trans - ref.trans).abs().max() / ref.trans.abs().max()).item()
            log(f"    bf16 alpha: log Z {rel:.3e}, trans {rel_t:.3e} relative to float32 scan")
            require(rel < 1e-3 and rel_t < 2e-2, f"{label}: bf16 alpha outside JAX's band")
        else:
            compare_local_stats(st, ref)
    for picked, (state, m) in finals.items():
        require(bool(torch.isfinite(m["noisy_elbo"])), "(main path) SVI: non-finite ELBO")
        require_sane_params(state.params, f"(main path) SVI V={WF_V} pick={picked}")
    log(f"   {WF_SVI_STEPS} SVI steps at V={WF_V}, W={SVI_W}, B={B} with and without the pick "
        "and bf16 alpha: every parameter finite")
    return counts, setup_s


def wf_time(dev) -> tuple[dict, list[str]]:
    """Phase 15 (d), by CUDA events (median_ms) at B = 1024, T = 1000: the
    fused pair's WF instances at every WF_TIMED shape, ungated and gated,
    beside their twins, their bounds and the split route's E-step on the
    same inputs (ll = feats @ W, the split pair, eacc as gamma^T feats);
    the in-kernel NIW at WF_INKERNEL_D; the pick at W = SVI_W against
    emit_gamma and the gather; bf16 alpha against float32 on the fused pair
    at F = 66 and the split pair at K = 64 and 256. Returns the rows' numbers
    (WF_ROWS) and the log lines."""
    import torch

    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.messages import split_fb as sf
    from pysvihmm_tpu_torch.messages.split_fb import exp_params
    from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms
    from pysvihmm_tpu_torch.utils.roofline import bound, kernel_work

    gen = torch.Generator(device=dev).manual_seed(62)
    rows, lines = {}, []

    def row(name, ms, plain, work):
        b_ms, b_by = bound(*work)
        rows[name] = {"ms": ms, "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by}
        return f"{ms:.4f} ms (twin {plain:.3f} ms, bound {b_ms:.4f} ms, {b_by})"

    def split_route(log_pi, log_A, W, feats, w=None, alpha_dtype=torch.float32):
        ll = torch.matmul(feats, W)
        fb = sf.estep_split(log_pi, log_A, ll, w, alpha_dtype)
        T_, B_, F_ = feats.shape
        return fb, fb.gamma.reshape(T_ * B_, -1).T @ feats.reshape(T_ * B_, F_)

    for K_, kind, size in WF_TIMED:
        log_pi, log_A, W, src, feats, ik = wf_problem(gen, B, T, K_, kind, size)
        F_ = W.shape[0]
        pi_t, A_t = exp_params(log_pi, log_A)
        w = svi_masks(gen, B, T, (5 * T) // 7)
        fwd = ff.fused_forward(pi_t, A_t, W, feats)
        t_f = median_ms(lambda: ff.fused_forward(pi_t, A_t, W, feats))
        t_b = median_ms(lambda: ff.fused_backward(A_t, W, feats, *fwd))
        t_g = median_ms(lambda: ff.fused_backward(A_t, W, feats, *fwd, False, w))
        p_f = cuda_ms(lambda: ff.forward_reference(pi_t, A_t, W, feats), 2, warmup=1)
        p_b = cuda_ms(lambda: ff.backward_reference(A_t, W, feats, *fwd), 2, warmup=1)
        e_fused = median_ms(lambda: ff.estep_fused(log_pi, log_A, W, feats))
        e_split = median_ms(lambda: split_route(log_pi, log_A, W, feats))
        S_f = ff.default_seqs("forward", B, F_, dev, K=K_)
        S_b = ff.default_seqs("backward", B, F_, dev, K=K_)
        tier = "" if K_ <= 64 else f"<KP={K_}>"
        name = "fused_{}_wf_kernel" if K_ <= 64 else "fused_{}_wide_wf_kernel"
        fr = row(name.format("fwd") + tier + f" F={F_}", t_f, p_f,
                 kernel_work("fused_fwd_kernel", B, T, K_, F_))
        br = row(name.format("bwd") + tier + f" F={F_}", t_b, p_b,
                 kernel_work("fused_bwd_kernel", B, T, K_, F_))
        b_g, by_g = bound(*kernel_work("fused_bwd_kernel", B, T, K_, F_, gated=True))
        lines.append(f"K={K_}, F={F_} ({kind} {size}), S={S_f}/{S_b}: forward {fr}; backward "
                     f"{br}; gated backward {t_g:.4f} ms (bound {b_g:.4f} ms, {by_g}); the "
                     f"E-step fused {e_fused:.4f} ms, split route {e_split:.4f} ms")
        log(f"  {lines[-1]}")
        del fwd, feats, src
        torch.cuda.empty_cache()

    for D_ in WF_INKERNEL_D:
        log_pi, log_A, W, obs = mode_problem(gen, B, T, K, D_, "niw")
        F_ = W.shape[0]
        pi_t, A_t = exp_params(log_pi, log_A)
        feats = ff.build_features(obs, "niw")
        fwd = ff.fused_forward(pi_t, A_t, W, obs, "niw")
        t_f = median_ms(lambda: ff.fused_forward(pi_t, A_t, W, obs, "niw"))
        t_b = median_ms(lambda: ff.fused_backward(A_t, W, obs, *fwd, False, None, "niw"))
        a_f = median_ms(lambda: ff.fused_forward(pi_t, A_t, W, feats))
        a_b = median_ms(lambda: ff.fused_backward(A_t, W, feats, *fwd))
        line = f"in-kernel NIW D={D_} (F={F_}), K={K}: "
        if D_ == 10:  # the kernels line's rows
            p_f = cuda_ms(lambda: ff.forward_reference(pi_t, A_t, W, obs, "niw"), 2, warmup=1)
            p_b = cuda_ms(lambda: ff.backward_reference(A_t, W, obs, *fwd, False, None, "niw"),
                          2, warmup=1)
            fr = row("fused_fwd_wf_kernel<niw>", t_f, p_f,
                     kernel_work("fused_fwd_kernel", B, T, K, F_, D=D_))
            br = row("fused_bwd_wf_kernel<niw>", t_b, p_b,
                     kernel_work("fused_bwd_kernel", B, T, K, F_, D=D_))
            line += f"forward {fr}; backward {br}"
        else:
            line += f"forward {t_f:.4f} ms, backward {t_b:.4f} ms"
        lines.append(line + f"; the array mode {a_f:.4f} / {a_b:.4f} ms")
        log(f"  {lines[-1]}")
        del fwd, feats, obs
        torch.cuda.empty_cache()

    # the pick at the main path's SVI shape: V = WF_V, K = 64, W = SVI_W
    log_pi, log_A, W, src, feats, _ = wf_problem(gen, B, SVI_W, K, "onehot", WF_V)
    F_ = W.shape[0]
    pi_t, A_t = exp_params(log_pi, log_A)
    offs = torch.randint(0, SVI_W - SVI_L + 1, (B,), generator=gen, device=dev)
    t_ = torch.arange(SVI_W, device=dev)[:, None]
    m_w = ((t_ >= offs) & (t_ < offs + SVI_L)).to(torch.float32).contiguous()
    rws = torch.arange(B, device=dev)
    fwd = ff.fused_forward(pi_t, A_t, W, feats)
    t_p = median_ms(lambda: ff.fused_backward(A_t, W, feats, *fwd, False, m_w, None, offs))
    t_e = median_ms(lambda: ff.fused_backward(A_t, W, feats, *fwd, True, m_w))
    t_gather = median_ms(lambda: ff.fused_backward(A_t, W, feats, *fwd, True, m_w)[0][offs, rws])
    p_p = cuda_ms(lambda: ff.backward_reference(A_t, W, feats, *fwd, False, m_w, None, offs), 2,
                  warmup=1)
    pr = row("fused_bwd_wf_kernel<gamma_sel>", t_p, p_p,
             kernel_work("fused_bwd_kernel", B, SVI_W, K, F_, gated=True))
    lines.append(f"the pick at V={WF_V} (F={F_}), K={K}, W={SVI_W}, B={B}, gated: {pr}; "
                 f"emit_gamma {t_e:.4f} ms, emit_gamma and the gather {t_gather:.4f} ms")
    log(f"  {lines[-1]}")

    # bf16 against float32: the fused pair at F = 66, the split pair at K = 64, 256
    log_pi, log_A, W, src, feats, _ = wf_problem(gen, B, T, K, "niw", 10)
    F_ = W.shape[0]
    pi_t, A_t = exp_params(log_pi, log_A)
    f32 = ff.fused_forward(pi_t, A_t, W, feats)
    b16 = ff.fused_forward(pi_t, A_t, W, feats, None, torch.bfloat16)
    t16 = (median_ms(lambda: ff.fused_forward(pi_t, A_t, W, feats, None, torch.bfloat16)),
           median_ms(lambda: ff.fused_backward(A_t, W, feats, *b16)))
    t32 = (median_ms(lambda: ff.fused_forward(pi_t, A_t, W, feats)),
           median_ms(lambda: ff.fused_backward(A_t, W, feats, *f32)))
    p16 = (cuda_ms(lambda: ff.forward_reference(pi_t, A_t, W, feats, None, torch.bfloat16), 2,
                   warmup=1),
           cuda_ms(lambda: ff.backward_reference(A_t, W, feats, *b16), 2, warmup=1))
    fr = row("fused_fwd_wf_kernel<bf16 alpha>", t16[0], p16[0],
             kernel_work("fused_fwd_kernel", B, T, K, F_, bf16_alpha=True))
    br = row("fused_bwd_wf_kernel<bf16 alpha>", t16[1], p16[1],
             kernel_work("fused_bwd_kernel", B, T, K, F_, bf16_alpha=True))
    lines.append(f"bf16 alpha, the fused pair at F={F_}, K={K}: forward {fr}, backward {br}; "
                 f"float32 {t32[0]:.4f} / {t32[1]:.4f} ms")
    log(f"  {lines[-1]}")
    del f32, b16, feats, src
    for K_ in (K, 256):
        log_pi, log_A, W, feats = random_problem(gen, B, T, K_, D)
        ll = (feats @ W).contiguous()
        pi_t, A_t = exp_params(log_pi, log_A)
        a32 = sf.split_forward(pi_t, A_t, ll)
        a16 = sf.split_forward(pi_t, A_t, ll, alpha_dtype=torch.bfloat16)
        t16 = (median_ms(lambda: sf.split_forward(pi_t, A_t, ll, alpha_dtype=torch.bfloat16)),
               median_ms(lambda: sf.split_backward(A_t, ll, *a16)))
        t32 = (median_ms(lambda: sf.split_forward(pi_t, A_t, ll)),
               median_ms(lambda: sf.split_backward(A_t, ll, *a32)))
        p16 = (cuda_ms(lambda: sf.split_forward_reference(pi_t, A_t, ll, torch.bfloat16), 2,
                       warmup=1),
               cuda_ms(lambda: sf.split_backward_reference(A_t, ll, *a16), 2, warmup=1))
        tier = "" if K_ <= 64 else f"<KP={K_}>"
        fr = row(f"split_fwd_kernel{tier}<bf16 alpha>", t16[0], p16[0],
                 kernel_work("split_fwd_kernel", B, T, K_, bf16_alpha=True))
        br = row(f"split_bwd_kernel{tier}<bf16 alpha>", t16[1], p16[1],
                 kernel_work("split_bwd_kernel", B, T, K_, bf16_alpha=True))
        lines.append(f"bf16 alpha, the split pair at K={K_}: forward {fr}, backward {br}; "
                     f"float32 {t32[0]:.4f} / {t32[1]:.4f} ms")
        log(f"  {lines[-1]}")
        del a32, a16, ll, feats
        torch.cuda.empty_cache()
    return rows, lines


def wide_f_phase(dev) -> tuple[list[dict], list[str]]:
    """Phase 15: the fused pair at every feature width and the split pair's
    bf16 alpha. (a) the WF instances (check_wide_f) at every WF_CASES width,
    K = 64 and 256 at B = 1024 and K = 4 and 128 at B = 3; (b) the split
    pair's bf16 alpha at K = 64, 128, 256 (check_split_bf16) and exact=True
    (check_split_exact); the main path at full width (wf_main_path); (d)
    the times (wf_time). Returns the kernels line's rows and the timing
    lines."""
    t_phase = time.perf_counter()
    import torch

    gen = torch.Generator(device=dev).manual_seed(63)
    errs = {}
    log(f"  (a) the WF instances at F = 65-820 (WF_CASES), K = 64 and 256 at B = {B}, K = 4 "
        f"and 128 at B = 3, T = {WF_T}")
    for kind, size in WF_CASES:
        for K_, B_ in ((K, B), (256, B), (4, 3), (128, 3)):
            e = check_wide_f(gen, K_, kind, size, B_)
            errs[kind, size, K_, B_] = e
    log(f"  (a) took {time.perf_counter() - t_phase:.1f} s")
    log(f"  (b) the split pair's bf16 alpha at K = {SPLIT_BF16_KS}, B = {B}, T = {WF_T}")
    split_errs = {K_: check_split_bf16(gen, K_, B, WF_T) for K_ in SPLIT_BF16_KS}
    check_split_exact(gen, dev)
    counts, setup_s = wf_main_path(dev)
    log(f"  (a), (b) and the main path took {time.perf_counter() - t_phase:.1f} s ({setup_s:.1f} "
        "s of it the data on the card)")
    times, lines = wf_time(dev)
    e66 = errs["niw", 10, K, B]
    max_err = {"fused_fwd_wf_kernel": e66["fwd"], "fused_bwd_wf_kernel": e66["bwd"],
               "fused_fwd_wide_wf_kernel<KP=256>": errs["niw", 10, 256, B]["fwd"],
               "fused_bwd_wide_wf_kernel<KP=256>": errs["niw", 10, 256, B]["bwd"],
               "fused_fwd_wf_kernel<niw>": e66["fwd"], "fused_bwd_wf_kernel<niw>": e66["bwd"],
               "fused_bwd_wf_kernel<gamma_sel>": errs["onehot", WF_V, K, B]["pick"],
               "fused_fwd_wf_kernel<bf16 alpha>": e66["bf16 fwd"],
               "fused_bwd_wf_kernel<bf16 alpha>": e66["bf16 bwd"],
               "split_fwd_kernel<bf16 alpha>": split_errs[K]["fwd"],
               "split_bwd_kernel<bf16 alpha>": split_errs[K]["bwd"]}
    timed = {"fused_fwd_wf_kernel": "fused_fwd_wf_kernel F=66",
             "fused_bwd_wf_kernel": "fused_bwd_wf_kernel F=66",
             "fused_fwd_wide_wf_kernel<KP=256>": "fused_fwd_wide_wf_kernel<KP=256> F=66",
             "fused_bwd_wide_wf_kernel<KP=256>": "fused_bwd_wide_wf_kernel<KP=256> F=66"}
    rows = []
    for name, kernel, tier, mode, src, replaces in WF_ROWS:
        n = counts.get((kernel, mode if mode is not None else tier), 0)
        require(n > 0, f"phase 15: {name} was not launched on the main path")
        rows.append({"name": name, "route": "cuda", "source": f"pysvihmm_tpu_torch/csrc/{src}",
                     "replaces": f"pysvihmm_tpu/messages/{replaces}", "launches": n,
                     "max_abs_err": max_err[name], **times[timed.get(name, name)],
                     "library_ms": None})
    log(f"  phase 15 took {time.perf_counter() - t_phase:.1f} s")
    return rows, lines


def time_route_kernels(gen) -> tuple[dict, dict, dict]:
    """Phase 5: each route kernel at K = 64, 128 and 256 (B=1024, T=1000,
    F=45, ungated) by CUDA events, its twin, its bound and share. Returns
    (ms, twin ms, bounds) by (kernel, K)."""
    import torch

    from pysvihmm_tpu_torch.messages import duplex_fb as df
    from pysvihmm_tpu_torch.messages import fused_fb as ff
    from pysvihmm_tpu_torch.messages import split_fb as sf
    from pysvihmm_tpu_torch.scripts.debug_split import cuda_ms
    from pysvihmm_tpu_torch.utils.roofline import bound, kernel_work

    ms, plain_ms, bounds = {}, {}, {}
    for K_ in (K, *LARGE_K):
        log_pi, log_A, W, feats = random_problem(gen, B, T, K_, D)
        F_ = feats.shape[-1]
        pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
        ll = (feats @ W).contiguous()
        a, s, sh, beta = df.duplex_chain(pi_t, A_t, W, feats)
        timed = {
            "fused_fwd_kernel": (lambda: ff.fused_forward(pi_t, A_t, W, feats),
                                 lambda: ff.forward_reference(pi_t, A_t, W, feats)),
            "fused_bwd_kernel": (lambda: ff.fused_backward(A_t, W, feats, a, s, sh, False),
                                 lambda: ff.backward_reference(A_t, W, feats, a, s, sh, False)),
            "split_fwd_kernel": (lambda: sf.split_forward(pi_t, A_t, ll),
                                 lambda: sf.split_forward_reference(pi_t, A_t, ll)),
            "split_bwd_kernel": (lambda: sf.split_backward(A_t, ll, a, s, sh),
                                 lambda: sf.split_backward_reference(A_t, ll, a, s, sh)),
            "duplex_chain_kernel": (lambda: df.duplex_chain(pi_t, A_t, W, feats),
                                    lambda: df.duplex_chain_reference(pi_t, A_t, W, feats)),
            "duplex_combine_kernel": (
                lambda: df.duplex_combine(W, feats, a, beta, sh),
                lambda: df.duplex_combine_reference(W, feats, a, beta, sh)),
        }
        for name, (kernel, plain) in timed.items():
            key = (name, K_)
            # a longer warm-up: the first kernel timed after the light small fit
            # read 20 % slow once with a single warm-up call
            ms[key] = cuda_ms(kernel, 20, warmup=5)
            plain_ms[key] = cuda_ms(plain, 3)
            bounds[key] = bound(*kernel_work(name, B, T, K_, F_))
            log(f"{tier_name(name, K_)}: {ms[key]:.3f} ms, plain twin {plain_ms[key]:.3f} ms, "
                f"bound {bounds[key][0]:.3f} ms ({bounds[key][1]}), "
                f"{100 * bounds[key][0] / ms[key]:.1f} % of it, at (B, T, K, F) = "
                f"({B}, {T}, {K_}, {F_})")
        del a, beta, ll, feats, timed
        torch.cuda.empty_cache()
    return ms, plain_ms, bounds


# the large-K instance of each route kernel (csrc/*.cu), by the kernel's name
WIDE_NAMES = {"fused_fwd_kernel": "fused_fwd_wide_kernel",
              "fused_bwd_kernel": "fused_bwd_wide_kernel",
              "split_fwd_kernel": "split_fwd_wide_kernel",
              "split_bwd_kernel": "split_bwd_wide_kernel",
              "duplex_chain_kernel": "duplex_chain_wide_kernel",
              "duplex_combine_kernel": "duplex_combine_kernel"}


PROBE_C = 8  # steps a tile, debug_pallas_split.py:76
# (T, B, K, C) of phase 8's checks: small, an odd K with C = 4, full B, full;
# then the large-K instances at full B and K = 128, small at K = 65 and 256,
# and at the full timed shape for both large-K tiers
PROBE_SHAPES = ((16, 4, 8, 8), (24, 3, 33, 4), (16, 1024, 64, 8), (T, B, K, PROBE_C),
                (16, 1024, 128, 8), (24, 5, 65, 4), (16, 9, 256, 8),
                (T, B, 128, PROBE_C), (T, B, 256, PROBE_C))
PROBE_TIERS = (K, *LARGE_K)  # the K the probes are timed at, one per instance tier
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


def check_probes(dev) -> dict[tuple[str, int], float]:
    """Phase 8, step 1: each probe kernel (every micro instance) against its
    twin on the same inputs at every shape of PROBE_SHAPES, one launch each.
    float32 to rtol 1e-5 per element with atol 1e-30 (another summation
    order; the micro bodies' third tile is subnormal); bf16 in its own
    dtype to rtol 1.6e-2, two bf16 ulps; "dot_only" on its written rows
    t % C == 0 only. Returns the max abs error of each by (kernel, tier),
    from the full shape (T, B, C) = (1000, 1024, 8) that phase 8 times."""
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
            if (T_, B_, C_) == (T, B, PROBE_C):
                errs[name, tier(K_)] = err
        counts = kernel_counts()
        for name, n in counts.items():
            want = 1 if name in checks else 0
            require(n == want, f"probe checks: {name} launched {n} times, expected {want}")
    return errs


def tier(K_: int) -> int:
    """The instance tier that takes K_ states: 64 (the first instances), or
    the padded states KP = 128 or 256 of the large-K ones."""
    return K if K_ <= K else 128 if K_ <= 128 else 256


def tier_name(name: str, K_: int) -> str:
    """The kernel instance that runs ``name`` at K_ states: the named kernel
    up to 64, its large-K instance (csrc/*.cu) at KP = 128 or 256 above."""
    kp = tier(K_)
    if name == OUTER_NAME:
        return f"{name} (K={K_})"
    if kp == K:
        return name
    if name in WIDE_NAMES:
        return f"{WIDE_NAMES[name]}<{kp}>"
    if name.startswith("probe_fwd_"):
        return f"probe_fwd_wide_kernel<{kp}, {'true' if 'stack' in name else 'false'}>"
    return name.replace("probe_micro_kernel<", "probe_micro_wide_kernel<")[:-1] + f", {kp}>"


def probe_timing(dev, K_) -> tuple[dict, dict, dict, dict]:
    """Phase 8, step 2, at one K: the script's timing function over the
    letters f b n s 1-5 at (T, B, K_, C) = (1000, 1024, K_, 8), the kernels
    (whose launches are counted) and then their twins; at K = 64 the split
    forward's breakdown. Returns (kernel ms, twin ms, bounds, launches), each
    by kernel name."""
    from pysvihmm_tpu_torch.scripts.debug_split import (
        VARIANTS,
        bound_ms,
        make_inputs,
        time_letters,
    )

    pi, A, lik = make_inputs(B, T, K_, dev)
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
        require(n == want, f"phase 8 timing at K={K_}: {name} launched {n} times, expected {want}")
    log(f"  launches in the timed run at K={K_}: {counts}")
    by_kernel = {kernel: label for label, kernel in VARIANTS.values()}
    kms, tms, bounds = {}, {}, {}
    for kernel, label in by_kernel.items():
        kms[kernel], tms[kernel] = ms[label], twin[label]
        bounds[kernel] = bound_ms(label, B, T, K_, PROBE_C)
        b_ms, b_by = bounds[kernel]
        log(f"{label:10s} {tier_name(kernel, K_):40s} {ms[label]:8.3f} ms, twin "
            f"{twin[label]:9.3f} ms, bound {b_ms:.4f} ms ({b_by}), {100 * b_ms / ms[label]:.1f} % "
            f"of it, at (T, B, K, C) = ({T}, {B}, {K_}, {PROBE_C})")
    if K_ == K:
        d = ms
        store = d["dot_store"]
        log(f"split_fwd_kernel {d['fwd']:.3f} ms = products {d['dot_only']:.3f} + stores "
            f"{store - d['dot_only']:.3f} + lik loads and products, renorm every 4th "
            f"{d['fwd_nos'] - store:.3f} + per-step sums {d['fwd_stack'] - d['fwd_nos']:.3f} "
            f"+ shift, exp and per-step renorm {d['fwd'] - d['fwd_stack']:.3f}; against "
            f"dot_store: bf16 {d['dot_bf16'] - store:+.3f}, interleaving x8 "
            f"{d['chunk8'] - store:+.3f}, x4 {d['chunk4'] - store:+.3f}")
    return kms, tms, bounds, counts


def probe_phase(dev) -> tuple[dict, dict, dict, dict, dict]:
    """Phase 8: the split path's profiling script (pysvihmm_tpu_torch/
    scripts/debug_split.py). Checks every probe against its twin
    (:func:`check_probes`), then times the letters at each K of PROBE_TIERS
    (:func:`probe_timing`). Returns (max abs errors, kernel ms, twin ms,
    bounds, launches), each by (kernel name, K)."""
    errs = check_probes(dev)
    kms, tms, bounds, counts = {}, {}, {}, {}
    for K_ in PROBE_TIERS:
        for out, part in zip((kms, tms, bounds, counts), probe_timing(dev, K_)):
            out.update({(name, K_): v for name, v in part.items()})
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
    build_s = time.perf_counter() - t0
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
    check_duplex_edges(gen)
    log(f"  above K = {K}: the large-K instances at K = {SMALL_LARGE_K} and at full width")
    large_errs = check_large_k(gen)
    log(f"  the large-K fused pair at every S at full width, K = {LARGE_K}")
    check_wide_seqs(gen)
    log(f"  the split pair at every S: B = {SPLIT_SEQ_B}, K = {SPLIT_SEQ_K}, gated and not")
    check_split_seqs(gen)
    log("  acc and eacc over repeated calls")
    for K_ in (K, *LARGE_K):
        check_repeatable(gen, K_)
    log(f"  the large-K outer sums (3xTF32) against float64 on one backward's windows, K = "
        f"{LARGE_K}: at most {OUTER_RATIO} x float32 torch.matmul's error")
    outer_errs = check_outer_sums(gen)

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
    _, A_s, ll, sa_r, ss_r, ssh_r, _ = split_inputs
    _, _, W_d, feats_d, da_r, _, dsh_r, db_r = duplex_inputs
    ms, plain_ms, bounds = time_route_kernels(torch.Generator(device=dev).manual_seed(81))
    fused_layout(full_inputs, {name: ms[name, K] for name in FUSED_KERNELS})
    duplex_layout(duplex_inputs, ms["duplex_chain_kernel", K])
    wide_layout(torch.Generator(device=dev).manual_seed(82))
    duplex_wide_layout(torch.Generator(device=dev).manual_seed(85))
    split_layout(torch.Generator(device=dev).manual_seed(84))
    outer_ms, outer_plain_ms, outer_lib_ms, outer_bounds = time_outer_sums(
        torch.Generator(device=dev).manual_seed(83))
    fused_large_batches(torch.Generator(device=dev).manual_seed(80))
    svi_shape_pair(torch.Generator(device=dev).manual_seed(79))

    # what the gates cost at the same shape (kept runs of 5T/7 per sequence)
    w_full = svi_masks(torch.Generator(device=dev).manual_seed(78), B, T, (5 * T) // 7)
    gated_ms = {
        "fused_bwd_kernel": cuda_ms(
            lambda: ff.fused_backward(A_t, W, feats, a_r, s_r, sh_r, False, w_full), 10),
        "split_bwd_kernel": cuda_ms(
            lambda: sf.split_backward(A_s, ll, sa_r, ss_r, ssh_r, w_full), 10),
        "duplex_combine_kernel": cuda_ms(
            lambda: df.duplex_combine(W_d, feats_d, da_r, db_r, dsh_r, False, w_full), 10),
    }
    for name, t_ms in gated_ms.items():
        log(f"{name}, gated: {t_ms:.3f} ms (ungated {ms[name, K]:.3f} ms) at (B, T, K, F) = "
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
    at_w = {
        "fused_fwd_kernel": (lambda: ff.fused_forward(pi_w, A_w, W_w, f_w), {}),
        "fused_bwd_kernel": (lambda: ff.fused_backward(A_w, W_w, f_w, fa, fs, fsh, True, m_w),
                             {"gated": True, "emit_gamma": True}),
        "split_fwd_kernel": (lambda: sf.split_forward(pi_w, A_w, ll_w), {}),
        "split_bwd_kernel": (lambda: sf.split_backward(A_w, ll_w, sa, ss, ssh, m_w),
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

    log(f"== phase 9: large K: batch VB at K={LARGE_VB_K}, B={B}, T={T}, D={D} on auto, split "
        f"and duplex; SVI at K={LARGE_SVI_K}, W={SVI_W}, B={B}")
    t0 = time.perf_counter()
    wide_launches = large_k_phase(dev)
    log(f"  phase 9 took {time.perf_counter() - t0:.1f} s; launches by (kernel, K): "
        + ", ".join(f"{tier_name(n, k_)} {c}" for (n, k_), c in wide_launches.items()))

    log(f"== phase 10: the other engines and decoders at B={B}, T={T}, K={K}, D={D}")
    t0 = time.perf_counter()
    engine_ms = engines_phase(dev)
    log(f"  phase 10 took {time.perf_counter() - t0:.1f} s; ms (host clock, synchronised; "
        f"{card}): " + json.dumps({k: round(v, 3) for k, v in engine_ms.items()}))

    log(f"== phase 11: the training loop and the user surface at K={K}, D={D} ({card})")
    t0 = time.perf_counter()
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")
    os.makedirs(scratch, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        surface_ms = surface_phase(dev, tmp)
    log(f"  phase 11 took {time.perf_counter() - t0:.1f} s; ms (host clock, synchronised; "
        f"{card}): " + json.dumps({k: round(v, 4) for k, v in surface_ms.items()}))

    with tempfile.TemporaryDirectory(dir=scratch) as tmp:
        log(f"== phase 12: the long-chain tiers at K={LC_K}, D={LC_D}, T up to {LC_T_SCALE} and "
            f"the multinomial at T={LC_MULTI_T} ({card})")
        longchain_ms, lc_share = longchain_phase(dev, share=tmp)
        log("  phase 12 ms (host clock, synchronised): "
            + json.dumps({k: round(v, 3) for k, v in longchain_ms.items()}))

        log(f"== phase 13: the parallel paths: NCCL in a world of one, then {PAR_WORLD} gloo "
            f"ranks sharing the card ({card})")
        parallel_ms = parallel_phase(dev, tmp, lc_share)
        log("  phase 13 ms (host clock, synchronised; one card measures no scaling): "
            + json.dumps({k: round(v, 3) for k, v in parallel_ms.items()}))

    log(f"== phase 14: kernel modes: in-kernel NIW and NIG features on the fused pair and the "
        f"duplex kernels, the fused backward's gamma pick, bf16-stored alpha ({card})")
    mode_rows, mode_lines = kernel_modes_phase(dev)
    log("  phase 14 times (CUDA events, median of "
        f"{MODE_REPS} means of {MODE_ITERS} calls; {card}):")
    for line in mode_lines:
        log(f"    {line}")

    log(f"== phase 15: the fused pair at every feature width (F = 65-820, K up to 256, every "
        f"kind and mode) and the split pair's bf16 alpha ({card})")
    wf_rows, wf_lines = wide_f_phase(dev)
    log(f"  phase 15 times (CUDA events, median of {MODE_REPS} means of {MODE_ITERS} calls; "
        f"twins 2 calls; {card}):")
    for line in wf_lines:
        log(f"    {line}")

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
        # the split and duplex chain rows name the S (sequences a block)
        # their times ran at
        split_kind = "forward" if "fwd" in name else "backward"
        seqs = {K_: (df.default_seqs(B, F, dev, K=K_) if name == "duplex_chain_kernel"
                     else sf.default_seqs(split_kind, B, dev, K=K_)) for K_ in (K, *LARGE_K)}
        with_s = name.startswith("split") or name == "duplex_chain_kernel"
        kernels.append({
            "name": name, "route": "cuda", "source": f"pysvihmm_tpu_torch/csrc/{src}",
            "replaces": f"pysvihmm_tpu/messages/{replaces}",
            "launches": svi_launches[name], "max_abs_err": errs[name],
            "ms": ms[name, K], "plain_ms": plain_ms[name, K], "bound_ms": bounds[name, K][0],
            "bound_by": bounds[name, K][1], "library_ms": None,
            **({"S": seqs[K]} if with_s else {}),
        })
        for K_ in LARGE_K:
            key = (name, K_)
            kernels.append({
                "name": tier_name(name, K_), "route": "cuda",
                "source": f"pysvihmm_tpu_torch/csrc/{src}",
                "replaces": f"pysvihmm_tpu/messages/{replaces}",
                "launches": wide_launches[key], "max_abs_err": large_errs[key],
                "ms": ms[key], "plain_ms": plain_ms[key], "bound_ms": bounds[key][0],
                "bound_by": bounds[key][1], "library_ms": None,
                **({"S": seqs[K_]} if with_s else {}),
            })
    # the large-K statistics' outer sums, which every large-K backward and the
    # duplex combine launch (pallas_fb.py:664, `outer_acc`, is the sum they
    # replace); times over the products of one backward, against one
    # torch.matmul a product
    for K_ in LARGE_K:
        kernels.append({
            "name": tier_name(OUTER_NAME, K_), "route": "cuda",
            "source": "pysvihmm_tpu_torch/csrc/fb_stats.cuh",
            "replaces": "pysvihmm_tpu/messages/pallas_fb.py:664",
            "launches": wide_launches[OUTER_NAME, K_], "max_abs_err": outer_errs[K_],
            "ms": outer_ms[K_], "plain_ms": outer_plain_ms[K_], "bound_ms": outer_bounds[K_][0],
            "bound_by": outer_bounds[K_][1], "library_ms": outer_lib_ms[K_],
        })
    # the probes: the kernel body each replaces in scripts/debug_pallas_split.py
    for name, line in (("probe_fwd_nos_kernel", 25), ("probe_fwd_stack_kernel", 48),
                       ("probe_micro_kernel<DOT_ONLY>", 229),
                       ("probe_micro_kernel<DOT_STORE>", 235),
                       ("probe_micro_kernel<BF16>", 241),
                       ("probe_micro_kernel<CHUNKED, 8>", 250),
                       ("probe_micro_kernel<CHUNKED, 4>", 250)):
        for K_ in PROBE_TIERS:
            key = (name, K_)
            kernels.append({
                "name": tier_name(name, K_), "route": "cuda",
                "source": "pysvihmm_tpu_torch/csrc/split_probe.cu",
                "replaces": f"scripts/debug_pallas_split.py:{line}",
                "launches": probe_launches[key], "max_abs_err": probe_errs[key],
                "ms": probe_ms[key], "plain_ms": probe_twin_ms[key],
                "bound_ms": probe_bounds[key][0], "bound_by": probe_bounds[key][1],
                "library_ms": None,
            })
    kernels.extend(mode_rows)
    kernels.extend(wf_rows)
    log(f"total {time.perf_counter() - t_start:.1f} s, the build's {build_s:.1f} s included; in "
        f"the kernels line: launches over the {SVI_STEPS} SVI steps of each kernel's route "
        f"(phase 6) for the K={K} instances, over phase 9's runs for the large-K ones (VB at "
        f"K={LARGE_VB_K}: {VB_ITERS} an instance; SVI at K={LARGE_SVI_K}: {LARGE_SVI_STEPS} steps "
        f"on auto, {LARGE_SVI_SIDE_STEPS} on split and duplex) and, for the probes, in phase 8's "
        f"timed run at their K; max_abs_err the forward's and the chain's log_c (nats), the "
        f"backward's and the combine's gamma at B={B}, T={T} (the largest over gated and not "
        f"above K={K}), each probe's alpha (and s) at (T, B, C) = ({T}, {B}, {PROBE_C}) and "
        f"the tier's K, the shape it is timed at; ms, plain_ms and "
        f"bound_ms at (B, T, F) = ({B}, {T}, {F}) and the tier's K ({K}, "
        f"{', '.join(map(str, LARGE_K))}), ungated, and for the probes at C={PROBE_C}; the "
        f"outer sums: launches over phase 9's VB (K={LARGE_VB_K}) and SVI (K={LARGE_SVI_K}) "
        f"runs, max_abs_err acc's largest against float64 over one backward's windows, ms "
        f"over that backward's products, library_ms one float32 torch.matmul a product; the "
        f"modes' rows (phase 14): launches over its main-path run (VB with in-kernel features, "
        f"SVI with the gamma pick, the bf16 probe), max_abs_err against the twins at (B, T, K) = "
        f"({B}, {T}, {K}), ms the median of {MODE_REPS} means of {MODE_ITERS} calls there (the "
        f"gamma pick's at the SVI shape, W={SVI_W}); the WF rows (phase 15): launches over its "
        f"main-path run (the E-steps at F = 66 and 100 on auto, K = 64 and 256, in-kernel NIW at "
        f"D = 10, the V = {WF_V} SVI steps with the pick and bf16 alpha, the V = {WF_BIG_V} "
        f"split pair with bf16 alpha), max_abs_err against the twins at B = {B}, T = {WF_T} "
        f"(F = 66, the pick's at V = {WF_V}), ms at (B, T) = ({B}, {T}) and F = 66 (the pick's "
        f"at V = {WF_V}, W = {SVI_W}; the split pair's at F = {F})")
    log(card)
    log(json.dumps({"kernels": kernels, "note": "the long-chain tiers (phase 12) are plain "
                    "PyTorch, as JAX's are plain XLA: they add no kernel to this line"}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
