"""The likelihood-fused streaming E-step and decode of one long chain at the
paper's scale (port of ``scripts/run_fused_scale.py``).

One chain of T steps (10^7-2.5x10^8; the chromatin chain of Foti et al.
2014 §4 has 2.5x10^8) is made on the host by ``sample_states_fast`` and put
on the device; the fused tier (messages/stream_fused.py) computes the
likelihoods a chunk at a time from the raw observations and rematerialises
alpha in the backward pass, so the device holds the observations and no
(T, K) array. One JSON line a phase:

  exact_fused       the fused streaming E-step, timed warm: log Z, s, steps/s
  exact_twophase    with --compare-twophase: the (T, K) two-phase tier
  subchain_svi      buffered-subchain SVI on the chain (the paper's estimator)
  fused_decode      the streaming decode at SVI's params and its full-chain
                    Hamming error against the generating states
  true_param_decode the decode at the generating parameters (the Bayes floor)

Every line carries the card's name and power limit (nvidia-smi). The
Gaussian chain is time-major, (T, D); --time-minor passes it feature-major,
(D, T), JAX's TPU layout.

    python -m pysvihmm_tpu_torch.scripts.run_fused_scale --T 50000000
    python -m pysvihmm_tpu_torch.scripts.run_fused_scale --family multinomial --V 64 \\
        --K 32 --T 250000000
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch

from ..data.synthetic import make_gaussian_params, make_multinomial_params, sample_states_fast
from ..distributions import GaussianNIW, MultinomialDirichlet
from ..distributions.niw import NIW
from ..engines import svi
from ..engines.base import _long_chain_ell_fn, long_chain_decode, long_chain_local_stats
from ..eval.metrics import hamming_error_long
from ..messages.stream_fused import forward_backward_fused_twophase
from ..models.hmm import (
    HMMParams,
    emission_flat_stats,
    expected_log_params,
    init_params,
    make_prior,
)
from ..utils.precision import f32_matmuls
from .debug_split import card_line

CONC = 1e8  # pseudo-counts of the Bayes-floor params: E[params] = the truth


def make_chain(family: str, T: int, K: int, D: int, V: int, seed: int,
               concentration: float = 0.3):
    """(observations (T, D) float32 or (T,) int32, states (T,) int32, true
    params on the CPU), made on the host: the true parameters from a torch
    generator seeded ``seed``, the states by ``sample_states_fast`` and the
    observations from ``numpy.random.default_rng(seed + 1)``, as JAX's
    script draws them (config 4's Gaussian: mean_scale 8, cov_scale 0.3)."""
    gen = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed + 1)
    if family == "gaussian":
        tp = make_gaussian_params(gen, K, D, mean_scale=8.0, cov_scale=0.3)
        z = sample_states_fast(tp.pi.numpy(), tp.A.numpy(), T, rng)
        mu = tp.theta[0].numpy()
        sd = math.sqrt(float(tp.theta[1][0, 0, 0]))
        obs = mu[z] + sd * rng.standard_normal((T, D)).astype(np.float32)
        return obs.astype(np.float32), z, tp
    tp = make_multinomial_params(gen, K, V, concentration=concentration)
    z = sample_states_fast(tp.pi.numpy(), tp.A.numpy(), T, rng)
    phi_cum = np.cumsum(tp.theta.numpy().astype(np.float64), axis=1)
    obs = np.empty((T,), np.int32)
    u = rng.random(T)
    for k in range(K):  # vectorised per state: K passes, no loop over T
        m = z == k
        obs[m] = np.searchsorted(phi_cum[k], u[m], side="right")
    np.clip(obs, 0, V - 1, out=obs)
    return obs, z, tp


def bayes_floor_params(tp, family: str, device) -> HMMParams:
    """Pseudo-posterior params whose expected parameters are the generator's
    (Dirichlet and NIW counts at CONC), so that a decode under them sees only
    the model's own ambiguity. The multinomial's counts get + 1: a sparse
    draw's phi ~ 1e-15 would put digamma in its divergent region."""
    K = tp.pi.shape[0]
    if family == "multinomial":
        emit = CONC * tp.theta.to(device) + 1.0
    else:
        mu, sigma = (x.to(device) for x in tp.theta)
        counts = torch.full((K,), CONC, device=device)
        emit = NIW(mean=mu, kappa=counts, nu=counts, psi=CONC * sigma)
    return HMMParams(init=CONC * tp.pi.to(device), trans=CONC * tp.A.to(device), emit=emit)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--family", choices=["gaussian", "multinomial"], default="gaussian")
    ap.add_argument("--T", type=int, default=50_000_000)
    ap.add_argument("--K", type=int, default=64)
    ap.add_argument("--obs-dim", type=int, default=8)
    ap.add_argument("--V", type=int, default=32)
    ap.add_argument("--block-size", type=int, default=1024)
    ap.add_argument("--chunks", type=int, default=16)
    ap.add_argument("--store-alphas", action="store_true",
                    help="store filtered messages instead of rematerialising them")
    ap.add_argument("--compare-twophase", action="store_true")
    ap.add_argument("--svi-steps", type=int, default=300)
    ap.add_argument("--svi-batch", type=int, default=256)
    ap.add_argument("--concentration", type=float, default=0.3,
                    help="multinomial emission Dirichlet concentration (lower = sparser)")
    ap.add_argument("--skip-decode", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--data-cache", type=str, default=None,
                    help=".npz of (obs, z): written after generation if absent, read if present")
    ap.add_argument("--gen-only", action="store_true")
    ap.add_argument("--time-minor", action="store_true",
                    help="pass the Gaussian chain feature-major, (D, T)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    f32_matmuls()
    dev = torch.device(args.device)
    T, K = args.T, args.K
    D = args.obs_dim if args.family == "gaussian" else None

    t0 = time.perf_counter()
    if args.data_cache and not args.data_cache.endswith(".npz"):
        args.data_cache += ".npz"
    cached = bool(args.data_cache) and os.path.exists(args.data_cache)
    if cached:
        data = np.load(args.data_cache)
        obs_np, z = data["obs"], data["z"]
        if obs_np.shape[0] != T:
            raise ValueError(f"{args.data_cache} holds T={obs_np.shape[0]}, not {T}")
        # the true params re-derive from the seed; the cache holds the data only
        tp = make_chain(args.family, 2, K, args.obs_dim, args.V, args.seed,
                        args.concentration)[2]
    else:
        obs_np, z, tp = make_chain(args.family, T, K, args.obs_dim, args.V, args.seed,
                                   args.concentration)
        if args.data_cache:
            np.savez(args.data_cache, obs=obs_np, z=z)
    gen_wall = time.perf_counter() - t0
    if args.gen_only:
        print(json.dumps({"phase": "gen_only", "T": T, "gen_wall_s": round(gen_wall, 1),
                          "cache": args.data_cache}), flush=True)
        return 0

    card = card_line() if dev.type == "cuda" else "cpu"
    emission = GaussianNIW if args.family == "gaussian" else MultinomialDirichlet
    prior = (make_prior(K, GaussianNIW, obs_dim=D, device=dev) if D else
             make_prior(K, MultinomialDirichlet, num_symbols=args.V, device=dev))
    chain_tm = torch.from_numpy(obs_np).to(dev)  # time-major; tokens stay int32
    time_minor = args.time_minor and args.family == "gaussian"
    chain = chain_tm.T.contiguous() if time_minor else chain_tm
    del obs_np
    head = min(T, 100_000)
    p0 = init_params(torch.Generator(dev).manual_seed(args.seed + 2), prior, emission,
                     chain_tm[:head])
    base = {"family": args.family, "T": T, "K": K, **({"D": D} if D else {"V": args.V}),
            "block_size": args.block_size, "chunks": args.chunks,
            "store_alphas": bool(args.store_alphas), "time_minor": time_minor,
            "device": card}

    def fused_stats(p, c):
        log_pi, log_A = expected_log_params(p)
        return forward_backward_fused_twophase(
            log_pi, log_A, c, _long_chain_ell_fn(p, emission), block_size=args.block_size,
            chunks=args.chunks, store_alphas=args.store_alphas or None,
            stat_fn=lambda g, y: emission_flat_stats(emission, p.emit, g, y),
            stat_init=emission.zero_stats(p.emit), time_minor=time_minor)

    float(fused_stats(p0, chain).log_z)  # first use
    t0 = time.perf_counter()
    log_z = float(fused_stats(p0, chain).log_z)  # reading log Z waits for the device
    wall = time.perf_counter() - t0
    print(json.dumps({"phase": "exact_fused", **base, "log_z": log_z, "wall_s": round(wall, 3),
                      "steps_per_s": round(T / wall, 1), "gen_wall_s": round(gen_wall, 1),
                      "peak_gb": _peak_gb(dev)}), flush=True)
    if not np.isfinite(log_z):
        raise FloatingPointError(f"exact_fused: log Z {log_z}")

    if args.compare_twophase:
        float(long_chain_local_stats(p0, emission, chain_tm, 256, impl="twophase").log_z)
        t0 = time.perf_counter()
        log_z2 = float(long_chain_local_stats(p0, emission, chain_tm, 256,
                                              impl="twophase").log_z)
        wall2 = time.perf_counter() - t0
        print(json.dumps({"phase": "exact_twophase", **base, "block_size": 256,
                          "log_z": log_z2, "wall_s": round(wall2, 3),
                          "steps_per_s": round(T / wall2, 1),
                          "log_z_rel_diff": abs(log_z2 - log_z) / abs(log_z)}), flush=True)

    cfg = svi.SVIConfig(batch_size=args.svi_batch, subchain_len=50, buffer=10, tau=10.0,
                        kappa=0.6)
    state = svi.init_state(p0, torch.Generator(dev).manual_seed(args.seed + 3))
    t0 = time.perf_counter()
    state, metrics = svi.fit(state, prior, chain_tm, emission, cfg, num_steps=args.svi_steps)
    ne = metrics["noisy_elbo"].double().cpu().numpy()
    print(json.dumps({"phase": "subchain_svi", **base, "steps": args.svi_steps,
                      "B": cfg.batch_size, "L": cfg.subchain_len, "buffer": cfg.buffer,
                      "wall_s": round(time.perf_counter() - t0, 1),
                      "noisy_elbo_last20": float(ne[-20:].mean())}), flush=True)

    if args.skip_decode:
        return 0

    def decode(p):
        return long_chain_decode(p, emission, chain, block_size=args.block_size,
                                 chunks=args.chunks, time_minor=time_minor)

    z_dev = torch.from_numpy(z).to(dev)
    decode(p0)  # first use, at the full shape
    for phase, params, key in (("fused_decode", state.params, "hamming_full_chain"),
                               ("true_param_decode", bayes_floor_params(tp, args.family, dev),
                                "hamming_bayes_floor")):
        _sync(dev)
        t0 = time.perf_counter()
        z_hat = decode(params)
        _sync(dev)
        dec_wall = time.perf_counter() - t0
        ham = hamming_error_long(z_hat, z_dev, K)
        print(json.dumps({"phase": phase, **base, "wall_s": round(dec_wall, 3),
                          "steps_per_s": round(T / dec_wall, 1), key: round(ham, 6)}),
              flush=True)
    return 0


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gb(dev):
    return round(torch.cuda.max_memory_allocated(dev) / 2**30, 2) if dev.type == "cuda" else None


if __name__ == "__main__":
    raise SystemExit(main())
