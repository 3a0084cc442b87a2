"""Exact full-chain VB iterations on one long chain (port of
``scripts/run_longchain_vb.py``).

Each iteration is one exact streaming E-step (``batch_vb.
make_long_chain_step``: the likelihood-fused tier, no (T, K) likelihood, no
gamma) and the conjugate update. Prints one JSON line: the ELBO of every
iteration, the largest relative drop (coordinate ascent never drops; JAX's
script allows 1e-3 for its TPU likelihood tier's noise, and so does this
one), the seconds of every iteration and the median after the first, and
the card's name and power limit.

    python -m pysvihmm_tpu_torch.scripts.run_fused_scale --T 100000000 \\
        --data-cache ga100.npz --gen-only
    python -m pysvihmm_tpu_torch.scripts.run_longchain_vb --T 100000000 --data-cache ga100.npz

Without --data-cache the chain is made here, as run_fused_scale makes it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..distributions import GaussianNIW
from ..engines import batch_vb
from ..models.hmm import init_params, make_prior
from .debug_split import card_line
from .run_fused_scale import make_chain

MAX_REL_DROP = 1e-3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--T", type=int, default=100_000_000)
    ap.add_argument("--K", type=int, default=64)
    ap.add_argument("--obs-dim", type=int, default=8)
    ap.add_argument("--iters", type=int, default=6)
    ap.add_argument("--block-size", type=int, default=4096)
    ap.add_argument("--data-cache", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--time-minor", action="store_true",
                    help="pass the chain feature-major, (D, T)")
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    T, D, K = args.T, args.obs_dim, args.K
    if args.data_cache:
        obs_np = np.load(args.data_cache)["obs"]
    else:
        obs_np = make_chain("gaussian", T, K, D, 0, args.seed)[0]
    if obs_np.shape != (T, D):
        raise ValueError(f"the chain is {obs_np.shape}, not {(T, D)}")

    chain = torch.from_numpy(obs_np).to(dev)
    prior = make_prior(K, GaussianNIW, obs_dim=D, device=dev)
    p0 = init_params(torch.Generator(dev).manual_seed(args.seed + 2), prior, GaussianNIW,
                     chain[:100_000])
    if args.time_minor:
        chain = chain.T.contiguous()
    step = batch_vb.make_long_chain_step(GaussianNIW, block_size=args.block_size,
                                         time_minor=args.time_minor)
    params, elbos, walls = p0, [], []
    for _ in range(args.iters):
        t0 = time.perf_counter()
        params, e = step(params, prior, chain)
        elbos.append(float(e))  # reading the ELBO waits for the device
        walls.append(time.perf_counter() - t0)
    max_drop = max([0.0] + [(a - b) / abs(a) for a, b in zip(elbos[:-1], elbos[1:])])
    print(json.dumps({
        "phase": "exact_fullchain_vb", "T": T, "K": K, "D": D, "block_size": args.block_size,
        "iters": args.iters, "time_minor": args.time_minor, "elbo_trajectory": elbos,
        "max_rel_drop": max_drop, "monotone_within_tier_noise": max_drop < MAX_REL_DROP,
        "iter_wall_s": [round(w, 3) for w in walls],
        "steady_s_per_iter": round(float(np.median(walls[1:] or walls)), 3),
        "device": card_line() if dev.type == "cuda" else "cpu",
    }), flush=True)
    if max_drop >= MAX_REL_DROP:
        raise AssertionError(f"ELBO dropped {max_drop} relative: {elbos}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
