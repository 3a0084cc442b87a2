"""Run the BASELINE evaluation configs end to end and print one JSON line a
config (port of ``scripts/run_baseline_configs.py``).

Each config is scaled by ``--scale`` (0.1 runs in seconds on the CPU, 1 is
the full size):

  1  Gaussian K=4, 100 seqs x T=800, batch VB            (correctness)
  2  Gaussian K=16, one chain, subchain SVI B=32 L=50    (single-device SVI)
  3  Multinomial K=32, V=48, minibatch SVI + pred-LL     (discrete)

  4  Gaussian K=64, D=8, one chain of T = max(10000, 100000 scale): the
     exact long-chain E-step (engines.base.long_chain_local_stats, block
     256), timed warm, then subchain SVI on the same chain (B=32 L=50 b=10)

  5  Gaussian K=8, D=4, N = max(4 n, 1024 scale) seqs x T=128 over the
     world's data mesh of n processes: data-parallel minibatch SVI
     (parallel.make_dp_minibatch_svi_step, 4 seqs a process a step, the
     elastic step size)

Each asserts its quality bar: config 1 a non-decreasing ELBO and Hamming
error < 0.05, config 2 Hamming error < 0.15, config 3 a held-out predictive
log-likelihood above the uniform model's, config 4 a finite log Z, config 5
Hamming error < 0.15. Config 5 runs over the job's process group (started
from the environment by ``parallel.initialize_distributed``, e.g. under
``torchrun``; each process on ``cuda:LOCAL_RANK``), or over a group of this
one process; only rank 0 prints.

    python -m pysvihmm_tpu_torch baseline --scale 1 --configs 1,2,3,4,5 [--device cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import tempfile
import time

import torch
import torch.distributed as dist

from ..data.synthetic import gen_gaussian_dataset, gen_multinomial_dataset
from ..distributions import GaussianNIW, MultinomialDirichlet
from ..engines import batch_vb, svi
from ..engines.base import decode, long_chain_local_stats, predictive_log_likelihood
from ..eval.metrics import hamming_error
from ..models.hmm import init_params, make_prior
from ..parallel import (
    initialize_distributed,
    make_dp_minibatch_svi_step,
    make_mesh,
    shard_batch,
)


def _emit(rec) -> None:
    if not dist.is_initialized() or dist.get_rank() == 0:
        print(json.dumps(rec), flush=True)


@contextlib.contextmanager
def _world(dev: torch.device):
    """The process group config 5 runs over: the job's, when the environment
    names one, else a group of this process alone for the call."""
    backend = "nccl" if dev.type == "cuda" else "gloo"
    initialize_distributed(backend=backend)
    if dist.is_initialized():
        if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
            torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        yield
        return
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(backend, init_method="file://" + os.path.join(tmp, "pg"),
                                world_size=1, rank=0)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="the BASELINE evaluation configs on the port")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--configs", type=str, default="1,2,3")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    which = {int(x) for x in args.configs.split(",")}
    s, dev = args.scale, torch.device(args.device)

    def gen(seed: int) -> torch.Generator:
        return torch.Generator(dev).manual_seed(seed)

    if 1 in which:
        K, D, N, T = 4, 2, max(8, int(100 * s)), max(64, int(200 * s * 4))
        obs, z, _ = gen_gaussian_dataset(gen(args.seed), K, D, N, T, mean_scale=6.0,
                                         cov_scale=0.3)
        prior = make_prior(K, GaussianNIW, obs_dim=D, device=dev)
        p0 = init_params(gen(1), prior, GaussianNIW, obs)
        t0 = time.perf_counter()
        params, elbos = batch_vb.fit(p0, prior, obs, GaussianNIW, num_iters=50)
        e = elbos.double().cpu()
        mono = bool(((e[1:] - e[:-1]) / e[:-1].abs() > -1e-5).all())
        err = hamming_error(decode(params, GaussianNIW, obs), z, K)
        _emit({"config": 1, "engine": "batch_vb", "elbo": float(e[-1]), "elbo_monotone": mono,
               "hamming": err, "wall_s": round(time.perf_counter() - t0, 2)})
        _check(mono and err < 0.05, f"config 1: ELBO monotone {mono}, Hamming {err}")

    if 2 in which:
        K, D, T = 16, 4, max(2000, int(20000 * s))
        obs, z, _ = gen_gaussian_dataset(gen(2), K, D, 1, T, mean_scale=6.0, cov_scale=0.3)
        chain = obs[0]
        prior = make_prior(K, GaussianNIW, obs_dim=D, device=dev)
        p0 = init_params(gen(3), prior, GaussianNIW, chain)
        cfg = svi.SVIConfig(batch_size=32, subchain_len=50, buffer=10, tau=10.0, kappa=0.6)
        t0 = time.perf_counter()
        state, metrics = svi.fit(svi.init_state(p0, gen(4)), prior, chain, GaussianNIW, cfg,
                                 num_steps=max(200, int(2000 * s)))
        err = hamming_error(decode(state.params, GaussianNIW, chain[None]), z, K)
        _emit({"config": 2, "engine": "svi",
               "noisy_elbo": float(metrics["noisy_elbo"][-20:].double().mean()),
               "hamming": err, "wall_s": round(time.perf_counter() - t0, 2)})
        _check(err < 0.15, f"config 2: Hamming {err}")

    if 3 in which:
        K, V, N, T = 32, 48, max(16, int(256 * s)), 300
        obs, z, _ = gen_multinomial_dataset(gen(5), K, V, N, T, concentration=0.15)
        held, train = obs[: max(2, N // 8)], obs[max(2, N // 8):]
        prior = make_prior(K, MultinomialDirichlet, num_symbols=V, device=dev)
        p0 = init_params(gen(6), prior, MultinomialDirichlet, train)
        cfg = svi.SVIConfig(batch_size=8, tau=5.0, kappa=0.6)
        t0 = time.perf_counter()
        state, _ = svi.fit_minibatch(svi.init_state(p0, gen(7)), prior, train,
                                     MultinomialDirichlet, cfg, max(200, int(1500 * s)))
        pl_mean = float(predictive_log_likelihood(state.params, MultinomialDirichlet,
                                                  held)) / held.numel()
        pl_exact = float(predictive_log_likelihood(state.params, MultinomialDirichlet, held,
                                                   exact=True)) / held.numel()
        uniform = -math.log(V)
        _emit({"config": 3, "engine": "svi_minibatch", "pred_ll_per_obs": pl_mean,
               "pred_ll_exact_per_obs": pl_exact, "uniform_baseline": uniform,
               "wall_s": round(time.perf_counter() - t0, 2)})
        _check(pl_mean > uniform, f"config 3: pred-LL {pl_mean} <= uniform {uniform}")

    if 4 in which:
        K, D, T = 64, 8, max(10000, int(100_000 * s))
        obs, z, _ = gen_gaussian_dataset(gen(8), K, D, 1, T, mean_scale=8.0, cov_scale=0.3)
        chain = obs[0]
        prior = make_prior(K, GaussianNIW, obs_dim=D, device=dev)
        p0 = init_params(gen(9), prior, GaussianNIW, chain)
        # the exact full-chain E-step through the streaming tier, timed warm;
        # reading log Z waits for the device
        float(long_chain_local_stats(p0, GaussianNIW, chain, block_size=256).log_z)
        t0 = time.perf_counter()
        exact_logz = float(long_chain_local_stats(p0, GaussianNIW, chain, block_size=256).log_z)
        wall_exact = time.perf_counter() - t0
        # SVI on the same chain (the algorithmic long-context answer)
        cfg = svi.SVIConfig(batch_size=32, subchain_len=50, buffer=10, tau=10.0, kappa=0.6)
        state, _ = svi.fit(svi.init_state(p0, gen(10)), prior, chain, GaussianNIW, cfg,
                           num_steps=max(200, int(2000 * s)))
        err = hamming_error(decode(state.params, GaussianNIW, chain[None]), z, K)
        _emit({"config": 4, "T": T, "exact_blocked_logz": exact_logz,
               "exact_path": "long_chain_local_stats[warm]",
               "exact_wall_s": round(wall_exact, 4), "svi_hamming": err,
               "wall_s": round(time.perf_counter() - t0, 2)})
        _check(math.isfinite(exact_logz), f"config 4: log Z {exact_logz}")

    if 5 in which:
        with _world(dev):
            n = dist.get_world_size()
            K, D, T = 8, 4, 128
            N = max(4 * n, int(1024 * s))
            N -= N % n
            obs, z, _ = gen_gaussian_dataset(gen(11), K, D, N, T, mean_scale=6.0,
                                             cov_scale=0.3)
            prior = make_prior(K, GaussianNIW, obs_dim=D, device=dev)
            p0 = init_params(gen(12), prior, GaussianNIW, obs)
            mesh = make_mesh(n, dev.type)
            cfg = svi.SVIConfig(batch_size=4 * n, tau=5.0, kappa=0.6, adaptive=True)
            step = make_dp_minibatch_svi_step(GaussianNIW, cfg, num_seqs=N, mesh=mesh)
            state = svi.init_state(p0, gen(13), adaptive=True)
            shard = shard_batch(obs, mesh)
            steps = max(500, int(2000 * s))
            t0 = time.perf_counter()
            for _ in range(steps):
                state, metrics = step(state, prior, shard)
            err = hamming_error(decode(state.params, GaussianNIW, obs), z, K)
            _emit({"config": 5, "processes": n, "N": N, "steps": steps,
                   "elastic_rho": float(metrics["rho"]), "hamming": err,
                   "wall_s": round(time.perf_counter() - t0, 2)})
            _check(err < 0.15, f"config 5: Hamming {err}")

    _emit({"event": "all_configs_done", "configs": sorted(which)})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
