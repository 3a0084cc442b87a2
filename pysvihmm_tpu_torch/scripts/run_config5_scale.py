"""BASELINE config 5 at scale: data-parallel SVI over a disk-resident corpus
(port of ``scripts/run_config5_scale.py``).

1. writes an (N, T, D) float32 corpus to a ``.npy`` memmap, sampled on the
   host in chunks (the true parameters from ``make_gaussian_params``, whose
   covariances are spherical, the states by inverse-CDF draws, all from
   ``--seed``), so the corpus never sits in host memory whole;
2. streams shuffled batches of each process's slice through
   ``ShardedSequenceLoader.from_npy`` (the OS pages in only the rows a batch
   touches);
3. runs ``parallel.make_dp_streamed_svi_step`` (the batch local step on each
   process's batch, the statistics summed over the processes, the elastic
   natural-gradient step) for ``--steps`` through the fault-tolerant trainer
   (``--checkpoint-dir``: a killed run restarted with the same directory
   resumes mid-corpus exactly);
4. prints one JSON line: sequences a second, the Hamming error of the first
   512 sequences and the held-out predictive log-likelihood per observation
   of the last 256.

Several processes (``torchrun --nproc-per-node n``, one card each) form the
data mesh; rank 0 writes the corpus and prints. Without such an
environment the script is one process.

    python -m pysvihmm_tpu_torch.scripts.run_config5_scale --num-seqs 200000 --steps 300
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..data.loader import ShardedSequenceLoader
from ..data.synthetic import make_gaussian_params
from ..distributions import GaussianNIW
from ..engines import svi, trainer
from ..engines.base import decode, predictive_log_likelihood
from ..eval.metrics import hamming_error
from ..models.hmm import init_params, make_prior
from ..parallel import initialize_distributed, make_dp_streamed_svi_step, make_mesh
from ..utils.logging import MetricsLogger

CHUNK = 16_384  # sequences sampled at a time


def _sample_states(rng, pi: np.ndarray, A_cum: np.ndarray, n: int, T: int) -> np.ndarray:
    z = np.empty((n, T), np.int32)
    z[:, 0] = rng.choice(len(pi), size=n, p=pi / pi.sum())
    u = rng.random((n, T - 1))
    for t in range(1, T):  # inverse-CDF draw from each sequence's current row
        z[:, t] = (A_cum[z[:, t - 1]] < u[:, t - 1, None]).sum(axis=1)
    return z


def write_corpus(path: str, N: int, T: int, D: int, K: int, seed: int) -> np.ndarray:
    """Sample the corpus into ``path`` chunk by chunk; returns the states of
    its first 512 sequences."""
    tp = make_gaussian_params(torch.Generator().manual_seed(seed), K, D, mean_scale=6.0,
                              cov_scale=0.3)
    pi, A_cum = tp.pi.double().numpy(), np.cumsum(tp.A.double().numpy(), axis=1)
    mu = tp.theta[0].numpy()
    sd = math.sqrt(float(tp.theta[1][0, 0, 0]))
    out = np.lib.format.open_memmap(path, mode="w+", dtype=np.float32, shape=(N, T, D))
    rng = np.random.default_rng(seed + 1)
    head = None
    for s in range(0, N, CHUNK):
        n = min(CHUNK, N - s)
        z = _sample_states(rng, pi, A_cum, n, T)
        out[s:s + n] = mu[z] + sd * rng.standard_normal((n, T, D), np.float32)
        if head is None:
            head = z[:512].copy()
    out.flush()
    return head


def head_states(N: int, T: int, K: int, D: int, seed: int) -> np.ndarray:
    """The states of the first 512 sequences of a corpus written with this
    seed: its first chunk's state draws precede the chunk's emission draws
    in the generator's stream, so a fresh generator replays them."""
    tp = make_gaussian_params(torch.Generator().manual_seed(seed), K, D, mean_scale=6.0,
                              cov_scale=0.3)
    pi, A_cum = tp.pi.double().numpy(), np.cumsum(tp.A.double().numpy(), axis=1)
    return _sample_states(np.random.default_rng(seed + 1), pi, A_cum, min(CHUNK, N), T)[:512]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--num-seqs", type=int, default=200_000)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--obs-dim", type=int, default=4)
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=512, help="sequences a step, all processes")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--corpus", type=str, default="config5_corpus.npy")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--reuse-corpus", action="store_true",
                    help="stream an existing --corpus written with the same seed")
    ap.add_argument("--gen-only", action="store_true", help="write the corpus and exit")
    ap.add_argument("--checkpoint-dir", type=str, default=None)
    ap.add_argument("--checkpoint-every", type=int, default=500)
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    N, T, D, K, B = args.num_seqs, args.seq_len, args.obs_dim, args.K, args.batch_size
    dev = torch.device(args.device)

    initialize_distributed(backend="nccl" if dev.type == "cuda" else "gloo")
    rank, world = (dist.get_rank(), dist.get_world_size()) if dist.is_initialized() else (0, 1)
    if dev.type == "cuda" and "LOCAL_RANK" in os.environ:
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    if B % world:
        raise ValueError(f"--batch-size {B} not divisible by {world} processes")

    t0 = time.perf_counter()
    if args.reuse_corpus:
        if np.load(args.corpus, mmap_mode="r").shape != (N, T, D):
            raise ValueError(f"{args.corpus} is not an {(N, T, D)} corpus")
        z_head = head_states(N, T, K, D, args.seed)
    elif rank == 0:
        z_head = write_corpus(args.corpus, N, T, D, K, args.seed)
    if dist.is_initialized():
        dist.barrier()  # the corpus is complete before any process maps it
    if not args.reuse_corpus and rank != 0:
        z_head = head_states(N, T, K, D, args.seed)
    gen_wall = time.perf_counter() - t0
    if args.gen_only:
        if rank == 0:
            print(json.dumps({"config": 5, "phase": "gen_only", "N": N, "T": T, "D": D,
                              "corpus_gb": round(N * T * D * 4 / 1e9, 2),
                              "gen_wall_s": round(gen_wall, 1), "corpus": args.corpus}))
        return 0

    mesh = make_mesh(world, dev.type) if dist.is_initialized() else None
    corpus = np.load(args.corpus, mmap_mode="r")
    loader = ShardedSequenceLoader.from_npy(args.corpus, dev, batch_per_host=B // world,
                                            seed=args.seed)
    head = torch.from_numpy(np.array(corpus[:512])).to(dev)  # copies: the memmap is read-only
    prior = make_prior(K, GaussianNIW, obs_dim=D, device=dev)
    p0 = init_params(torch.Generator(dev).manual_seed(args.seed + 2), prior, GaussianNIW, head)
    state = svi.init_state(p0, torch.Generator(dev).manual_seed(args.seed + 3), adaptive=True)
    cfg = svi.SVIConfig(batch_size=B, tau=10.0, kappa=0.6, adaptive=True)
    step = make_dp_streamed_svi_step(GaussianNIW, cfg, num_seqs=N, mesh=mesh)

    # the first segment (one step) pays the warm-up, or restores a checkpoint,
    # so that the timed segment is steady
    ckpt = dict(checkpoint_dir=args.checkpoint_dir, checkpoint_every=args.checkpoint_every)
    state = trainer.train_streamed(step, state, prior, loader, 1, **ckpt)
    resumed_from = int(state.step)
    t0 = time.perf_counter()
    state = trainer.train_streamed(step, state, prior, loader, args.steps, **ckpt,
                                   log=MetricsLogger(echo=rank == 0),
                                   log_every=max(1, args.steps // 4), resume=False)
    done = int(state.step) - resumed_from  # reading the step waits for the device
    fit_wall = time.perf_counter() - t0

    z_hat = decode(state.params, GaussianNIW, head).cpu().numpy()
    ham = hamming_error(z_hat.reshape(-1), z_head.reshape(-1), K)
    held = torch.from_numpy(np.array(corpus[N - 256:])).to(dev)
    pll = float(predictive_log_likelihood(state.params, GaussianNIW, held)) / held[..., 0].numel()
    if rank == 0:
        print(json.dumps({
            "config": 5, "scale": "disk-streamed", "N": N, "T": T, "D": D, "K": K, "B": B,
            "corpus_gb": round(N * T * D * 4 / 1e9, 2), "gen_wall_s": round(gen_wall, 1),
            "steps": done, "resumed_from": resumed_from, "fit_wall_s": round(fit_wall, 1),
            "seqs_per_s": round(done * B / fit_wall, 1) if done else None,
            "hamming": ham, "pred_ll_per_obs": round(pll, 4), "processes": world,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
            "checkpoint_dir": args.checkpoint_dir,
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
