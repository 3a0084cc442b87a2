"""Time the fused E-step pair on the card at the VB shape (B=1024, T=1000,
K=64, a Gaussian-NIW at D=8: F=45): the forward, the backward ungated and
gated (kept runs of 5T/7), and the whole fused E-step; then one windowed SVI
step (L=50, b=10, W=70, on one chain of T=100,000) on "auto" and on "split"
at B = 32, 256 and 1024.

Usage, on a machine with an NVIDIA GPU and nvcc, from the repository root::

    PYTHONPATH=<checkout> python pysvihmm_tpu_torch/scripts/time_fused.py [reps]

It imports the ``pysvihmm_tpu_torch`` of ``<checkout>`` (``.`` for this one)
and calls only what every version of the port has had since windowed SVI
was ported (``fused_forward``, ``fused_backward``, ``estep_fused`` with
their default arguments, ``svi.make_step``), so the same file times an
earlier checkout too: two checkouts are compared in one call, in turns. Each
line gives ms per launch (per step for SVI, chained steps with nothing read
back) by CUDA events, 20 launches after 3 warm-ups, ``reps`` times (default
3), and their median and minimum (the host-bound SVI step varies by up to 2x
from one rep to the next); the last line is the card's name and power limit.
Without a card it raises.
"""

from __future__ import annotations

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


def inputs(dev: torch.device):
    """chip_smoke.py's E-step inputs (overlapping states, NIW parameters
    near the generating ones), from a seeded generator on the card."""
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


def report(name: str, times: list[float]) -> None:
    print(f"{name}: " + " / ".join(f"{x:.3f}" for x in times)
          + f" ms (median {statistics.median(times):.3f}, min {min(times):.3f})", flush=True)


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
    dev = torch.device("cuda", 0)
    log_pi, log_A, W, feats, w = inputs(dev)
    pi_t, A_t = torch.exp(log_pi).contiguous(), torch.exp(log_A).contiguous()
    alpha, s, sh = fused_fb.fused_forward(pi_t, A_t, W, feats)
    print(f"package {pysvihmm_tpu_torch.__file__}; (B, T, K, F) = ({B}, {T}, {K}, "
          f"{feats.shape[-1]})", flush=True)
    runs = {
        "fused_fwd_kernel": lambda: fused_fb.fused_forward(pi_t, A_t, W, feats),
        "fused_bwd_kernel": lambda: fused_fb.fused_backward(A_t, W, feats, alpha, s, sh),
        "fused_bwd_kernel, gated": lambda: fused_fb.fused_backward(A_t, W, feats, alpha, s,
                                                                   sh, False, w),
        "estep_fused": lambda: fused_fb.estep_fused(log_pi, log_A, W, feats),
    }
    for name, fn in runs.items():
        report(name, [cuda_ms(fn, 20, warmup=3) for _ in range(reps)])
    del alpha, s, sh, feats, w
    svi_steps(dev, reps)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
