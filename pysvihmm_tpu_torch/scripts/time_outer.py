"""Time the large-K statistics' outer sums alone (``fused_fb.outer_sum``,
``csrc/fb_stats.cuh``: 3xTF32 on the tensor cores, chunked in an order
fixed by the shapes) on the card, beside one float32 ``torch.matmul`` on
the same operands, at the products one window of the backward sums: N =
2^17 rows (a window at B = 1024), X (N, I) in [0, 1) as alpha or gamma,
Y (N, J) signed as dn or the features, from a seeded generator.

Usage, on a machine with an NVIDIA GPU and nvcc, from the repository root::

    PYTHONPATH=<checkout> python pysvihmm_tpu_torch/scripts/time_outer.py [reps] [I:J,...]

It imports the ``pysvihmm_tpu_torch`` of ``<checkout>`` (``.`` for this
one) and calls only ``fused_fb.outer_sum``, so two checkouts (say, two
chunking rules) are compared in one call, in turns. The default shapes are
acc and eacc (F = 45) at K = 512 and 1024, acc at K = 256, and eacc at
K = 64 and 256 for F = 325 and 820. Each line gives ms per call by CUDA
events (20 calls after 3 warm-ups), ``reps`` times (default 3), their
median and minimum, torch.matmul's median, the largest error against
float64 relative to the largest entry, and the result's sha256 (two
chunkings give other bits); a shape the checkout's ``outer_sum`` refuses
is reported as such. The last line is the card's name and power limit.
Without a card it raises.
"""

from __future__ import annotations

import hashlib
import statistics
import sys

import torch

import pysvihmm_tpu_torch
from pysvihmm_tpu_torch.messages import fused_fb
from pysvihmm_tpu_torch.scripts.debug_split import card_line, cuda_ms

N = 1 << 17
SHAPES = ((512, 512), (512, 45), (1024, 1024), (1024, 45), (256, 256), (64, 820), (64, 325),
          (256, 820))


def main() -> None:
    reps = int(sys.argv[1]) if len(sys.argv) > 1 else 3
    shapes = (tuple(tuple(int(x) for x in s.split(":")) for s in sys.argv[2].split(","))
              if len(sys.argv) > 2 else SHAPES)
    if not torch.cuda.is_available():
        raise RuntimeError("time_outer.py needs an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    print(f"checkout {pysvihmm_tpu_torch.__file__}", flush=True)
    for I, J in shapes:
        gen = torch.Generator(device=dev).manual_seed(I * 10_000 + J)
        X = torch.rand((N, I), generator=gen, device=dev)
        Y = torch.randn((N, J), generator=gen, device=dev)
        try:
            out = fused_fb.outer_sum(X, Y)
        except ValueError as e:
            print(f"I={I} J={J}: refused ({e})", flush=True)
            continue
        ref = X.double().T @ Y.double()
        err = ((out.double() - ref).abs().max() / ref.abs().max()).item()
        digest = hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]
        ms = [cuda_ms(lambda: fused_fb.outer_sum(X, Y), 20, warmup=3) for _ in range(reps)]
        mm = [cuda_ms(lambda: torch.matmul(X.T, Y), 20, warmup=3) for _ in range(reps)]
        print(f"N={N} I={I} J={J}: outer_sum median {statistics.median(ms):.4f} ms, min "
              f"{min(ms):.4f}; torch.matmul float32 median {statistics.median(mm):.4f} ms; "
              f"error {err:.2e} of max|ref|; sha256 {digest}", flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
