"""Matmul precision policy of the port: float32, or its 3xTF32 equal.

The counterpart of ``pysvihmm_tpu/utils/precision.py``. Message passing
compounds rounding over T steps, and the NIW posterior's second moments sit
a thin PSD margin above their noise, so the port runs every float32 matrix
product of PyTorch in full float32. On an NVIDIA GPU that means TF32 off for
both cuBLAS matmuls and cuDNN, which PyTorch does not guarantee by default
(cuDNN's TF32 is on unless turned off).

The hand-written kernels need no switch. Their recursions and the K <= 64
statistics use plain float32 FMAs. The large-K statistics' outer sums
(``csrc/fb_stats.cuh``, acc and eacc above 64 states) run on the tensor
cores at 3xTF32: each operand splits into a TF32 big part and a TF32
remainder, and big.small + small.big + big.big add into float32 sums, about
2^-22 relative a product. That is the counterpart of the reference's
default stats tier, "bf16x3" (three MXU passes over hi / lo bf16 parts,
``pysvihmm_tpu/messages/pallas_fb.py::_kdot``, about 2e-6 relative against
HIGHEST, a ~1000x margin to the NIW-psi hazard that a 1-pass sum trips).
The tier is the default because it passed ``chip_smoke.py`` phase 3's gate
on the card: on the windows a backward sums, its error against float64 is
at most twice float32 ``torch.matmul``'s, and phase 9's batch VB at K = 256
and SVI at K = 128 (every psi factorisable after every step) hold.
"""

from __future__ import annotations

import torch


def f32_matmuls() -> dict[str, object]:
    """Set the full-float32 policy and return it as it now stands.

    Sets ``torch.backends.cuda.matmul.allow_tf32 = False``,
    ``torch.backends.cudnn.allow_tf32 = False`` and
    ``torch.set_float32_matmul_precision("highest")``. The engines call it
    at every entry; it is idempotent and cheap.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    return {
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }
