"""The large-K statistics' outer sums (``fused_fb.outer_sum``) on the CPU.

On a CPU tensor the wrapper runs its plain twin, X^T Y; here that twin is
held to the reference's own contraction, the body of ``outer_acc``
(pysvihmm_tpu/messages/pallas_fb.py:664-665): ``_kdot`` over axis 0 at the
"bf16x3" tier, called as a plain JAX function on the CPU (no Pallas, no
kernel compile). The wrapper's refusals and the roofline's count of the
sums' work are checked too. The kernel itself (3xTF32 on the tensor cores)
is held to float64 and to float32 ``torch.matmul`` on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysvihmm_tpu.messages.pallas_fb import _kdot
from pysvihmm_tpu_torch.messages import fused_fb
from pysvihmm_tpu_torch.utils import roofline


def _operands(N, I, J, seed):
    """X like the statistics' left operands (probabilities in [0, 1)), Y
    signed like the features, float32, from one NumPy seed."""
    rng = np.random.default_rng(seed)
    X = rng.random((N, I), dtype=np.float32)
    Y = rng.standard_normal((N, J), dtype=np.float32)
    return X, Y


def test_cpu_tensors_run_the_twin():
    X, Y = _operands(50, 65, 45, 0)
    tx, ty = torch.from_numpy(X), torch.from_numpy(Y)
    before = fused_fb.outer_sum.launches
    out = fused_fb.outer_sum(tx, ty)
    assert fused_fb.outer_sum.launches == before
    assert out.shape == (65, 45) and out.dtype == torch.float32
    assert torch.equal(out, fused_fb.outer_sum_reference(tx, ty))
    assert torch.equal(out, tx.T @ ty)


@pytest.mark.parametrize("X,Y", [
    (torch.zeros(8), torch.zeros(8, 4)),                            # X 1-D
    (torch.zeros(8, 4), torch.zeros(7, 4)),                         # rows differ
    (torch.zeros(8, 4, dtype=torch.float64), torch.zeros(8, 4)),    # dtype
    (torch.zeros(8, 4), torch.zeros(8, 4, dtype=torch.int32)),      # dtype
    (torch.zeros(4, 8).T, torch.zeros(8, 4)),                       # not contiguous
    (torch.zeros(0, 4), torch.zeros(0, 4)),                         # no rows
    (torch.zeros(8, 1025), torch.zeros(8, 4)),                      # I > 1024
    (torch.zeros(8, 4), torch.zeros(8, 0)),                         # J = 0
])
def test_refuses_bad_operands(X, Y):
    with pytest.raises(ValueError):
        fused_fb.outer_sum(X, Y)


@pytest.mark.parametrize("N,I,J", [(300, 129, 45), (300, 256, 256)])
def test_matches_the_reference_contraction(N, I, J):
    """The reference's bf16x3 sum is about 2^-21 relative a product (three
    bf16 passes, pallas_fb.py:241-265); the twin is float32: 1e-5 of the
    largest entry bounds both with room."""
    X, Y = _operands(N, I, J, N + I + J)
    ref = np.asarray(_kdot(jnp.asarray(X), jnp.asarray(Y), (((0,), (0,)), ((), ())), "bf16x3"))
    got = fused_fb.outer_sum(torch.from_numpy(X), torch.from_numpy(Y)).numpy()
    exact = X.astype(np.float64).T @ Y.astype(np.float64)
    scale = np.abs(exact).max()
    assert ref.shape == got.shape == (I, J)
    assert np.abs(got - ref).max() <= 1e-5 * scale
    assert np.abs(got - exact).max() <= 1e-6 * scale


@pytest.mark.parametrize("K,F", [(256, 45), (128, 45), (256, 0)])
def test_roofline_counts_the_sums_of_one_backward(K, F):
    """acc over the (T - 1) B rows t >= 1, eacc over the T B rows: at K =
    256, F = 45, B = 1024, T = 1000 that is 157.7 GFLOP and 3.33 GB, a bound
    of 0.99 ms set by the bytes (0.96 ms of 3xTF32 operations)."""
    B, T = 1024, 1000
    nbytes, flops, rate = roofline.kernel_work("outer_sums", B, T, K, F)
    rows_a, rows_e = 999 * 1024, (1000 * 1024 if F else 0)
    assert flops == 2 * rows_a * K * K + 2 * rows_e * K * F
    assert nbytes == 4 * (2 * rows_a * K + rows_e * (K + F) + K * K + K * F)
    assert rate == roofline.TF32_FLOP_PER_S / 3 == 165e12
    if (K, F) == (256, 45):
        assert flops == pytest.approx(157.7e9, rel=1e-3)
        assert nbytes == pytest.approx(3.33e9, rel=1e-3)
        ms, by = roofline.bound(nbytes, flops, rate)
        assert by == "bytes" and ms == pytest.approx(0.99, rel=5e-3)
        assert flops / rate * 1e3 == pytest.approx(0.96, rel=5e-3)
