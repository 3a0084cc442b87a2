"""Munkres-matched Hamming error (port of ``pysvihmm_tpu/eval/metrics.py``).

State labels are unidentifiable, so the error-minimising relabelling is
found first (scipy's Hungarian solver on the K x K cost matrix, on the
host). Inputs may be NumPy arrays or tensors on any device.
"""

from __future__ import annotations

import numpy as np
from scipy.optimize import linear_sum_assignment


def _flat_int(x) -> np.ndarray:
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1)


def best_permutation(est, true, K: int) -> np.ndarray:
    """Permutation perm maximising agreement of perm[est] with true."""
    est, true = _flat_int(est), _flat_int(true)
    cost = np.zeros((K, K))
    for i in range(K):
        mask = est == i
        if mask.any():
            cost[i] = -np.bincount(true[mask], minlength=K)
    rows, cols = linear_sum_assignment(cost)
    perm = np.arange(K)
    perm[rows] = cols
    return perm


def hamming_error(est, true, K: int) -> float:
    """Fraction of mismatched states after optimal relabelling, in [0, 1]."""
    est, true = _flat_int(est), _flat_int(true)
    perm = best_permutation(est, true, K)
    return float(np.mean(perm[est] != true))


def hamming_error_long(est, true, K: int) -> float:
    """Matched Hamming error for decodes of T = 10M+ steps that stay on
    their device.

    The K x K confusion matrix is ONE ``torch.bincount`` over est * K + true
    on the labels' device, in int64 (no int32 overflow at any T); only that
    matrix goes to the host for the assignment. est, true: (T,) int tensors
    on one device, or arrays. Returns the same value as :func:`hamming_error`.
    """
    import torch

    est = torch.as_tensor(est).reshape(-1).long()
    true = torch.as_tensor(true, device=est.device).reshape(-1).long()
    conf = torch.bincount(est * K + true, minlength=K * K).cpu().numpy().reshape(K, K)
    rows, cols = linear_sum_assignment(-conf)
    total = int(conf.sum())
    return float((total - int(conf[rows, cols].sum())) / total)
