"""Structured metrics logging (port of ``pysvihmm_tpu/utils/logging.py``):
JSONL records with wall-clock stamps, and a profiler trace around a hot
region."""

from __future__ import annotations

import json
import sys
import time
from typing import IO, Any

import numpy as np
import torch


class MetricsLogger:
    """Append-only JSONL metrics writer with wall-clock stamps.

    Values may be tensors on any device, NumPy arrays or scalars, or Python
    values; tensors and arrays are written as (nested) lists or numbers.

        log = MetricsLogger("run.jsonl")
        log.write(step=10, elbo=-123.4, rho=torch.tensor(0.05))
    """

    def __init__(self, path: str | None = None, echo: bool = True):
        self._fh: IO[str] | None = open(path, "a") if path else None
        self._echo = echo
        self._t0 = time.perf_counter()

    def write(self, **metrics: Any) -> None:
        rec = {"wall_s": round(time.perf_counter() - self._t0, 4)}
        for k, v in metrics.items():
            if isinstance(v, torch.Tensor):
                v = v.detach().cpu().tolist()
            elif isinstance(v, (np.ndarray, np.generic)):
                v = v.tolist()
            rec[k] = v
        line = json.dumps(rec)
        if self._fh is not None:
            self._fh.write(line + "\n")
            self._fh.flush()
        if self._echo:
            print(line, file=sys.stderr)

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None


def profile_trace(log_dir: str) -> torch.profiler.profile:
    """A ``torch.profiler.profile`` context over every activity this build
    of torch can trace (the card's kernels where there is one) that writes
    a Chrome trace (``*.pt.trace.json``, which TensorBoard and Perfetto
    read) into ``log_dir`` when it exits."""
    return torch.profiler.profile(
        activities=list(torch.profiler.supported_activities()),
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir),
    )
