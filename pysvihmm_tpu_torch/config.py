"""Unified configuration with CLI binding for the runners (port of
``pysvihmm_tpu/config.py``).

The dataclasses, fields, defaults and flags are JAX's, so ``parse_config``
gives the values JAX's gives for the same argv, and one field more:
``run.device`` (``--device``, default ``cuda``), the device the runners put
their data and state on. ``--method`` takes what
``messages.resolve_method`` takes; JAX's other E-step names raise.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, field

from .messages import METHODS


@dataclass
class ModelConfig:
    K: int = 4  # hidden states
    emission: str = "gaussian"  # "gaussian" | "diag_gaussian" | "multinomial" | "poisson"
    obs_dim: int = 2  # D (gaussian)
    num_symbols: int = 32  # V (multinomial)
    alpha_init: float = 1.0  # Dirichlet prior on pi
    alpha_tran: float = 1.0  # Dirichlet prior on A rows
    niw_kappa: float = 1.0
    niw_nu: float | None = None  # default D + 2
    niw_psi_scale: float = 1.0


@dataclass
class SVIHyperConfig:
    batch_size: int = 32
    subchain_len: int = 50
    buffer: int = 10
    tau: float = 1.0
    kappa: float = 0.6
    adaptive: bool = False  # elastic step-size adaptation


@dataclass
class RunConfig:
    engine: str = "batch_vb"  # batch_vb | batch_sgd | svi | metaobs | gibbs
    num_iters: int = 100
    method: str = "auto"  # e-step route: auto | scan | fused | split | duplex
    seed: int = 0
    mesh_devices: int = 0  # 0 = all; parsed and not read, as in JAX
    checkpoint_dir: str = ""
    checkpoint_every: int = 0
    log_every: int = 10
    log_path: str = ""  # JSONL metrics file (echoes to stderr regardless)
    dtype: str = "float32"
    # Held-out predictive-log-likelihood tracking: every N iterations, pause
    # the fit and score `holdout_seqs` held-out sequences (split from the
    # SAME synthetic dataset). 0 disables.
    pred_ll_every: int = 0
    holdout_seqs: int = 8
    # NaN debugging. torch has no op-level counterpart of jax_debug_nans, so
    # the runner instead runs one iteration at a time, reads every metric and
    # parameter's finiteness to the host after each (one read an
    # iteration) and raises FloatingPointError naming the first non-finite
    # leaf and the iteration.
    debug_nans: bool = False
    device: str = "cuda"  # the port's own: where data and state live


@dataclass
class Config:
    model: ModelConfig = field(default_factory=ModelConfig)
    svi: SVIHyperConfig = field(default_factory=SVIHyperConfig)
    run: RunConfig = field(default_factory=RunConfig)


def _add_dataclass_args(parser: argparse.ArgumentParser, dc, prefix: str) -> None:
    for f in dataclasses.fields(dc):
        arg = f"--{prefix}{f.name.replace('_', '-')}"
        default = getattr(dc, f.name)
        if isinstance(default, bool):
            parser.add_argument(arg, type=lambda s: s.lower() in ("1", "true", "yes"),
                                default=default)
        elif default is None:
            parser.add_argument(arg, type=float, default=None)
        else:
            parser.add_argument(arg, type=type(default), default=default)


def parse_config(argv: list[str] | None = None) -> Config:
    """Build a Config from CLI flags (--k, --svi-batch-size, --engine, ...).

    Raises ``ValueError`` for a ``--method`` the port does not have (JAX's
    "pallas", "pallas_fused", "grad", ...). ``--mesh-devices`` is parsed and
    not acted on, as in JAX: the experiment runner is one process."""
    cfg = Config()
    parser = argparse.ArgumentParser(description="pysvihmm_tpu_torch runner")
    _add_dataclass_args(parser, cfg.model, "")
    _add_dataclass_args(parser, cfg.svi, "svi-")
    _add_dataclass_args(parser, cfg.run, "")
    ns = parser.parse_args(argv)
    for f in dataclasses.fields(cfg.model):
        setattr(cfg.model, f.name, getattr(ns, f.name))
    for f in dataclasses.fields(cfg.svi):
        setattr(cfg.svi, f.name, getattr(ns, f"svi_{f.name}"))
    for f in dataclasses.fields(cfg.run):
        setattr(cfg.run, f.name, getattr(ns, f.name))
    if cfg.run.method not in ("auto", *METHODS):
        raise ValueError(f"--method {cfg.run.method!r} is not a method of the port; expected "
                         f"one of {('auto', *METHODS)}")
    return cfg
