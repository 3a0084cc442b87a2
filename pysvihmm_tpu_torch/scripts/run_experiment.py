"""Experiment runner (port of ``scripts/run_experiment.py``): generate data,
run a configured engine, log JSONL metrics, optionally checkpoint.

    python -m pysvihmm_tpu_torch experiment --engine batch_vb --K 4 --num-iters 50
    python -m pysvihmm_tpu_torch experiment --engine svi --K 16 --svi-batch-size 32 \\
        --svi-subchain-len 50 --num-iters 2000 --log-every 100 --pred-ll-every 100

Data and state live on ``--device`` (default ``cuda``; ``--device cpu`` runs
on the CPU). The data are drawn from ``torch.Generator(device)`` seeded with
``--seed``, the initial parameters with seed + 1 and the SVI or Gibbs state
with seed + 2, so the numbers are the port's own, not JAX's. With
``--pred-ll-every N`` the last ``--holdout-seqs`` sequences are held out
and the fit runs in N-iteration segments; after each, the runner logs the
cumulative training wall clock (evaluation excluded) and the held-out
predictive log-likelihood per observation. With ``--debug-nans true`` the
fit runs one iteration a segment and raises ``FloatingPointError`` at the
first non-finite metric or parameter. The last record is
``{"event": "done", "hamming": ..., "final_elbo": ..., ...}``.
"""

from __future__ import annotations

import time

import torch

from ..config import parse_config
from ..data.synthetic import (
    gen_diag_gaussian_dataset,
    gen_gaussian_dataset,
    gen_multinomial_dataset,
    gen_poisson_dataset,
)
from ..engines import batch_sgd, batch_vb, gibbs, metaobs, svi
from ..engines.base import decode, lower_bound, predictive_log_likelihood
from ..eval.metrics import hamming_error
from ..models.hmm import init_params, make_prior, resolve_emission
from ..utils import checkpoint
from ..utils.logging import MetricsLogger


def _dataset(model, gen: torch.Generator):
    """(obs, true states, the prior's size keyword) of the configured family:
    64 sequences of T = 500."""
    K, D = model.K, model.obs_dim
    if model.emission == "gaussian":
        obs, z, _ = gen_gaussian_dataset(gen, K, D, 64, 500, mean_scale=6.0, cov_scale=0.3)
    elif model.emission == "diag_gaussian":
        obs, z, _ = gen_diag_gaussian_dataset(gen, K, D, 64, 500, mean_scale=6.0, var_scale=0.3)
    elif model.emission == "poisson":
        obs, z, _ = gen_poisson_dataset(gen, K, D, 64, 500, rate_scale=25.0)
    else:
        obs, z, _ = gen_multinomial_dataset(gen, K, model.num_symbols, 64, 500)
        return obs, z, dict(num_symbols=model.num_symbols)
    return obs, z, dict(obs_dim=D)


def require_finite(what: str, step: int, tree) -> None:
    """Raise ``FloatingPointError`` naming the first non-finite tensor of
    ``tree`` (a dict, (named) tuples and tensors; depth first), with one host
    read for all of them (``--debug-nans``)."""
    named = []

    def walk(prefix, node):
        if isinstance(node, torch.Tensor):
            if node.is_floating_point():
                named.append((prefix, node))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}.{k}" if prefix else k, v)
        elif isinstance(node, tuple):
            fields = getattr(node, "_fields", range(len(node)))
            for k, v in zip(fields, node):
                walk(f"{prefix}.{k}" if prefix else str(k), v)

    walk("", tree)
    ok = torch.stack([torch.isfinite(x).all() for _, x in named]).tolist()
    for (name, _), good in zip(named, ok):
        if not good:
            raise FloatingPointError(f"{what}: non-finite {name} after iteration {step}")


def main(argv=None) -> int:
    cfg = parse_config(argv)
    dev = torch.device(cfg.run.device)
    seed = cfg.run.seed
    log = MetricsLogger(cfg.run.log_path or None)
    emission = resolve_emission(cfg.model.emission)  # raises on unknown names
    obs, z_true, size_kw = _dataset(cfg.model, torch.Generator(dev).manual_seed(seed))
    prior = make_prior(cfg.model.K, emission, alpha_init=cfg.model.alpha_init,
                       alpha_tran=cfg.model.alpha_tran, device=dev, **size_kw)

    # Held-out split of the same dataset (same true params): the last
    # sequences.
    track_pred = cfg.run.pred_ll_every > 0 and cfg.run.engine != "gibbs"
    held, n_held_obs = None, 0
    if track_pred:
        h = max(1, cfg.run.holdout_seqs)
        held, obs, z_true = obs[-h:], obs[:-h], z_true[:-h]
        n_held_obs = held.shape[0] * held.shape[1]

    params = init_params(torch.Generator(dev).manual_seed(seed + 1), prior, emission, obs)

    def eval_pred(p):
        return float(predictive_log_likelihood(p, emission, held)) / n_held_obs

    engine, method, num_iters = cfg.run.engine, cfg.run.method, cfg.run.num_iters
    chain = obs.reshape(-1, *obs.shape[2:])  # the sequences as one chain (svi, metaobs)
    if engine in ("batch_vb", "batch_sgd"):
        state = batch_sgd.init_state(params)

        def segment(st, n):
            if engine == "batch_vb":
                p, elbos = batch_vb.fit(st.params, prior, obs, emission, n, method)
                return st._replace(params=p), {"elbo": elbos}
            st, elbos = batch_sgd.fit_state(st, prior, obs, emission, n, cfg.svi.tau,
                                            cfg.svi.kappa, method)
            return st, {"elbo": elbos}
    elif engine in ("svi", "metaobs"):
        state = svi.init_state(params, torch.Generator(dev).manual_seed(seed + 2))
        if engine == "svi":
            c = svi.SVIConfig(batch_size=cfg.svi.batch_size, subchain_len=cfg.svi.subchain_len,
                              buffer=cfg.svi.buffer, tau=cfg.svi.tau, kappa=cfg.svi.kappa)
            fit = svi.fit
        else:
            c = metaobs.MetaObsConfig(minibatch=cfg.svi.batch_size,
                                      block_len=cfg.svi.subchain_len, buffer=cfg.svi.buffer,
                                      tau=cfg.svi.tau, kappa=cfg.svi.kappa)
            fit = metaobs.fit

        def segment(st, n):
            st, m = fit(st, prior, chain, emission, c, n, method)
            return st, {"noisy_elbo": m["noisy_elbo"]}
    elif engine == "gibbs":
        state = gibbs.init_state(torch.Generator(dev).manual_seed(seed + 2), prior, emission,
                                 obs, cfg.model.K)

        def segment(st, n):
            st, m = gibbs.run(st, prior, obs, emission, cfg.model.K, n)
            return st, {"marginal_loglik": m["marginal_loglik"]}
    else:
        raise SystemExit(f"unknown engine {engine}")

    # segments: --pred-ll-every iterations with pred-LL tracking, one with
    # --debug-nans, else the whole fit at once
    seg = 1 if cfg.run.debug_nans else (cfg.run.pred_ll_every if track_pred else num_iters)
    train_wall, history, done = 0.0, [], 0
    t_start = time.perf_counter()
    while done < num_iters:
        n = min(seg, num_iters - done)
        t0 = time.perf_counter()
        state, metrics = segment(state, n)
        (key, values), = metrics.items()
        history.append(values.cpu())  # the host read ends the segment's device work
        train_wall += time.perf_counter() - t0
        done += n
        if cfg.run.debug_nans:
            require_finite(engine, done, {"metrics": metrics, "state": state})
        if track_pred:
            log.write(step=done, wall_s=train_wall, pred_ll=eval_pred(state.params))
    values = torch.cat(history).double().numpy()
    for i in range(0, len(values), cfg.run.log_every):
        log.write(step=i, **{key: float(values[i])})
    if engine in ("svi", "metaobs") and cfg.run.checkpoint_dir:
        checkpoint.save_step(cfg.run.checkpoint_dir, int(state.step), state)

    wall = time.perf_counter() - t_start
    if engine == "gibbs":
        z_hat, final_elbo = state.z, None
    else:
        params = state.params
        z_hat = decode(params, emission, obs)
        final_elbo = float(lower_bound(params, prior, emission, obs))
    err = hamming_error(z_hat, z_true, cfg.model.K)
    final_pred = eval_pred(state.params) if track_pred else None
    log.write(event="done", wall_s=wall, train_wall_s=train_wall, hamming=err,
              final_elbo=final_elbo, final_pred_ll=final_pred)
    log.close()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
