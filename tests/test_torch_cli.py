"""The port's user surface on the CPU: ``config.parse_config`` against JAX's,
the package CLI (``python -m pysvihmm_tpu_torch``), the two runners,
``hamming_error_long``, ``MetricsLogger`` and ``profile_trace``, and the
refusal of every new entry point to fall back to the CPU without a card.
"""

import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest
import torch

from pysvihmm_tpu.config import parse_config as jparse_config
from pysvihmm_tpu.eval.metrics import hamming_error_long as jhamming_error_long
from pysvihmm_tpu_torch import __main__ as cli
from pysvihmm_tpu_torch.config import parse_config
from pysvihmm_tpu_torch.distributions import GaussianNIW
from pysvihmm_tpu_torch.engines import svi
from pysvihmm_tpu_torch.eval.metrics import hamming_error, hamming_error_long
from pysvihmm_tpu_torch.models.hmm import init_params, make_prior
from pysvihmm_tpu_torch.scripts import run_baseline_configs, run_experiment
from pysvihmm_tpu_torch.utils import checkpoint
from pysvihmm_tpu_torch.utils.logging import MetricsLogger, profile_trace

torch.set_num_threads(1)

ARGVS = [
    [],
    ["--K", "64", "--obs-dim", "8", "--engine", "svi", "--svi-batch-size", "1024"],
    ["--emission", "multinomial", "--num-symbols", "48", "--alpha-init", "0.5"],
    ["--niw-nu", "7.5", "--niw-kappa", "0.1", "--niw-psi-scale", "2"],
    ["--svi-adaptive", "true", "--svi-tau", "5", "--svi-kappa", "0.75", "--svi-buffer", "4",
     "--svi-subchain-len", "30"],
    ["--method", "scan", "--seed", "3", "--num-iters", "7", "--log-every", "2",
     "--checkpoint-dir", "ck", "--checkpoint-every", "5", "--log-path", "x.jsonl"],
    ["--pred-ll-every", "10", "--holdout-seqs", "4", "--debug-nans", "yes", "--dtype",
     "float64", "--mesh-devices", "1", "--engine", "gibbs"],
    ["--svi-adaptive", "no", "--debug-nans", "0", "--emission", "poisson", "--method", "auto"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_parse_config_is_jax_field_for_field(argv):
    mine, theirs = parse_config(argv), jparse_config(argv)
    for part in ("model", "svi", "run"):
        got = dataclasses.asdict(getattr(mine, part))
        want = dataclasses.asdict(getattr(theirs, part))
        assert {k: got[k] for k in want} == want
        assert set(got) - set(want) == ({"device"} if part == "run" else set())
    assert mine.run.device == "cuda"


@pytest.mark.parametrize("method", ["pallas", "pallas_fused", "grad"])
def test_jax_only_methods_raise_with_the_ports_names(method):
    with pytest.raises(ValueError, match="fused.*split.*duplex"):
        parse_config(["--method", method])


@pytest.mark.parametrize("method", ["assoc", "blocked"])
def test_experiment_runs_assoc_and_blocked(tmp_path, method):
    """--method assoc and --method blocked are the port's: batch VB through
    ``experiment`` for a few iterations, every ELBO finite."""
    log = tmp_path / "run.jsonl"
    assert parse_config(["--method", method]).run.method == method
    assert cli.main(["experiment", "--engine", "batch_vb", "--K", "3", "--device", "cpu",
                     "--num-iters", "4", "--log-every", "1", "--method", method,
                     "--log-path", str(log)]) == 0
    recs = _records(log)
    elbos = [r["elbo"] for r in recs if "elbo" in r]
    assert len(elbos) == 4 and all(math.isfinite(e) for e in elbos)
    assert recs[-1]["event"] == "done" and math.isfinite(recs[-1]["final_elbo"])


def test_mesh_devices_above_one_raise():
    """--mesh-devices above 1 is parsed and not acted on, as in JAX (the
    experiment runner is one process); nothing raises."""
    assert parse_config(["--mesh-devices", "4"]).run.mesh_devices == 4


@pytest.mark.parametrize("argv,code,text", [
    ([], 0, "experiment"), (["--help"], 0, "baseline"), (["frobnicate"], 2, "unknown command"),
    (["bench"], 2, "Queue 1 item 1")])
def test_cli_exit_codes(capsys, argv, code, text):
    assert cli.main(argv) == code
    out = capsys.readouterr()
    assert text in out.out + out.err


def _records(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


@pytest.mark.parametrize("engine", ["batch_vb", "batch_sgd", "svi", "metaobs", "gibbs"])
def test_experiment_end_to_end(tmp_path, engine):
    log = tmp_path / "run.jsonl"
    argv = ["experiment", "--engine", engine, "--K", "4", "--device", "cpu", "--num-iters", "6",
            "--log-every", "2", "--log-path", str(log), "--checkpoint-dir", str(tmp_path / "ck")]
    if engine != "gibbs":
        argv += ["--pred-ll-every", "3", "--holdout-seqs", "4"]
    assert cli.main(argv) == 0
    recs = _records(log)
    done = recs[-1]
    assert done["event"] == "done" and 0.0 <= done["hamming"] <= 1.0
    assert math.isfinite(done["wall_s"]) and math.isfinite(done["train_wall_s"])
    key = {"batch_vb": "elbo", "batch_sgd": "elbo", "gibbs": "marginal_loglik"}.get(
        engine, "noisy_elbo")
    steps = [r for r in recs if key in r]
    assert [r["step"] for r in steps] == [0, 2, 4]
    assert all(math.isfinite(r[key]) for r in steps)
    if engine == "gibbs":
        assert done["final_elbo"] is None and done["final_pred_ll"] is None
        return
    assert math.isfinite(done["final_elbo"]) and math.isfinite(done["final_pred_ll"])
    assert [r["step"] for r in recs if "pred_ll" in r] == [3, 6]
    path = checkpoint.latest_step_path(str(tmp_path / "ck"))
    if engine not in ("svi", "metaobs"):
        assert path is None
        return
    assert path.endswith("ckpt_6.pt")
    prior = make_prior(4, GaussianNIW, obs_dim=2, device="cpu")
    target = svi.init_state(init_params(torch.Generator().manual_seed(0), prior, GaussianNIW),
                            torch.Generator())
    state = checkpoint.restore(path, target)
    assert int(state.step) == 6 and torch.isfinite(state.params.emit.psi).all()


def test_experiment_debug_nans_checks_every_iteration(tmp_path, monkeypatch):
    """--debug-nans runs one iteration a segment and raises at the first
    non-finite leaf, naming it and the iteration."""
    seen = []
    real = run_experiment.require_finite

    def spy(what, step, tree):
        seen.append(step)
        if step == 3:
            tree["state"].params.trans[0, 0] = math.nan
        real(what, step, tree)

    monkeypatch.setattr(run_experiment, "require_finite", spy)
    with pytest.raises(FloatingPointError, match="state.params.trans after iteration 3"):
        run_experiment.main(["--engine", "batch_sgd", "--K", "3", "--device", "cpu",
                             "--num-iters", "5", "--debug-nans", "true"])
    assert seen == [1, 2, 3]


def test_baseline_configs_1_2_3_on_cpu(capsys):
    assert cli.main(["baseline", "--scale", "0.1", "--configs", "1,2,3", "--device",
                     "cpu"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    by = {r.get("config"): r for r in recs}
    assert by[1]["elbo_monotone"] and by[1]["hamming"] < 0.05
    assert by[2]["hamming"] < 0.15
    assert by[3]["pred_ll_per_obs"] > by[3]["uniform_baseline"]
    assert recs[-1] == {"event": "all_configs_done", "configs": [1, 2, 3]}


@pytest.mark.parametrize("config,item", [("4,5", "item 7"), ("5", "item 7"), ("1,5", "item 7")])
def test_baseline_configs_4_and_5_raise(config, item, capsys):
    """Config 5 (ROADMAP Queue 1 ``item``) runs beside the others at a small
    scale: data-parallel SVI over a gloo group of this one process, which
    the runner starts and takes down again."""
    assert run_baseline_configs.main(["--configs", config, "--scale", "0.01",
                                      "--device", "cpu"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    by = {r.get("config"): r for r in recs}
    assert by[5]["processes"] == 1 and by[5]["hamming"] < 0.15
    assert recs[-1] == {"event": "all_configs_done",
                        "configs": sorted(int(c) for c in config.split(","))}
    assert not torch.distributed.is_initialized()


def test_baseline_config_4_on_cpu(capsys):
    """Config 4 at a small scale: the exact long-chain E-step's log Z is
    finite and SVI's Hamming error on the chain lies in [0, 1]."""
    assert cli.main(["baseline", "--scale", "0.01", "--configs", "4", "--device", "cpu"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    rec = recs[0]
    assert rec["config"] == 4 and rec["T"] == 10_000
    assert math.isfinite(rec["exact_blocked_logz"]) and 0.0 <= rec["svi_hamming"] <= 1.0
    assert recs[-1] == {"event": "all_configs_done", "configs": [4]}


@pytest.mark.parametrize("K,T,noise", [(4, 1000, 0.1), (64, 100_000, 0.3), (7, 5, 0.0)])
def test_hamming_error_long(K, T, noise):
    rng = np.random.default_rng(K + T)
    true = rng.integers(0, K, size=T)
    perm = rng.permutation(K)
    est = np.where(rng.random(T) < noise, rng.integers(0, K, size=T), perm[true])
    got = hamming_error_long(torch.tensor(est), torch.tensor(true), K)
    assert got == hamming_error(est, true, K)
    assert abs(got - jhamming_error_long(est, true, K)) <= 1e-12
    assert hamming_error_long(est.astype(np.int32), true, K) == got


def test_metrics_logger_takes_tensors(tmp_path, capsys):
    path = tmp_path / "m.jsonl"
    log = MetricsLogger(str(path))
    log.write(step=1, elbo=torch.tensor(-1.5, dtype=torch.float64), rho=np.float32(0.25),
              v=torch.arange(3), a=np.ones((2, 1)), name="x")
    log.close()
    rec = _records(path)[0]
    assert rec["elbo"] == -1.5 and rec["rho"] == 0.25 and rec["v"] == [0, 1, 2]
    assert rec["a"] == [[1.0], [1.0]] and rec["name"] == "x" and rec["wall_s"] >= 0
    assert json.loads(capsys.readouterr().err.strip()) == rec


def test_profile_trace_writes_a_trace(tmp_path):
    d = tmp_path / "trace"
    with profile_trace(str(d)):
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = [f for f in os.listdir(d) if f.endswith(".pt.trace.json")]
    assert len(files) == 1
    events = json.loads((d / files[0]).read_text())["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "") for e in events)


NO_CARD_ENTRY_POINTS = {
    "experiment": lambda tmp: run_experiment.main(["--K", "3", "--num-iters", "1"]),
    "baseline": lambda tmp: run_baseline_configs.main(["--configs", "1"]),
    "compat": lambda tmp: __import__("pysvihmm_tpu_torch.compat", fromlist=["VBHMM"]).VBHMM(
        np.zeros((2, 10, 2), np.float32), K=2),
    "loader": lambda tmp: __import__("pysvihmm_tpu_torch.data.loader", fromlist=["x"])
    .ShardedSequenceLoader(lambda s, e: np.zeros((e - s, 4, 2), np.float32), 8, None, 4),
}


@pytest.mark.parametrize("name", sorted(NO_CARD_ENTRY_POINTS))
def test_entry_points_need_a_card_unless_given_cpu(tmp_path, name):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the entry point runs on it")
    with pytest.raises((RuntimeError, AssertionError)):
        NO_CARD_ENTRY_POINTS[name](tmp_path)


def test_jax_is_not_imported_by_the_port():
    """The port's modules of this slice import neither JAX nor the JAX
    package (the tests import both)."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent / "pysvihmm_tpu_torch"
    for path in root.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for n in names:
                assert n.split(".")[0] not in ("jax", "pysvihmm_tpu"), (path, n)
    assert jax.__name__ == "jax"
