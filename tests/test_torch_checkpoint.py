"""Checkpoint and resume of the port's training state
(pysvihmm_tpu_torch/utils/checkpoint.py), on the CPU: the counterparts of
tests/test_checkpoint.py's msgpack-tier tests, plus what the torch format
adds (``weights_only`` loading, the generator's state, refusals).

The data are JAX's (its ``gen_gaussian_dataset`` at the seeds of
tests/test_checkpoint.py) and the initial params JAX's, carried across by
``convert.params_from_numpy``. Every comparison is exact: a restored state
must be the saved one bit for bit.
"""

import os

import jax
import numpy as np
import pytest
import torch

from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset as jgen_gaussian_dataset
from pysvihmm_tpu.distributions.emissions import GaussianNIW as JGaussianNIW
from pysvihmm_tpu.models import hmm as jhmm
from pysvihmm_tpu_torch import convert
from pysvihmm_tpu_torch.distributions import GaussianNIW
from pysvihmm_tpu_torch.engines import batch_sgd, gibbs, svi
from pysvihmm_tpu_torch.models.hmm import make_prior
from pysvihmm_tpu_torch.utils import checkpoint

torch.set_num_threads(1)
CFG = svi.SVIConfig(batch_size=4, subchain_len=50, buffer=5)


def _setup(dtype=torch.float32):
    """tests/test_checkpoint.py's problem: K=3, D=2, one chain of T=500."""
    obs, _, _ = jgen_gaussian_dataset(jax.random.PRNGKey(0), 3, 2, 1, 500)
    jprior = jhmm.make_prior(3, JGaussianNIW, obs_dim=2)
    jp0 = jhmm.init_params(jax.random.PRNGKey(1), jprior, JGaussianNIW, obs[0])
    chain = torch.tensor(np.asarray(obs[0]), dtype=dtype)
    prior = make_prior(3, GaussianNIW, obs_dim=2, dtype=dtype, device="cpu")
    return chain, prior, convert.params_from_numpy(jp0, device="cpu", dtype=dtype)


def _leaves(state) -> list:
    """Every tensor of a state, generators as their state, depth first."""
    if isinstance(state, torch.Generator):
        return [state.get_state()]
    if isinstance(state, torch.Tensor):
        return [state]
    if state is None:
        return []
    return [x for v in state for x in _leaves(v)]


def _assert_same(a, b) -> None:
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.device == y.device
        assert torch.equal(x, y)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _svi_state(adaptive: bool):
    chain, prior, params = _setup()
    cfg = CFG._replace(adaptive=adaptive)
    state = svi.init_state(params, _gen(2), adaptive=adaptive)
    state, _ = svi.fit(state, prior, chain, GaussianNIW, cfg, num_steps=10)
    return state, svi.init_state(params, _gen(99), adaptive=adaptive)


def _sgd_state(_):
    chain, prior, params = _setup()
    state, _ = batch_sgd.fit_state(batch_sgd.init_state(params), prior, chain[None],
                                   GaussianNIW, num_iters=3)
    return state, batch_sgd.init_state(params)


def _gibbs_state(_):
    chain, prior, _ = _setup()
    obs = chain[None, :200]
    state = gibbs.init_state(_gen(3), prior, GaussianNIW, obs, 3)
    state, _ = gibbs.run(state, prior, obs, GaussianNIW, 3, 2)
    return state, gibbs.init_state(_gen(4), prior, GaussianNIW, obs, 3)


class TestCheckpoint:
    @pytest.mark.parametrize("make,adaptive", [(_svi_state, False), (_svi_state, True),
                                               (_sgd_state, None), (_gibbs_state, None)])
    def test_roundtrip_exact(self, tmp_path, make, adaptive):
        """params, step, adaptive state and generator state come back bit for
        bit, into a fresh state of another seed; the target is not changed."""
        state, fresh = make(adaptive)
        fresh_before = _leaves(fresh)
        path = str(tmp_path / "ckpt.pt")
        checkpoint.save(path, state)
        restored = checkpoint.restore(path, fresh)
        _assert_same(state, restored)
        for x, y in zip(_leaves(fresh), fresh_before):
            assert torch.equal(x, y)
        if hasattr(restored, "step"):
            assert int(restored.step) == int(state.step)

    def test_restored_generator_draws_what_the_saved_one_would(self, tmp_path):
        state, fresh = _svi_state(False)
        path = str(tmp_path / "ckpt.pt")
        checkpoint.save(path, state)
        restored = checkpoint.restore(path, fresh)
        assert restored.generator is not state.generator
        assert torch.equal(torch.randint(0, 1000, (64,), generator=restored.generator),
                           torch.randint(0, 1000, (64,), generator=state.generator))

    @pytest.mark.parametrize("adaptive", [False, True])
    def test_resume_equals_uninterrupted(self, tmp_path, adaptive):
        """10 steps == 5 steps -> checkpoint -> restore -> 5 steps, bit for
        bit, on "scan" in float64."""
        chain, prior, params = _setup(torch.float64)
        cfg = CFG._replace(adaptive=adaptive)

        full = svi.init_state(params, _gen(3), adaptive=adaptive)
        full, _ = svi.fit(full, prior, chain, GaussianNIW, cfg, 10, method="scan")

        half = svi.init_state(params, _gen(3), adaptive=adaptive)
        half, _ = svi.fit(half, prior, chain, GaussianNIW, cfg, 5, method="scan")
        path = str(tmp_path / "ckpt.pt")
        checkpoint.save(path, half)
        restored = checkpoint.restore(path, svi.init_state(params, _gen(0), adaptive=adaptive))
        resumed, _ = svi.fit(restored, prior, chain, GaussianNIW, cfg, 5, method="scan")
        _assert_same(full, resumed)
        assert int(resumed.step) == 10

    def test_save_step_prune_and_latest(self, tmp_path):
        state, _ = _svi_state(False)
        d = str(tmp_path / "ckpts")
        assert checkpoint.latest_step_path(d) is None
        for s in (1, 2, 3, 4, 5):
            checkpoint.save_step(d, s, state, keep=3)
        open(os.path.join(d, "ckpt_x.pt"), "w").close()  # not a step file
        assert sorted(os.listdir(d)) == ["ckpt_3.pt", "ckpt_4.pt", "ckpt_5.pt", "ckpt_x.pt"]
        assert checkpoint.latest_step_path(d).endswith("ckpt_5.pt")

    def test_atomic_no_tmp_and_no_torn_file(self, tmp_path, monkeypatch):
        state, fresh = _svi_state(False)
        path = str(tmp_path / "c.pt")
        checkpoint.save(path, state)
        assert not os.path.exists(path + ".tmp")

        def torn(obj, f):  # a write that dies half way
            with open(f, "wb") as fh:
                fh.write(b"PK\x03\x04 torn")
            raise OSError("disk gone")

        monkeypatch.setattr(checkpoint.torch, "save", torn)
        with pytest.raises(OSError):
            checkpoint.save(path, fresh)
        monkeypatch.undo()
        _assert_same(state, checkpoint.restore(path, fresh))

    def test_weights_only_flat_file(self, tmp_path):
        """The file is one flat dict of tensors (and generator device names)
        that torch.load reads with weights_only=True."""
        state, _ = _svi_state(True)
        path = str(tmp_path / "c.pt")
        checkpoint.save(path, state)
        flat = torch.load(path, weights_only=True)
        assert set(flat) == {
            "params.init", "params.trans", "params.emit.mean", "params.emit.kappa",
            "params.emit.nu", "params.emit.psi", "step", "generator", "generator.device",
            "adapt.g_bar", "adapt.h_bar", "adapt.tau_adapt"}
        assert flat["generator.device"] == "cpu" and flat["generator"].dtype == torch.uint8
        assert all(isinstance(v, torch.Tensor) for k, v in flat.items() if k != "generator.device")

    @pytest.mark.parametrize("case", ["extra", "missing", "shape"])
    def test_refuses_mismatched_structure(self, tmp_path, case):
        chain, prior, params = _setup()
        path = str(tmp_path / "c.pt")
        saved = svi.init_state(params, _gen(1), adaptive=case != "missing")
        checkpoint.save(path, saved)
        target = svi.init_state(params, _gen(2), adaptive=case == "missing")
        if case == "shape":
            target = target._replace(params=target.params._replace(init=torch.ones(4)))
        with pytest.raises(ValueError, match={"extra": "lacks", "missing": "no entry",
                                              "shape": "shape"}[case]):
            checkpoint.restore(path, target)

    def test_refuses_a_generator_of_another_device_type(self, tmp_path):
        """A CPU generator's state never goes into a CUDA generator (nor the
        reverse); the check is made before any generator is built, so it
        runs without a card."""
        cpu_state = torch.Generator().manual_seed(5).get_state()
        with pytest.raises(ValueError, match="cpu generator"):
            checkpoint.generator_from_state(cpu_state, "cpu", torch.device("cuda"))
        # a checkpoint written from a card, restored into a CPU state
        state, fresh = _svi_state(False)
        flat = checkpoint.flatten(state)
        flat["generator.device"] = "cuda"
        path = str(tmp_path / "c.pt")
        torch.save(flat, path)
        with pytest.raises(ValueError, match="cuda generator"):
            checkpoint.restore(path, fresh)
