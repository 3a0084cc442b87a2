"""The port's fault-tolerant trainer (engines/trainer.py), resumable loader
(data/loader.py) and streamed SVI step (parallel/data_parallel.py) on the
CPU: the counterparts of tests/test_trainer.py, and parity with the JAX
package's loader and streamed step.

Data are JAX's (its ``gen_*_dataset`` at tests/test_trainer.py's seeds) and
initial params JAX's, carried across by ``convert.py``; the port's
generators make their own draws. The loader is held to JAX's index for
index; the streamed step on JAX's batches to JAX's to 1e-5 relative in
float32 (JAX sums its statistics per device shard and then across the
eight devices of tests/conftest.py, the port over the batch at once) and
1e-9 in float64.
"""

import math

import jax
import numpy as np
import pytest
import torch

from pysvihmm_tpu.data.loader import ShardedSequenceLoader as JLoader
from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset as jgen_gaussian_dataset
from pysvihmm_tpu.data.synthetic import gen_multinomial_dataset as jgen_multinomial_dataset
from pysvihmm_tpu.distributions.emissions import GaussianNIW as JGaussianNIW
from pysvihmm_tpu.distributions.emissions import MultinomialDirichlet as JMultinomialDirichlet
from pysvihmm_tpu.engines import svi as jsvi
from pysvihmm_tpu.models import hmm as jhmm
from pysvihmm_tpu.parallel import make_dp_streamed_svi_step as jmake_dp_streamed_svi_step
from pysvihmm_tpu.parallel import make_mesh
from pysvihmm_tpu_torch import convert
from pysvihmm_tpu_torch.data import loader as loader_mod
from pysvihmm_tpu_torch.data.loader import ShardedSequenceLoader, process_shard_bounds
from pysvihmm_tpu_torch.distributions import GaussianNIW, MultinomialDirichlet
from pysvihmm_tpu_torch.engines import svi, trainer
from pysvihmm_tpu_torch.engines.base import decode, predictive_log_likelihood
from pysvihmm_tpu_torch.eval.metrics import hamming_error
from pysvihmm_tpu_torch.models.hmm import make_prior
from pysvihmm_tpu_torch.parallel import data_parallel, make_dp_streamed_svi_step
from pysvihmm_tpu_torch.utils.logging import MetricsLogger

torch.set_num_threads(1)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _chain_problem(seed=5, K=4, D=2, T=2000):
    """tests/test_trainer.py's chain: JAX's data and init params."""
    obs, z_true, _ = jgen_gaussian_dataset(jax.random.PRNGKey(seed), K, D, 1, T,
                                           mean_scale=6.0, cov_scale=0.3)
    jprior = jhmm.make_prior(K, JGaussianNIW, obs_dim=D)
    jp0 = jhmm.init_params(jax.random.PRNGKey(seed + 1), jprior, JGaussianNIW, obs[0])
    chain = torch.tensor(np.asarray(obs[0]))
    prior = make_prior(K, GaussianNIW, obs_dim=D, device="cpu")
    return chain, np.asarray(z_true[0]), prior, convert.params_from_numpy(jp0, device="cpu")


def _same_state(a, b) -> None:
    """Two SVI states bit for bit: params, step, adaptive state, generator."""
    la = [*a.params[:2], *a.params.emit, a.step, *(a.adapt or ()), a.generator.get_state()]
    lb = [*b.params[:2], *b.params.emit, b.step, *(b.adapt or ()), b.generator.get_state()]
    for x, y in zip(la, lb, strict=True):
        assert torch.equal(x, y)


class TestTrainer:
    def test_restart_resumes_from_checkpoint(self, tmp_path):
        chain, z_true, prior, params0 = _chain_problem()
        cfg = svi.SVIConfig(batch_size=16, subchain_len=50, buffer=10, tau=10.0)
        step = svi.make_step(GaussianNIW, cfg, chain_len=chain.shape[0])
        d = str(tmp_path)

        s = svi.init_state(params0, _gen(7))
        s = trainer.train(step, s, prior, chain, 120, checkpoint_dir=d, checkpoint_every=40)
        assert int(s.step) == 120

        # "crash" and restart with a fresh state object: must resume, not redo
        s2 = svi.init_state(params0, _gen(7))
        s2 = trainer.train(step, s2, prior, chain, 200, checkpoint_dir=d, checkpoint_every=40)
        assert int(s2.step) == 200
        err = hamming_error(decode(s2.params, GaussianNIW, chain[None]), z_true, 4)
        assert err < 0.05

    @pytest.mark.parametrize("adaptive", [False, True])
    def test_kill_resume_bitexact(self, tmp_path, adaptive):
        """A windowed-SVI run killed at 11 of 20 steps (checkpoints every 4)
        and restarted from a fresh state ends on the uninterrupted run's
        bits, generator state included."""
        chain, _, prior, params0 = _chain_problem(T=600)
        cfg = svi.SVIConfig(batch_size=8, subchain_len=30, buffer=5, tau=10.0, adaptive=adaptive)
        step = svi.make_step(GaussianNIW, cfg, chain_len=chain.shape[0])
        ref = trainer.train(step, svi.init_state(params0, _gen(3), adaptive), prior, chain, 20)
        d = str(tmp_path)
        trainer.train(step, svi.init_state(params0, _gen(3), adaptive), prior, chain, 11,
                      checkpoint_dir=d, checkpoint_every=4)
        resumed = trainer.train(step, svi.init_state(params0, _gen(3), adaptive), prior, chain,
                                20, checkpoint_dir=d, checkpoint_every=4)
        _same_state(ref, resumed)

    def test_watchdog_raises_on_a_nan_metric(self):
        calls = []

        def step_fn(state, prior, obs):
            calls.append(1)
            bad = len(calls) == 3
            return state, {"noisy_elbo": torch.tensor(math.nan if bad else -1.0)}

        state = svi.init_state(_chain_problem(T=200)[3], _gen(0))
        with pytest.raises(FloatingPointError, match="step 3") as info:
            trainer.train(step_fn, state, None, None, 10, watchdog_every=1)
        assert info.value.step == 3 and math.isnan(info.value.metrics["noisy_elbo"])
        assert len(calls) == 3

    def test_logs_every_log_every_steps(self, tmp_path):
        chain, _, prior, params0 = _chain_problem(T=300)
        cfg = svi.SVIConfig(batch_size=4, subchain_len=20, buffer=5)
        step = svi.make_step(GaussianNIW, cfg, chain_len=chain.shape[0])
        path = tmp_path / "m.jsonl"
        log = MetricsLogger(str(path), echo=False)
        trainer.train(step, svi.init_state(params0, _gen(1)), prior, chain, 6, log=log,
                      log_every=2)
        log.close()
        import json

        recs = [json.loads(x) for x in path.read_text().splitlines()]
        assert [r["step"] for r in recs] == [2, 4, 6]
        assert all(math.isfinite(r["noisy_elbo"]) and 0 < r["rho"] <= 1 for r in recs)


class TestStreamedTrainer:
    N, T, D, K, B = 64, 32, 2, 3, 8

    def _corpus(self, tmp_path):
        obs, _, _ = jgen_gaussian_dataset(jax.random.PRNGKey(20), self.K, self.D, self.N, self.T,
                                          mean_scale=6.0, cov_scale=0.3)
        arr = np.asarray(obs, np.float32)
        path = str(tmp_path / "corpus.npy")
        np.save(path, arr)
        jprior = jhmm.make_prior(self.K, JGaussianNIW, obs_dim=self.D)
        jp0 = jhmm.init_params(jax.random.PRNGKey(21), jprior, JGaussianNIW, obs)
        return path, arr, jprior, jp0

    def _setup(self, tmp_path):
        path, arr, _, jp0 = self._corpus(tmp_path)
        prior = make_prior(self.K, GaussianNIW, obs_dim=self.D, device="cpu")
        cfg = svi.SVIConfig(batch_size=self.B, tau=5.0, kappa=0.6, adaptive=True)
        step = make_dp_streamed_svi_step(GaussianNIW, cfg, num_seqs=self.N)
        loader = ShardedSequenceLoader.from_npy(path, "cpu", batch_per_host=self.B, seed=3)
        return prior, convert.params_from_numpy(jp0, device="cpu"), step, loader

    def test_stream_is_deterministic_and_resumable(self, tmp_path):
        _, _, _, loader = self._setup(tmp_path)
        a = [b.clone() for _, b in zip(range(13), loader.stream(0))]
        b = [b.clone() for _, b in zip(range(13), loader.stream(0))]
        for x, y in zip(a, b):
            assert torch.equal(x, y)
        # resuming at step 5 reproduces the tail across the epoch boundary
        # (64 sequences / B=8 -> 8 batches an epoch)
        c = [b.clone() for _, b in zip(range(8), loader.stream(5))]
        for x, y in zip(a[5:], c):
            assert torch.equal(x, y)

    def test_rank0_order_and_batches_are_jax(self, tmp_path):
        """epoch_order, the resumable stream, one shuffled epoch and its
        prefetched form: JAX's process 0, index for index."""
        path, arr, _, _ = self._corpus(tmp_path)
        jl = JLoader.from_npy(path, make_mesh(), batch_per_host=self.B, seed=3)
        tl = ShardedSequenceLoader.from_npy(path, "cpu", batch_per_host=self.B, seed=3)
        assert tl.batches_per_epoch() == jl.batches_per_epoch() == 8
        for epoch in range(3):
            np.testing.assert_array_equal(tl.epoch_order(epoch), jl.epoch_order(epoch))
        for start in (0, 6):
            for x, y in zip([np.asarray(b) for _, b in zip(range(11), jl.stream(start))],
                            [b.numpy() for _, b in zip(range(11), tl.stream(start))],
                            strict=True):
                np.testing.assert_array_equal(x, y)
        for x, y in zip([np.asarray(b) for b in jl], [b.numpy() for b in tl], strict=True):
            np.testing.assert_array_equal(x, y)
        for x, y in zip([np.asarray(b) for b in jl.prefetch()],
                        [b.numpy() for b in tl.prefetch()], strict=True):
            np.testing.assert_array_equal(x, y)

    @pytest.mark.parametrize("total,nproc", [(64, 1), (64, 3), (10, 4), (4096, 7)])
    def test_shard_bounds(self, total, nproc):
        from pysvihmm_tpu.data.loader import process_shard_bounds as jbounds

        bounds = [process_shard_bounds(total, nproc, p) for p in range(nproc)]
        assert bounds == [jbounds(total, nproc, p) for p in range(nproc)]
        assert bounds[0][0] == 0 and bounds[-1][1] == total
        assert all(a[1] == b[0] for a, b in zip(bounds, bounds[1:]))

    def test_loader_takes_its_rank_slice(self, tmp_path, monkeypatch):
        """With a process group of 3, rank 1 loads only its slice and orders
        it by (seed, 1, epoch), as JAX's process 1 does."""
        path, arr, _, _ = self._corpus(tmp_path)
        monkeypatch.setattr(loader_mod, "process_rank_world", lambda: (1, 3))
        tl = ShardedSequenceLoader.from_npy(path, "cpu", batch_per_host=self.B, seed=3)
        assert (tl.start, tl.end) == process_shard_bounds(self.N, 3, 1)
        np.testing.assert_array_equal(tl.local, arr[tl.start:tl.end])
        np.testing.assert_array_equal(
            tl.epoch_order(2), np.random.default_rng((3, 1, 2)).permutation(tl.end - tl.start))

    def test_stream_passes_loader_errors_on(self):
        def load(s, e):
            return np.zeros((e - s, 4, 2), np.float32)

        tl = ShardedSequenceLoader(load, 16, "cpu", batch_per_host=4)

        def broken(rows):
            raise OSError("read failed")

        tl._stage = broken
        with pytest.raises(OSError, match="read failed"):
            next(tl.stream(0))

    def test_streamed_kill_resume_bitexact(self, tmp_path):
        """Killed at step 11 of 20 (checkpoints every 4) and restarted from a
        fresh state: the uninterrupted run's bits, across two epoch
        boundaries."""
        prior, p0, step, loader = self._setup(tmp_path)
        ref = svi.init_state(p0, _gen(22), adaptive=True)
        it = loader.stream(0)
        for _ in range(20):
            ref, _ = step(ref, prior, next(it))
        it.close()

        d = str(tmp_path / "ckpt")
        trainer.train_streamed(step, svi.init_state(p0, _gen(22), adaptive=True), prior, loader,
                               11, checkpoint_dir=d, checkpoint_every=4)
        s2 = trainer.train_streamed(step, svi.init_state(p0, _gen(22), adaptive=True), prior,
                                    loader, 20, checkpoint_dir=d, checkpoint_every=4)
        assert int(s2.step) == 20
        _same_state(ref, s2)

    @pytest.mark.parametrize("adaptive", [False, True])
    @pytest.mark.parametrize("dtype", ["float32", "float64"])
    def test_streamed_step_matches_jax(self, tmp_path, request, adaptive, dtype):
        """Three streamed steps on JAX's own batches from JAX's state: params,
        adaptive state and metrics to 1e-5 relative of JAX's in float32 (to
        1e-9 in float64), every step. The NIW psi leaves the float32 bound:
        its natural-gradient step subtracts kappa m m^T terms hundreds of
        times larger than psi, so float32 puts JAX's psi as well as the
        port's about 1e-4 from float64 on this data (ROADMAP Queue 3); in
        float32 the port's psi is held to the float64 oracle (the port's
        step in float64 on the same batches) no further than 4x JAX's is."""
        if dtype == "float64":
            request.getfixturevalue("enable_x64")
        tdt = getattr(torch, dtype)
        path, _, jprior, jp0 = self._corpus(tmp_path)
        if dtype == "float64":
            jprior, jp0 = (jax.tree.map(lambda x: jax.numpy.asarray(x, dtype), p)
                           for p in (jprior, jp0))
        cfg = dict(batch_size=self.B, tau=5.0, kappa=0.6, adaptive=adaptive)
        mesh = make_mesh()
        jstep = jmake_dp_streamed_svi_step(JGaussianNIW, jsvi.SVIConfig(**cfg), self.N, mesh)
        jstate = jsvi.init_state(jp0, jax.random.PRNGKey(22), adaptive=adaptive)
        step = make_dp_streamed_svi_step(GaussianNIW, svi.SVIConfig(**cfg), self.N)
        state, oracle = (convert.svi_state_from_numpy(jstate, _gen(0), device="cpu", dtype=d)
                         for d in (tdt, torch.float64))
        prior, prior64 = (make_prior(self.K, GaussianNIW, obs_dim=self.D, device="cpu", dtype=d)
                          for d in (tdt, torch.float64))
        rtol = 1e-5 if dtype == "float32" else 1e-9
        psi_err = {"port": 0.0, "jax": 0.0}
        jl = JLoader.from_npy(path, mesh, batch_per_host=self.B, seed=3)
        for _, jbatch in zip(range(3), jl.stream(0)):
            batch = torch.tensor(np.asarray(jbatch), dtype=tdt)
            jstate, jm = jstep(jstate, jprior, jax.numpy.asarray(jbatch, dtype))
            state, m = step(state, prior, batch)
            oracle, _ = step(oracle, prior64, batch.double())
            for k in ("rho", "noisy_elbo"):
                np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol)
            got, ref = convert.svi_state_to_numpy(state), convert.svi_state_to_numpy(oracle)
            for name, a, b, c in zip(
                    ("init", "trans", *got.params.emit._fields, *getattr(got.adapt, "_fields", ())),
                    jax.tree.leaves((got.params, got.adapt)),
                    jax.tree.leaves((jstate.params, jstate.adapt)),
                    jax.tree.leaves((ref.params, ref.adapt)), strict=True):
                b = np.asarray(b)
                if name == "psi" and dtype == "float32":
                    scale = np.abs(c).max()
                    psi_err["port"] = max(psi_err["port"], np.abs(a - c).max() / scale)
                    psi_err["jax"] = max(psi_err["jax"], np.abs(b - c).max() / scale)
                    continue
                np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max(),
                                           err_msg=name)
        if dtype == "float32":
            assert psi_err["port"] <= 4 * psi_err["jax"], psi_err
        assert int(state.step) == int(jstate.step) == 3

    def test_streamed_step_refuses_several_processes(self):
        """The streamed step no longer refuses several processes: with no mesh
        it sums the statistics over the world's process group when one is up
        (tests/test_torch_parallel.py runs that in gloo groups of 2 and 4),
        and with none it is the single-process minibatch step's
        ``with_batch``, bit for bit."""
        chain, _, prior, p0 = _chain_problem()
        batch = chain[:200].reshape(4, 50, 2)
        cfg = svi.SVIConfig(batch_size=4, adaptive=True)
        a = b = svi.init_state(p0, _gen(3), adaptive=True)
        step = make_dp_streamed_svi_step(GaussianNIW, cfg, 64)
        base = svi.make_minibatch_step(GaussianNIW, cfg, 64)
        assert data_parallel.collectives.world_group() is None
        for _ in range(2):
            a, _ = step(a, prior, batch)
            b, _ = base.with_batch(b, prior, batch)
        _same_state(a, b)


class TestAdaptiveStepSize:
    def test_adaptive_svi_converges(self):
        chain, z_true, prior, params0 = _chain_problem(seed=9)
        cfg = svi.SVIConfig(batch_size=16, subchain_len=50, buffer=10, adaptive=True)
        state = svi.init_state(params0, _gen(8), adaptive=True)
        state, metrics = svi.fit(state, prior, chain, GaussianNIW, cfg, num_steps=250)
        rhos = metrics["rho"].numpy()
        err = hamming_error(decode(state.params, GaussianNIW, chain[None]), z_true, 4)
        assert err < 0.05, f"hamming {err}"
        # the elastic rho adapts: it decays from its early values
        assert np.mean(rhos[-20:]) < np.mean(rhos[:20])


class TestMultinomialSVI:
    def test_config3_discrete_svi_with_predll(self):
        """BASELINE config 3 (scaled): multinomial SVI whose held-out
        predictive log-likelihood beats the uniform model's."""
        K, V, T = 6, 30, 6000
        obs, z_true, _ = jgen_multinomial_dataset(jax.random.PRNGKey(12), K, V, 1, T,
                                                  concentration=0.08)
        jprior = jhmm.make_prior(K, JMultinomialDirichlet, num_symbols=V)
        jp0 = jhmm.init_params(jax.random.PRNGKey(13), jprior, JMultinomialDirichlet)
        seq = torch.tensor(np.asarray(obs[0]))
        chain, held = seq[:5000], seq[5000:]
        prior = make_prior(K, MultinomialDirichlet, num_symbols=V, device="cpu")
        cfg = svi.SVIConfig(batch_size=16, subchain_len=100, buffer=20, tau=10.0, kappa=0.6)
        state = svi.init_state(convert.params_from_numpy(jp0, device="cpu"), _gen(14))
        state, _ = svi.fit(state, prior, chain, MultinomialDirichlet, cfg, num_steps=600)
        pll = float(predictive_log_likelihood(state.params, MultinomialDirichlet, held[None]))
        assert pll > 0.8 * held.numel() * np.log(1.0 / V)
        err = hamming_error(decode(state.params, MultinomialDirichlet, chain[None]),
                            np.asarray(z_true[0][:5000]), K)
        assert err < 0.3, f"hamming {err}"
