"""The port's data parallelism, multi-process runtime, multi-rank trainer
resume, distributed checkpoint and baseline config 5 (parallel/
data_parallel.py, parallel/multihost.py, parallel/collectives.py,
engines/trainer.py, utils/checkpoint.py, scripts/run_baseline_configs.py)
on the CPU: the counterparts of tests/test_sharding.py and
tests/test_multihost.py.

The port runs as gloo process groups of 1, 2 and 4 ranks started with
``spawn`` (``parallel.spawn_local``), one group a world size running every
case once (the module fixture, ranks that never import JAX); JAX runs the
same steps on the same NumPy inputs and draws over a virtual CPU mesh of the
same size (tests/conftest.py).

Tolerances: the float32 data-parallel steps to rtol 2e-4 and atol 1e-5,
JAX's two-process tolerance (tests/test_multihost.py); a world of one
against the single-process port, and the trainer's kill and resume against
the uninterrupted run, bit for bit.
"""

import contextlib
import io
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pysvihmm_tpu_torch import convert
from pysvihmm_tpu_torch.data.loader import ShardedSequenceLoader
from pysvihmm_tpu_torch.distributions import GaussianNIW
from pysvihmm_tpu_torch.engines import batch_vb, metaobs, svi, trainer
from pysvihmm_tpu_torch.engines.base import batch_local_step, decode
from pysvihmm_tpu_torch.eval.metrics import hamming_error
from pysvihmm_tpu_torch.models.hmm import make_prior
from pysvihmm_tpu_torch.parallel import (
    collectives,
    global_data_mesh,
    host_local_batch_to_global,
    initialize_distributed,
    make_dp_metaobs_step,
    make_dp_minibatch_svi_step,
    make_dp_streamed_svi_step,
    make_dp_vb_step,
    make_mesh,
    shard_batch,
    sharded_local_step,
    spawn_local,
)
from pysvihmm_tpu_torch.scripts import run_baseline_configs
from pysvihmm_tpu_torch.utils.checkpoint import DistributedCheckpointer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2, 4)
STEPS = 3  # SVI and metaobs steps fed JAX's draws
SVI_CFG = dict(batch_size=4, subchain_len=24, buffer=0, tau=1.0, kappa=0.6)
META_CFG = dict(minibatch=8, block_len=100, buffer=10, tau=10.0, kappa=0.6)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _np(tree):
    """Tensors of a (named) tuple, as NumPy, in the order of their leaves."""
    if isinstance(tree, torch.Tensor):
        return [tree.detach().numpy()]
    return [a for x in tree for a in _np(x)]


def _rows(x, world, rank):
    n = x.shape[0] // world
    return x[rank * n:(rank + 1) * n]


def _expect_error(fn, exc=ValueError):
    try:
        fn()
    except exc as e:
        return str(e)
    return "no error"


def _rank_cases(rank, world, inp):
    """Every case on one rank of a gloo group (runs in a spawned process)."""
    torch.set_num_threads(1)
    out = {}
    mesh = make_mesh(world, "cpu")

    # the two-process test's problem (tests/test_multihost.py): one VB step,
    # 3 minibatch SVI steps on JAX's draws, 2 streamed steps on JAX's batches
    s = inp["small"]
    obs, p0 = torch.from_numpy(s["obs"]), s["p0"]
    prior = make_prior(3, GaussianNIW, obs_dim=2, device="cpu")
    shard = shard_batch(obs, mesh)
    out["local"] = _np(sharded_local_step(p0, GaussianNIW, shard, mesh, "scan"))
    p1, elbo = make_dp_vb_step(GaussianNIW, mesh, "scan")(p0, prior, shard)
    out["vb"] = _np(p1) + [elbo.numpy()]
    cfg = svi.SVIConfig(**SVI_CFG)
    step = make_dp_minibatch_svi_step(GaussianNIW, cfg, 8, mesh, "scan")
    st = svi.init_state(p0, _gen(2))
    for idx in s["idx"][world]:
        st, _ = step.with_indices(st, prior, shard, torch.from_numpy(idx[rank]))
    out["svi"] = _np(st.params)
    stream = make_dp_streamed_svi_step(GaussianNIW, cfg, 8, mesh, "scan")
    st = svi.init_state(p0, _gen(2))
    for batch in s["batches"]:
        st, _ = stream(st, prior, _rows(torch.from_numpy(batch), world, rank))
    out["streamed"] = _np(st.params)

    # a world of one against the single-process port, bit for bit
    if world == 1:
        single = {"local": _np(batch_local_step(p0, GaussianNIW, obs, "scan",
                                                need_gamma=False)[0])}
        q, e = batch_vb.make_step(GaussianNIW, "scan")(p0, prior, obs)
        single["vb"] = _np(q) + [e.numpy()]
        st = svi.init_state(p0, _gen(2))
        base = svi.make_minibatch_step(GaussianNIW, cfg, 8, "scan")
        for idx in s["idx"][1]:
            st, _ = base.with_indices(st, prior, obs, torch.from_numpy(idx[0]))
        single["svi"] = _np(st.params)
        st = svi.init_state(p0, _gen(2))
        for batch in s["batches"]:
            st, _ = base.with_batch(st, prior, torch.from_numpy(batch))
        single["streamed"] = _np(st.params)
        # the drawing steps: the same draws from the same generator
        a, b = svi.init_state(p0, _gen(5)), svi.init_state(p0, _gen(5))
        for _ in range(STEPS):
            a, _ = step(a, prior, shard)
            b, _ = base(b, prior, obs)
        single["svi_drawn"] = (_np(a.params), _np(b.params))
        out["single"] = single

    # convergence on the port's own draws (tests/test_sharding.py)
    c = inp["converge"]
    cobs = torch.from_numpy(c["obs"])
    prior4 = make_prior(4, GaussianNIW, obs_dim=2, device="cpu")
    step = make_dp_minibatch_svi_step(GaussianNIW, svi.SVIConfig(batch_size=16, tau=5.0,
                                                                 kappa=0.6), 64, mesh)
    st = svi.init_state(c["p0"], _gen(5))
    for _ in range(120):
        st, _ = step(st, prior4, shard_batch(cobs, mesh))
    out["svi_hamming"] = hamming_error(decode(st.params, GaussianNIW, cobs), c["z"], 4)

    # meta-observation SVI: 3 steps on JAX's block draws, then convergence
    m = inp["meta"]
    chain = torch.from_numpy(m["chain"])
    mcfg = metaobs.MetaObsConfig(**META_CFG)
    mstep = make_dp_metaobs_step(GaussianNIW, mcfg, chain.shape[0], mesh)
    st = svi.init_state(m["p0"], _gen(8))
    for ids in m["ids"]:
        st, _ = mstep.with_blocks(st, prior4, chain, torch.from_numpy(ids))
    out["meta"] = _np(st.params)
    if world == 1:
        a, b = svi.init_state(m["p0"], _gen(9)), svi.init_state(m["p0"], _gen(9))
        base = metaobs.make_step(GaussianNIW, mcfg, chain.shape[0])
        for _ in range(STEPS):
            a, _ = mstep(a, prior4, chain)
            b, _ = base(b, prior4, chain)
        out["single"]["meta_drawn"] = (_np(a.params), _np(b.params))
    st = svi.init_state(m["p0"], _gen(8))
    for _ in range(150):
        st, _ = mstep(st, prior4, chain)
    out["meta_hamming"] = hamming_error(decode(st.params, GaussianNIW, chain[None]), m["z"], 4)

    out["multihost"] = _multihost_cases(rank, world, s["obs"])
    out["trainer"] = _trainer_cases(rank, world, inp)
    out["checkpointer"] = _checkpointer_cases(rank, world, inp, p0)

    # config 5 at a small scale over this world
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_baseline_configs.main(["--configs", "5", "--scale", "0.01", "--device", "cpu"])
    out["config5"] = [json.loads(x) for x in buf.getvalue().splitlines()]
    return out


def _multihost_cases(rank, world, obs_np):
    got = {}
    initialize_distributed(num_processes=world, backend="gloo")  # a group is up: nothing
    got["still_up"] = dist.is_initialized() and dist.get_world_size() == world
    got["wrong_world"] = _expect_error(
        lambda: initialize_distributed(num_processes=world + 1, backend="gloo"), RuntimeError)
    mesh = global_data_mesh(device_type="cpu")
    rows = _rows(obs_np, world, rank)
    got["local_rows"] = host_local_batch_to_global(rows, mesh).numpy()
    got["mesh_size"] = _expect_error(lambda: make_mesh(world + 1, "cpu"))
    if world > 1:
        extra = obs_np[: len(rows) + (rank == 0)]
        got["unequal_rows"] = _expect_error(lambda: host_local_batch_to_global(extra, mesh))
        cfg = svi.SVIConfig(batch_size=2 * world + 1)
        got["svi_batch"] = _expect_error(
            lambda: make_dp_minibatch_svi_step(GaussianNIW, cfg, 100, mesh))
        mcfg = metaobs.MetaObsConfig(minibatch=2 * world + 1)
        got["meta_minibatch"] = _expect_error(
            lambda: make_dp_metaobs_step(GaussianNIW, mcfg, 1000, mesh))
        got["shard_batch"] = _expect_error(
            lambda: shard_batch(torch.zeros(2 * world + 1, 3), mesh))
    # the axis collectives against their definitions
    group = mesh.get_group("data")
    x = torch.arange(3.0) + 10 * rank
    got["all_gather"] = collectives.all_gather(x, group).numpy()
    got["all_gather_tiled"] = collectives.all_gather(x[:, None], group, axis=1, tiled=True).numpy()
    got["psum_scatter"] = collectives.psum_scatter(torch.arange(2.0 * world) + rank, group).numpy()
    got["pmax"] = collectives.pmax(x, group).numpy()
    got["ppermute"] = collectives.ppermute(
        x, group, [(i, (i + 1) % world) for i in range(world)]).numpy()
    got["broadcast"] = collectives.broadcast_int(7 + rank, group)
    return got


def _trainer_cases(rank, world, inp):
    """The streamed trainer: 10 steps uninterrupted; 6 steps checkpointed
    (every 4 and at the end) by rank 0; then fresh states, loaders and steps
    in every rank resume from the shared directory to 10."""
    t = inp["trainer"]
    prior = make_prior(3, GaussianNIW, obs_dim=2, device="cpu")
    cfg = svi.SVIConfig(batch_size=8, tau=5.0, kappa=0.6, adaptive=True)
    ckpt = os.path.join(t["dir"], f"world{world}")

    def run(num_steps, **kw):
        loader = ShardedSequenceLoader.from_npy(t["corpus"], "cpu", 8 // world, seed=3)
        step = make_dp_streamed_svi_step(GaussianNIW, cfg, 16)
        state = svi.init_state(t["p0"], _gen(4), adaptive=True)
        return trainer.train_streamed(step, state, prior, loader, num_steps, **kw)

    ref = run(10)
    run(6, checkpoint_dir=ckpt, checkpoint_every=4)
    got = run(10, checkpoint_dir=ckpt, checkpoint_every=4)
    return {"ref": _np(ref.params) + _np(ref.adapt), "got": _np(got.params) + _np(got.adapt),
            "step": int(got.step), "files": sorted(os.listdir(ckpt))}


def _checkpointer_cases(rank, world, inp, p0):
    directory = os.path.join(inp["trainer"]["dir"], f"dcp{world}")
    states = [svi.SVIState(p0._replace(init=p0.init * (i + 1)), torch.tensor(i, dtype=torch.int32),
                           _gen(100 + i)) for i in range(5)]
    for st in states:
        torch.rand(3, generator=st.generator)  # a generator away from its seed
    ck = DistributedCheckpointer(directory, keep=3)
    for i in range(1, 5):
        ck.save(i, states[i])
    ck.close()
    dist.barrier()  # rank 0's renames are done
    target = svi.SVIState(p0, torch.tensor(0, dtype=torch.int32), _gen(0))

    def same(a, b):
        return (all(np.array_equal(x, y) for x, y in zip(_np(a.params), _np(b.params)))
                and int(a.step) == int(b.step)
                and torch.equal(a.generator.get_state(), b.generator.get_state()))

    got = {"latest": ck.latest_step(),
           "steps": sorted(n for n in os.listdir(directory)),
           "restore_latest": same(ck.restore(target), states[4]),
           "restore_3": same(ck.restore(target, step=3), states[3])}
    empty = DistributedCheckpointer(os.path.join(directory, "empty"))
    got["empty"] = _expect_error(lambda: empty.restore(target), FileNotFoundError)
    return got


# --------------------------------------------------------------- the inputs


def _inputs(tmp_dir):
    import jax

    from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset
    from pysvihmm_tpu.distributions import GaussianNIW as JNIW
    from pysvihmm_tpu.models.hmm import init_params, make_prior as jprior

    def problem(key, K, N, T, seed, **kw):
        obs, z, _ = gen_gaussian_dataset(jax.random.PRNGKey(key), K, 2, N, T, **kw)
        jp0 = init_params(jax.random.PRNGKey(seed), jprior(K, JNIW, obs_dim=2), JNIW, obs)
        return np.asarray(obs), np.asarray(z), jp0

    jinp = {}
    obs, _, jinp["small"] = problem(0, 3, 8, 24, 1)
    # JAX's draws: per step, key -> (key, k); device d draws from fold_in(k, d)
    idx = {}
    for w in WORLDS:
        key, draws = jax.random.PRNGKey(2), []
        for _ in range(STEPS):
            key, k = jax.random.split(key)
            draws.append(np.stack([np.asarray(jax.random.randint(
                jax.random.fold_in(k, d), (4 // w,), 0, 8 // w)) for d in range(w)]))
        idx[w] = draws
    rng = np.random.default_rng(7)
    batches = [obs[rng.integers(0, 8, 4)] for _ in range(2)]
    small = {"obs": obs, "p0": convert.params_from_numpy(jinp["small"], device="cpu"),
             "idx": idx, "batches": batches}

    cobs, cz, jp = problem(3, 4, 64, 100, 4, mean_scale=6.0, cov_scale=0.3)
    converge = {"obs": cobs, "z": cz, "p0": convert.params_from_numpy(jp, device="cpu")}

    mobs, mz, jinp["meta"] = problem(6, 4, 1, 3200, 7, mean_scale=6.0, cov_scale=0.3)
    key, ids = jax.random.PRNGKey(8), []
    for _ in range(STEPS):
        key, k = jax.random.split(key)
        ids.append(np.asarray(jax.random.choice(k, 32, (8,), replace=False)))
    meta = {"chain": mobs[0], "z": mz[0], "ids": ids,
            "p0": convert.params_from_numpy(jinp["meta"], device="cpu")}

    tobs, _, jp = problem(20, 3, 16, 24, 21, mean_scale=6.0, cov_scale=0.3)
    corpus = os.path.join(tmp_dir, "corpus.npy")
    np.save(corpus, tobs.astype(np.float32))
    tr = {"corpus": corpus, "dir": tmp_dir, "p0": convert.params_from_numpy(jp, device="cpu")}
    return {"small": small, "converge": converge, "meta": meta, "trainer": tr}, jinp


def _jax_cases(world, inp, jinp):
    """The data-parallel steps through the JAX package on a virtual mesh of
    ``world`` CPU devices (float32), fed the same draws and batches."""
    import jax
    import jax.numpy as jnp

    from pysvihmm_tpu.distributions import GaussianNIW as JNIW
    from pysvihmm_tpu.engines import metaobs as jmetaobs, svi as jsvi
    from pysvihmm_tpu.models.hmm import make_prior as jprior
    from pysvihmm_tpu.parallel import (
        make_dp_metaobs_step as jmeta,
        make_dp_minibatch_svi_step as jminibatch,
        make_dp_streamed_svi_step as jstreamed,
        make_dp_vb_step as jvb,
        make_mesh as jmesh,
        shard_batch as jshard,
        sharded_local_step as jlocal,
    )

    mesh = jmesh(world)
    s = inp["small"]
    p0, prior = jinp["small"], jprior(3, JNIW, obs_dim=2)
    gobs = jshard(jnp.asarray(s["obs"]), mesh)
    out = {"local": jax.tree.leaves(jax.jit(lambda p, o: jlocal(p, JNIW, o, mesh, "scan"))(
        p0, gobs))}
    p1, elbo = jvb(JNIW, mesh, method="scan")(p0, prior, gobs)
    out["vb"] = jax.tree.leaves(p1) + [elbo]
    cfg = jsvi.SVIConfig(**SVI_CFG)
    st = jsvi.init_state(p0, jax.random.PRNGKey(2))
    step = jminibatch(JNIW, cfg, 8, mesh, method="scan")
    for _ in range(STEPS):
        st, _ = step(st, prior, gobs)
    out["svi"] = jax.tree.leaves(st.params)
    st = jsvi.init_state(p0, jax.random.PRNGKey(2))
    step = jstreamed(JNIW, cfg, 8, mesh, method="scan")
    for batch in s["batches"]:
        st, _ = step(st, prior, jshard(jnp.asarray(batch), mesh))
    out["streamed"] = jax.tree.leaves(st.params)

    m = inp["meta"]
    st = jsvi.init_state(jinp["meta"], jax.random.PRNGKey(8))
    step = jmeta(JNIW, jmetaobs.MetaObsConfig(**META_CFG), m["chain"].shape[0], mesh)
    for _ in range(STEPS):
        st, _ = step(st, jprior(4, JNIW, obs_dim=2), jnp.asarray(m["chain"]))
    out["meta"] = jax.tree.leaves(st.params)
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """{world: (the ranks' results, JAX's)}: one spawned gloo group a world
    size runs every case while JAX runs its steps in this process."""
    inp, jinp = _inputs(str(tmp_path_factory.mktemp("parallel")))
    with ThreadPoolExecutor(len(WORLDS)) as pool:
        groups = {w: pool.submit(spawn_local, _rank_cases, w, inp, timeout=120.0)
                  for w in WORLDS}
        ref = {w: _jax_cases(w, inp, jinp) for w in WORLDS}
        return {w: (groups[w].result(), ref[w]) for w in WORLDS}


def _close(got, want):
    """rtol 2e-4, atol 1e-5 leaf by leaf; the NIW scale matrix psi (the one
    3-d parameter leaf, (K, D, D)) to 2e-4 of its largest entry: its float32
    update cancels, and both packages carry that rounding (about 1e-4 from
    float64, ROADMAP Queue 3), which its small off-diagonal entries show
    relative to themselves."""
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        atol = 2e-4 * np.abs(b).max() if b.ndim == 3 else 1e-5
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=atol)


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def _replicated(ranks, case):
    """A replicated result: the same bits on every rank; rank 0's."""
    for r in ranks[1:]:
        _equal(r[case], ranks[0][case])
    return ranks[0][case]


@pytest.mark.parametrize("world", WORLDS)
class TestDataParallel:
    @pytest.mark.parametrize("case", ["local", "vb", "svi", "streamed", "meta"])
    def test_matches_jax(self, results, world, case):
        """sharded_local_step, one DP VB step, 3 minibatch SVI steps on JAX's
        per-device draws, 2 streamed steps on JAX's batches and 3
        meta-observation steps on JAX's block draws."""
        ranks, ref = results[world]
        _close(_replicated(ranks, case), ref[case])

    def test_minibatch_svi_converges(self, results, world):
        ranks, _ = results[world]
        assert all(r["svi_hamming"] < 0.05 for r in ranks), [r["svi_hamming"] for r in ranks]

    def test_metaobs_converges(self, results, world):
        ranks, _ = results[world]
        assert all(r["meta_hamming"] < 0.05 for r in ranks), [r["meta_hamming"] for r in ranks]


@pytest.mark.parametrize("case", ["local", "vb", "svi", "streamed", "svi_drawn", "meta_drawn"])
def test_world_of_one_is_single_process(results, case):
    """A gloo world of one gives the single-process port's bits: the local
    step, batch VB's step, the minibatch and streamed steps (and the drawing
    steps from one seed: the (1, B) draw is the (B,) draw), the metaobs step."""
    ranks, _ = results[1]
    single = ranks[0]["single"]
    if case in ("svi_drawn", "meta_drawn"):
        _equal(*single[case])
    else:
        _equal(ranks[0][case], single[case])


@pytest.mark.parametrize("world", WORLDS)
def test_multihost_runtime(results, world):
    """initialize_distributed is idempotent and refuses a world of another
    size; host-local rows stay local and must agree in number; mesh and
    batch sizes that do not divide raise; the collectives do what JAX's do."""
    ranks, _ = results[world]
    rows = 8 // world
    for rank, r in enumerate(ranks):
        got = r["multihost"]
        assert got["still_up"]
        assert "requested" in got["wrong_world"]
        assert got["local_rows"].shape[0] == rows
        assert "world" in got["mesh_size"]
        if world > 1:
            assert "different numbers of rows" in got["unequal_rows"]
            for key in ("svi_batch", "meta_minibatch", "shard_batch"):
                assert "divisible" in got[key], (key, got[key])
        xs = np.stack([np.arange(3.0) + 10 * d for d in range(world)])
        np.testing.assert_array_equal(got["all_gather"], xs)
        np.testing.assert_array_equal(got["all_gather_tiled"], xs.T)
        total = sum(np.arange(2.0 * world) + d for d in range(world))
        np.testing.assert_array_equal(got["psum_scatter"], total[2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(got["pmax"], xs[-1])
        np.testing.assert_array_equal(got["ppermute"], xs[(rank - 1) % world])
        assert got["broadcast"] == 7


@pytest.mark.parametrize("world", WORLDS)
def test_trainer_kill_and_resume(results, world):
    """Every rank restores rank 0's latest step from the shared directory and
    lands on the uninterrupted run's bits (parameters and adaptive state)."""
    ranks, _ = results[world]
    for r in ranks:
        got = r["trainer"]
        assert got["step"] == 10
        _equal(got["got"], got["ref"])
        _equal(got["got"], ranks[0]["trainer"]["got"])
    # rank 0 wrote steps 4 and 6, then 8 and 10 after the resume: the newest 3 stay
    assert ranks[0]["trainer"]["files"] == ["ckpt_10.pt", "ckpt_6.pt", "ckpt_8.pt"]


@pytest.mark.parametrize("world", WORLDS)
def test_distributed_checkpointer(results, world):
    """Asynchronous saves across the ranks, the newest 3 steps kept, only
    finished steps visible, the latest and a chosen step restored with the
    generator's state, and a restore from an empty directory refused."""
    ranks, _ = results[world]
    for r in ranks:
        got = r["checkpointer"]
        assert got["latest"] == 4
        assert got["steps"] == ["step_2", "step_3", "step_4"]
        assert got["restore_latest"] and got["restore_3"]
        assert "no checkpoint" in got["empty"]


@pytest.mark.parametrize("world", WORLDS)
def test_config5_small_scale(results, world):
    """Baseline config 5 over the world's data mesh: rank 0 reports, every
    process ran (processes == world), and the fit passes its bar."""
    ranks, _ = results[world]
    recs = ranks[0]["config5"]
    assert recs[0]["config"] == 5 and recs[0]["processes"] == world
    assert recs[0]["hamming"] < 0.15
    assert recs[-1] == {"event": "all_configs_done", "configs": [5]}
    assert all(r["config5"] == [] for r in ranks[1:])


def test_distributed_checkpointer_single_process(tmp_path):
    """Without a process group the checkpointer is one process's."""
    prior = make_prior(3, GaussianNIW, obs_dim=2, device="cpu")
    states = [svi.SVIState(prior._replace(trans=prior.trans * i), torch.tensor(i), _gen(i))
              for i in range(4)]
    ck = DistributedCheckpointer(str(tmp_path), keep=2)
    for i, st in enumerate(states):
        ck.save(i, st)
    ck.close()
    assert ck.latest_step() == 3 and sorted(os.listdir(tmp_path)) == ["step_2", "step_3"]
    got = ck.restore(svi.SVIState(prior, torch.tensor(0), _gen(9)))
    assert torch.equal(got.params.trans, states[3].params.trans) and int(got.step) == 3
    assert torch.equal(got.generator.get_state(), states[3].generator.get_state())
    assert not dist.is_initialized()


def _fail_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("rank 1 failed on purpose")
    dist.barrier()  # rank 0 waits for a rank that never comes


def test_spawn_local_reports_a_failed_rank():
    """A rank that raises fails the group at once: the rank left waiting in
    a collective is killed, and the error carries the failed rank's
    traceback."""
    with pytest.raises(RuntimeError, match="rank 1 failed on purpose"):
        spawn_local(_fail_on_rank_1, 2, timeout=60.0)


def test_initialize_distributed_fails_loudly():
    """An explicit multi-process request that cannot reach its coordinator
    raises; it never returns to carry on as one process."""
    script = (
        "import sys\n"
        "from pysvihmm_tpu_torch.parallel import initialize_distributed\n"
        "try:\n"
        "    initialize_distributed('localhost:1', 2, 1, initialization_timeout=3,"
        " backend='gloo')\n"
        "except Exception:\n"
        "    sys.exit(42)\n"
        "print('PROCEEDED-SILENTLY')\n"
        "sys.exit(3)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    p = subprocess.run([sys.executable, "-c", script], env=env, capture_output=True, timeout=120)
    assert p.returncode == 42, (p.returncode, p.stdout, p.stderr[-2000:])
    assert b"PROCEEDED-SILENTLY" not in p.stdout


def test_single_process_paths(monkeypatch):
    """One process with no process group: initialize_distributed does nothing
    (num_processes 1, or no coordinator anywhere), a mesh cannot be built,
    and the collectives of no group are the identity."""
    for var in ("COORDINATOR_ADDRESS", "MASTER_ADDR"):
        monkeypatch.delenv(var, raising=False)
    initialize_distributed(num_processes=1)
    initialize_distributed()
    monkeypatch.setenv("MASTER_ADDR", "localhost")  # torchrun's variables, one process
    monkeypatch.setenv("WORLD_SIZE", "1")
    initialize_distributed()
    assert not dist.is_initialized()
    monkeypatch.delenv("MASTER_ADDR")
    with pytest.raises(RuntimeError, match="no process group"):
        make_mesh()
    with pytest.raises(ValueError, match="coordinator"):
        initialize_distributed(num_processes=2)
    x = torch.arange(4.0)
    assert collectives.psum((x, None), None)[0] is x
    assert torch.equal(collectives.all_gather(x, None), x[None])
    assert torch.equal(collectives.ppermute(x, None, [(0, 0)]), x)
    assert collectives.broadcast_int(5, None) == 5
