"""The port's time- and state-sharded exact tiers (messages/time_sharded.py,
messages/state_sharded.py, parallel/time_parallel.py,
parallel/state_parallel.py) held to the JAX package's on the CPU: the
counterparts of tests/test_longchain.py's TestTimeShardedFB,
TestTimeSharded2D, TestStateShardedFB, TestStateParallelEngine,
TestTimeShardedEngine and TestShardedStream.

The port runs as gloo process groups of 1, 2 and 4 ranks started with
``spawn`` (``parallel.multihost.spawn_local``), each rank on its own tile or
state block; JAX runs the same function on the same NumPy inputs over a
virtual CPU mesh of the same size (tests/conftest.py). One group a world
size runs every case once (the module fixture) and the tests compare. The
ranks never import JAX: it is imported in the fixture only.

Tolerances, float64 throughout: gamma to 1e-10, log Z to 1e-9 relative and
the statistics to 1e-10 (JAX's own tests'); the VB engines' ELBOs to 1e-9
relative and their parameters to 1e-8 relative over 10-15 iterations.
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import init_device_mesh

from pysvihmm_tpu_torch import convert
from pysvihmm_tpu_torch.distributions import GaussianNIW, MultinomialDirichlet
from pysvihmm_tpu_torch.messages import (
    state_sharded_forward_backward,
    time_sharded_forward_backward,
    time_sharded_forward_backward_batched,
)
from pysvihmm_tpu_torch.messages.time_sharded import (
    time_sharded_fused_stats,
    time_sharded_long_chain_stats,
)
from pysvihmm_tpu_torch.models.hmm import emission_flat_stats, expected_log_params, make_prior
from pysvihmm_tpu_torch.parallel import (
    collectives,
    fit_large_k,
    fit_long_chain,
    make_mesh,
    make_time_mesh,
    make_ts_stream_vb_step,
    run_vb_scan,
    shard_chain,
    shard_params_by_state,
    spawn_local,
    time_sharded_decode,
    time_sharded_local_step,
)
from pysvihmm_tpu_torch.parallel.state_parallel import make_ss_vb_step

WORLDS = (1, 2, 4)
F64 = torch.float64
MESH_2D = {1: (1, 1), 2: (1, 2), 4: (2, 2)}  # (data, time) axis sizes a world


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _np(tree):
    """Tensors of a (named) tuple, as NumPy, in the order of their leaves."""
    if isinstance(tree, torch.Tensor):
        return [tree.detach().numpy()]
    return [a for x in tree for a in _np(x)]


def _tile(x, world, rank, dim=0):
    n = x.shape[dim] // world
    return x.narrow(dim, rank * n, n)


def _sf(g, y):
    return (g.T @ y, g.sum(dim=0))


def _rank_cases(rank, world, inp):
    """Every case on one rank of a gloo group (runs in a spawned process)."""
    torch.set_num_threads(1)
    out = {}
    tmesh = make_time_mesh(world, "cpu")
    smesh = make_mesh(world, "cpu", axis="state")

    # time-sharded forward-backward, plain and with kept-masks, and deep
    # underflow (log-likelihoods shifted by -500)
    for name in ("fb", "fbw", "fbu"):
        lp, lA, ll, w = (inp[name][k] for k in ("log_pi", "log_A", "ll", "w"))
        r = time_sharded_forward_backward(_t(lp), _t(lA), _tile(_t(ll), world, rank), tmesh,
                                          weights=None if w is None else _tile(_t(w), world, rank))
        out[name] = {"gamma": r.gamma.numpy(), "log_c": r.log_c.numpy(),
                     "log_z": r.log_z.numpy(), "trans": r.trans_stats.numpy(),
                     "init": r.init_stats.numpy()}

    # (data, time) 2-D mesh
    db, dt = MESH_2D[world]
    m2 = init_device_mesh("cpu", (db, dt), mesh_dim_names=("data", "time"))
    bi = collectives.axis_index(m2.get_group("data"))
    ti = collectives.axis_index(m2.get_group("time"))
    b2 = inp["b2"]
    blk = _tile(_tile(_t(b2["ll"]), db, bi, 0), dt, ti, 1)
    wblk = _tile(_tile(_t(b2["w"]), db, bi, 0), dt, ti, 1)
    r = time_sharded_forward_backward_batched(_t(b2["log_pi"]), _t(b2["log_A"]), blk, m2,
                                              weights=wblk)
    out["b2"] = {"gamma": r.gamma.numpy(), "log_c": r.log_c.numpy(), "log_z": r.log_z.numpy(),
                 "trans": r.trans_stats.numpy(), "init": r.init_stats.numpy(), "bi": bi, "ti": ti}

    # state-sharded forward-backward: each rank its state block
    ss = inp["ss"]
    K = ss["log_A"].shape[0]
    Kd = K // world
    r = state_sharded_forward_backward(
        _t(ss["log_pi"])[rank * Kd:(rank + 1) * Kd], _t(ss["log_A"])[rank * Kd:(rank + 1) * Kd],
        _t(ss["ll"])[:, rank * Kd:(rank + 1) * Kd], smesh, weights=_t(ss["w"]))
    out["ss"] = {"gamma": r.gamma.numpy(), "log_c": r.log_c.numpy(), "log_z": r.log_z.numpy(),
                 "trans": r.trans_stats.numpy(), "init": r.init_stats.numpy()}

    # streaming tiers: twophase with a statistic (zero and nonzero seeds) and
    # the likelihood-fused tier with the decode, time-major and time-minor
    st = inp["stream"]
    xs = _tile(_t(st["xs"]), world, rank)
    for name, seed in (("stream", 0.0), ("stream_seeded", 1.0)):
        si = (torch.full((5, 3), 7.0 * seed, dtype=F64), torch.full((5,), 3.0 * seed, dtype=F64))
        r = time_sharded_long_chain_stats(_t(st["log_pi"]), _t(st["log_A"]),
                                          _tile(_t(st["ll"]), world, rank), tmesh, block_size=8,
                                          stat_xs=xs, stat_fn=_sf, stat_init=si)
        out[name] = {"log_z": r.log_z.numpy(), "init": r.init_stats.numpy(),
                     "trans": r.trans_stats.numpy(), "acc0": r.acc[0].numpy(),
                     "acc1": r.acc[1].numpy()}
    fu = inp["fused"]
    W = _t(fu["W"])
    obs = _tile(_t(fu["obs"]), world, rank)
    si = (torch.zeros((5, 3), dtype=F64), torch.zeros(5, dtype=F64))
    for name, o, tm in (("fused", obs, False), ("fused_tm", obs.T.contiguous(), True)):
        r = time_sharded_fused_stats(_t(fu["log_pi"]), _t(fu["log_A"]), o, lambda y: y @ W,
                                     tmesh, block_size=8, chunks=2, stat_fn=_sf, stat_init=si,
                                     emit_argmax=True, time_minor=tm)
        out[name] = {"log_z": r.log_z.numpy(), "init": r.init_stats.numpy(),
                     "trans": r.trans_stats.numpy(), "acc0": r.acc[0].numpy(),
                     "acc1": r.acc[1].numpy(), "z": r.z.numpy()}

    # engines on Gaussian and multinomial chains (JAX's data and init params)
    g = inp["gauss"]
    prior = make_prior(3, GaussianNIW, obs_dim=2, dtype=F64, device="cpu")
    p, elbos = fit_long_chain(g["p0"], prior, _t(g["chain"]), GaussianNIW, tmesh, num_iters=15)
    out["ts_vb"] = {"elbos": elbos.numpy(), "params": _np(p)}
    stats, gamma = time_sharded_local_step(g["p0"], GaussianNIW,
                                           shard_chain(_t(g["chain"]), tmesh), tmesh)
    out["ts_local"] = {"stats": _np(stats), "gamma": gamma.numpy()}
    for impl in ("fused", "twophase"):
        step = make_ts_stream_vb_step(GaussianNIW, tmesh, block_size=16, impl=impl)
        p, elbos = run_vb_scan(step, g["p0"], prior, shard_chain(_t(g["chain"]), tmesh), 12)
        out["ts_stream_" + impl] = {"elbos": elbos.numpy(), "params": _np(p)}
    m = inp["mult"]
    mprior = make_prior(3, MultinomialDirichlet, num_symbols=6, dtype=F64, device="cpu")
    _, elbos = fit_long_chain(m["p0"], mprior, torch.as_tensor(m["chain"]), MultinomialDirichlet,
                              tmesh, num_iters=10)
    out["ts_mult"] = {"elbos": elbos.numpy()}

    # one fused streaming VB step, the sharded decode and the Gaussian E-step
    g4 = inp["gauss4"]
    prior4 = make_prior(4, GaussianNIW, obs_dim=2, dtype=F64, device="cpu")
    sh = shard_chain(_t(g4["chain"]), tmesh)
    p, elbo = make_ts_stream_vb_step(GaussianNIW, tmesh, block_size=8, impl="fused")(
        g4["p0"], prior4, sh)
    out["ts_fused_step"] = {"elbo": elbo.numpy(), "params": _np(p),
                            "z": time_sharded_decode(g4["p0"], GaussianNIW, sh, tmesh,
                                                     block_size=8).numpy()}
    log_pi, log_A = expected_log_params(g4["p0"])
    r = time_sharded_long_chain_stats(
        log_pi, log_A, GaussianNIW.expected_log_likelihood(g4["p0"].emit, sh), tmesh,
        block_size=8, stat_xs=sh,
        stat_fn=lambda gm, y: emission_flat_stats(GaussianNIW, g4["p0"].emit, gm, y),
        stat_init=GaussianNIW.zero_stats(g4["p0"].emit))
    out["ts_estep"] = {"log_z": r.log_z.numpy(), "init": r.init_stats.numpy(),
                       "trans": r.trans_stats.numpy(), "acc": _np(r.acc)}

    # state-parallel VB at K = 16: each rank's block of the fitted params
    k = inp["large_k"]
    prior16 = make_prior(16, GaussianNIW, obs_dim=2, dtype=F64, device="cpu")
    p, elbos = fit_large_k(k["p0"], prior16, _t(k["chain"]), GaussianNIW, smesh, num_iters=12)
    out["ss_vb"] = {"elbos": elbos.numpy(), "params": _np(p)}
    blk = shard_params_by_state(k["p0"], smesh)
    p1, e1 = make_ss_vb_step(GaussianNIW, smesh)(blk, shard_params_by_state(prior16, smesh),
                                                  _t(k["chain"]))
    out["ss_step"] = {"elbo": e1.numpy(), "params": _np(p1)}

    # errors: every rank raises the same ValueError
    errs = {}
    for name, fn in _error_cases(rank, world, tmesh, smesh, m2).items():
        try:
            fn()
            errs[name] = "no error"
        except ValueError as e:
            errs[name] = str(e)
    out["errors"] = errs
    return out


def _error_cases(rank, world, tmesh, smesh, m2):
    cases = {}
    if world > 1:
        T_bad = 4 * world + 1  # not a multiple of the world
        cases["shard_chain_T"] = lambda: shard_chain(torch.zeros(T_bad, 2, dtype=F64), tmesh)
        # unequal tiles: the global T is no multiple of the axis size
        C = 4 + (rank == 0)
        ll = torch.zeros(C, 3, dtype=F64)
        lp, lA = torch.full((3,), -1.0986, dtype=F64), torch.full((3, 3), -1.0986, dtype=F64)
        cases["fb_tiles"] = lambda: time_sharded_forward_backward(lp, lA, ll, tmesh)
        cases["stream_tiles"] = lambda: time_sharded_long_chain_stats(lp, lA, ll, tmesh)
        K = world + 1  # not a multiple of the world
        cases["state_K"] = lambda: state_sharded_forward_backward(
            torch.zeros(1, dtype=F64), torch.zeros(1, K, dtype=F64), torch.zeros(5, 1, dtype=F64),
            smesh)
        cases["shard_params_K"] = lambda: shard_params_by_state(
            (torch.zeros(K, dtype=F64),), smesh)
    if MESH_2D[world][0] > 1:
        # every data-axis group holds one tile of 3 chains and one of 2
        B = 2 + (collectives.axis_index(m2.get_group("data")) == 0)
        cases["batched_B"] = lambda: time_sharded_forward_backward_batched(
            torch.zeros(3, dtype=F64), torch.zeros(3, 3, dtype=F64),
            torch.zeros(B, 4, 3, dtype=F64), m2)
    return cases


ERROR_CASES = {1: set(), 2: {"shard_chain_T", "fb_tiles", "stream_tiles", "state_K",
                             "shard_params_K"}}
ERROR_CASES[4] = ERROR_CASES[2] | {"batched_B"}


# --------------------------------------------------------------- the inputs


def _inputs():
    import jax

    from pysvihmm_tpu.data.synthetic import gen_gaussian_dataset, gen_multinomial_dataset
    from pysvihmm_tpu.distributions import GaussianNIW as JNIW
    from pysvihmm_tpu.distributions import MultinomialDirichlet as JMult
    from pysvihmm_tpu.models.hmm import init_params, make_prior as jprior

    rng = np.random.default_rng(11)

    def problem(T, K, shift=0.0, weights=False):
        return {"log_pi": np.log(rng.dirichlet(np.ones(K))),
                "log_A": np.log(rng.dirichlet(np.ones(K), size=K)),
                "ll": rng.normal(size=(T, K)) * 2.0 + shift,
                "w": (rng.uniform(size=T) > 0.3).astype(np.float64) if weights else None}

    inp = {"fb": problem(48, 5), "fbw": problem(48, 4, weights=True),
           "fbu": problem(512, 4, shift=-500.0), "ss": problem(30, 8, weights=True)}
    b2 = problem(40, 5)
    b2["ll"] = rng.normal(size=(4, 40, 5)) * 2.0
    b2["w"] = (rng.uniform(size=(4, 40)) > 0.3).astype(np.float64)
    inp["b2"] = b2
    st = problem(64, 5)
    st["xs"] = rng.normal(size=(64, 3))
    inp["stream"] = st
    fu = problem(96, 5)
    fu.update(W=rng.normal(size=(3, 5)), obs=rng.normal(size=(96, 3)))
    inp["fused"] = fu

    def chain_problem(key, K, T, seed, family=JNIW, **kw):
        if family is JMult:
            obs, _, _ = gen_multinomial_dataset(jax.random.PRNGKey(key), K=K, V=6, num_seqs=1,
                                                T=T)
            pr = jprior(K, JMult, num_symbols=6)
        else:
            obs, _, _ = gen_gaussian_dataset(jax.random.PRNGKey(key), K=K, D=2, num_seqs=1, T=T,
                                             **kw)
            pr = jprior(K, JNIW, obs_dim=2)
        jp0 = init_params(jax.random.PRNGKey(seed), pr, family, obs)
        jp0_np[len(jp0_np)] = jax.tree.map(np.asarray, jp0)
        return {"chain": np.asarray(obs[0]),
                "p0": convert.params_from_numpy(jp0, device="cpu", dtype=F64)}

    jp0_np = {}
    inp["gauss"] = chain_problem(3, 3, 400, 1, mean_scale=4.0, cov_scale=0.3)
    inp["mult"] = chain_problem(5, 3, 240, 2, family=JMult)
    inp["gauss4"] = chain_problem(0, 4, 96, 1)
    inp["large_k"] = chain_problem(3, 16, 240, 1, mean_scale=4.0)
    # the ranks get the port's params; JAX its own (NumPy leaves)
    jparams = dict(zip(("gauss", "mult", "gauss4", "large_k"), jp0_np.values()))
    return inp, jparams


# ---------------------------------------------------------- JAX's results


def _jax_cases(world, inp, jinit):
    """The same cases through the JAX package on a virtual mesh of ``world``
    CPU devices (float64)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from pysvihmm_tpu.distributions import GaussianNIW as JNIW
    from pysvihmm_tpu.distributions import MultinomialDirichlet as JMult
    from pysvihmm_tpu.messages.state_sharded import state_sharded_forward_backward as jss
    from pysvihmm_tpu.messages.time_sharded import (
        time_sharded_forward_backward as jts,
        time_sharded_forward_backward_batched as jts2,
        time_sharded_fused_stats as jfused,
        time_sharded_long_chain_stats as jstream,
    )
    from pysvihmm_tpu.models.hmm import (
        emission_flat_stats as jflat,
        expected_log_params as jelp,
        make_prior as jprior,
    )
    from pysvihmm_tpu.parallel import fit_large_k as jfit_large_k
    from pysvihmm_tpu.parallel import fit_long_chain as jfit_long_chain
    from pysvihmm_tpu.parallel.data_parallel import default_devices, make_mesh as jmake_mesh
    from pysvihmm_tpu.parallel.time_parallel import (
        make_ts_stream_vb_step as jts_stream_step,
        run_vb_scan as jrun,
        shard_chain as jshard_chain,
        time_sharded_decode as jdecode,
        time_sharded_local_step as jlocal,
    )

    out = {}
    tmesh = jmake_mesh(world, axis="time")
    smesh = jmake_mesh(world, axis="state")
    for name in ("fb", "fbw", "fbu"):
        c = inp[name]
        w = None if c["w"] is None else jnp.asarray(c["w"])
        r = jax.jit(lambda p, A, ll, w: jts(p, A, ll, tmesh, weights=w))(
            jnp.asarray(c["log_pi"]), jnp.asarray(c["log_A"]), jnp.asarray(c["ll"]), w)
        out[name] = {"gamma": r.gamma, "log_c": r.log_c, "log_z": r.log_z,
                     "trans": r.trans_stats, "init": r.init_stats}
    db, dt = MESH_2D[world]
    m2 = Mesh(np.array(default_devices()[:world]).reshape(db, dt), ("data", "time"))
    b2 = inp["b2"]
    r = jax.jit(lambda p, A, ll, w: jts2(p, A, ll, m2, weights=w))(
        jnp.asarray(b2["log_pi"]), jnp.asarray(b2["log_A"]), jnp.asarray(b2["ll"]),
        jnp.asarray(b2["w"]))
    out["b2"] = {"gamma": r.gamma, "log_c": r.log_c, "log_z": r.log_z, "trans": r.trans_stats,
                 "init": r.init_stats}
    ss = inp["ss"]
    r = jax.jit(lambda p, A, ll, w: jss(p, A, ll, smesh, weights=w))(
        jnp.asarray(ss["log_pi"]), jnp.asarray(ss["log_A"]), jnp.asarray(ss["ll"]),
        jnp.asarray(ss["w"]))
    out["ss"] = {"gamma": r.gamma, "log_c": r.log_c, "log_z": r.log_z, "trans": r.trans_stats,
                 "init": r.init_stats}

    st = inp["stream"]

    def sf(g, y):
        return (g.T @ y, jnp.sum(g, axis=0))

    for name, seed in (("stream", 0.0), ("stream_seeded", 1.0)):
        si = (jnp.full((5, 3), 7.0 * seed), jnp.full((5,), 3.0 * seed))
        r = jax.jit(lambda p, A, ll, x, si: jstream(p, A, ll, tmesh, block_size=8, stat_xs=x,
                                                   stat_fn=sf, stat_init=si))(
            jnp.asarray(st["log_pi"]), jnp.asarray(st["log_A"]), jnp.asarray(st["ll"]),
            jnp.asarray(st["xs"]), si)
        out[name] = {"log_z": r.log_z, "init": r.init_stats, "trans": r.trans_stats,
                     "acc0": r.acc[0], "acc1": r.acc[1]}
    fu = inp["fused"]
    W = jnp.asarray(fu["W"])
    si = (jnp.zeros((5, 3)), jnp.zeros((5,)))
    for name, o, tm in (("fused", fu["obs"], False), ("fused_tm", fu["obs"].T, True)):
        r = jax.jit(lambda p, A, o, tm=tm: jfused(
            p, A, o, lambda y: y @ W, tmesh, block_size=8, chunks=2, stat_fn=sf, stat_init=si,
            emit_argmax=True, time_minor=tm))(
            jnp.asarray(fu["log_pi"]), jnp.asarray(fu["log_A"]), jnp.asarray(o))
        out[name] = {"log_z": r.log_z, "init": r.init_stats, "trans": r.trans_stats,
                     "acc0": r.acc[0], "acc1": r.acc[1], "z": r.z}

    def jparams(name):
        return jax.tree.map(lambda x: jnp.asarray(x, jnp.float64), jinit[name])

    g = inp["gauss"]
    jpr = jprior(3, JNIW, obs_dim=2)
    jp0 = jparams("gauss")
    chain = jnp.asarray(g["chain"], jnp.float64)
    p, elbos = jfit_long_chain(jp0, jpr, chain, JNIW, tmesh, num_iters=15)
    out["ts_vb"] = {"elbos": elbos, "params": jax.tree.leaves(p)}
    stats, gamma = jax.jit(lambda p, o: jlocal(p, JNIW, o, tmesh))(jp0,
                                                                   jshard_chain(chain, tmesh))
    out["ts_local"] = {"stats": jax.tree.leaves(stats), "gamma": gamma}
    for impl in ("fused", "twophase"):
        step = jts_stream_step(JNIW, tmesh, block_size=16, impl=impl)
        p, elbos = jrun(step, jp0, jpr, jshard_chain(chain, tmesh), 12)
        out["ts_stream_" + impl] = {"elbos": elbos, "params": jax.tree.leaves(p)}
    m = inp["mult"]
    _, elbos = jfit_long_chain(jparams("mult"), jprior(3, JMult, num_symbols=6),
                               jnp.asarray(m["chain"]), JMult, tmesh, num_iters=10)
    out["ts_mult"] = {"elbos": elbos}

    g4 = inp["gauss4"]
    jp4 = jparams("gauss4")
    sh = jshard_chain(jnp.asarray(g4["chain"], jnp.float64), tmesh)
    p, elbo = jts_stream_step(JNIW, tmesh, block_size=8, impl="fused")(
        jp4, jprior(4, JNIW, obs_dim=2), sh)
    out["ts_fused_step"] = {"elbo": elbo, "params": jax.tree.leaves(p),
                            "z": jax.jit(lambda p, o: jdecode(p, JNIW, o, tmesh,
                                                              block_size=8))(jp4, sh)}
    def estep(p, o):
        log_pi, log_A = jelp(p)
        return jstream(log_pi, log_A, JNIW.expected_log_likelihood(p.emit, o), tmesh,
                       block_size=8, stat_xs=o, stat_fn=lambda gm, y: jflat(JNIW, p.emit, gm, y),
                       stat_init=JNIW.zero_stats(p.emit))

    r = jax.jit(estep)(jp4, sh)
    out["ts_estep"] = {"log_z": r.log_z, "init": r.init_stats, "trans": r.trans_stats,
                       "acc": jax.tree.leaves(r.acc)}

    k = inp["large_k"]
    jpr16 = jprior(16, JNIW, obs_dim=2)
    p, elbos = jfit_large_k(jparams("large_k"), jpr16, jnp.asarray(k["chain"], jnp.float64),
                            JNIW, smesh, num_iters=12)
    out["ss_vb"] = {"elbos": elbos, "params": jax.tree.leaves(p)}
    p1, e1 = jfit_large_k(jparams("large_k"), jpr16, jnp.asarray(k["chain"], jnp.float64),
                          JNIW, smesh, num_iters=1)
    out["ss_step"] = {"elbo": e1[0], "params": jax.tree.leaves(p1)}
    return jax.tree.map(np.asarray, out)


@pytest.fixture(scope="module")
def results():
    """{world: (the ranks' results, JAX's)}: one spawned gloo group a world
    size runs every case; JAX runs them in this process in float64."""
    import jax

    inp, jinit = _inputs()
    with ThreadPoolExecutor(len(WORLDS)) as pool:  # the groups run while JAX computes
        groups = {w: pool.submit(spawn_local, _rank_cases, w, inp, timeout=120.0)
                  for w in WORLDS}
        jax.config.update("jax_enable_x64", True)
        try:
            ref = {w: _jax_cases(w, inp, jinit) for w in WORLDS}
        finally:
            jax.config.update("jax_enable_x64", False)
        return {w: (groups[w].result(), ref[w]) for w in WORLDS}


def _cat(ranks, case, key, axis=0):
    return np.concatenate([r[case][key] for r in ranks], axis=axis)


def _close(a, b, rtol=0.0, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol, atol=atol, err_msg=what)


def _replicated(ranks, case, key):
    """A replicated output: the same bits on every rank; rank 0's."""
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[case][key], ranks[0][case][key])
    return ranks[0][case][key]


@pytest.mark.parametrize("world", WORLDS)
class TestTimeShardedFB:
    @pytest.mark.parametrize("case", ["fb", "fbw"])
    def test_matches_jax(self, results, world, case):
        ranks, ref = results[world]
        _close(_cat(ranks, case, "gamma"), ref[case]["gamma"], atol=1e-10, what="gamma")
        _close(_cat(ranks, case, "log_c"), ref[case]["log_c"], atol=1e-10, what="log_c")
        _close(_replicated(ranks, case, "log_z"), ref[case]["log_z"], rtol=1e-9)
        _close(_replicated(ranks, case, "trans"), ref[case]["trans"], atol=1e-10, what="trans")
        _close(_replicated(ranks, case, "init"), ref[case]["init"], atol=1e-12, what="init")

    def test_underflow_resistance(self, results, world):
        ranks, ref = results[world]
        log_z = _replicated(ranks, "fbu", "log_z")
        assert np.isfinite(log_z)
        _close(log_z, ref["fbu"]["log_z"], rtol=1e-9)


@pytest.mark.parametrize("world", WORLDS)
def test_time_sharded_2d_matches_jax(results, world):
    """(data, time) meshes of (1, 1), (1, 2) and (2, 2) processes."""
    ranks, ref = results[world]
    db, dt = MESH_2D[world]
    by = {(r["b2"]["bi"], r["b2"]["ti"]): r["b2"] for r in ranks}
    for key in ("gamma", "log_c"):
        full = np.concatenate([np.concatenate([by[(i, j)][key] for j in range(dt)], axis=1)
                               for i in range(db)], axis=0)
        _close(full, ref["b2"][key], atol=1e-10, what=key)
    log_z = np.concatenate([by[(i, 0)]["log_z"] for i in range(db)])
    init = np.concatenate([by[(i, 0)]["init"] for i in range(db)])
    _close(log_z, ref["b2"]["log_z"], rtol=1e-9)
    _close(init, ref["b2"]["init"], atol=1e-12)
    _close(_replicated(ranks, "b2", "trans"), ref["b2"]["trans"], atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
def test_state_sharded_matches_jax(results, world):
    """Each rank's state block of gamma, init_stats and trans_stats' rows,
    put together, against JAX's global arrays."""
    ranks, ref = results[world]
    _close(_cat(ranks, "ss", "gamma", axis=1), ref["ss"]["gamma"], atol=1e-10)
    _close(_cat(ranks, "ss", "init"), ref["ss"]["init"], atol=1e-12)
    _close(_cat(ranks, "ss", "trans"), ref["ss"]["trans"], atol=1e-10)
    _close(_replicated(ranks, "ss", "log_z"), ref["ss"]["log_z"], rtol=1e-9)
    _close(_replicated(ranks, "ss", "log_c"), ref["ss"]["log_c"], atol=1e-10)


@pytest.mark.parametrize("world", WORLDS)
class TestShardedStream:
    @pytest.mark.parametrize("case", ["stream", "stream_seeded", "fused", "fused_tm"])
    def test_matches_jax(self, results, world, case):
        """Twophase tiles with zero and nonzero stat_init (counted once), the
        likelihood-fused tiles time-major and time-minor."""
        ranks, ref = results[world]
        _close(_replicated(ranks, case, "log_z"), ref[case]["log_z"], rtol=1e-9)
        _close(_replicated(ranks, case, "init"), ref[case]["init"], atol=1e-11)
        for key in ("trans", "acc0", "acc1"):
            _close(_replicated(ranks, case, key), ref[case][key], atol=1e-9, what=key)
        if case.startswith("fused"):
            np.testing.assert_array_equal(_cat(ranks, case, "z"), ref[case]["z"])

    def test_gaussian_estep_matches_jax(self, results, world):
        ranks, ref = results[world]
        got, want = ranks[0]["ts_estep"], ref["ts_estep"]
        _close(got["log_z"], want["log_z"], rtol=1e-9)
        _close(got["init"], want["init"], atol=1e-10)
        _close(got["trans"], want["trans"], rtol=1e-9, atol=1e-9)
        for a, b in zip(got["acc"], want["acc"]):
            _close(a, b, rtol=1e-9, atol=1e-9)


def _params_close(got, want, rtol):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _close(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


@pytest.mark.parametrize("world", WORLDS)
class TestTimeShardedEngine:
    @pytest.mark.parametrize("case", ["ts_vb", "ts_stream_fused", "ts_stream_twophase"])
    def test_vb_trajectory_matches_jax(self, results, world, case):
        ranks, ref = results[world]
        _close(_replicated(ranks, case, "elbos"), ref[case]["elbos"], rtol=1e-9)
        _params_close(ranks[0][case]["params"], ref[case]["params"], 1e-8)

    def test_multinomial_chain(self, results, world):
        ranks, ref = results[world]
        _close(_replicated(ranks, "ts_mult", "elbos"), ref["ts_mult"]["elbos"], rtol=1e-9)

    def test_local_step_matches_jax(self, results, world):
        ranks, ref = results[world]
        _params_close(ranks[0]["ts_local"]["stats"], ref["ts_local"]["stats"], 1e-9)
        _close(np.concatenate([r["ts_local"]["gamma"] for r in ranks]),
               ref["ts_local"]["gamma"], atol=1e-10)

    def test_fused_vb_step_and_decode(self, results, world):
        ranks, ref = results[world]
        got, want = ranks[0]["ts_fused_step"], ref["ts_fused_step"]
        _close(got["elbo"], want["elbo"], rtol=1e-9)
        _params_close(got["params"], want["params"], 1e-8)
        np.testing.assert_array_equal(np.concatenate([r["ts_fused_step"]["z"] for r in ranks]),
                                      want["z"])


@pytest.mark.parametrize("world", WORLDS)
class TestStateParallelEngine:
    @pytest.mark.parametrize("case,iters", [("ss_step", 1), ("ss_vb", 12)])
    def test_vb_matches_jax(self, results, world, case, iters):
        """Each rank's block of every K-leading leaf, put together, against
        JAX's global arrays after ``iters`` iterations of fit_large_k."""
        ranks, ref = results[world]
        key = "elbo" if case == "ss_step" else "elbos"
        _close(_replicated(ranks, case, key), ref[case][key], rtol=1e-9)
        full = [np.concatenate([r[case]["params"][i] for r in ranks])
                for i in range(len(ref[case]["params"]))]
        _params_close(full, ref[case]["params"], 1e-8)


@pytest.mark.parametrize("world", WORLDS)
def test_indivisible_raise(results, world):
    """T, K and B that the axis size does not divide raise ValueError on
    every rank: shard_chain, unequal tiles of the time tiers, the state
    tier's K and shard_params_by_state, the 2-D tier's batch."""
    ranks, _ = results[world]
    for r in ranks:
        assert set(r["errors"]) == ERROR_CASES[world]
        for name, msg in r["errors"].items():
            assert "divisible" in msg, (name, msg)
