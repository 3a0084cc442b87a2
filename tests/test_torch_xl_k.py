"""The port's fused and split routes above 256 states against the JAX package.

The CUDA kernels take K up to 1024 on the fused and split pairs (the XL
instances of ``csrc/fb_xl.cuh`` above 256); here, on the CPU, the launchers
run their plain PyTorch twins, and those are held to JAX's Pallas kernels
in interpret mode: ``batch_local_step`` on "fused" against ``pallas_fused``
at (B, T, K, D) = (2, 16, 300, 2), ungated, and (2, 16, 512, 2) under a
kept-mask, and on "split" against ``pallas`` at (2, 16, 300, 2), gated.
JAX runs with every precision knob at "highest". The inputs come from one
NumPy seed per test.

Tolerances are tests/test_torch_large_k.py's (tests/test_pallas.py:246-251):
gamma and init 5e-5, trans atol min(1e-3, 1e-4 x its largest entry), log_z
rtol 2e-6, emit rtol 3e-3 atol 2e-3: float32 on both sides, another order
of summation.

The tiers' plumbing is checked too: which padded state count takes a K
(``_launch.instance_tier``), which S each library builds there, the modes
the XL tiers leave out (``NotImplementedError`` at launch) and the one
block an SM that the S rule counts there. The kernels themselves, their
ceilings (1024 on the fused and split pairs, 256 on the duplex pair and the
probes) and their bits at every S are checked on the card by
tests/test_torch_cuda.py and chip_smoke.py's phase 17.
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pysvihmm_tpu.distributions.emissions import GaussianNIW as JGaussianNIW
from pysvihmm_tpu.engines.base import batch_local_step as jbatch_local_step
from pysvihmm_tpu.models import hmm as jhmm
from pysvihmm_tpu_torch import convert
from pysvihmm_tpu_torch.distributions import GaussianNIW
from pysvihmm_tpu_torch.engines.base import batch_local_step
from pysvihmm_tpu_torch.messages import _launch, fused_fb, split_fb

torch.set_num_threads(1)

PRECISION_KNOBS = ("PYSVIHMM_KERNEL_PREC", "PYSVIHMM_LL_PREC", "PYSVIHMM_STATS_PREC")


@pytest.fixture(scope="module")
def jax_highest():
    """JAX's kernels at exact float32 and its duplex knob off for the whole
    module (JAX reads the knobs while tracing, so its caches are cleared on
    the way in and out)."""
    with pytest.MonkeyPatch.context() as mp:
        for knob in PRECISION_KNOBS:
            mp.setenv(knob, "highest")
        mp.delenv("PYSVIHMM_DUPLEX", raising=False)
        jax.clear_caches()
        yield
    jax.clear_caches()


def _obs(B, T, K, D, seed):
    """Gaussian HMM observations (B, T, D) float32 from a NumPy seed."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=4.0, size=(K, D))
    z = np.empty((B, T), np.int64)
    z[:, 0] = rng.integers(0, K, size=B)
    for t in range(1, T):
        stay = rng.random(B) < 0.8
        z[:, t] = np.where(stay, z[:, t - 1], rng.integers(0, K, size=B))
    return (centres[z] + 0.8 * rng.normal(size=(B, T, D))).astype(np.float32)


# (port route, JAX method, (B, T, K, D), gated)
XL_CASES = [
    ("fused", "pallas_fused", (2, 16, 300, 2), False),
    ("fused", "pallas_fused", (2, 16, 512, 2), True),
    ("split", "pallas", (2, 16, 300, 2), True),
]


@pytest.mark.parametrize("route,jmethod,shape,gated", XL_CASES)
def test_local_step_matches_jax_above_256_states(jax_highest, route, jmethod, shape, gated):
    """batch_local_step on the port's fused and split routes against JAX's
    Pallas kernels, from the same NumPy observations and JAX's own
    init_params; on the CPU no kernel launch is counted."""
    B, T, K, D = shape
    obs = _obs(B, T, K, D, seed=K + D)
    jprior = jhmm.make_prior(K, JGaussianNIW, obs_dim=D)
    jp = jhmm.init_params(jax.random.PRNGKey(K), jprior, JGaussianNIW, jnp.asarray(obs))
    w = (np.random.default_rng(7).random((B, T)) > 0.3).astype(np.float32) if gated else None
    js, jg = jbatch_local_step(jp, JGaussianNIW, jnp.asarray(obs), jmethod,
                               weights=None if w is None else jnp.asarray(w))
    launches = (fused_fb.fused_backward.launches, split_fb.split_backward.launches,
                dict(fused_fb.fused_backward.xl_launches),
                dict(split_fb.split_backward.xl_launches))
    ts, tg = batch_local_step(convert.params_from_numpy(jp, device="cpu"), GaussianNIW,
                              torch.from_numpy(obs), route,
                              weights=None if w is None else torch.from_numpy(w))
    assert (fused_fb.fused_backward.launches, split_fb.split_backward.launches,
            fused_fb.fused_backward.xl_launches, split_fb.split_backward.xl_launches) == launches
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=5e-5)
    np.testing.assert_allclose(ts.init.numpy(), np.asarray(js.init), atol=5e-5)
    ref = np.asarray(js.trans)
    np.testing.assert_allclose(ts.trans.numpy(), ref, atol=min(1e-3, 1e-4 * np.abs(ref).max()))
    np.testing.assert_allclose(ts.log_z.item(), float(js.log_z), rtol=2e-6)
    for a, b in zip(ts.emit, js.emit):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=3e-3, atol=2e-3)


@pytest.mark.parametrize("K,tier", [(1, 64), (64, 64), (65, 128), (128, 128), (129, 256),
                                    (256, 256), (257, 512), (512, 512), (513, 1024),
                                    (1024, 1024), (1025, 1025)])
def test_instance_tier(K, tier):
    """The padded state count whose instance takes K: the XL tiers 512 and
    1024 above 256, and K itself past 1024, where no library has one."""
    assert _launch.instance_tier(K) == tier


@pytest.mark.parametrize("K", [257, 300, 512, 513, 1024])
def test_xl_tiers_build_every_wide_s(K):
    """Both pairs build S = 1, 2, 4, 8 at the XL tiers, as above K = 64."""
    assert fused_fb.built_seqs(K) == fused_fb.WIDE_SEQS == (1, 2, 4, 8)
    for kernel in ("forward", "backward", "gated backward"):
        assert split_fb.built_seqs(kernel, K) == split_fb.WIDE_SEQS
    with pytest.raises(ValueError, match="S=3"):
        split_fb.check_seqs("backward", 3, K)


@pytest.mark.parametrize("route", ["fused", "split"])
@pytest.mark.parametrize("mode", ["bf16_alpha", "gamma_sel"])
def test_modes_left_out_above_256_raise(route, mode):
    """bf16 alpha and the pick have no XL instance: the launchers' check
    raises NotImplementedError from K = 257 on, naming the mode and K, and
    lets 256 and the modes switched off pass."""
    _launch.check_xl_modes(256, route, **{mode: True})
    _launch.check_xl_modes(1024, route, **{mode: False})
    with pytest.raises(NotImplementedError, match=rf"{mode}.*K=257"):
        _launch.check_xl_modes(257, route, **{mode: True})
    with pytest.raises(NotImplementedError, match=rf"{route}.*K=1024"):
        _launch.check_xl_modes(1024, route, **{mode: True})


@pytest.mark.parametrize("K,per_sm,resident", [(256, 2, 264), (512, 2, 132), (1024, 1, 132),
                                               (512, 0, 0)])
def test_xl_tiers_count_one_block_an_sm(K, per_sm, resident):
    """The one-wave rule's resident blocks: every block the card holds up to
    256 states, one an SM at the XL tiers (each block reads all of A~ from
    L2 a step). With the H100's 132 SMs, B = 1024 then takes S = 8 there."""
    info = {"blocks_per_sm": per_sm, "sms": 132}
    assert _launch.resident_blocks(info, K) == resident
    if resident:
        S = fused_fb.seqs_per_block(1024, {s: resident for s in fused_fb.WIDE_SEQS},
                                    seqs=fused_fb.WIDE_SEQS)
        assert S == (8 if K > 256 else 4)


def test_xl_launch_counts_by_tier():
    """count_xl adds a launcher's call under its XL tier and ignores K <= 256."""
    def fn():
        pass
    fn.xl_launches = {}
    for K in (64, 256, 257, 512, 513, 1024):
        _launch.count_xl(fn, K)
    assert fn.xl_launches == {512: 2, 1024: 2}


def test_the_tiers_are_the_sources():
    """_launch keeps its own copy of the tiers, which the launchers need on
    the CPU without a library: XL_MIN is one past fb_wide.cuh's KWIDE, and
    the last two STATE_TIERS are fb_xl.cuh's xl_tier_of cut and KXL."""
    csrc = Path(_launch.__file__).resolve().parents[1] / "csrc"
    wide = (csrc / "fb_wide.cuh").read_text()
    xl = (csrc / "fb_xl.cuh").read_text()
    kwide = int(re.search(r"constexpr int KWIDE = (\d+);", wide).group(1))
    kxl = int(re.search(r"constexpr int KXL = (\d+);", xl).group(1))
    cut = re.search(r"xl_tier_of\(int K\) \{ return K <= (\d+) \? (\d+) : (\d+); \}", xl)
    assert _launch.XL_MIN == kwide + 1
    assert _launch.STATE_TIERS[-3:] == (kwide, int(cut.group(1)), kxl)
    assert int(cut.group(2)) == int(cut.group(1)) and int(cut.group(3)) == kxl
