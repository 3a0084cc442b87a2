"""The split probes' plain twins (messages/split_probe.py) against the JAX
script's own kernel bodies, on CPU.

``scripts/debug_pallas_split.py`` defines its Pallas kernels inside
``main``; the test reads the script as text, takes the bodies ``_fwd_nos``,
``_fwd_stack``, ``make_micro``, ``body_dot_only``, ``body_dot_store``,
``body_bf16`` and ``make_chunked`` out of ``main`` with :mod:`ast`, and
compiles them into a namespace that holds the names their closures read and
a ``pl`` whose ``pallas_call`` runs in interpret mode. The script itself is
neither edited nor run. ``_fwd_nos`` and ``_fwd_stack`` get the script's
grid and block specs (debug_pallas_split.py:166-200); ``make_micro`` builds
its own.

Tolerances: float32 to rtol 1e-5 (K-term sums in another order) with an
atol of 1e-30, since the micro bodies' third tile is subnormal and XLA:CPU
may flush what torch keeps; bf16 to rtol 1.6e-2, two bf16 ulps, since a
one-ulp flip carries into the later steps. "dot_only" writes rows
t % C == 0 only (interpret mode leaves the others NaN), so only those are
compared.

The CUDA kernels are checked against the same twins on the card by
tests/test_torch_cuda.py and chip_smoke.py (phase 8).
"""

import ast
import functools
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from pysvihmm_tpu_torch.messages import split_probe

torch.set_num_threads(1)

SCRIPT = Path(__file__).resolve().parent.parent / "scripts" / "debug_pallas_split.py"
BODIES = ("_fwd_nos", "_fwd_stack", "make_micro", "body_dot_only", "body_dot_store",
          "body_bf16", "make_chunked")
F32 = dict(rtol=1e-5, atol=1e-30)
BF16 = dict(rtol=1.6e-2, atol=1e-30)
# (T, B, K, C, tile_b) and the chunk counts that divide tile_b
CASES = {"small": ((16, 4, 8, 8, 4), (2, 4)), "odd_k": ((24, 4, 33, 4, 2), (2,))}


@functools.lru_cache(maxsize=None)
def _jax_script(T, B, K, C, tile_b):
    """The script's kernel bodies, compiled for this shape."""
    tree = ast.parse(SCRIPT.read_text(), filename=str(SCRIPT))
    main = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")
    defs = [n for n in main.body if isinstance(n, ast.FunctionDef) and n.name in BODIES]
    assert sorted(d.name for d in defs) == sorted(BODIES)
    interpret_pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec, program_id=pl.program_id)
    ns = dict(jax=jax, jnp=jnp, functools=functools, pltpu=pltpu, pl=interpret_pl,
              T=T, B=B, K=K, C=C, nB=B // tile_b, nT=T // C, tile_b=tile_b,
              cp=pltpu.CompilerParams(vmem_limit_bytes=100 * 1024 * 1024))
    exec(compile(ast.Module(body=defs, type_ignores=[]), str(SCRIPT), "exec"), ns)
    return types.SimpleNamespace(**ns)


def _fwd_call(s, kernel, stack):
    """``_fwd_nos`` / ``_fwd_stack`` with the script's grid and specs (:166-200)."""
    T, K, C, tile_b = s.T, s.K, s.C, s.tile_b
    alpha_spec = pl.BlockSpec((C, tile_b, K), lambda i, j: (j, i, 0), memory_space=pltpu.VMEM)
    out_specs, out_shape = alpha_spec, jax.ShapeDtypeStruct((T, s.B, K), jnp.float32)
    if stack:
        out_specs = [alpha_spec, pl.BlockSpec((C, tile_b), lambda i, j: (j, i),
                                              memory_space=pltpu.VMEM)]
        out_shape = [out_shape, jax.ShapeDtypeStruct((T, s.B), jnp.float32)]
    return s.pl.pallas_call(
        functools.partial(kernel, C=C),
        grid=(s.nB, s.nT),
        in_specs=[
            pl.BlockSpec((1, K), lambda i, j: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((K, K), lambda i, j: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((C, tile_b, K), lambda i, j: (j, i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=out_specs,
        out_shape=out_shape,
        scratch_shapes=[pltpu.VMEM((tile_b, K), jnp.float32)],
        compiler_params=s.cp,
    )


def _inputs(T, B, K, seed):
    """The script's inputs (:81-86) from NumPy: lik ~ U[0.01, 1), pi = 1/K,
    A's rows Dirichlet(1); float32."""
    rng = np.random.default_rng(seed)
    lik = rng.uniform(0.01, 1.0, size=(T, B, K)).astype(np.float32)
    pi = np.full((K,), 1.0 / K, np.float32)
    A = rng.dirichlet(np.ones(K), size=K).astype(np.float32)
    return pi, A, lik


def _jax_variant(s, variant, pi, A, lik):
    """The JAX script's output for one variant, as NumPy float32."""
    args = (jnp.asarray(pi)[None, :], jnp.asarray(A), jnp.asarray(lik))
    if variant == "fwd_nos":
        out = _fwd_call(s, s._fwd_nos, False)(*args)
    elif variant == "fwd_stack":
        out = _fwd_call(s, s._fwd_stack, True)(*args)
    elif variant == "dot_bf16":
        out = s.make_micro(s.body_bf16, jnp.bfloat16)(*args)
    elif variant.startswith("chunk"):
        out = s.make_micro(s.make_chunked(int(variant[5:])))(*args)
    else:
        out = s.make_micro({"dot_only": s.body_dot_only, "dot_store": s.body_dot_store}[variant])(
            *args)
    return jax.tree.map(lambda x: np.asarray(x.astype(jnp.float32)), out)


def _port_variant(variant, pi, A, lik, C):
    args = (torch.from_numpy(pi), torch.from_numpy(A), torch.from_numpy(lik), C)
    if variant == "fwd_nos":
        return [split_probe.probe_fwd_nos_reference(*args)]
    if variant == "fwd_stack":
        alpha, s = split_probe.probe_fwd_stack_reference(*args)
        return [alpha, s]
    if variant.startswith("chunk"):  # every port chunk body computes what JAX's chunked ones do
        return [split_probe.probe_micro_reference(*args, body) for body in ("chunk8", "chunk4")]
    return [split_probe.probe_micro_reference(*args, variant)]


PARAMS = [(case, v) for case, (_, chunks) in CASES.items()
          for v in ("fwd_nos", "fwd_stack", "dot_only", "dot_store", "dot_bf16",
                    *(f"chunk{n}" for n in chunks))]


@pytest.mark.parametrize("case,variant", PARAMS)
def test_twin_matches_the_jax_script(case, variant):
    (T, B, K, C, tile_b), _ = CASES[case]
    pi, A, lik = _inputs(T, B, K, seed=T * K)
    want = _jax_variant(_jax_script(T, B, K, C, tile_b), variant, pi, A, lik)
    got = _port_variant(variant, pi, A, lik, C)
    if variant == "fwd_stack":
        want = list(want)
    else:
        want = [want] * len(got)
    rows = slice(None, None, C) if variant == "dot_only" else slice(None)
    tol = BF16 if variant == "dot_bf16" else F32
    for g, w in zip(got, want):
        assert g.dtype == (torch.bfloat16 if variant == "dot_bf16" else torch.float32)
        g = g.float().numpy()[rows]
        w = w[rows]
        assert np.isfinite(g).all() and (g[0] > 0).all()
        np.testing.assert_allclose(g, w, **tol)


def test_dot_only_leaves_the_other_rows_unwritten():
    T, B, K, C = 16, 3, 5, 8
    pi, A, lik = (torch.from_numpy(x) for x in _inputs(T, B, K, seed=1))
    alpha = split_probe.probe_micro_reference(pi, A, lik, C, "dot_only")
    keep = torch.arange(T) % C == 0
    assert bool(torch.isnan(alpha[~keep]).all()) and bool(torch.isfinite(alpha[keep]).all())
    store = split_probe.probe_micro_reference(pi, A, lik, C, "dot_store")
    torch.testing.assert_close(alpha[keep], store[C - 1::C], rtol=0, atol=0)


def test_cpu_launchers_run_the_plain_twins():
    """On CPU tensors each launcher is its twin, bit for bit, and counts no
    kernel launch."""
    T, B, K, C = 16, 3, 6, 4
    pi, A, lik = (torch.from_numpy(x) for x in _inputs(T, B, K, seed=2))
    split_probe.reset_launch_counts()
    torch.testing.assert_close(split_probe.probe_fwd_nos(pi, A, lik, C),
                               split_probe.probe_fwd_nos_reference(pi, A, lik, C), rtol=0, atol=0)
    for x, y in zip(split_probe.probe_fwd_stack(pi, A, lik, C),
                    split_probe.probe_fwd_stack_reference(pi, A, lik, C)):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    for body in split_probe.MICRO_BODIES:
        got = split_probe.probe_micro(pi, A, lik, C, body)
        torch.testing.assert_close(got, split_probe.probe_micro_reference(pi, A, lik, C, body),
                                   rtol=0, atol=0, equal_nan=True)
        assert got.dtype == split_probe.micro_dtype(body)
    assert split_probe.probe_fwd_nos.launches == split_probe.probe_fwd_stack.launches == 0
    assert set(split_probe.probe_micro.launches.values()) == {0}


def test_chunked_bodies_compute_dot_store():
    pi, A, lik = (torch.from_numpy(x) for x in _inputs(24, 5, 7, seed=3))
    store = split_probe.probe_micro_reference(pi, A, lik, 8, "dot_store")
    for body in ("chunk8", "chunk4"):
        torch.testing.assert_close(split_probe.probe_micro(pi, A, lik, 8, body), store,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "contiguity", "shape", "device_mix", "c_divides_t",
                                 "body"])
def test_launchers_reject_what_the_kernels_do_not_take(bad):
    pi, A, lik = (torch.from_numpy(x) for x in _inputs(16, 3, 4, seed=4))
    C, body = 8, "dot_store"
    if bad == "dtype":
        lik = lik.double()
    elif bad == "contiguity":
        lik = lik.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "shape":
        A = A[:, :-1]
    elif bad == "device_mix":
        lik = lik.to("meta")
    elif bad == "c_divides_t":
        C = 5
    else:
        body = "dot_fp8"
    with pytest.raises(ValueError):
        split_probe.probe_micro(pi, A, lik, C, body)
    if bad != "body":
        with pytest.raises(ValueError):
            split_probe.probe_fwd_nos(pi, A, lik, C)
        with pytest.raises(ValueError):
            split_probe.probe_fwd_stack(pi, A, lik, C)


def test_probe_bounds_at_the_script_shape():
    """Each variant's least time at T = 1000, B = 1024, K = 64, C = 8: each
    input read once, each output written once, the bf16 body's operations
    at the bf16 peak (utils/roofline.py)."""
    from pysvihmm_tpu_torch.scripts.debug_split import VARIANTS, bound_ms

    want = {"fwd": (0.159, "bytes"), "bwd": (0.258, "operations"),
            "fwd_nos": (0.157, "bytes"), "fwd_stack": (0.158, "bytes"),
            "dot_only": (0.125, "operations"), "dot_store": (0.125, "operations"),
            "chunk8": (0.125, "operations"), "chunk4": (0.125, "operations"),
            "dot_bf16": (0.039, "bytes")}
    assert set(want) == {label for label, _ in VARIANTS.values()}
    for label, (ms, by) in want.items():
        got_ms, got_by = bound_ms(label, 1024, 1000, 64, 8)
        assert got_by == by and abs(got_ms - ms) < 1e-3, (label, got_ms, got_by)


def test_debug_split_exits_nonzero_without_a_card():
    import subprocess
    import sys

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible here: the script runs for real")
    proc = subprocess.run([sys.executable, "-m", "pysvihmm_tpu_torch.scripts.debug_split",
                           "8", "8", "8", "n", "4"], cwd=SCRIPT.parent.parent,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "needs an NVIDIA GPU" in proc.stderr
    assert "ms/it" not in proc.stdout
