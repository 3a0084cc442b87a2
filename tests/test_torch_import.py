"""The port stands alone: it imports neither JAX nor the JAX package, and
chip_smoke.py refuses to run (exit code != 0, no result line) without a GPU
or without the repository around it."""

import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import pysvihmm_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for n in ("messages.duplex_fb", "distributions.diag_gaussian", "distributions.poisson"):
    assert pkg.__name__ + "." + n in names, n
for n in names:
    importlib.import_module(n)
import chip_smoke
leaked = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
                or m == "pysvihmm_tpu" or m.startswith("pysvihmm_tpu."))
print(len(names), leaked)
"""


def _run(args, cwd, timeout=120):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


def test_port_imports_no_jax():
    proc = _run(["-c", _IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stderr
    n, leaked = proc.stdout.strip().split(" ", 1)
    assert int(n) >= 18  # every subpackage and module of the port
    assert leaked == "[]"


def test_chip_smoke_fails_without_a_gpu():
    proc = _run(["chip_smoke.py"], REPO)
    if "torch.cuda.is_available() is false" not in proc.stderr:
        pytest.skip("a GPU is visible here; chip_smoke.py runs for real on the card")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
