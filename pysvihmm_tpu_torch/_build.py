"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled into a shared library with a plain C
interface (no PyTorch headers, so ``nvcc`` takes seconds) under
``build/torch_kernels/`` at the repository root, and loaded with
:mod:`ctypes`. The library's file name carries a hash of the source, of
every ``csrc/`` header it includes (``#include "..."``, followed
transitively) and of the compiler flags, so an edited source or header is
rebuilt and a stale library is never loaded. :func:`build` compiles several
sources at once, one ``nvcc`` each, all started together. Nothing here runs
at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, to build_log
)

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # per source: wall time of the nvcc call
build_log: dict[str, str] = {}  # per source: what nvcc and ptxas printed


def _nvcc() -> str:
    """Path of ``nvcc``: $CUDA_HOME/bin, then PATH, then /usr/local/cuda/bin."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin): "
        "the CUDA kernels cannot be built"
    )


def sources(name: str) -> list[str]:
    """``<name>.cu`` and the ``csrc/`` headers it includes, transitively, in
    the order they are first met (file names relative to ``csrc/``)."""
    found, todo = [], [f"{name}.cu"]
    while todo:
        f = todo.pop(0)
        if f not in found:
            found.append(f)
            todo += _INCLUDE.findall((CSRC / f).read_text())
    return found


def library_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives."""
    h = hashlib.sha256()
    for f in sources(name):
        h.update(f.encode() + b"\0" + (CSRC / f).read_bytes() + b"\0")
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build(names: list[str]) -> None:
    """Compile every ``csrc/<name>.cu`` whose library is missing, one nvcc
    process each, all running at once; raise if any of them fails."""
    todo = [n for n in dict.fromkeys(names) if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = log
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {name}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("\n".join(failed))


def loaded_library(name: str) -> ctypes.CDLL | None:
    """The library of ``csrc/<name>.cu`` if it is loaded, else None (no build)."""
    return _loaded.get(name)


def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it once."""
    if name not in _loaded:
        build([name])
        _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return _loaded[name]
