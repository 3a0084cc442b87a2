"""Build the port's CUDA sources with ``nvcc`` at first use and load them.

Each library ``<name>`` is compiled from ``csrc/<name>.cu`` and the other
translation units :data:`UNITS` names for it into a shared library with a
plain C interface (no PyTorch headers, so ``nvcc`` takes seconds) under
``build/torch_kernels/`` at the repository root, and loaded with
:mod:`ctypes`. The library's file name carries a hash of its units, of
every ``csrc/`` header they include (``#include "..."``, followed
transitively) and of the compiler flags, so an edited source or header is
rebuilt and a stale library is never loaded. :func:`build` compiles every
unit of several libraries at once, one ``nvcc -c`` each, all started
together, then links each library. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
GENCODE = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (
    *GENCODE,
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, to build_log
    # the optimiser's passes on as many threads as the host has cores: the
    # fused and duplex sources hold every feature kind's instances (about
    # 150 and 110 s on one thread each, 62 s for the three chain sources at
    # once with this flag on an 8-core host; PERF.md)
    "-split-compile=0",
)
LINK_FLAGS = ("-shared", *GENCODE)

# the translation units of a library beyond csrc/<name>.cu, each compiled by
# its own nvcc at the same time: the fused pair's modes' instances
# (fused_fb_modes.cu) double the fused library's instances, and its
# instances for features wider than 64 (fused_fb_wide.cu, and their modes'
# in fused_fb_wide_modes.cu) add as many again; as units of their own they
# build beside the default ones instead of after them (PERF.md); the duplex
# pair's instances for features wider than 64 (duplex_fb_wide.cu) the same,
# and the fused and split pairs' instances above 256 states (fused_fb_xl.cu,
# split_fb_xl.cu)
UNITS = {"fused_fb": ("fused_fb", "fused_fb_modes", "fused_fb_wide", "fused_fb_wide_modes",
                      "fused_fb_xl"),
         "split_fb": ("split_fb", "split_fb_xl"),
         "duplex_fb": ("duplex_fb", "duplex_fb_wide")}

_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}  # per library: wall time of its units' nvcc and the link
build_log: dict[str, str] = {}  # per library: what nvcc and ptxas printed


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


def units(name: str) -> tuple[str, ...]:
    """The translation units of library ``name``: ``csrc/<unit>.cu`` each."""
    return UNITS.get(name, (name,))


def library_path(name: str) -> Path:
    """Where library ``name``, built from its :func:`units`, lives."""
    h = hashlib.sha256()
    for unit in units(name):
        for f in sources(unit):
            h.update(f.encode() + b"\0" + (CSRC / f).read_bytes() + b"\0")
    h.update(" ".join((*NVCC_FLAGS, "|", *LINK_FLAGS)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def _run(cmd: list[str]) -> tuple[int, str, float]:
    """(exit code, output, wall seconds) of one compiler process."""
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc.returncode, proc.stdout, time.perf_counter() - t0


def build(names: list[str]) -> None:
    """Build every library of ``names`` that is missing: each unit of each
    compiled to an object by its own ``nvcc -c``, all running at once, then
    each library linked from its objects; raise if any step fails."""
    todo = [n for n in dict.fromkeys(names) if not library_path(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = {(n, u): library_path(n).with_suffix(f".{u}.{tag}.o") for n in todo for u in units(n)}
    cmds = {key: [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(CSRC / f"{key[1]}.cu")]
            for key, obj in objs.items()}
    with ThreadPoolExecutor(len(cmds)) as pool:
        done = dict(zip(cmds, pool.map(_run, cmds.values())))
    failed = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{tag}")
        compiled = [done[name, u] for u in units(name)]
        logs = [log for _, log, _ in compiled]
        seconds = max(s for _, _, s in compiled)
        errors = [f"nvcc failed on {u}.cu (exit {code}):\n{log}"
                  for u, (code, log, _) in zip(units(name), compiled) if code != 0]
        if not errors:
            code, log, s = _run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                                 *(str(objs[name, u]) for u in units(name))])
            logs.append(log)
            seconds += s
            if code != 0:
                errors.append(f"nvcc failed to link {name} (exit {code}):\n{log}")
        build_log[name], build_seconds[name] = "".join(logs), seconds
        for u in units(name):
            objs[name, u].unlink(missing_ok=True)
        if errors:
            tmp.unlink(missing_ok=True)
            failed += errors
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
