"""Launcher plumbing shared by the port's CUDA kernels (``fused_fb``,
``split_fb``, ``duplex_fb``): argument checks, the CPU-twin / CUDA-kernel routing, and
raising on a CUDA error code a C launcher returns."""

from __future__ import annotations

import ctypes

import torch


def check(name: str, x: torch.Tensor, shape: tuple[int, ...], device: torch.device) -> None:
    """Raise unless ``x`` is a contiguous float32 tensor of ``shape`` on ``device``."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name} must be float32, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected {shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def runs_plain_twin(x: torch.Tensor) -> bool:
    """True for CPU tensors (run the plain twin), False for CUDA ones
    (launch the kernel); any other device raises."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the E-step kernels take CPU or CUDA tensors, got {x.device}")
    return x.device.type == "cpu"


def device_index(dev: torch.device) -> int:
    return dev.index if dev.index is not None else torch.cuda.current_device()


def stream(dev: torch.device) -> int:
    """PyTorch's current CUDA stream on ``dev``, as the C launchers take it."""
    return torch.cuda.current_stream(dev).cuda_stream


def ptr(x: torch.Tensor | None) -> int | None:
    """Device pointer of ``x``, or None (a null pointer) for a missing input."""
    return None if x is None else x.data_ptr()


def raise_on(error_string, code: int, what: str) -> None:
    """Raise if the C launcher returned a CUDA error; ``error_string`` is the
    library's ``cudaGetErrorString`` wrapper."""
    if code != 0:
        msg = error_string(code).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {code} ({msg})")


def bind(lib: ctypes.CDLL, signatures: dict[str, str], error_string: str) -> ctypes.CDLL:
    """Set argtypes and restype on a freshly loaded library, once. Each
    signature spells the arguments as "p" (pointer or stream) and "i" (int);
    those functions return an int. ``error_string`` names the library's
    ``const char* (int)`` wrapper of ``cudaGetErrorString``."""
    if not getattr(lib, "_bound", False):
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int}
        for fn, sig in signatures.items():
            getattr(lib, fn).argtypes = [kinds[c] for c in sig]
            getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, error_string).argtypes = [ctypes.c_int]
        getattr(lib, error_string).restype = ctypes.c_char_p
        lib._bound = True
    return lib
