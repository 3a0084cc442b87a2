"""Launcher plumbing shared by the port's CUDA kernels (``fused_fb``,
``split_fb``, ``duplex_fb``): argument checks, the CPU-twin / CUDA-kernel routing, and
raising on a CUDA error code a C launcher returns."""

from __future__ import annotations

import ctypes

import torch


def instance_tier(K: int) -> int:
    """The K a library's ``*_kernel_info`` knows the instance that takes K
    states by: 64 up to 64 (the S-sequence instances), else the padded state
    count of the large-K instance, 128 or 256 (csrc/fb_wide.cuh)."""
    return 64 if K <= 64 else 128 if K <= 128 else 256


def check(name: str, x: torch.Tensor, shape: tuple[int, ...], device: torch.device,
          dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``x`` is a contiguous ``dtype`` tensor of ``shape`` on ``device``."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {x.dtype}")
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


def scratch(lib, fn: str, error_string, dev: torch.device, *shape: int) -> torch.Tensor:
    """A float32 scratch tensor on ``dev`` of the length the library's
    ``fn(*shape, long long* out)`` reports (what a launcher needs at these
    shapes)."""
    out = ctypes.c_longlong(0)
    raise_on(error_string, getattr(lib, fn)(*shape, ctypes.addressof(out)), fn)
    return torch.empty(max(1, out.value), dtype=torch.float32, device=dev)


def bind(lib: ctypes.CDLL, signatures: dict[str, str], error_string: str) -> ctypes.CDLL:
    """Set argtypes and restype on a freshly loaded library, once. Each
    signature spells the arguments as "p" (pointer or stream), "i" (int)
    and "l" (long long); those functions return an int. ``error_string`` names the library's
    ``const char* (int)`` wrapper of ``cudaGetErrorString``."""
    if not getattr(lib, "_bound", False):
        kinds = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong}
        for fn, sig in signatures.items():
            getattr(lib, fn).argtypes = [kinds[c] for c in sig]
            getattr(lib, fn).restype = ctypes.c_int
        getattr(lib, error_string).argtypes = [ctypes.c_int]
        getattr(lib, error_string).restype = ctypes.c_char_p
        lib._bound = True
    return lib
