"""Launcher plumbing shared by the port's CUDA kernels (``fused_fb``,
``split_fb``, ``duplex_fb``): argument checks, the CPU-twin / CUDA-kernel routing, and
raising on a CUDA error code a C launcher returns."""

from __future__ import annotations

import ctypes

import torch


# the padded state counts of the instances above 64 states: the large-K
# tiers (csrc/fb_wide.cuh), then the fused and split pairs' XL tiers
# (csrc/fb_xl.cuh)
STATE_TIERS = (128, 256, 512, 1024)


def instance_tier(K: int) -> int:
    """The K a library's ``*_kernel_info`` knows the instance that takes K
    states by: 64 up to 64 (the S-sequence instances), else the padded state
    count of the instance above, 128 or 256 (the large-K tiers,
    csrc/fb_wide.cuh) or 512 or 1024 (the XL tiers, csrc/fb_xl.cuh); K
    itself past the last tier (which no library takes)."""
    if K <= 64:
        return 64
    return next((kp for kp in STATE_TIERS if K <= kp), K)


XL_MIN = 257  # the fewest states of the XL instances (csrc/fb_xl.cuh)


def check_xl_modes(K: int, route: str, **modes: bool) -> None:
    """Raise ``NotImplementedError`` where a kernel mode that has no XL
    instance (bf16 alpha, the gamma pick) is asked for at K >= XL_MIN; the
    launchers check it before a launch, ``modes`` naming each mode and
    whether it is on."""
    if K >= XL_MIN:
        for mode, on in modes.items():
            if on:
                raise NotImplementedError(
                    f"the {route} CUDA kernels have no {mode} instance above 256 states, "
                    f"got K={K}")


def resident_blocks(info: dict, K: int) -> int:
    """Blocks of one instance the card runs at once, for the one-wave rule:
    blocks an SM times SMs, where at the XL tiers (K, the padded state
    count, above 256) one an SM counts, since each block reads all of A~
    from L2 every step and a second block on an SM would read it again."""
    per_sm = min(info["blocks_per_sm"], 1) if K >= XL_MIN else info["blocks_per_sm"]
    return per_sm * info["sms"]


def count_xl(fn, K: int) -> None:
    """A call of a launcher at K >= XL_MIN: one more in its ``xl_launches``
    under the XL tier's padded state count (512 or 1024)."""
    if K >= XL_MIN:
        tier = instance_tier(K)
        fn.xl_launches[tier] = fn.xl_launches.get(tier, 0) + 1


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
