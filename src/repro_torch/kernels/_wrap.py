"""What every ctypes kernel wrapper and dispatcher of the port shares.

A dispatcher takes ``impl=None`` (the CUDA kernel for a CUDA tensor, the
plain PyTorch version for a CPU tensor: the CPU is the only reason the
plain version runs, and on a CUDA tensor the kernel launches or raises)
or ``impl="torch"`` (the plain version, for explicit comparisons only).
A wrapper checks every tensor it hands a kernel, launches on the current
stream without synchronising, and raises if the launch was refused.

A ``device="meta"`` tensor resolves to the kernel path, the path the card
takes.  The two wrappers on the dry run's path (``flash_attention``,
``ssd_scan``; ``launch/dryrun.py``) have a meta branch: it makes the
``torch.empty`` allocations of the CUDA path through the same function
and returns the outputs without building or launching anything, and adds
the FLOPs a launch would do to the module's ``META_FLOPS``.  A meta
tensor holds no values, so nothing can mistake such an output for a
result.  The other wrappers refuse meta tensors (``check_x``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def resolve_impl(impl, x, op: str) -> str:
    if impl is None:
        return "torch" if x.device.type == "cpu" else "cuda"
    if impl not in ("torch", "cuda"):
        raise ValueError(f"unknown {op} impl {impl!r}")
    return impl


def check(t, name, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_x(x, op: str, dim: int, meta: bool = False) -> None:
    """``meta``: the wrapper has a meta branch, so x may be on meta."""
    if x.device.type != "cuda" and not (meta and x.device.type == "meta"):
        raise ValueError(f"the CUDA {op} kernel takes CUDA tensors, x is on "
                         f"{x.device} (the plain version serves CPU tensors)")
    if x.dtype not in SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != dim or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous {dim}-D tensor, got shape "
                         f"{tuple(x.shape)}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def sm_count(dev) -> int:
    """The number of SMs of CUDA device ``dev``."""
    return _sm_count(dev.index if dev.index is not None
                     else torch.cuda.current_device())


def stream(x) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def raise_on(rc: int, lib, prefix: str, op: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if rc != 0:
        err = getattr(lib, f"{prefix}_error_string")
        err.argtypes, err.restype = [I], ctypes.c_char_p
        raise RuntimeError(f"{op} launch failed: CUDA error {rc} "
                           f"({err(rc).decode()})")
