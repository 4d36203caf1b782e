"""ctypes wrappers for the hand-written CUDA BGMV kernels (``csrc/bgmv.cu``).

``bgmv_cuda`` replaces the Pallas ``bgmv_matmul`` and ``bgmv_mag_cuda``
the Pallas ``bgmv_mag_matmul`` (``repro/kernels/batched_lora/bgmv.py``).
Each wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take; allocates its output with
``torch.empty``; launches on the current stream without synchronising;
raises if the launch was refused; and then adds one to its count in
``LAUNCHES``, so a run can show that it went through the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"bgmv": 0, "bgmv_mag": 0}

MAX_RANK = 64                    # kMaxRank in csrc/bgmv.cu

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    lib = _build.library("bgmv")
    if not getattr(lib, "_argtypes_set", False):
        tail = [_P, _I, _I, _I, _I, _I, _I, _F, _P]  # y, B, S, d_in, d_out, r, L, scale, stream
        for s in _SUFFIX.values():
            fn = getattr(lib, f"bgmv_{s}")
            fn.argtypes = [_P, _P, _P, _P, _P] + tail
            fn.restype = _I
            fn = getattr(lib, f"bgmv_mag_{s}")
            fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P] + tail
            fn.restype = _I
        lib.bgmv_error_string.argtypes = [_I]
        lib.bgmv_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(t, name, dtype, shape, device):
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, x is on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_x(x, r):
    if x.device.type != "cuda":
        raise ValueError(f"the CUDA BGMV kernels take CUDA tensors, x is on "
                         f"{x.device} (the plain version serves CPU tensors)")
    if x.dtype not in _SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous (B, S, d_in) tensor, got "
                         f"shape {tuple(x.shape)}")
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside the kernel's [1, {MAX_RANK}]")


def _launch(name, fn, x, ptrs, idx, ranks, y, dims, scale):
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(*ptrs, idx.data_ptr(),
                None if ranks is None else ranks.data_ptr(), y.data_ptr(),
                *dims, float(scale), stream)
    if rc != 0:
        msg = _lib().bgmv_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
    LAUNCHES[name] += 1


def bgmv_cuda(x, a_pool, b_pool, idx, ranks=None, *, scale: float = 1.0):
    """x (B, S, d_in) f32|bf16, a_pool (L, d_in, r) f32, b_pool
    (L, r, d_out) f32, idx (B,) int32, ranks (L,) int32 or None
    → (B, S, d_out) in x's dtype."""
    B, S, d_in = x.shape
    L, _, r = a_pool.shape
    d_out = b_pool.shape[-1]
    _check_x(x, r)
    dev = x.device
    _check(a_pool, "a_pool", torch.float32, (L, d_in, r), dev)
    _check(b_pool, "b_pool", torch.float32, (L, r, d_out), dev)
    _check(idx, "idx", torch.int32, (B,), dev)
    if ranks is not None:
        _check(ranks, "ranks", torch.int32, (L,), dev)
    y = torch.empty((B, S, d_out), dtype=x.dtype, device=dev)
    if B * S == 0:
        return y
    fn = getattr(_lib(), f"bgmv_{_SUFFIX[x.dtype]}")
    _launch("bgmv", fn, x, (x.data_ptr(), a_pool.data_ptr(),
                            b_pool.data_ptr()),
            idx, ranks, y, (B, S, d_in, d_out, r, L), scale)
    return y


def bgmv_mag_cuda(x, a_dir, a_mag, b_mag, dmag_pool, b_dir, idx,
                  ranks=None, *, scale: float = 1.0):
    """x (B, S, d_in) f32|bf16; shared a_dir (d_in, r), a_mag (d_in,),
    b_mag (r,), b_dir (r, d_out) f32; raw-delta pool dmag_pool (L, r)
    f32; idx (B,) int32; ranks (L,) int32 or None → (B, S, d_out)."""
    B, S, d_in = x.shape
    r = a_dir.shape[-1]
    L = dmag_pool.shape[0]
    d_out = b_dir.shape[-1]
    _check_x(x, r)
    dev = x.device
    _check(a_dir, "a_dir", torch.float32, (d_in, r), dev)
    _check(a_mag, "a_mag", torch.float32, (d_in,), dev)
    _check(b_mag, "b_mag", torch.float32, (r,), dev)
    _check(dmag_pool, "dmag_pool", torch.float32, (L, r), dev)
    _check(b_dir, "b_dir", torch.float32, (r, d_out), dev)
    _check(idx, "idx", torch.int32, (B,), dev)
    if ranks is not None:
        _check(ranks, "ranks", torch.int32, (L,), dev)
    y = torch.empty((B, S, d_out), dtype=x.dtype, device=dev)
    if B * S == 0:
        return y
    fn = getattr(_lib(), f"bgmv_mag_{_SUFFIX[x.dtype]}")
    _launch("bgmv_mag", fn, x,
            (x.data_ptr(), a_dir.data_ptr(), a_mag.data_ptr(),
             b_mag.data_ptr(), dmag_pool.data_ptr(), b_dir.data_ptr()),
            idx, ranks, y, (B, S, d_in, d_out, r, L), scale)
    return y
