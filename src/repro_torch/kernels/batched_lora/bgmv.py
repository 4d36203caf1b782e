"""ctypes wrappers for the hand-written CUDA BGMV kernels (``csrc/bgmv.cu``).

``bgmv_cuda`` replaces the Pallas ``bgmv_matmul`` and ``bgmv_mag_cuda``
the Pallas ``bgmv_mag_matmul`` (``repro/kernels/batched_lora/bgmv.py``).
Each wrapper checks device, dtype, shape and contiguity and raises on
anything the kernel does not take; allocates its output with
``torch.empty``; launches on the current stream without synchronising;
raises if the launch was refused; and then adds one to its count in
``LAUNCHES`` (one a call, whatever the kernel's grid), so a run can show
that it went through the kernel.  ``variant`` names the tiling a call
takes, as the source's ``launch`` picks it: ``decode`` for B * S <= 16
rows (pairs one block cluster a batch row, the magnitude kind one cluster
for all rows), else ``prefill`` (clusters over tiles of 32 tokens).
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import F, I, P, SUFFIX, check, check_x, stream
from repro_torch.kernels._wrap import raise_on

LAUNCHES = {"bgmv": 0, "bgmv_mag": 0}

MAX_RANK = 64                    # kMaxRank in csrc/bgmv.cu

# bgmv_variant's codes
VARIANTS = ("decode", "prefill")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = _build.library("bgmv")
    if not getattr(lib, "_argtypes_set", False):
        tail = [P, I, I, I, I, I, I, F, P]  # y, B, S, d_in, d_out, r, L, scale, stream
        for s in SUFFIX.values():
            fn = getattr(lib, f"bgmv_{s}")
            fn.argtypes = [P, P, P, P, P] + tail
            fn.restype = I
            fn = getattr(lib, f"bgmv_mag_{s}")
            fn.argtypes = [P, P, P, P, P, P, P, P] + tail
            fn.restype = I
        lib.bgmv_variant.argtypes = [I, I]
        lib.bgmv_variant.restype = I
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=256)
def variant(B: int, S: int) -> str:
    """The variant a call with x (B, S, d_in) takes: one of ``VARIANTS``
    (the same for both kinds and both dtypes)."""
    return VARIANTS[_lib().bgmv_variant(B, S)]


def _check_x(x, r):
    check_x(x, "BGMV", 3)
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside the kernel's [1, {MAX_RANK}]")


def _launch(name, fn, x, ptrs, idx, ranks, y, dims, scale):
    with torch.cuda.device(x.device):
        rc = fn(*ptrs, idx.data_ptr(),
                None if ranks is None else ranks.data_ptr(), y.data_ptr(),
                *dims, float(scale), stream(x))
    raise_on(rc, _lib(), "bgmv", name)
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
    check(a_pool, "a_pool", torch.float32, (L, d_in, r), dev)
    check(b_pool, "b_pool", torch.float32, (L, r, d_out), dev)
    check(idx, "idx", torch.int32, (B,), dev)
    if ranks is not None:
        check(ranks, "ranks", torch.int32, (L,), dev)
    y = torch.empty((B, S, d_out), dtype=x.dtype, device=dev)
    if B * S == 0:
        return y
    fn = getattr(_lib(), f"bgmv_{SUFFIX[x.dtype]}")
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
    check(a_dir, "a_dir", torch.float32, (d_in, r), dev)
    check(a_mag, "a_mag", torch.float32, (d_in,), dev)
    check(b_mag, "b_mag", torch.float32, (r,), dev)
    check(dmag_pool, "dmag_pool", torch.float32, (L, r), dev)
    check(b_dir, "b_dir", torch.float32, (r, d_out), dev)
    check(idx, "idx", torch.int32, (B,), dev)
    if ranks is not None:
        check(ranks, "ranks", torch.int32, (L,), dev)
    y = torch.empty((B, S, d_out), dtype=x.dtype, device=dev)
    if B * S == 0:
        return y
    fn = getattr(_lib(), f"bgmv_mag_{SUFFIX[x.dtype]}")
    _launch("bgmv_mag", fn, x,
            (x.data_ptr(), a_dir.data_ptr(), a_mag.data_ptr(),
             b_mag.data_ptr(), dmag_pool.data_ptr(), b_dir.data_ptr()),
            idx, ranks, y, (B, S, d_in, d_out, r, L), scale)
    return y
