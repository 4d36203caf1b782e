"""ctypes wrapper for the hand-written CUDA fused DoRA linear
(``csrc/fused_dora.cu``), which replaces the Pallas ``fused_dora_matmul``
(``repro/kernels/fused_dora/fused_dora.py``).

``fused_dora_cuda`` checks device, dtype, shape and contiguity and raises
on anything the kernel does not take; allocates its output, and for the
bf16 decode variant (M <= 16) the f32 workspace of its split-K pass, with
``torch.empty`` (so a call can be captured in a CUDA graph); launches on
the current stream without synchronising (one or, for the split pass,
two CUDA kernels); raises if the launch was refused; and then adds one
to ``LAUNCHES["fused_dora"]``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import F, I, P, SUFFIX, check, check_x, raise_on
from repro_torch.kernels._wrap import sm_count, stream

LAUNCHES = {"fused_dora": 0}

MAX_RANK = 64                    # kMaxRank in csrc/fused_dora.cu


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = _build.library("fused_dora")
    if not getattr(lib, "_argtypes_set", False):
        for s in SUFFIX.values():
            # x, w0, a_eff, a_mag, b_dir, b_eff_mag, y, part, M, K, N, r,
            # scale, splits, stream
            fn = getattr(lib, f"fused_dora_{s}")
            fn.argtypes = [P, P, P, P, P, P, P, P, I, I, I, I, F, I, P]
            fn.restype = I
        lib.fused_dora_splits.argtypes = [I, I, I, I, I]
        lib.fused_dora_splits.restype = I
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=256)
def _splits(M: int, K: int, N: int, bf16: bool, sms: int) -> int:
    """K splits of the bf16 decode variant, 0 when the call takes no
    workspace (``fused_dora_splits`` in the source)."""
    return _lib().fused_dora_splits(M, K, N, int(bf16), sms)


def fused_dora_cuda(x, w0, a_eff, a_mag, b_dir, b_eff_mag, *,
                    scale: float = 1.0):
    """x (M, K) f32|bf16; w0 (K, N), a_eff (K, r) and b_dir (r, N) in x's
    dtype; a_mag (K,) and b_eff_mag (r,) f32 → (M, N) in x's dtype."""
    check_x(x, "fused_dora", 2)
    M, K = x.shape
    r = a_eff.shape[-1]
    N = w0.shape[-1]
    if not 1 <= r <= MAX_RANK:
        raise ValueError(f"rank {r} outside the kernel's [1, {MAX_RANK}]")
    dev, dt = x.device, x.dtype
    check(w0, "w0", dt, (K, N), dev)
    check(a_eff, "a_eff", dt, (K, r), dev)
    check(a_mag, "a_mag", torch.float32, (K,), dev)
    check(b_dir, "b_dir", dt, (r, N), dev)
    check(b_eff_mag, "b_eff_mag", torch.float32, (r,), dev)
    y = torch.empty((M, N), dtype=dt, device=dev)
    if M == 0 or N == 0:
        return y
    lib = _lib()
    splits = _splits(M, K, N, dt == torch.bfloat16, sm_count(dev))
    # (splits, M, N) base partials, then (splits, M, MAX_RANK) of h
    part = (torch.empty(splits * M * (N + MAX_RANK), dtype=torch.float32,
                        device=dev) if splits else None)
    fn = getattr(lib, f"fused_dora_{SUFFIX[dt]}")
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), w0.data_ptr(), a_eff.data_ptr(),
                a_mag.data_ptr(), b_dir.data_ptr(), b_eff_mag.data_ptr(),
                y.data_ptr(), None if part is None else part.data_ptr(),
                M, K, N, r, float(scale), splits, stream(x))
    raise_on(rc, lib, "fused_dora", "fused_dora")
    LAUNCHES["fused_dora"] += 1
    return y
