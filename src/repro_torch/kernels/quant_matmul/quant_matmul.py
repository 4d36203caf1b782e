"""ctypes wrapper for the hand-written CUDA quantized matmul
(``csrc/quant_matmul.cu``), which replaces the Pallas
``quant_matmul_kernel`` (``repro/kernels/quant_matmul/quant_matmul.py``).

``quant_matmul_cuda`` checks device, dtype, shape and contiguity and
raises on anything the kernel does not take; allocates the output, and
for a split-K variant (``qmm_skinny``, ``qmm_mma_decode``) the
(splits, M, N) f32 partials, with ``torch.empty`` (so a call can be
captured in a CUDA graph); launches on the current stream without
synchronising; raises if the launch was refused; and then adds one to
``LAUNCHES["quant_matmul"]``.  ``variant`` names the kernel a call
takes, as the source's ``launch`` picks it: bf16 x on the tensor cores
(``qmm_mma`` for M > 16, ``qmm_mma_decode`` for M <= 16) when the scales
are per channel or their groups are a multiple of 16 rows, else the
CUDA-core ``qmm_tiled`` / ``qmm_skinny``, which also serve f32 x.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import I, P, SUFFIX, check, check_x, raise_on
from repro_torch.kernels._wrap import sm_count, stream

LAUNCHES = {"quant_matmul": 0}

_MODE = {torch.int8: "int8", torch.uint8: "int4"}

# quant_matmul_variant's codes
VARIANTS = ("qmm_skinny", "qmm_tiled", "qmm_mma", "qmm_mma_decode")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = _build.library("quant_matmul")
    if not getattr(lib, "_argtypes_set", False):
        for mode in _MODE.values():
            for s in SUFFIX.values():
                # x, q, scale, part, y, M, K, N, G, splits, stream
                fn = getattr(lib, f"quant_matmul_{mode}_{s}")
                fn.argtypes = [P, P, P, P, P, I, I, I, I, I, P]
                fn.restype = I
        # M, K, N, G, is_bf16, is_int4, sm_count
        lib.quant_matmul_splits.argtypes = [I, I, I, I, I, I, I]
        lib.quant_matmul_splits.restype = I
        lib.quant_matmul_variant.argtypes = [I, I, I, I]
        lib.quant_matmul_variant.restype = I
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=256)
def _splits(M: int, K: int, N: int, G: int, bf16: bool, int4: bool,
            sms: int) -> int:
    return _lib().quant_matmul_splits(M, K, N, G, int(bf16), int(int4), sms)


@functools.lru_cache(maxsize=256)
def variant(M: int, K: int, G: int, dtype) -> str:
    """The kernel an (M, K) x (K, N) call with G scale groups and x of
    ``dtype`` takes: one of ``VARIANTS``."""
    return VARIANTS[_lib().quant_matmul_variant(M, K, G,
                                                int(dtype == torch.bfloat16))]


def quant_matmul_cuda(x, q, scale):
    """x (M, K) f32|bf16, q int8 (K, N) or packed-int4 uint8 (K/2, N),
    scale (G, N) f32 with G dividing K → (M, N) in x's dtype."""
    check_x(x, "quant_matmul", 2)
    M, K = x.shape
    if q.dtype not in _MODE:
        raise TypeError(f"q must be int8 or packed-int4 uint8, got {q.dtype}")
    int4 = q.dtype == torch.uint8
    N = q.shape[-1]
    G = scale.shape[0]
    dev = x.device
    check(q, "q", q.dtype, (K // 2 if int4 else K, N), dev)
    if int4 and K % 2:
        raise ValueError(f"packed int4 needs an even d_in, x has {K}")
    check(scale, "scale", torch.float32, (G, N), dev)
    if G < 1 or K % G:
        raise ValueError(f"{G} scale groups do not divide d_in {K}")
    y = torch.empty((M, N), dtype=x.dtype, device=dev)
    if M == 0 or N == 0:
        return y
    lib = _lib()
    splits = _splits(M, K, N, G, x.dtype == torch.bfloat16, int4,
                     sm_count(dev))
    part = (torch.empty((splits, M, N), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    fn = getattr(lib, f"quant_matmul_{_MODE[q.dtype]}_{SUFFIX[x.dtype]}")
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                None if part is None else part.data_ptr(), y.data_ptr(),
                M, K, N, G, splits, stream(x))
    raise_on(rc, lib, "quant_matmul", "quant_matmul")
    LAUNCHES["quant_matmul"] += 1
    return y
