"""ctypes wrapper for the hand-written CUDA flash attention
(``csrc/flash_attention.cu``), which replaces the Pallas
``flash_attention_bhsd`` (``repro/kernels/flash_attention/flash_attention.py``).

The source's launcher picks the kernel's variant, by dtype and Sq: f32
takes the CUDA-core kernel, bf16 the tensor-core kernels (a decode
variant for Sq ≤ 16).

``flash_attention_bhsd_cuda`` checks device, dtype, shape and contiguity
and raises on anything the kernel does not take; allocates the output
with ``torch.empty``; launches on the current stream without
synchronising; raises if the launch was refused; and then adds one to
``LAUNCHES["flash_attention"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import F, I, P, SUFFIX, check, check_x, raise_on
from repro_torch.kernels._wrap import stream

LAUNCHES = {"flash_attention": 0}

MAX_DH = 256                     # the largest dh bucket in csrc/flash_attention.cu


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = _build.library("flash_attention")
    if not getattr(lib, "_argtypes_set", False):
        for s in SUFFIX.values():
            # q, k, v, o, BH, BK, Sq, Sk, dh, scale, causal, has_window,
            # window, sk_valid, q_offset, stream
            fn = getattr(lib, f"flash_attention_{s}")
            fn.argtypes = [P, P, P, P, I, I, I, I, I, F, I, I, I, I, I, P]
            fn.restype = I
        lib._argtypes_set = True
    return lib


def flash_attention_bhsd_cuda(q, k, v, *, scale: float, causal: bool = True,
                              window: int | None = None, sk_valid: int = 0,
                              q_offset: int = 0):
    """q (BH, Sq, dh); k/v (BK, Sk, dh), all f32 or all bf16, BH a
    multiple of BK (head h reads kv head h // (BH/BK)) → (BH, Sq, dh) in
    q's dtype.  Keys at or past ``sk_valid`` (0: Sk) are masked; query
    row i sits at key position i + ``q_offset``."""
    check_x(q, "flash_attention", 3)
    BH, Sq, dh = q.shape
    BK, Sk, _ = k.shape
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"head dim {dh} outside the kernel's [1, {MAX_DH}]")
    if BK < 1 or BH % BK:
        raise ValueError(f"{BH} query heads do not split over {BK} kv heads")
    check(k, "k", q.dtype, (BK, Sk, dh), q.device)
    check(v, "v", q.dtype, (BK, Sk, dh), q.device)
    o = torch.empty_like(q)
    lib = _lib()
    fn = getattr(lib, f"flash_attention_{SUFFIX[q.dtype]}")
    with torch.cuda.device(q.device):
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), BH,
                BK, Sq, Sk, dh, float(scale), int(causal),
                int(window is not None), int(window or 0), int(sk_valid),
                int(q_offset), stream(q))
    raise_on(rc, lib, "flash_attention", "flash_attention")
    LAUNCHES["flash_attention"] += 1
    return o
