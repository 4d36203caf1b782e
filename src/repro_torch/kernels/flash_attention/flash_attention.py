"""ctypes wrapper for the hand-written CUDA flash attention
(``csrc/flash_attention.cu``), which replaces the Pallas
``flash_attention_bhsd`` (``repro/kernels/flash_attention/flash_attention.py``).

The source's launcher picks the kernel's variant, by dtype and Sq: f32
takes the CUDA-core kernel, bf16 the tensor-core kernels (a decode
variant for Sq ≤ 16).

``flash_attention_bhsd_cuda`` checks device, dtype, shape and contiguity
and raises on anything the kernel does not take; allocates the output
with ``torch.empty`` (``alloc``); launches on the current stream without
synchronising; raises if the launch was refused; and then adds one to
``LAUNCHES["flash_attention"]``.  On meta tensors (the dry run) it makes
the same allocation, adds the launch's FLOPs (``flops``) to
``META_FLOPS["flash_attention"]`` and returns the output unlaunched.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import F, I, P, SUFFIX, check, check_x, raise_on
from repro_torch.kernels._wrap import stream

LAUNCHES = {"flash_attention": 0}
# FLOPs of the calls the meta branch stood in for (no launch, no count)
META_FLOPS = {"flash_attention": 0}

MAX_DH = 256                     # the largest dh bucket in csrc/flash_attention.cu


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def alloc(q):
    """The output the CUDA path allocates (and the meta branch with it)."""
    return torch.empty_like(q)


def valid_pairs(Sq: int, Sk: int, causal: bool, window, q_offset: int,
                sk_valid: int = 0) -> int:
    """(query row, key) pairs the masks keep; a row with no valid key
    averages v over all Sk keys, as the kernel does."""
    qi = np.arange(Sq, dtype=np.int64) + q_offset
    hi = np.full(Sq, min(sk_valid or Sk, Sk), np.int64)
    if causal:
        hi = np.minimum(hi, qi + 1)
    lo = np.maximum(qi - window + 1, 0) if window is not None else 0 * qi
    n = np.maximum(hi - lo, 0)
    return int(np.where(n > 0, n, Sk).sum())


def flops(BH: int, dh: int, pairs: int) -> int:
    """QKᵀ and PV over the kept pairs: 2·dh multiply-adds each."""
    return 4 * BH * dh * pairs


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
    check_x(q, "flash_attention", 3, meta=True)
    BH, Sq, dh = q.shape
    BK, Sk, _ = k.shape
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"head dim {dh} outside the kernel's [1, {MAX_DH}]")
    if BK < 1 or BH % BK:
        raise ValueError(f"{BH} query heads do not split over {BK} kv heads")
    check(k, "k", q.dtype, (BK, Sk, dh), q.device)
    check(v, "v", q.dtype, (BK, Sk, dh), q.device)
    o = alloc(q)
    if q.device.type == "meta":
        META_FLOPS["flash_attention"] += flops(
            BH, dh, valid_pairs(Sq, Sk, causal, window, q_offset, sk_valid))
        return o
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
