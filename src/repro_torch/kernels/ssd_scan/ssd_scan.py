"""ctypes wrapper for the hand-written CUDA SSD chunked scan
(``csrc/ssd_scan.cu``), which replaces the Pallas ``ssd_scan_bh``
(``repro/kernels/ssd_scan/ssd_scan.py``).

``ssd_scan_bh_cuda`` checks device, dtype, shape and contiguity and
raises on anything the kernel does not take; allocates y and the final
state with ``torch.empty``; launches on the current stream without
synchronising; raises if the launch was refused (also when the shared
memory a block needs for (P, N, chunk) is above the card's limit); and
then adds one to ``LAUNCHES["ssd_scan"]``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import I, P, SUFFIX, check, check_x, raise_on
from repro_torch.kernels._wrap import stream

LAUNCHES = {"ssd_scan": 0}

MAX_P = 64                       # kMaxP in csrc/ssd_scan.cu


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib():
    lib = _build.library("ssd_scan")
    if not getattr(lib, "_argtypes_set", False):
        for s in SUFFIX.values():
            # x, dt, a_log, B, C, y, state, BH, BG, S, P, N, Q, stream
            fn = getattr(lib, f"ssd_scan_{s}")
            fn.argtypes = [P] * 7 + [I] * 6 + [P]
            fn.restype = I
        lib._argtypes_set = True
    return lib


def ssd_scan_bh_cuda(x, dt, a_log, B, C, *, chunk: int = 256):
    """x (BH, S, P) f32|bf16; dt (BH, S) and a_log (BH,) f32; B, C
    (BG, S, N) in x's dtype, with BH a multiple of BG (head h reads
    group h // (BH / BG)).  Returns (y (BH, S, P) in x's type, final
    state (BH, N, P) f32).  The chunk is min(chunk, S), which must
    divide S."""
    check_x(x, "ssd_scan", 3)
    BH, S, Pd = x.shape
    BG, _, N = B.shape
    dev = x.device
    if BG < 1 or BH % BG:
        raise ValueError(f"{BH} heads do not split into {BG} groups")
    if not 1 <= Pd <= MAX_P:
        raise ValueError(f"head dim P = {Pd} outside the kernel's [1, {MAX_P}]")
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"S = {S} is not a multiple of the chunk {Q}")
    check(dt, "dt", torch.float32, (BH, S), dev)
    check(a_log, "a_log", torch.float32, (BH,), dev)
    check(B, "B", x.dtype, (BG, S, N), dev)
    check(C, "C", x.dtype, (BG, S, N), dev)
    y = torch.empty_like(x)
    st = torch.empty((BH, N, Pd), dtype=torch.float32, device=dev)
    lib = _lib()
    fn = getattr(lib, f"ssd_scan_{SUFFIX[x.dtype]}")
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B.data_ptr(),
                C.data_ptr(), y.data_ptr(), st.data_ptr(), BH, BG, S, Pd, N,
                Q, stream(x))
    raise_on(rc, lib, "ssd_scan", "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y, st
