"""ctypes wrapper for the hand-written CUDA SSD chunked scan
(``csrc/ssd_scan.cu``), which replaces the Pallas ``ssd_scan_bh``
(``repro/kernels/ssd_scan/ssd_scan.py``).

``ssd_scan_bh_cuda`` checks device, dtype, shape and contiguity and
raises on anything the kernel does not take; allocates y, the final
state and the workspaces of the chunk-parallel scan (C·Bᵀ once a group
and chunk in x's type, the f32 log-decay, the (BH, nc, N, P) f32 chunk
states and, for bf16, the entering states split into bf16 hi and lo
tiles) with ``torch.empty`` (``alloc``), so a call can be captured in a
CUDA graph; launches the four kernels on the current stream without
synchronising; raises if a launch was refused (N above 256, or more
shared memory than the card has for the chunk); and then adds one to
``LAUNCHES["ssd_scan"]``.  On meta tensors (the dry run) it makes the
same allocations, adds the call's FLOPs (``flops``) to
``META_FLOPS["ssd_scan"]`` and returns y and the state unlaunched.
``variant`` names the path a call takes: ``mma`` (bf16, the products on
the tensor cores) or ``simt`` (f32, on the CUDA cores); ``blocks`` the
blocks each of the four launches runs.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._wrap import I, P, SUFFIX, check, check_x, raise_on
from repro_torch.kernels._wrap import stream

LAUNCHES = {"ssd_scan": 0}
# FLOPs of the calls the meta branch stood in for (no launch, no count)
META_FLOPS = {"ssd_scan": 0}

MAX_P = 64                       # kMaxP in csrc/ssd_scan.cu

# ssd_scan_variant's codes
VARIANTS = ("simt", "mma")
# the four launches of one call, in order (ssd_scan_blocks)
KERNELS = ("ssd_cb", "ssd_states", "ssd_pass", "ssd_y")


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _row_lg(nch: int) -> int:
    lg = 1
    while (1 << lg) < nch:
        lg += 1
    return lg


def state_bytes(P: int, N: int, is_bf16: bool) -> int:
    """Bytes of one head and chunk's split entering states: a copy of
    ``ssd_scan_state_bytes`` in csrc/ssd_scan.cu (bf16: the hi and lo
    tiles ssd_pass writes for ssd_y_mma; f32: 0, they stay in W), so the
    meta branch sizes the workspace without the library.  The CUDA path
    holds the two equal."""
    if not is_bf16:
        return 0
    return 2 * ((16 * ((N + 15) // 16)) << _row_lg(2 * ((P + 15) // 16))) * 16


def alloc(x, BG: int, N: int, Q: int):
    """The tensors the CUDA path allocates (and the meta branch with it):
    y, the final state, C·Bᵀ, the log-decay, the chunk states and, for
    bf16, the split entering states (None for f32)."""
    BH, S, Pd = x.shape
    dev, nc = x.device, S // Q
    split = state_bytes(Pd, N, x.dtype == torch.bfloat16)
    y = torch.empty_like(x)
    st = torch.empty((BH, N, Pd), dtype=torch.float32, device=dev)
    cb = torch.empty((BG, nc, Q, Q), dtype=x.dtype, device=dev)
    lw = torch.empty((BH, S), dtype=torch.float32, device=dev)
    w = torch.empty((BH, nc, N, Pd), dtype=torch.float32, device=dev)
    sin = (torch.empty((BH * nc * split,), dtype=torch.uint8, device=dev)
           if split else None)
    return y, st, cb, lw, w, sin


def flops(BH: int, BG: int, S: int, P: int, N: int, Q: int) -> int:
    """The chunked scan's multiply-adds, 2 FLOPs each: C·Bᵀ over each
    chunk's triangle once a group, the decayed triangle's product with
    x·dt, the chunk end states and the entering states' term per head."""
    nc, tri = S // Q, Q * (Q + 1) // 2
    return 2 * nc * (BG * tri * N + BH * (tri * P + 2 * Q * N * P))


def _lib():
    lib = _build.library("ssd_scan")
    if not getattr(lib, "_argtypes_set", False):
        for s in SUFFIX.values():
            # x, dt, a_log, B, C, y, state, cb, lw, w, sin, BH, BG, S, P,
            # N, Q, stream
            fn = getattr(lib, f"ssd_scan_{s}")
            fn.argtypes = [P] * 11 + [I] * 6 + [P]
            fn.restype = I
        lib.ssd_scan_variant.argtypes = [I]
        lib.ssd_scan_variant.restype = I
        # BH, BG, S, P, N, Q, is_bf16, out[4]
        lib.ssd_scan_blocks.argtypes = [I] * 7 + [P]
        lib.ssd_scan_blocks.restype = I
        lib.ssd_scan_state_bytes.argtypes = [I] * 3
        lib.ssd_scan_state_bytes.restype = I
        lib._argtypes_set = True
    return lib


@functools.lru_cache(maxsize=None)
def variant(dtype) -> str:
    """The path a call with x of ``dtype`` takes: one of ``VARIANTS``."""
    return VARIANTS[_lib().ssd_scan_variant(int(dtype == torch.bfloat16))]


def blocks(BH: int, BG: int, S: int, P: int, N: int, chunk: int,
           dtype) -> dict[str, int]:
    """{kernel: blocks launched} for a (BH, S, P) x (BG, S, N) call at
    ``chunk`` (capped at S, as the call caps it)."""
    lib = _lib()
    out = (ctypes.c_int * 4)()
    rc = lib.ssd_scan_blocks(BH, BG, S, P, N, min(chunk, S),
                             int(dtype == torch.bfloat16),
                             ctypes.cast(out, ctypes.c_void_p))
    raise_on(rc, lib, "ssd_scan", "ssd_scan")
    return dict(zip(KERNELS, out))


def ssd_scan_bh_cuda(x, dt, a_log, B, C, *, chunk: int = 256):
    """x (BH, S, P) f32|bf16; dt (BH, S) and a_log (BH,) f32; B, C
    (BG, S, N) in x's dtype, with BH a multiple of BG (head h reads
    group h // (BH / BG)).  Returns (y (BH, S, P) in x's type, final
    state (BH, N, P) f32).  The chunk is min(chunk, S), which must
    divide S."""
    check_x(x, "ssd_scan", 3, meta=True)
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
    y, st, cb, lw, w, sin = alloc(x, BG, N, Q)
    if dev.type == "meta":
        META_FLOPS["ssd_scan"] += flops(BH, BG, S, Pd, N, Q)
        return y, st
    lib = _lib()
    is_bf16 = x.dtype == torch.bfloat16
    if lib.ssd_scan_state_bytes(Pd, N, int(is_bf16)) != state_bytes(
            Pd, N, is_bf16):
        raise RuntimeError("ssd_scan: state_bytes disagrees with the "
                           "library's ssd_scan_state_bytes")
    fn = getattr(lib, f"ssd_scan_{SUFFIX[x.dtype]}")
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), B.data_ptr(),
                C.data_ptr(), y.data_ptr(), st.data_ptr(), cb.data_ptr(),
                lw.data_ptr(), w.data_ptr(),
                None if sin is None else sin.data_ptr(), BH, BG, S, Pd, N, Q,
                stream(x))
    raise_on(rc, lib, "ssd_scan", "ssd_scan")
    LAUNCHES["ssd_scan"] += 1
    return y, st
