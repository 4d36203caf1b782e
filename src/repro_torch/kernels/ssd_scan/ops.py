"""Public dispatcher for the Mamba-2 SSD chunked scan, in the model's
(b, S, H, P) layout.

``ssd_scan(..., impl=None)`` launches the CUDA kernel for a CUDA tensor
and runs the plain ``ssd_ref`` for a CPU tensor; ``impl="torch"`` forces
the plain version, for explicit comparisons only.  As the reference's
dispatcher does, it flattens heads and groups into the batch (b·H and
b·G), uses the chunk min(chunk, S), which must divide S (nothing is
padded), and returns y in x's dtype and the final state as (b, H, P, N)
in f32.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._wrap import resolve_impl
from repro_torch.kernels.ssd_scan.ref import ssd_naive, ssd_ref
from repro_torch.kernels.ssd_scan.ssd_scan import ssd_scan_bh_cuda


def ssd_scan(x, dt, A_log, B, C, *, chunk: int = 256, impl=None):
    """x (b,S,H,P); dt (b,S,H); A_log (H,); B,C (b,S,G,N).
    Returns (y (b,S,H,P), final_state (b,H,P,N))."""
    impl = resolve_impl(impl, x, "ssd_scan")
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    if H % G:
        raise ValueError(f"{H} heads do not split into {G} groups")
    Q = min(chunk, S)
    if Q < 1 or S % Q:
        raise ValueError(f"S = {S} is not a multiple of the chunk {Q}")
    if impl == "torch":
        y, st = ssd_ref(x, dt, A_log, B, C, Q)
        return y.to(x.dtype), st
    f32 = torch.float32
    xf = x.transpose(1, 2).reshape(b * H, S, P).contiguous()
    dtf = dt.transpose(1, 2).reshape(b * H, S).to(f32).contiguous()
    Bf = B.transpose(1, 2).reshape(b * G, S, N).contiguous()
    Cf = C.transpose(1, 2).reshape(b * G, S, N).contiguous()
    alog = A_log.to(f32).expand(b, H).reshape(b * H).contiguous()
    y, st = ssd_scan_bh_cuda(xf, dtf, alog, Bf, Cf, chunk=Q)
    y = y.reshape(b, H, S, P).transpose(1, 2)
    st = st.reshape(b, H, N, P).transpose(2, 3)          # → (b,H,P,N)
    return y, st


__all__ = ["ssd_scan", "ssd_ref", "ssd_naive"]
