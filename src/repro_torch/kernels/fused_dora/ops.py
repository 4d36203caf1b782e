"""Public dispatcher for the fused DoRA-decomposed LoRA linear.

``fused_dora(..., impl=None)`` launches the CUDA kernel for a CUDA
tensor and runs the plain version for a CPU tensor; ``impl="torch"``
forces the plain version, for explicit comparisons only.  Leading dims
of x flatten to (M, K); a missing dA_dir or dB_mag means zeros.  Before
the kernel the dispatcher forms, as the Pallas wrapper does,
a_eff = (A_dir + dA_dir) in x's dtype, b_eff_mag = (B_mag + dB_mag) in
f32, and B_dir in x's dtype.  The kernel masks its own ragged edges, so
nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels._wrap import resolve_impl
from repro_torch.kernels.fused_dora.fused_dora import fused_dora_cuda
from repro_torch.kernels.fused_dora.ref import fused_dora_ref


def fused_dora(x, w0, a_dir, a_mag, b_dir, b_mag, da_dir=None, db_mag=None,
               *, scale: float = 1.0, impl=None):
    impl = resolve_impl(impl, x, "fused_dora")
    if da_dir is None:
        da_dir = torch.zeros_like(a_dir)
    if db_mag is None:
        db_mag = torch.zeros_like(b_mag)
    lead, K = x.shape[:-1], x.shape[-1]
    N = w0.shape[1]
    xm = x.reshape(-1, K)
    if impl == "torch":
        y = fused_dora_ref(xm, w0, a_dir, a_mag, b_dir, b_mag, da_dir,
                           db_mag, scale)
    else:
        dt = x.dtype
        y = fused_dora_cuda(
            xm.contiguous(), w0.to(dt).contiguous(),
            (a_dir + da_dir).to(dt).contiguous(),
            a_mag.to(torch.float32).contiguous(), b_dir.to(dt).contiguous(),
            (b_mag + db_mag).to(torch.float32).contiguous(), scale=scale)
    return y.reshape(*lead, N)


__all__ = ["fused_dora", "fused_dora_ref"]
