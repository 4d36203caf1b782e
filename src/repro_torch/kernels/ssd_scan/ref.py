"""Plain PyTorch versions of the Mamba-2 SSD chunked scan.

Port of ``repro/kernels/ssd_scan/ref.py``.  ``ssd_ref`` is the model's
chunked form (``repro_torch/models/ssm.py::_ssd_chunked``) and
``ssd_naive`` the O(S) per-step recurrence, so kernel, chunked form and
recurrence make a three-way check.  Both serve CPU tensors; the CUDA
scan is held against them.
"""
from __future__ import annotations

import torch

from repro_torch.models.ssm import _ssd_chunked


def ssd_ref(x, dt, A_log, B, C, chunk: int):
    """x (b,S,H,P); dt (b,S,H); B,C (b,S,G,N) → (y (b,S,H,P) f32,
    final state (b,H,P,N) f32)."""
    return _ssd_chunked(x, dt, A_log, B, C, chunk)


def ssd_naive(x, dt, A_log, B, C):
    """O(S) sequential recurrence in f32 — ground truth for short S.
    Returns y in x's dtype and the final state (b,H,P,N) in f32."""
    f32 = torch.float32
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bh = B.repeat_interleave(rep, dim=2).to(f32)
    Ch = C.repeat_interleave(rep, dim=2).to(f32)
    dtf = dt.to(f32)
    a = torch.exp(-torch.exp(A_log.to(f32)) * dtf)          # (b,S,H)
    xdt = x.to(f32) * dtf[..., None]
    state = torch.zeros((b, H, N, P), dtype=f32, device=x.device)
    ys = []
    for t in range(S):
        state = a[:, t, :, None, None] * state + torch.einsum(
            "bhn,bhp->bhnp", Bh[:, t], xdt[:, t])
        ys.append(torch.einsum("bhn,bhnp->bhp", Ch[:, t], state))
    y = torch.stack(ys, dim=1)
    return y.to(x.dtype), state.transpose(2, 3)
