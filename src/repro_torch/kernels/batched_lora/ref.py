"""Plain PyTorch versions of the batched-LoRA (BGMV) kernels.

Mirrors ``repro/kernels/batched_lora/ref.py`` op for op and cast for
cast.  The op order deliberately follows ``models.layers.lora_delta``,
so a mixed-tenant batch through the pooled path reproduces the
per-tenant merged-adapter path in float32:

  pairs      y[i] = (x[i] @ A[idx[i]]) @ B[idx[i]] · scale
  magnitude  y[i] = (((x[i] ⊙ A_mag) @ A_dir) ⊙ (B_mag + Δmag[idx[i]]))
                     @ B_dir · scale

``ranks`` (L,) int32 masks the low-rank intermediate at columns ≥ the
row's slot rank (after the magnitude product on the magnitude path), so
padded or stale rows contribute nothing and a rank-0 slot gives 0.

These serve CPU tensors and are what ``chip_smoke.py`` and the GPU
tests hold the CUDA kernels against.
"""
from __future__ import annotations

import torch


def _rank_keep(h, idx, ranks):
    """(B, S, r) keep-mask for per-row slot ranks."""
    rr = ranks.to(torch.int64)[idx.to(torch.int64)]              # (B,)
    return (torch.arange(h.shape[-1], device=h.device)[None, None, :]
            < rr[:, None, None])


def bgmv_ref(x, a_pool, b_pool, idx, scale: float = 1.0, ranks=None):
    """x (B, S, d_in), a_pool (L, d_in, r), b_pool (L, r, d_out),
    idx (B,) → (B, S, d_out)."""
    gi = idx.to(torch.int64)
    a = a_pool[gi].to(x.dtype)                              # (B, d_in, r)
    b = b_pool[gi].to(x.dtype)                              # (B, r, d_out)
    h = torch.einsum("bsd,bdr->bsr", x, a)
    if ranks is not None:
        h = torch.where(_rank_keep(h, idx, ranks), h, 0.0)
    return torch.einsum("bsr,bro->bso", h, b) * scale


def bgmv_mag_ref(x, a_dir, a_mag, b_mag, dmag_pool, b_dir, idx,
                 scale: float = 1.0, ranks=None):
    """Decomposed-DoRA magnitude path: shared directions + magnitudes,
    per-row raw-delta gather."""
    h = (x * a_mag.to(x.dtype)) @ a_dir.to(x.dtype)              # (B, S, r)
    m = b_mag[None] + dmag_pool[idx.to(torch.int64)]             # (B, r)
    h = h * m[:, None, :].to(x.dtype)
    if ranks is not None:
        h = torch.where(_rank_keep(h, idx, ranks), h, 0.0)
    return (h @ b_dir.to(x.dtype)) * scale
