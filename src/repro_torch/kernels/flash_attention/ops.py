"""Public dispatcher for flash attention in the model's (B, S, H, dh)
layout, with GQA.

``flash_attention(..., impl=None)`` launches the CUDA kernel for a CUDA
tensor and runs the plain ``attention_ref`` for a CPU tensor;
``impl="torch"`` forces the plain version, for explicit comparisons
only.  As the reference's dispatcher does, it folds heads into the
batch (B·H query heads over B·K kv heads), aligns the ends (causal
offset Sk − Sq, so a decode row sees the whole cache) and defaults the
scale to 1/sqrt(dh).  The kernel picks its own tiles and masks ragged
edges, so there are no block knobs and nothing is padded.
"""
from __future__ import annotations

import math

from repro_torch.kernels._wrap import resolve_impl
from repro_torch.kernels.flash_attention.flash_attention import (
    flash_attention_bhsd_cuda)
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q, k, v, *, causal: bool = True, window: int | None = None,
                    scale: float | None = None, impl=None):
    """q (B,Sq,H,dh); k/v (B,Sk,K,dh) GQA → (B,Sq,H,dh) in q's dtype."""
    impl = resolve_impl(impl, q, "flash_attention")
    if impl == "torch":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    if scale is None:
        scale = 1.0 / math.sqrt(dh)
    qf = q.transpose(1, 2).reshape(B * H, Sq, dh).contiguous()
    kf = k.transpose(1, 2).reshape(B * K, Sk, dh).contiguous()
    vf = v.transpose(1, 2).reshape(B * K, Sk, dh).contiguous()
    out = flash_attention_bhsd_cuda(qf, kf, vf, scale=scale, causal=causal,
                                    window=window, q_offset=Sk - Sq)
    return out.reshape(B, H, Sq, dh).transpose(1, 2)


__all__ = ["flash_attention", "attention_ref"]
