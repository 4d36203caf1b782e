"""Plain PyTorch versions of flash attention, all in f32.

``attention_ref`` is a port of ``repro/kernels/flash_attention/ref.py``:
(B, S, H, dh) layouts, GQA (query head h reads kv head h // (H/K)),
masking at −1e30, ends aligned (query row i sits at key position
i + Sk − Sq), the output cast to q's dtype.  ``flash_attention_bhsd_ref``
is the same function in the kernel's own (B·H, S, dh) layout with its
knobs (``sk_valid``, ``q_offset``).  They serve CPU tensors and are what
the CUDA kernel is held against; the kernel rounds the softmax weights to
v's dtype before the PV product, as the Pallas body does, so in bf16 the
two differ by that rounding.  A row with no valid key (Sq > Sk under
causal, or keys cut by ``sk_valid`` or the window) gets the uniform
average of v over all Sk keys, as the −1e30 mask gives it.
``bf16_bound_bhsd`` gives, beside the plain output, an elementwise bound
on how far an output with those bf16 cast points may lie from it.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
BF16_UNIT = 2.0 ** -8    # bf16's unit roundoff: 8 significant bits


def _weights(qf, kf, mask, scale):
    """Softmax weights (..., Sq, Sk) in f32; mask (Sq, Sk) bool."""
    scores = torch.einsum("...qd,...kd->...qk", qf, kf) * scale
    return torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1)


def _attend(qf, kf, vf, mask, scale, dtype):
    """qf (..., Sq, dh), kf/vf (..., Sk, dh) f32, mask (Sq, Sk) bool."""
    w = _weights(qf, kf, mask, scale)
    return torch.einsum("...qk,...kd->...qd", w, vf).to(dtype)


def _mask(Sq, Sk, *, causal, window, q_offset, sk_valid, device):
    qi = torch.arange(Sq, device=device)[:, None] + q_offset
    kj = torch.arange(Sk, device=device)[None, :]
    mask = kj < (sk_valid or Sk)
    if causal:
        mask = mask & (kj <= qi)
    if window is not None:
        mask = mask & (kj > qi - window)
    return mask


def attention_ref(q, k, v, *, causal: bool = True, window: int | None = None,
                  scale: float | None = None):
    """q (B,Sq,H,dh), k/v (B,Sk,K,dh) → (B,Sq,H,dh) in q's dtype."""
    B, Sq, H, dh = q.shape
    Sk, K = k.shape[1], k.shape[2]
    rep = H // K
    f32 = torch.float32
    s = scale if scale is not None else 1.0 / math.sqrt(dh)
    kf = k.repeat_interleave(rep, dim=2).to(f32).transpose(1, 2)
    vf = v.repeat_interleave(rep, dim=2).to(f32).transpose(1, 2)
    mask = _mask(Sq, Sk, causal=causal, window=window, q_offset=Sk - Sq,
                 sk_valid=0, device=q.device)
    out = _attend(q.to(f32).transpose(1, 2), kf, vf, mask, s, q.dtype)
    return out.transpose(1, 2)


def _bhsd_f32(q, k, v, **mask_kw):
    """q, k, v in f32 with each kv head repeated for its query heads, and
    the (Sq, Sk) mask."""
    BH, Sq, _ = q.shape
    BK, Sk, _ = k.shape
    rep = BH // BK
    f32 = torch.float32
    mask = _mask(Sq, Sk, device=q.device, **mask_kw)
    return (q.to(f32), k.repeat_interleave(rep, dim=0).to(f32),
            v.repeat_interleave(rep, dim=0).to(f32), mask)


def flash_attention_bhsd_ref(q, k, v, *, scale: float, causal: bool = True,
                             window: int | None = None, sk_valid: int = 0,
                             q_offset: int = 0):
    """q (BH, Sq, dh); k/v (BK, Sk, dh), BH a multiple of BK (head h reads
    kv head h // (BH/BK)) → (BH, Sq, dh) in q's dtype.  Keys at or past
    ``sk_valid`` (0: Sk) are masked; query row i sits at key position
    i + ``q_offset``."""
    qf, kf, vf, mask = _bhsd_f32(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, sk_valid=sk_valid)
    return _attend(qf, kf, vf, mask, scale, q.dtype)


def bf16_bound_bhsd(q, k, v, *, scale: float, causal: bool = True,
                    window: int | None = None, sk_valid: int = 0,
                    q_offset: int = 0, f32_err: float = 2e-5):
    """The plain output in f32 on the values of q, k and v, in
    ``flash_attention_bhsd_ref``'s layout and knobs, and an elementwise
    bound on how far an output with the Pallas body's bf16 cast points may
    lie from it.  Returns (ref, bound), both (BH, Sq, dh) f32.

    Such an output rounds each softmax weight to bf16 before the PV product
    (relative error δ_j, |δ_j| ≤ u = 2^-8, while the normaliser sums the
    unrounded weights) and rounds itself to bf16 (≤ u |y|).  With w the
    softmax weights, the first adds Σ_j w_j δ_j v_j: at most u Σ_j w_j |v_j|
    and, the δ_j being independent rounding errors of mean zero, beyond
    8 u sqrt(Σ_j w_j² v_j²) with a probability below 2 e^-32 (Hoeffding).
    The bound is u |ref| + (1 + u)(u min(those two) + ``f32_err``), where
    ``f32_err`` is the f32 kernel's own error."""
    qf, kf, vf, mask = _bhsd_f32(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset, sk_valid=sk_valid)
    w = _weights(qf, kf, mask, scale)
    ref = torch.einsum("...qk,...kd->...qd", w, vf)
    worst = torch.einsum("...qk,...kd->...qd", w, vf.abs())
    w.square_()
    spread = torch.einsum("...qk,...kd->...qd", w, vf.square()).sqrt_()
    del w
    u = BF16_UNIT
    p_err = torch.minimum(worst, 8.0 * spread).mul_(u).add_(f32_err)
    return ref, p_err.mul_(1.0 + u).add_(ref.abs(), alpha=u)
