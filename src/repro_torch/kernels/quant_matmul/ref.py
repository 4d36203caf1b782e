"""Weight-only int8/int4 codecs and the plain dequant-matmul.

Port of ``repro/kernels/quant_matmul/ref.py``, op for op, so that the
same f32 weights give byte-identical codes and equal scales in both
packages (``max|w|`` over each group of input rows, over 127 or 7, then
``round(w / scale)`` — a true division, rounding half to even — and a
clip).  Layouts:

  int8   q (..., d_in, d_out) int8 in [-127, 127]
  int4   q (..., d_in/2, d_out) uint8 — two nibbles packed along d_in,
         row 2j in the low nibble and row 2j+1 in the high one, each
         stored biased (v = q + 8, q in [-7, 7])
  scale  (..., G, d_out) float32 — per output channel (G = 1) or per
         group of ``group_size`` input rows (G = d_in / group_size)

The storage dtype is the format tag: int8 leaves are int8, packed int4
leaves are uint8.  ``quant_matmul_ref`` serves CPU tensors and is what
the CUDA kernel is held against.
"""
from __future__ import annotations

import torch

_EPS = 1e-8          # scale floor: an all-zero channel dequantizes to zero


def _grouped(w, group_size):
    *lead, d_in, d_out = w.shape
    g = d_in if group_size is None else int(group_size)
    if d_in % g:
        raise ValueError(f"group_size {g} does not divide d_in {d_in}")
    return w.reshape(*lead, d_in // g, g, d_out)


def _scaled_codes(w, group_size, qmax):
    """(codes as f32 in [-qmax, qmax] shaped like w, scale (..., G, d_out))."""
    wg = _grouped(w, group_size)
    scale = torch.clamp_min(wg.abs().amax(dim=-2), _EPS) / qmax
    q = torch.clamp(torch.round(wg / scale[..., None, :]), -qmax, qmax)
    return q.reshape(w.shape), scale


def quantize_int8(w, *, group_size=None):
    """w (..., d_in, d_out) → (q int8, scale f32 (..., G, d_out)); a bf16
    w is cast to f32 first."""
    w = w.to(torch.float32)
    q, scale = _scaled_codes(w, group_size, 127.0)
    return q.to(torch.int8), scale


def quantize_int4(w, *, group_size=None):
    """w (..., d_in, d_out), d_in even →
    (packed uint8 (..., d_in/2, d_out), scale f32 (..., G, d_out))."""
    w = w.to(torch.float32)
    if w.shape[-2] % 2:
        raise ValueError(f"int4 packing needs even d_in, got {w.shape[-2]}")
    q, scale = _scaled_codes(w, group_size, 7.0)
    v = (q + 8.0).to(torch.uint8)                          # biased nibbles
    return v[..., 0::2, :] | (v[..., 1::2, :] << 4), scale


def unpack_int4(packed):
    """(..., d_in/2, d_out) uint8 → (..., d_in, d_out) int8 in [-7, 7]."""
    lo = (packed & 0xF).to(torch.int8) - 8
    hi = (packed >> 4).to(torch.int8) - 8
    *lead, p, d_out = packed.shape
    return torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * p, d_out)


def dequantize(q, scale):
    """The f32 weight of an int8 or packed-int4 leaf."""
    if q.dtype == torch.uint8:
        q = unpack_int4(q)
    *lead, d_in, d_out = q.shape
    G = scale.shape[-2]
    wg = q.to(torch.float32).reshape(*lead, G, d_in // G, d_out)
    return (wg * scale[..., None, :]).reshape(*lead, d_in, d_out)


def quant_matmul_ref(x, q, scale):
    """x (..., d_in) @ dequant(q, scale) → (..., d_out): the weight is
    dequantized in f32, cast to x's dtype, and multiplied."""
    return x @ dequantize(q, scale).to(x.dtype)
