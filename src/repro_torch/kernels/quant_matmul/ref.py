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
the CUDA kernel is held against; like the JAX package's oracle it rounds
the dequantized weight to x's dtype before the product.

``quant_matmul_cast_ref`` computes the same function with the Pallas
body's cast points instead: f32(x) · (f32(code) · scale) in f32, rounded
once to x's dtype.  ``bf16_bound`` gives the exact value of that
function and an elementwise bound on how far an output computed with f32
sums in any order, the scale applied per element or per group, and one
final rounding may lie from it.
"""
from __future__ import annotations

import torch

_EPS = 1e-8          # scale floor: an all-zero channel dequantizes to zero
BF16_UNIT = 2.0 ** -8    # bf16's unit roundoff: 8 significant bits
# an f32 add's relative error: 2^-24 rounding to nearest, 2^-23 for the
# tensor cores' sums, which may truncate
F32_SUM_UNIT = 2.0 ** -23


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


def dequantize(q, scale, dtype=torch.float32):
    """The f32 weight of an int8 or packed-int4 leaf (``dtype`` f64: the
    exact code · scale)."""
    if q.dtype == torch.uint8:
        q = unpack_int4(q)
    *lead, d_in, d_out = q.shape
    G = scale.shape[-2]
    wg = q.to(dtype).reshape(*lead, G, d_in // G, d_out)
    return (wg * scale.to(dtype)[..., None, :]).reshape(*lead, d_in, d_out)


def quant_matmul_ref(x, q, scale):
    """x (..., d_in) @ dequant(q, scale) → (..., d_out): the weight is
    dequantized in f32, cast to x's dtype, and multiplied."""
    return x @ dequantize(q, scale).to(x.dtype)


def quant_matmul_cast_ref(x, q, scale):
    """x (M, K) → (M, N) in x's dtype: f32(x) @ (f32(code) · scale) in
    f32, rounded once, as the Pallas body computes it."""
    return (x.to(torch.float32) @ dequantize(q, scale)).to(x.dtype)


def _gamma(n: int) -> float:
    """The relative error bound of an f32 sum of n terms in any order."""
    return n * F32_SUM_UNIT / (1.0 - n * F32_SUM_UNIT)


def bf16_bound(x, q, scale):
    """The exact (f64) value of Σ_k x[m, k] · code[k, n] · scale[g(k), n]
    and an elementwise bound on how far an output in x's dtype computed
    with f32 arithmetic may lie from it; both (M, N) f64.  x is (M, K).

    An f32 computation of y takes each term x · code · s through at most
    K + 1 f32 roundings: the Pallas body's f32(code) · s and its product
    with x, then its sums, or the kernel's exact products x · code, its
    sums within a group, the group scale's multiply and the sum over groups
    (one FMA each).  Sums of n terms in any order, and those multiplies,
    lie within γ_{K+2} Σ_k |x code s| of the exact value (γ_n = n u32 /
    (1 − n u32), u32 = 2^-23, which also covers sums that truncate).  With
    E that bound, the output's own rounding to bf16 (u = 2^-8) gives
    bound = u |ref| + (1 + u) E."""
    f64 = torch.float64
    xf = x.to(f64)
    w = dequantize(q, scale, f64)
    ref = xf @ w
    err = _gamma(xf.shape[-1] + 2) * (xf.abs() @ w.abs())
    return ref, BF16_UNIT * ref.abs() + (1 + BF16_UNIT) * err
