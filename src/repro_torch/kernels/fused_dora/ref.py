"""Plain PyTorch versions of the fused DoRA-decomposed LoRA linear.

``fused_dora_ref`` is a port of ``repro/kernels/fused_dora/ref.py``:

    y = x @ W0 + scale · ((x ⊙ A_mag) @ (A_dir + dA_dir))
                          ⊙ (B_mag + dB_mag) @ B_dir

with every operand cast to f32 and the result to x's dtype.  Shapes:
x (M, K), W0 (K, N), A_dir/dA_dir (K, r), A_mag (K,), B_dir (r, N),
B_mag/dB_mag (r,).  It serves CPU tensors and is what the CUDA kernel is
held against (the kernel rounds at the Pallas body's cast points
instead, so in bf16 the two differ by a rounding).

``fused_dora_cast_ref`` computes the same function with the Pallas
body's cast points (T = x's dtype): a_eff = T(A_dir + dA_dir),
b_eff_mag = B_mag + dB_mag in f32, h = T(x ⊙ T(A_mag)) @ a_eff,
y = T(x @ W0 + scale · (T(h ⊙ b_eff_mag) @ T(B_dir))), products in f32.
``bf16_bound`` gives the exact value at those cast points and an
elementwise bound on how far any output with them and f32 sums, in any
order, may lie from it.
"""
from __future__ import annotations

import torch

BF16_UNIT = 2.0 ** -8    # bf16's unit roundoff: 8 significant bits
# an f32 add's relative error: 2^-24 rounding to nearest, 2^-23 for the
# tensor cores' sums, which may truncate
F32_SUM_UNIT = 2.0 ** -23


def fused_dora_ref(x, w0, a_dir, a_mag, b_dir, b_mag, da_dir, db_mag,
                   scale: float):
    f32 = torch.float32
    xf = x.to(f32)
    y = xf @ w0.to(f32)
    h = (xf * a_mag.to(f32)[None, :]) @ (a_dir.to(f32) + da_dir.to(f32))
    h = h * (b_mag.to(f32) + db_mag.to(f32))[None, :]
    y = y + scale * (h @ b_dir.to(f32))
    return y.to(x.dtype)


def _cast_operands(x, w0, a_dir, a_mag, b_dir, b_mag, da_dir, db_mag, ft):
    """The operands at the Pallas body's cast points, as ``ft`` values:
    x, W0, T(x ⊙ T(A_mag)), a_eff, b_eff_mag, T(B_dir)."""
    f32, dt = torch.float32, x.dtype
    xf = x.to(f32)
    xs = (xf * a_mag.to(f32).to(dt).to(f32)[None, :]).to(dt)
    a_eff = (a_dir.to(f32) + da_dir.to(f32)).to(dt)
    b_eff = b_mag.to(f32) + db_mag.to(f32)
    return (xf.to(ft), w0.to(dt).to(ft), xs.to(ft), a_eff.to(ft),
            b_eff.to(ft), b_dir.to(dt).to(ft))


def fused_dora_cast_ref(x, w0, a_dir, a_mag, b_dir, b_mag, da_dir, db_mag,
                        scale: float):
    """x (M, K) → (M, N) in x's dtype, rounded where the Pallas body
    rounds, products and sums in f32."""
    xf, w, xs, a_eff, b_eff, bd = _cast_operands(
        x, w0, a_dir, a_mag, b_dir, b_mag, da_dir, db_mag, torch.float32)
    hf = (xs @ a_eff * b_eff[None, :]).to(x.dtype).float()
    return (xf @ w + scale * (hf @ bd)).to(x.dtype)


def _gamma(n: int) -> float:
    """The relative error bound of an f32 sum of n terms in any order."""
    return n * F32_SUM_UNIT / (1.0 - n * F32_SUM_UNIT)


def bf16_bound(x, w0, a_dir, a_mag, b_dir, b_mag, da_dir, db_mag,
               scale: float):
    """The exact (f64) value before the output's rounding, at the Pallas
    body's cast points, and an elementwise bound on how far an output with
    those cast points, f32 sums and its own rounding may lie from it.
    Returns (ref, bound), both (M, N) f32.  x is bf16 (M, K).

    Products of bf16 values are exact in f32.  Sums of n f32 terms, in
    any order, lie within γ_n Σ|terms| of the exact sum (γ_n = n u32 /
    (1 − n u32), u32 = 2^-23, which also covers sums that truncate):
    γ_K over Σ_k |x w| bounds the base product, and γ_{K+1} over
    |b_eff_mag| Σ_k |xs a_eff| the magnitude-scaled h, p = h ⊙ b_eff_mag
    (one f32 multiply more).  T(p) lies within u|p| of p (u = 2^-8), so
    the kernel's T(p_k) and the exact T(p) differ by at most
    e_p + (u + u32)(2|p| + e_p), e_p the bound on |p_k − p|: a change of
    sum order can flip that rounding by one ulp.  Through B_dir that adds
    e_hf @ |B_dir| and γ_r over the r terms, and the epilogue's f32
    multiply and add γ_2 of their magnitudes.  With E the sum of these,
    the output's own rounding gives bound = u |ref| + (1 + u) E."""
    f64 = torch.float64
    xf, w, xs, a_eff, b_eff, bd = _cast_operands(
        x, w0, a_dir, a_mag, b_dir, b_mag, da_dir, db_mag, f64)
    K, r = xf.shape[-1], a_eff.shape[-1]
    u = BF16_UNIT
    acc = xf @ w
    e_acc = _gamma(K) * (xf.abs() @ w.abs())
    p = xs @ a_eff * b_eff[None, :]
    e_p = _gamma(K + 1) * ((xs.abs() @ a_eff.abs()) * b_eff.abs()[None, :])
    hf = p.to(torch.float32).to(x.dtype).to(f64)
    e_hf = e_p + (u + F32_SUM_UNIT) * (2 * p.abs() + e_p)
    delta = hf @ bd
    e_delta = e_hf @ bd.abs() + _gamma(r) * ((hf.abs() + e_hf) @ bd.abs())
    ref = acc + scale * delta
    err = (e_acc + abs(scale) * e_delta + _gamma(2) * (
        acc.abs() + e_acc + abs(scale) * (delta.abs() + e_delta)))
    bound = u * ref.abs() + (1 + u) * err
    return ref.to(torch.float32), bound.to(torch.float32)
