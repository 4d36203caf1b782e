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
tests hold the CUDA kernels against.  ``bf16_bound`` gives the exact
value at the Pallas bodies' cast points and an elementwise bound on how
far a bf16 output with those cast points and f32 sums in any order may
lie from it.
"""
from __future__ import annotations

import torch

BF16_UNIT = 2.0 ** -8    # bf16's unit roundoff: 8 significant bits
# an f32 add's relative error: 2^-24 rounding to nearest, 2^-23 also
# covers sums that truncate
F32_SUM_UNIT = 2.0 ** -23


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


def _gamma(n: int) -> float:
    """The relative error bound of an f32 sum of n terms in any order."""
    return n * F32_SUM_UNIT / (1.0 - n * F32_SUM_UNIT)


def _cast_operands(x, a, b, idx, mag, ft):
    """The operands at the Pallas bodies' cast points (T = x's dtype), as
    ``ft`` values: xs = x or T(x ⊙ T(a_mag)) (B, S, d_in), T(A) (B, d_in,
    r) or (d_in, r), T(B) (B, r, d_out) or (1, r, d_out), and the f32
    magnitude m = b_mag + dmag[slot] (B, 1, r), or None for pairs."""
    dt, gi = x.dtype, idx.to(torch.int64)
    if mag is None:
        return (x.to(ft), a[gi].to(dt).to(ft), b[gi].to(dt).to(ft), None)
    a_mag, b_mag, dmag_pool = mag
    xs = (x.float() * a_mag.float().to(dt).float()).to(dt)
    m = b_mag.float()[None] + dmag_pool.float()[gi]
    return (xs.to(ft), a.to(dt).to(ft), b.to(dt).to(ft)[None],
            m[:, None, :].to(ft))


def bgmv_cast_ref(x, a, b, idx, scale: float = 1.0, ranks=None, *,
                  mag=None):
    """Both kinds with the Pallas bodies' cast points, products and sums in
    f32 (arguments as ``bf16_bound``'s): what the CUDA kernel computes, up
    to the order of its sums.  ``bgmv_mag_ref`` rounds twice more (h before
    the magnitude product, and the magnitude itself)."""
    xs, af, bf, m = _cast_operands(x, a, b, idx, mag, torch.float32)
    p = xs @ af
    if m is not None:
        p = p * m
    if ranks is not None:
        p = torch.where(_rank_keep(p, idx, ranks), p, 0.0)
    h = p.to(x.dtype).float()
    return ((h @ bf) * scale).to(x.dtype)


def bf16_bound(x, a, b, idx, scale: float = 1.0, ranks=None, *, mag=None):
    """The exact (f64) value before the output's rounding, at the Pallas
    bodies' cast points, and an elementwise bound on how far a bf16 output
    with those cast points, f32 sums in any order and its own rounding may
    lie from it.  Returns (ref, bound), both (B, S, d_out) f32.

    x is bf16 (B, S, d_in).  Pairs: a = a_pool (L, d_in, r), b = b_pool
    (L, r, d_out).  Magnitude: a = a_dir (d_in, r), b = b_dir (r, d_out)
    and ``mag`` = (a_mag, b_mag, dmag_pool).  Every slot in idx is in range.

    The cast points: T(A) and T(B) (T = bf16), xs = x or T(x ⊙ T(a_mag)),
    one product each and exact in f32; m = b_mag + dmag[slot] in f32.
    p_j = (Σ_k xs_k T(A)_kj)(· m_j) is a sum of K exact products (one f32
    multiply more on the magnitude path): an f32 evaluation in any order
    lies within e_p = γ_{K(+1)} Σ_k |xs_k T(A)_kj| (|m_j|) of it (γ_n =
    n u32 / (1 − n u32), u32 = 2^-23).  The rank mask zeroes p_j and e_p
    at j ≥ the slot's rank.  h_j = T(p_j) lies within u|p_j| of p_j (u =
    2^-8), so a kernel's T(p̂_j) and the exact T(p_j) differ by at most
    e_h = e_p + (u + u32)(2|p_j| + e_p): a change of sum order can flip
    that rounding by one ulp of h_j, which moves y by about u |h_j|
    |T(B)_jo| -- carried per rank column.  Through T(B) that adds
    e_h @ |T(B)| and γ_r over the r terms, and the scale's f32 multiply
    γ_2 of the magnitude.  With E the sum of these, the output's own
    rounding gives bound = u |ref| + (1 + u) E."""
    xs, af, bf, m = _cast_operands(x, a, b, idx, mag, torch.float64)
    K = x.shape[-1]
    p = xs @ af
    e_p = xs.abs() @ af.abs()
    if m is None:
        e_p = _gamma(K) * e_p
    else:
        p, e_p = p * m, _gamma(K + 1) * e_p * m.abs()
    r = p.shape[-1]
    if ranks is not None:
        keep = _rank_keep(p, idx, ranks)
        p, e_p = torch.where(keep, p, 0.0), torch.where(keep, e_p, 0.0)
    u = BF16_UNIT
    hf = p.to(torch.float32).to(x.dtype).to(torch.float64)
    e_h = e_p + (u + F32_SUM_UNIT) * (2 * p.abs() + e_p)
    delta = hf @ bf
    e_delta = e_h @ bf.abs() + _gamma(r) * ((hf.abs() + e_h) @ bf.abs())
    ref = scale * delta
    err = abs(scale) * e_delta + _gamma(2) * abs(scale) * (delta.abs() + e_delta)
    bound = u * ref.abs() + (1 + u) * err
    return ref.to(torch.float32), bound.to(torch.float32)
