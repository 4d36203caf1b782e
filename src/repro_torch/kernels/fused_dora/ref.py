"""Plain PyTorch version of the fused DoRA-decomposed LoRA linear.

Port of ``repro/kernels/fused_dora/ref.py``:

    y = x @ W0 + scale · ((x ⊙ A_mag) @ (A_dir + dA_dir))
                          ⊙ (B_mag + dB_mag) @ B_dir

with every operand cast to f32 and the result to x's dtype.  Shapes:
x (M, K), W0 (K, N), A_dir/dA_dir (K, r), A_mag (K,), B_dir (r, N),
B_mag/dB_mag (r,).  It serves CPU tensors and is what the CUDA kernel is
held against (the kernel rounds at the Pallas body's cast points
instead, so in bf16 the two differ by a rounding).
"""
from __future__ import annotations

import torch


def fused_dora_ref(x, w0, a_dir, a_mag, b_dir, b_mag, da_dir, db_mag,
                   scale: float):
    f32 = torch.float32
    xf = x.to(f32)
    y = xf @ w0.to(f32)
    h = (xf * a_mag.to(f32)[None, :]) @ (a_dir.to(f32) + da_dir.to(f32))
    h = h * (b_mag.to(f32) + db_mag.to(f32))[None, :]
    y = y + scale * (h @ b_dir.to(f32))
    return y.to(x.dtype)
