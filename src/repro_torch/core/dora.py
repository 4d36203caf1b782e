"""Direction–Magnitude (D-M) decomposition (paper Eq. 1 / Eq. 4).

For a kernel in (d_in, d_out) layout the DoRA "column" is the per-input-
feature vector over outputs, so

    mag(X) = ||X||_c           shape (..., d_in)    [norm over last axis]
    dir(X) = X / ||X||_c       shape (..., d_in, d_out)
    X      = dir * mag[..., None]                   (Eq. 1)

Leading stacked dims (the superblock layer axis) pass straight through.
"""
from __future__ import annotations

import torch

_EPS = 1e-12


def magnitude(x):
    return torch.linalg.vector_norm(x.float(), dim=-1)


def decompose(x):
    """x (..., d_in, d_out) → (mag (..., d_in), dir (..., d_in, d_out))."""
    m = magnitude(x)
    d = x.float() / (m[..., None] + _EPS)
    return m.to(x.dtype), d.to(x.dtype)


def recompose(mag, dir_):
    """(Eq. 1)  X = mag ⊙ dir  (broadcast over the output axis)."""
    return (dir_.float() * mag.float()[..., None]).to(dir_.dtype)


def decompose_lora_pair(lora_A, lora_B):
    """LoRA factors → the paper's Eq. 4 components:
    lora_A (..., d_in, r) → A_mag (..., d_in), A_dir;
    lora_B (..., r, d_out) → B_mag (..., r), B_dir."""
    A_mag, A_dir = decompose(lora_A)
    B_mag, B_dir = decompose(lora_B)
    return {"A_mag": A_mag, "A_dir": A_dir, "B_mag": B_mag, "B_dir": B_dir}


def recompose_lora_pair(c):
    """Decomposed factors → (A, B), honouring the trained deltas
    (paper Eq. 9 / Eq. 10):

        A = (A_dir + dA_dir) · diag(A_mag)
        B = diag(B_mag + dB_mag) · B_dir
    """
    a_dir = c["A_dir"] + c["dA_dir"] if "dA_dir" in c else c["A_dir"]
    b_mag = c["B_mag"] + c["dB_mag"] if "dB_mag" in c else c["B_mag"]
    return recompose(c["A_mag"], a_dir), recompose(b_mag, c["B_dir"])


def effective_delta_w(c, scale: float):
    """ΔW = scale · A · B materialized in f32, for analysis and tests (the
    model applies the factors without forming ΔW)."""
    A, B = recompose_lora_pair(c)
    return scale * torch.einsum("...ir,...ro->...io", A.float(), B.float())
