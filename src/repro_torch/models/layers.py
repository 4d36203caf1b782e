"""Core layers of the dense decoder (port of ``repro/models/layers.py``).

Everything is a function over nested-dict params.  Linear layers
understand adapter params living alongside their kernel:

  {kernel}                                  — plain frozen projection
  {kernel, lora_A, lora_B}                  — raw LoRA (baseline)
  {kernel, lora_A, lora_B, local_A, local_B} — FedALT's dual pairs
  {kernel, A_dir, A_mag, B_dir, B_mag,
   dA_dir, dB_mag}                          — DoRA-decomposed LoRA
  {kernel, pool_A, pool_B[, pool_ranks]}    — pooled per-tenant pairs
  {kernel, bgmv_A_dir, bgmv_A_mag,
   bgmv_B_mag, bgmv_B_dir, pool_dB_mag
   [, pool_ranks]}                          — pooled decomposed DoRA
  {kernel_q, kernel_scale, ...}             — quantized frozen backbone
                                              (int8 / packed int4), any
                                              of the adapters above on top

Kernels use (d_in, d_out) layout.  Dtypes and cast points follow the
reference: bf16 operands with f32 accumulation where it accumulates in
f32, so the two packages agree to a stated tolerance and the port's
pooled path equals its merged path in float32.

``linear`` routes to the port's kernels: ``fused=True`` (``cfg.
use_fused_dora``) sends a non-pooled DoRA-decomposed projection through
``fused_dora``, a ``kernel_q`` leaf goes through ``quant_matmul``, and
pooled adapters through the BGMV ops.  ``kernel_impl`` threads down to
all of them: None launches the CUDA kernel for CUDA tensors (the plain
version for CPU ones); "torch" forces the plain versions, for explicit
comparisons only.
"""
from __future__ import annotations

import math
from typing import Any

import torch
import torch.nn.functional as F

Params = Any


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x, w, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


# ---------------------------------------------------------------------------
# rotary embeddings
# ---------------------------------------------------------------------------

def _rope_freqs(dh: int, theta: float, device):
    return theta ** (-torch.arange(0, dh // 2, dtype=torch.float32,
                                   device=device) / (dh // 2))


def apply_rope(x, positions, theta: float = 1e4):
    """x: (B, S, H, dh); positions: (B, S) int.  Rotates split halves
    (x[..., :dh/2], x[..., dh/2:]), not interleaved pairs."""
    dh = x.shape[-1]
    freqs = _rope_freqs(dh, theta, x.device)                   # (dh/2,)
    ang = positions[..., None].float() * freqs                 # (B,S,dh/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# adapter-aware linear
# ---------------------------------------------------------------------------

def adapter_dropout(x, generator, p: float):
    """Inverted dropout on the adapter's input: keep each element with
    probability 1 − p (a fresh draw from ``generator``, which lives on
    x's device) and divide the kept ones by 1 − p."""
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1 - p
    return torch.where(keep, x / (1.0 - p), 0.0).to(x.dtype)


def lora_delta(p: Params, x, scale: float, dropout_gen=None,
               dropout: float = 0.0):
    """Low-rank adapter contribution for input x (..., d_in), with adapter
    dropout at rate ``dropout`` when ``dropout_gen`` is given."""
    if dropout_gen is not None and dropout > 0.0:
        x = adapter_dropout(x, dropout_gen, dropout)
    if "lora_A" in p:                                    # raw LoRA
        h = x @ p["lora_A"].to(x.dtype)
        y = (h @ p["lora_B"].to(x.dtype)) * scale
        if "local_A" in p:           # FedALT dual pair, on the same x
            hl = x @ p["local_A"].to(x.dtype)
            y = y + (hl @ p["local_B"].to(x.dtype)) * scale
        return y
    # DoRA-decomposed LoRA (the paper's form):
    #   A = (A_dir + dA_dir) * A_mag[:, None]
    #   B = B_dir * (B_mag + dB_mag)[:, None]
    a_dir = p["A_dir"] + p["dA_dir"] if "dA_dir" in p else p["A_dir"]
    h = (x * p["A_mag"].to(x.dtype)) @ a_dir.to(x.dtype)
    b_mag = p["B_mag"] + p["dB_mag"] if "dB_mag" in p else p["B_mag"]
    return ((h * b_mag.to(x.dtype)) @ p["B_dir"].to(x.dtype)) * scale


def lora_delta_batched(p: Params, x, adapter_idx, scale: float,
                       kernel_impl=None):
    """Mixed-tenant adapter contribution: row i of x (B, ..., d_in) uses
    the adapter in pool slot adapter_idx[i] (BGMV — see
    kernels/batched_lora and serve/adapter_store).  An optional
    {pool_ranks} leaf ((L,) int32) masks each row at its slot's rank."""
    from repro_torch.kernels import bgmv, bgmv_mag
    ranks = p.get("pool_ranks")
    if "pool_A" in p:
        return bgmv(x, p["pool_A"], p["pool_B"], adapter_idx, scale=scale,
                    ranks=ranks, impl=kernel_impl)
    return bgmv_mag(x, p["bgmv_A_dir"], p["bgmv_A_mag"], p["bgmv_B_mag"],
                    p["pool_dB_mag"], p["bgmv_B_dir"], adapter_idx,
                    scale=scale, ranks=ranks, impl=kernel_impl)


def _has_pooled(p: Params) -> bool:
    return "pool_A" in p or "pool_dB_mag" in p


def linear(p: Params, x, *, lora_scale: float = 0.0, dropout_gen=None,
           dropout: float = 0.0, fused: bool = False, adapter_idx=None,
           kernel_impl=None):
    if (fused and "A_dir" in p and lora_scale
            and (adapter_idx is None or not _has_pooled(p))
            and (dropout_gen is None or dropout == 0.0)
            and "bias" not in p and "kernel" in p
            and p["kernel"].dim() == 2):
        # fused base + adapter product (forward only).  Pooled per-row
        # routing outranks it: taking this branch there would serve every
        # tenant the shared adapter.
        from repro_torch.kernels import fused_dora
        return fused_dora(x, p["kernel"], p["A_dir"], p["A_mag"],
                          p["B_dir"], p["B_mag"], p.get("dA_dir"),
                          p.get("dB_mag"), scale=lora_scale,
                          impl=kernel_impl)
    if "kernel_q" in p:
        # quantized frozen backbone: dequant-fused product; the adapter
        # deltas below stay full precision on top
        from repro_torch.kernels import quant_matmul
        y = quant_matmul(x, p["kernel_q"], p["kernel_scale"],
                         impl=kernel_impl)
    else:
        y = x @ p["kernel"].to(x.dtype)
    if "bias" in p:
        y = y + p["bias"].to(y.dtype)
    if adapter_idx is not None and lora_scale and _has_pooled(p):
        y = y + lora_delta_batched(p, x, adapter_idx, lora_scale, kernel_impl)
    elif ("lora_A" in p or "A_dir" in p) and lora_scale:
        y = y + lora_delta(p, x, lora_scale, dropout_gen, dropout)
    return y


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

def _causal_mask(S_q, S_k, device):
    """(S_q, S_k) boolean mask; q position i attends k position j ≤ i."""
    qi = torch.arange(S_q, device=device)[:, None]
    kj = torch.arange(S_k, device=device)[None, :]
    return kj <= qi


def _sdpa(q, k, v, mask, softmax_scale):
    """q:(B,Sq,H,dh) k,v:(B,Sk,K,dh) GQA by grouped heads; mask
    (..., Sq, Sk) bool or None.  Scores in f32 (bf16 operands are exact
    in f32, so this is the reference's f32 accumulation), masked to
    -1e30, softmax in f32, weights cast to v's dtype before the PV
    product, which accumulates in f32."""
    B, Sq, H, dh = q.shape
    K = k.shape[2]
    rep = H // K
    qg = q.reshape(B, Sq, K, rep, dh)
    scores = torch.einsum("bqkrd,bskd->bkrqs", qg.float(),
                          k.float()) * softmax_scale
    if mask is not None:
        m = mask
        if m.dim() == 4:                      # (B?,1,Sq,Sk) → (B?,1,1,Sq,Sk)
            m = m[:, :, None]
        scores = torch.where(m, scores, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkrqs,bskd->bqkrd", w.to(v.dtype).float(), v.float())
    return out.reshape(B, Sq, H, dh).to(q.dtype)


def _target_scale(cfg, proj: str, lora_scale: float) -> float:
    return lora_scale if proj in cfg.lora_targets else 0.0


def attention(p: Params, x, positions, cfg, *, kind: str = "global",
              cache=None, cache_index=None,
              lora_scale: float = 0.0, dropout_gen=None,
              return_cache: bool = False, cache_len: int = 0,
              adapter_idx=None, kernel_impl=None):
    """Causal self-attention sublayer (pre-norm outside).  Returns
    (y, new_cache).

    dropout_gen: torch.Generator for adapter dropout (training) on the
    q/k/v adapters, at cfg.lora_dropout; each projection takes its own
    draw from it.

    cache: dict(k=(B,Sc,K,dh), v=...) — decode buffer.  The port writes
    the new token's k/v into it IN PLACE (the reference returns a
    functional copy); the returned cache is the same dict.
    cache_index: int / 0-d tensor shared write position, or (B,) int
    tensor of per-row positions (mixed-tenant serving).  Per-row writes
    at positions ≥ Sc are dropped, as the reference's scatter drops them.
    adapter_idx: (B,) int32 pool slot per row for batched-LoRA serving.
    """
    if kind == "local" and cfg.sliding_window is not None:
        raise NotImplementedError("sliding-window attention is not ported "
                                  "yet (ROADMAP A12)")
    if "q_norm" in p or cfg.mrope:
        raise NotImplementedError("qk-norm and M-RoPE are not ported yet "
                                  "(ROADMAP A12)")
    B, S, D = x.shape
    H, Kh, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    scale = 1.0 / math.sqrt(dh)
    kw = dict(fused=cfg.use_fused_dora, adapter_idx=adapter_idx,
              kernel_impl=kernel_impl)
    drop = dict(dropout_gen=dropout_gen, dropout=cfg.lora_dropout)
    q = linear(p["q_proj"], x, lora_scale=_target_scale(cfg, "q_proj",
                                                        lora_scale),
               **drop, **kw)
    k = linear(p["k_proj"], x, lora_scale=_target_scale(cfg, "k_proj",
                                                        lora_scale),
               **drop, **kw)
    v = linear(p["v_proj"], x, lora_scale=_target_scale(cfg, "v_proj",
                                                        lora_scale),
               **drop, **kw)
    q = q.reshape(B, S, H, dh)
    k = k.reshape(B, S, Kh, dh)
    v = v.reshape(B, S, Kh, dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    new_cache = None
    if cache is not None:
        ck, cv = cache["k"], cache["v"]
        Sc = ck.shape[1]
        ar = torch.arange(Sc, device=x.device)
        if torch.is_tensor(cache_index) and cache_index.dim() == 1:
            # per-row write positions (continuous batching): one slot per
            # row; rows past the buffer keep what they hold
            pos = cache_index.to(torch.int64)
            rows = torch.arange(B, device=x.device)
            slot = pos.clamp(max=Sc - 1)
            inside = (pos < Sc)[:, None, None]
            ck[rows, slot] = torch.where(inside, k[:, 0], ck[rows, slot])
            cv[rows, slot] = torch.where(inside, v[:, 0], cv[rows, slot])
            valid = ar[None, :] < (pos + 1).clamp(max=Sc)[:, None]
            mask = valid[:, None, None, :]                 # (B,1,1,Sc)
        else:
            idx = int(cache_index)
            start = min(max(idx, 0), Sc - S)               # as dynamic_update_slice clamps
            ck[:, start:start + S] = k
            cv[:, start:start + S] = v
            valid = ar < min(idx + 1, Sc)
            mask = valid[None, None, None, :]              # (1,1,1,Sc)
        new_cache = cache
        out = _sdpa(q, ck, cv, mask, scale)
    else:
        out = _sdpa(q, k, v, _causal_mask(S, S, x.device)[None, None], scale)
        if return_cache:
            pad = max(cache_len, S) - S
            new_cache = {"k": F.pad(k, (0, 0, 0, 0, 0, pad)),
                         "v": F.pad(v, (0, 0, 0, 0, 0, pad))}

    y = linear(p["o_proj"], out.reshape(B, S, H * dh),
               lora_scale=_target_scale(cfg, "o_proj", lora_scale), **kw)
    return y, new_cache


def init_attn_cache(cfg, batch, seq_len: int, dtype, device):
    """Zero k/v buffers of shape (*batch, seq_len, K, dh); ``batch`` is an
    int or a tuple of leading dims (the stacked superblock axis first).
    Linear buffers only: sliding-window rings are ROADMAP A12."""
    lead = (batch,) if isinstance(batch, int) else tuple(batch)
    shape = (*lead, seq_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# dense FFN (SwiGLU)
# ---------------------------------------------------------------------------

def dense_ffn(p: Params, x, cfg, lora_scale: float = 0.0, adapter_idx=None,
              kernel_impl=None):
    """SwiGLU FFN; with {adapter_down, adapter_up} in ``p``, a Houlsby
    adapter after down_proj: y + gelu(y @ down) @ up, gelu in its tanh
    form (``jax.nn.gelu``'s default) computed in f32.  The adapter's
    factors are cast to the activation dtype, as ``lora_delta`` casts
    its own, so a bf16 model stays bf16 (the reference's f32
    ``adapter_up`` promotes a bf16 block to f32: ROADMAP C, caveat 3)."""
    kw = dict(fused=cfg.use_fused_dora, adapter_idx=adapter_idx,
              kernel_impl=kernel_impl)
    g = linear(p["gate_proj"], x,
               lora_scale=_target_scale(cfg, "gate_proj", lora_scale), **kw)
    u = linear(p["up_proj"], x,
               lora_scale=_target_scale(cfg, "up_proj", lora_scale), **kw)
    h = F.silu(g.float()).to(x.dtype) * u
    y = linear(p["down_proj"], h,
               lora_scale=_target_scale(cfg, "down_proj", lora_scale), **kw)
    if "adapter_down" in p:                              # Houlsby adapter
        a = F.gelu((y @ p["adapter_down"].to(y.dtype)).float(),
                   approximate="tanh").to(y.dtype)
        y = y + a @ p["adapter_up"].to(y.dtype)
    return y
