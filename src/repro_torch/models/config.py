"""Architecture configuration + superblock pattern derivation.

The port's own copy of ``repro/models/config.py`` (pure Python, kept
separate so the port never imports the JAX package).  A *superblock* is
the smallest repeating sequence of sublayers; params are stacked
``(n_superblocks, ...)`` and the port runs them as a Python loop over
per-superblock views.  Uneven layer counts produce a stacked main body
plus a shorter tail.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence


@dataclasses.dataclass(frozen=True)
class SubLayer:
    """One sublayer within a superblock pattern."""
    mixer: str        # "attn" | "ssm" | "cross_attn"
    ffn: str          # "dense" | "moe" | "none"
    attn_kind: str = "global"   # "global" | "local"  (local = sliding window)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense|moe|ssm|hybrid|encdec|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0               # 0 → d_model // n_heads
    # --- moe ---
    n_experts: int = 0
    top_k: int = 0
    moe_every: int = 1            # every k-th sublayer's ffn is MoE
    capacity_factor: float = 1.25
    ep_fsplit: int = 1            # physical expert slots per expert
    # --- attention flavor ---
    rope_theta: float = 1e4
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    local_global: int = 0         # gemma3: N local layers per 1 global
    mrope: bool = False           # qwen2-vl 3-section rotary
    # --- ssm (mamba2 / jamba) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    attn_every: int = 0           # hybrid: 1 attn layer per this many layers
    # --- enc-dec ---
    n_enc_layers: int = 0         # >0 → encoder-decoder; n_layers = decoder
    # --- modality frontend stub ---
    frontend: Optional[str] = None  # "audio" | "vision"
    frontend_tokens: int = 256      # stub embedding positions
    # --- adapters (paper setting: LoRA r=8 α=32 on Q,V) ---
    lora_rank: int = 8
    lora_alpha: float = 32.0
    lora_dropout: float = 0.1
    lora_targets: Sequence[str] = ("q_proj", "v_proj")
    use_fused_dora: bool = False  # fused base+adapter kernel (forward only)
    # --- serving-time weight-only quantization ("int8" | "int4") ---
    backbone_quant: Optional[str] = None
    backbone_quant_group: Optional[int] = None
    # --- misc ---
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"
    source: str = ""              # citation

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // max(self.n_heads, 1))

    # ---- superblock pattern ------------------------------------------------
    def pattern(self) -> list[SubLayer]:
        if self.family == "ssm":
            return [SubLayer("ssm", "none")]
        if self.family == "hybrid":
            pat = []
            for i in range(self.attn_every):
                mixer = "attn" if i == 0 else "ssm"
                ffn = "moe" if (self.n_experts and (i % self.moe_every == self.moe_every - 1)) else "dense"
                pat.append(SubLayer(mixer, ffn,
                                    "local" if self.sliding_window else "global"))
            return pat
        if self.local_global:
            pat = [SubLayer("attn", "dense", "local")] * self.local_global
            pat += [SubLayer("attn", "dense", "global")]
            return pat
        ffn = "moe" if self.n_experts else "dense"
        kind = "local" if self.sliding_window else "global"
        return [SubLayer("attn", ffn, kind)]

    def dec_pattern(self) -> list[SubLayer]:
        """Decoder pattern for enc-dec: self-attn + cross-attn per layer."""
        return [SubLayer("attn", "none"), SubLayer("cross_attn", "dense")]

    def blocks_layout(self, n_layers: Optional[int] = None,
                      pattern: Optional[list[SubLayer]] = None):
        """(n_superblocks, tail_len, pattern). tail runs pattern[:tail_len]."""
        n = self.n_layers if n_layers is None else n_layers
        pat = self.pattern() if pattern is None else pattern
        per = len(pat)
        return n // per, n % per, pat


def reduced(cfg: ArchConfig, n_layers: int = 2, d_model: int = 256,
            n_experts: int = 4, vocab: int = 512, d_ff: int = 0,
            seq_window: int = 64) -> ArchConfig:
    """Smoke-test variant of the same family (≤512 d_model, ≤4 experts)."""
    heads = max(1, min(cfg.n_heads, 4))
    kv = max(1, min(cfg.n_kv_heads, heads))
    nl = max(n_layers, 2) if (cfg.family == "hybrid" or cfg.local_global) \
        else n_layers
    return dataclasses.replace(
        cfg,
        n_layers=nl,
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=kv,
        d_head=d_model // heads,
        d_ff=d_ff or (2 * d_model),
        vocab_size=vocab,
        n_experts=min(cfg.n_experts, n_experts) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ep_fsplit=1,
        capacity_factor=8.0,
        attn_every=min(cfg.attn_every, 2) if cfg.attn_every else 0,
        moe_every=min(cfg.moe_every, 2) if cfg.moe_every else 1,
        ssm_state=min(cfg.ssm_state, 16) if cfg.ssm_state else 0,
        ssm_headdim=32 if cfg.ssm_state else cfg.ssm_headdim,
        ssm_chunk=16,
        sliding_window=seq_window if cfg.sliding_window else None,
        local_global=min(cfg.local_global, 1) if cfg.local_global else 0,
        n_enc_layers=min(cfg.n_enc_layers, 2) if cfg.n_enc_layers else 0,
        frontend_tokens=8 if cfg.frontend else 0,
        lora_rank=4,
        dtype="float32",
    )
