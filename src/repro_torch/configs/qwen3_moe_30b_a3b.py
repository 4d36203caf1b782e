"""Qwen3-30B-A3B — 128-expert top-8 MoE, GQA kv=4
[hf:Qwen/Qwen3-30B-A3B].  d_ff=768 is the per-expert FFN width; every
layer's FFN is MoE.  qk-norm per the Qwen3 family."""
from repro_torch.models.config import ArchConfig, reduced

ARCH = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, d_ff=768,
    vocab_size=151936,
    n_experts=128, top_k=8, qk_norm=True, d_head=128,
    source="hf:Qwen/Qwen3-30B-A3B",
)
SMOKE = reduced(ARCH)
