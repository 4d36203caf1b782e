"""Jamba v0.1 52B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2
[arXiv:2403.19887].  Attention layer every 8 sublayers; MoE replaces the
dense FFN on every 2nd sublayer.  Jamba uses Mamba-1 (d_state 16); the
SSM block here is the SSD (Mamba-2) formulation of the same recurrence,
as the reference's.  Attention is global (no sliding window)."""
from repro_torch.models.config import ArchConfig, reduced

ARCH = ArchConfig(
    name="jamba-v0.1-52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=65536,
    n_experts=16, top_k=2, moe_every=2,
    attn_every=8,
    ssm_state=16, ssm_conv=4, ssm_expand=2, ssm_headdim=64, ssm_groups=1,
    ssm_chunk=128,
    source="arXiv:2403.19887",
)
SMOKE = reduced(ARCH)
