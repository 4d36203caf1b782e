"""Mixtral 8x22B — 8-expert top-2 MoE with sliding-window attention
[arXiv:2401.04088].  ep_fsplit=2: the 8 experts are stored as 16
half-d_ff slots (the reference's layout for a 16-wide expert-parallel
axis; on one card the slots' down-projection partial sums recombine in
the weighted combine)."""
from repro_torch.models.config import ArchConfig, reduced

ARCH = ArchConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab_size=32768,
    n_experts=8, top_k=2, ep_fsplit=2,
    sliding_window=4096,
    source="arXiv:2401.04088",
)
SMOKE = reduced(ARCH)
