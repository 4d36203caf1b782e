"""Qwen3-32B — dense GQA kv=8 with qk-norm, head_dim 128
[hf:Qwen/Qwen3-8B family card]."""
from repro_torch.models.config import ArchConfig, reduced

ARCH = ArchConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_ff=25600,
    vocab_size=151936, d_head=128, qk_norm=True,
    source="hf:Qwen/Qwen3-8B",
)
SMOKE = reduced(ARCH)
