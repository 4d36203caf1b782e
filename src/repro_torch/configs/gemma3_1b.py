"""Gemma 3 1B — dense, 5:1 local(SWA-512):global interleave, 128k-class
context, MQA kv=1, head_dim 256 [hf:google/gemma-3-1b-pt]."""
from repro_torch.models.config import ArchConfig, reduced

ARCH = ArchConfig(
    name="gemma3-1b", family="dense",
    n_layers=26, d_model=1152, n_heads=4, n_kv_heads=1, d_ff=6912,
    vocab_size=262144, d_head=256,
    local_global=5, sliding_window=512, rope_theta=1e6,
    tie_embeddings=True,
    source="hf:google/gemma-3-1b-pt",
)
SMOKE = reduced(ARCH)
