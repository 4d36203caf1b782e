"""Qwen2-VL 2B — VLM backbone with M-RoPE and dynamic resolution
[arXiv:2409.12191].  The ViT vision tower is a stub, as in the
reference: the caller provides projected patch embeddings
(``frontend_emb``); this is the language decoder that consumes them,
with the 3-section multimodal rotary."""
from repro_torch.models.config import ArchConfig, reduced

ARCH = ArchConfig(
    name="qwen2-vl-2b", family="vlm",
    n_layers=28, d_model=1536, n_heads=12, n_kv_heads=2, d_ff=8960,
    vocab_size=151936, d_head=128,
    mrope=True, frontend="vision", frontend_tokens=1024,
    source="arXiv:2409.12191",
)
SMOKE = reduced(ARCH)
