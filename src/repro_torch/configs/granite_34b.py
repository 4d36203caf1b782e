"""Granite 34B code model — llama-arch dense, MQA (kv=1), 88 layers
[arXiv:2405.04324]."""
from repro_torch.models.config import ArchConfig, reduced

ARCH = ArchConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab_size=49152,
    source="arXiv:2405.04324",
)
SMOKE = reduced(ARCH)
