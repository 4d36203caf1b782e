"""LLaMA-2 7B — the paper\'s primary fine-tuning target
[arXiv:2307.09288]."""
from repro_torch.models.config import ArchConfig, reduced

ARCH = ArchConfig(
    name="llama2-7b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab_size=32000,
    source="arXiv:2307.09288",
)
SMOKE = reduced(ARCH)
