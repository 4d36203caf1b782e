"""DeepSeek-7B — llama-arch dense MHA (kv=heads) [arXiv:2401.02954].
Also one of the paper\'s two fine-tuning targets."""
from repro_torch.models.config import ArchConfig, reduced

ARCH = ArchConfig(
    name="deepseek-7b", family="dense",
    n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, d_ff=11008,
    vocab_size=102400,
    source="arXiv:2401.02954",
)
SMOKE = reduced(ARCH)
