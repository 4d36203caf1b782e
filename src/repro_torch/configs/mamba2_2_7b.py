"""Mamba-2 2.7B — attention-free SSD (state-space duality)
[arXiv:2405.21060].  d_inner = 2*2560 = 5120, 80 heads of 64, state 128.
Vocab 50280 padded to 50288, as the reference's.  The paper's LoRA
targets (attention Q/V) do not exist; adapters attach to the mixer's
in (x_proj) and out projections instead."""
from repro_torch.models.config import ArchConfig, reduced

ARCH = ArchConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=1, n_kv_heads=1, d_ff=0,
    vocab_size=50288,
    ssm_state=128, ssm_conv=4, ssm_expand=2, ssm_headdim=64, ssm_groups=1,
    ssm_chunk=128,
    lora_targets=("x_proj", "out_proj"),
    source="arXiv:2405.21060",
)
SMOKE = reduced(ARCH, d_ff=1)
