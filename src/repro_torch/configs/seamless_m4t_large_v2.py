"""SeamlessM4T-Large v2 — speech/text encoder-decoder transformer
backbone [arXiv:2308.11596].  The conformer/mel frontend is a stub, as
in the reference: the caller provides precomputed frame embeddings
(``frontend_emb``); this is the 24 + 24 encoder-decoder that consumes
them.  Vocab 256206 is padded to 256256, as the reference's."""
from repro_torch.models.config import ArchConfig, reduced

ARCH = ArchConfig(
    name="seamless-m4t-large-v2", family="audio",
    n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab_size=256256,
    frontend="audio", frontend_tokens=1024,
    source="arXiv:2308.11596",
)
SMOKE = reduced(ARCH)
