"""``flash_attention`` on the model's prefill path, against the plain
chunked path, on the card.

Imports no JAX.  The ``gpu`` tests need a card and skip without one
(decided inside the fixture); on the GPU run them with ``python -m
pytest -q -m gpu tests/test_torch_dense_attention_gpu.py``.

At each config's full width (random weights from a seeded generator),
prefill 1 × 2048 tokens (the reference's chunked length) through
``forward``: kernel_impl None launches ``flash_attention`` once a
layer, kernel_impl "torch" takes the plain chunked path and launches
nothing.  granite-34b holds its rep 48 (48 query heads over one kv
head), qwen3-32b rep 8 with qk-norm and d_head 128 ≠ d_model / heads,
gemma3-1b rep 4 at d_head 256 with window 512 on its local layers.

Tolerances: last-row logits within 2e-2 of max |logit| in bf16 through
2 layers and within 1e-4 in f32 (``chip_smoke.py``'s rules: bf16 logits
part with depth); each layer's attention, bf16 q, k, v at the configs'
shapes, also elementwise within ``bf16_bound_bhsd`` of its roundings.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention import flash_attention as FK
from repro_torch.kernels.flash_attention.ref import bf16_bound_bhsd
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

S = 2048
TOL = {"bfloat16": 2e-2, "float32": 1e-4}
# arch → the depth of the f32 run (gemma3: one superblock of 5 local + 1
# global and a one-layer tail); bf16 runs 2 layers
ARCHS = {"llama2-7b": 2, "qwen3-32b": 2, "granite-34b": 2, "gemma3-1b": 7}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash_attention kernel runs only "
                    "on the GPU")
    return torch.device("cuda")


def _last_logits(params, tokens, cfg, impl):
    with torch.no_grad():
        h = TM.forward(params, {"tokens": tokens}, cfg, kernel_impl=impl)[0]
        return (h[:, -1] @ TM._head_kernel(params, cfg).to(h.dtype)).float()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_flash_prefill_matches_the_plain_chunked_path(cuda, arch, dtype):
    layers = ARCHS[arch] if dtype == "float32" else 2
    cfg = dataclasses.replace(get_config(arch), n_layers=layers, dtype=dtype,
                              lora_dropout=0.0)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = TM.init_params(g, cfg, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, S), generator=g,
                           device=cuda)
    before = FK.LAUNCHES["flash_attention"]
    plain = _last_logits(params, tokens, cfg, "torch")
    assert FK.LAUNCHES["flash_attention"] == before
    flash = _last_logits(params, tokens, cfg, None)
    assert FK.LAUNCHES["flash_attention"] == before + layers
    assert bool(torch.isfinite(flash).all())
    err = (flash - plain).abs().max() / plain.abs().max()
    assert err.item() <= TOL[dtype], (arch, dtype, err.item())


@pytest.mark.gpu
@pytest.mark.parametrize("arch,window", [
    ("llama2-7b", None), ("qwen3-32b", None), ("granite-34b", None),
    ("gemma3-1b", None), ("gemma3-1b", 512)])
def test_long_attention_within_the_rounding_bound(cuda, arch, window):
    """The layer's dispatch at the config's heads, bf16: the kernel's
    output against the plain chunked path within 2e-2 absolute, and each
    element within ``bf16_bound_bhsd``."""
    cfg = get_config(arch)
    H, K, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = torch.Generator(device=cuda).manual_seed(H + dh)
    q, k, v = (torch.randn((1, S, h, dh), generator=g, device=cuda).to(
        torch.bfloat16) for h in (H, K, K))
    scale = dh ** -0.5
    y = TL._long_attention(q, k, v, scale, window, None)
    with torch.no_grad():
        plain = TL._sdpa_chunked(q.float(), k.float(), v.float(), scale,
                                 window)
    assert (y.float() - plain).abs().max().item() <= 2e-2

    def fold(t):
        return t.transpose(1, 2).reshape(-1, S, dh).contiguous()
    ref, bound = bf16_bound_bhsd(fold(q), fold(k), fold(v), scale=scale,
                                 causal=True, window=window)
    assert bool(((fold(y).float() - ref).abs() <= bound).all())
