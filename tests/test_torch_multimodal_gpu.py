"""``flash_attention`` on the encoder-decoder's and the vision-language
model's prefill paths, on the card: its non-causal form (the encoder,
and cross-attention of Sq queries over Sk encoder keys) against the
plain chunked path, and the SMOKE configs of qwen2-vl-2b and
seamless-m4t-large-v2 through ``forward`` with the kernel against
``kernel_impl="torch"``.

Imports no JAX.  The ``gpu`` tests need a card and skip without one
(decided inside the fixture); on the GPU run them with ``python -m
pytest -q -m gpu tests/test_torch_multimodal_gpu.py``.

Tolerances:
- one non-causal layer at seamless's heads (16 / 16, dh 64), bf16 q, k,
  v: the kernel within 2e-2 absolute of the plain chunked path in f32
  and elementwise within ``bf16_bound_bhsd``; f32 within 2e-5 absolute
  (``chip_smoke.py``'s FLASH_TOL, TF32 off); the ops entry point's
  ``q_offset = Sk − Sq`` changes nothing without a causal mask or a
  window (bit for bit the kernel at q_offset 0);
- whole SMOKE models, last-row logits within 1e-4 of max |logit| in f32
  and 2e-2 in bf16, a decode step (with the encoder's output) within
  1e-4 of the full forward's last row in f32.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import flash_attention as FK
from repro_torch.kernels.flash_attention.ref import bf16_bound_bhsd
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

VL, ENC = "qwen2-vl-2b", "seamless-m4t-large-v2"
TOL = {"bfloat16": 2e-2, "float32": 1e-4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash_attention kernel runs only "
                    "on the GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _fold(t):
    return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3]).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("Sq,Sk", [(2048, 2048), (2048, 4096), (4096, 2048)])
def test_non_causal_flash_matches_the_plain_chunked_path(cuda, Sq, Sk, dtype):
    """The encoder (Sq = Sk) and cross-attention (Sq ≠ Sk either way):
    ``_long_attention(causal=False)`` launches the kernel once."""
    g = torch.Generator(device=cuda).manual_seed(Sq + Sk)
    q = torch.randn((1, Sq, 16, 64), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((1, Sk, 16, 64), generator=g, device=cuda).to(dtype)
            for _ in range(2))
    scale = 0.125
    before = FK.LAUNCHES["flash_attention"]
    with torch.no_grad():
        y = TL._long_attention(q, k, v, scale, None, None, False)
        plain = TL._sdpa_chunked(q.float(), k.float(), v.float(), scale,
                                 None, False)
    assert FK.LAUNCHES["flash_attention"] == before + 1
    err = (y.float() - plain).abs().max().item()
    assert err <= (2e-2 if dtype == torch.bfloat16 else 2e-5), err
    at0 = FK.flash_attention_bhsd_cuda(_fold(q), _fold(k), _fold(v),
                                       scale=scale, causal=False, q_offset=0)
    assert torch.equal(_fold(y), at0)
    if dtype == torch.bfloat16:
        ref, bound = bf16_bound_bhsd(_fold(q), _fold(k), _fold(v),
                                     scale=scale, causal=False)
        assert bool(((_fold(y).float() - ref).abs() <= bound).all())


def _model(arch, dtype, cuda):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype=dtype,
                              lora_dropout=0.0)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = TM.init_params(g, cfg, device=cuda)
    F = 2048 if cfg.n_enc_layers else cfg.frontend_tokens
    S = 2048 if cfg.n_enc_layers else 2048 - F   # the chunked length
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, S), generator=g,
                                     device=cuda),
             "frontend_emb": torch.randn((1, F, cfg.d_model), generator=g,
                                         device=cuda)}
    return cfg, params, batch


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("arch", [VL, ENC])
def test_kernel_path_matches_the_plain_path(cuda, arch, dtype):
    """qwen2-vl: 8 patches + 2040 tokens, flash once a layer (causal);
    seamless: 2048 frames and 2048 tokens, flash in each encoder layer
    and each decoder layer's self- and cross-attention (non-causal but
    the self-attention).  In f32, a decode step after a prefill of all
    tokens but the last equals the full forward's last row."""
    cfg, params, batch = _model(arch, dtype, cuda)
    per = (cfg.n_enc_layers + 2 * cfg.n_layers if cfg.n_enc_layers
           else cfg.n_layers)

    def last(impl):
        with torch.no_grad():
            h = TM.forward(params, batch, cfg, kernel_impl=impl)[0]
            return (h[:, -1] @ TM._head_kernel(params, cfg).to(h.dtype)
                    ).float()
    before = FK.LAUNCHES["flash_attention"]
    plain = last("torch")
    assert FK.LAUNCHES["flash_attention"] == before
    flash = last(None)
    assert FK.LAUNCHES["flash_attention"] == before + per
    assert bool(torch.isfinite(flash).all())
    err = ((flash - plain).abs().max() / plain.abs().max()).item()
    assert err <= TOL[dtype], (arch, dtype, err)
    if dtype == "bfloat16":
        return
    S = batch["tokens"].shape[1]
    Stot = S + (0 if cfg.n_enc_layers else batch["frontend_emb"].shape[1])
    short = dict(batch, tokens=batch["tokens"][:, :-1])
    with torch.no_grad():
        enc = (TM._encode(params, batch["frontend_emb"], cfg)
               if cfg.n_enc_layers else None)
        _, cache = TM.prefill(params, short, cfg, cache_len=Stot,
                              enc_out=enc)
        dlog, _ = TM.decode_step(params, batch["tokens"][:, -1], cache,
                                 Stot - 1, cfg, enc_out=enc)
    err = ((dlog - flash).abs().max() / flash.abs().max()).item()
    assert err <= 1e-4, (arch, err)
