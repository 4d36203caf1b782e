"""Mixture of experts on the card: the grouped layer against the dense
oracle at qwen3-moe-30b-a3b's width, and a 2-layer prefill of the full
width against the CPU.

Imports no JAX.  The ``gpu`` tests need a card and skip without one
(decided inside the fixture); on the GPU run them with ``python -m
pytest -q -m gpu tests/test_torch_moe_gpu.py``.

Tolerances:
- one MoE layer (128 experts, top 8, D 2048, F 768), T 512, at the
  drop-free capacity (E / k): f32 grouped against ``moe_ffn_dense_ref``
  within 1e-4 of max |y|, the aux within 1e-5; bf16 against the f32
  oracle on the same rounded weights, router and inputs within 2e-2 of
  max |y| over the tokens whose bf16 top-k set is the f32 one, at most
  15% of the tokens routed otherwise (``chip_smoke.py`` phase 14 (b));
  two runs bit-equal (the combine sums each token's picks in one fixed
  order);
- the 2-layer f32 prefill (1 x 256, published capacity 1.25) on the
  card against the CPU: logits and caches within 1e-4 of max |value|,
  the aux within 1e-5 (TF32 off).
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.utils import pytree as tpt

ARCH = "qwen3-moe-30b-a3b"
T = 512


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the MoE path is held on the GPU "
                    "against its oracle and the CPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    return float((got.float() - want.float()).abs().max()
                 / want.float().abs().max())


def _layer(cuda, seed=0):
    cfg = dataclasses.replace(get_config(ARCH), dtype="float32")
    free = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    g = torch.Generator(device=cuda).manual_seed(seed)
    D, E, F = cfg.d_model, cfg.n_experts, cfg.d_ff

    def n(*shape):
        return 0.02 * torch.randn(shape, generator=g, device=cuda)
    p = {"router": {"kernel": n(D, E)},
         "experts": {"gate": n(E, D, F), "up": n(E, D, F), "down": n(E, F, D)}}
    x = torch.randn((1, T, D), generator=g, device=cuda)
    return cfg, free, p, x


@pytest.mark.gpu
def test_grouped_layer_matches_the_dense_oracle_in_f32(cuda):
    _, free, p, x = _layer(cuda)
    with torch.no_grad():
        y, aux = TL.moe_ffn_local(p, x, free)
        yo, auxo = TL.moe_ffn_dense_ref(p, x, free)
        assert TL.moe_capacity(free, T) == T
        assert _rel(y, yo) <= 1e-4
        assert abs(float(aux) - float(auxo)) <= 1e-5
        y2, aux2 = TL.moe_ffn_local(p, x, free)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)


@pytest.mark.gpu
@pytest.mark.parametrize("capacity", ["drop_free", "published"])
def test_grouped_layer_in_bf16(cuda, capacity):
    """bf16 experts, inputs and router product against the f32 oracle on
    the same rounded values (drop-free), and two runs bit-equal at
    either capacity (the published 1.25 drops picks)."""
    cfg, free, p, x = _layer(cuda, seed=1)
    p16 = {"router": p["router"], "experts": tpt.tree_map(
        lambda t: t.to(torch.bfloat16), p["experts"])}
    x16 = x.to(torch.bfloat16)
    run = dataclasses.replace(free if capacity == "drop_free" else cfg,
                              dtype="bfloat16")
    with torch.no_grad():
        y16, aux16 = TL.moe_ffn_local(p16, x16, run)
        y16b, aux16b = TL.moe_ffn_local(p16, x16, run)
        assert torch.equal(y16, y16b) and torch.equal(aux16, aux16b)
        if capacity != "drop_free":
            assert TL.moe_capacity(run, T) < T
            return
        pr = {"router": {"kernel": p["router"]["kernel"].to(
            torch.bfloat16).float()}, "experts": tpt.tree_map(
            lambda t: t.float(), p16["experts"])}
        yr, _ = TL.moe_ffn_dense_ref(pr, x16.float(), free)
        xt = x16.reshape(T, -1)
        i16 = TL.moe_router(p16, xt, run)[0].sort(-1).values
        i32 = TL.moe_router(pr, xt.float(), free)[0].sort(-1).values
        same = (i16 == i32).all(-1)
    assert int((~same).sum()) <= 0.15 * T
    d = (y16.float() - yr).abs().reshape(T, -1)[same]
    assert float(d.max() / yr.abs().max()) <= 2e-2


@pytest.mark.gpu
def test_two_layer_prefill_matches_the_cpu(cuda):
    """qwen3-moe, 2 layers of full width in f32 at the published
    capacity: the card's prefill (logits, caches, aux) against the
    CPU's on the same weights and tokens."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2, dtype="float32",
                              lora_dropout=0.0)
    g = torch.Generator(device=cuda).manual_seed(0)
    params = TM.init_params(g, cfg, device=cuda)
    tokens = torch.randint(0, cfg.vocab_size, (1, 256), generator=g,
                           device=cuda)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        p = tpt.tree_map(lambda t: t.to(dev), params)
        with torch.no_grad():
            h, cache, aux = TM.forward(p, {"tokens": tokens.to(dev)}, cfg,
                                       return_cache=True, cache_len=264)
            logits = (h[:, -1] @ TM._head_kernel(p, cfg)).float()
        out[dev.type] = (logits.cpu(), tpt.tree_map(lambda t: t.cpu(), cache),
                         float(aux))
        del p
    (lg, cg, ag), (lc, cc, ac) = out["cuda"], out["cpu"]
    assert _rel(lg, lc) <= 1e-4
    for path, want in tpt.tree_leaves_with_path(cc):
        assert _rel(tpt.tree_get(cg, path), want) <= 1e-4, path
    assert abs(ag - ac) <= 1e-5
