"""The CUDA flash attention against its plain PyTorch version.

Imports no JAX.  The ``gpu`` tests need a card and skip without one
(decided inside the fixture); on the GPU run them with ``python -m
pytest -q -m gpu tests/test_torch_*.py``.  The CPU tests hold the
wrapper's routing: a CPU tensor takes the plain version and never counts
a launch, and the CUDA wrapper refuses CPU tensors instead of falling
back.

Tolerances, absolute, those of tests/test_kernels.py's flash sweep: f32
2e-5; bf16 2e-2 against the plain version run in f32 on the same bf16
values (the kernel rounds the softmax weights to bf16 before the PV
product, as the Pallas body does, and its output to bf16; held against
the plain output rounded to bf16 as well, an output of |y| ≥ 4, whose
bf16 ulp is 2^-5, could differ by one ulp from rounding alone).  In bf16
each element is also held within ``bf16_bound_bhsd``'s bound of those
two roundings.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import flash_attention as K
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (attention_ref,
                                                     bf16_bound_bhsd,
                                                     flash_attention_bhsd_ref)

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the flash_attention kernel runs only "
                    "on the GPU")
    return torch.device("cuda")


def _qkv(B, Sq, Sk, H, Kh, dh, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=(B, S, h, dh)), dtype=dtype,
                            device=device)
            for S, h in ((Sq, H), (Sk, Kh), (Sk, Kh))]


def _err(y, plain):
    return (y.float() - plain.float()).abs().max().item()


def _within_rounding_bound(y, q, k, v, **kw):
    """y, q, k, v in the (B·H, S, dh) layout: each element of a bf16 y
    within the bound of its roundings (f32 y: trivially true)."""
    ref, bound = bf16_bound_bhsd(q.float(), k.float(), v.float(), **kw)
    return bool(((y.float() - ref).abs() <= bound).all())


def _fold(t):
    return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,Sq,Sk,H,Kh,dh,causal,window", [
    (2, 256, 256, 4, 2, 64, True, None),       # tests/test_kernels.py sweep
    (1, 128, 128, 4, 4, 32, True, 48),
    (2, 256, 256, 8, 1, 64, False, None),
    (1, 512, 512, 2, 2, 128, True, 128),
    (1, 128, 256, 2, 2, 64, True, None),
    (1, 200, 200, 8, 1, 128, True, None),      # rep 8, ragged tiles
    (2, 130, 130, 4, 1, 256, True, 100),       # dh 256, rep 4, window
    (1, 96, 160, 8, 2, 256, False, None),      # dh 256, Sq < Sk, non-causal
    (4, 1, 128, 32, 32, 128, True, None),      # decode: one row, whole cache
    (2, 1, 77, 8, 1, 64, True, 16),            # decode, ragged cache, window
    (1, 40, 20, 4, 2, 64, True, None),         # Sq > Sk: 20 rows see no key
    (1, 300, 300, 2, 1, 100, True, 64),        # dh 100 (zero-padded bucket)
])
def test_kernel_matches_plain(cuda, dtype, B, Sq, Sk, H, Kh, dh, causal,
                              window):
    q, k, v = _qkv(B, Sq, Sk, H, Kh, dh, dtype, cuda, seed=Sq + dh)
    y = flash_attention(q, k, v, causal=causal, window=window)
    plain = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                          window=window)
    torch.cuda.synchronize()
    assert y.shape == q.shape and y.dtype == dtype
    assert bool(torch.isfinite(y.float()).all())
    assert _err(y, plain) <= TOL[dtype]
    assert _within_rounding_bound(_fold(y), _fold(q), _fold(k), _fold(v),
                                  scale=dh ** -0.5, causal=causal,
                                  window=window, q_offset=Sk - Sq)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("BH,BK,Sq,Sk,dh,causal,window,sk_valid,q_offset", [
    (8, 2, 64, 200, 64, True, None, 120, 136),
    (4, 4, 130, 130, 32, False, None, 77, 0),
    (4, 1, 200, 200, 128, True, 30, 90, 0),     # rows ≥ 119 see no key
    (8, 1, 1, 128, 256, True, None, 100, 127),  # decode past sk_valid
])
def test_bhsd_kernel_matches_plain_with_sk_valid(cuda, dtype, BH, BK, Sq, Sk,
                                                 dh, causal, window, sk_valid,
                                                 q_offset):
    g = torch.Generator(device=cuda).manual_seed(BH + Sq)
    q = torch.randn((BH, Sq, dh), generator=g, device=cuda).to(dtype)
    k, v = (torch.randn((BK, Sk, dh), generator=g, device=cuda).to(dtype)
            for _ in "kv")
    kw = dict(scale=1 / math.sqrt(dh), causal=causal, window=window,
              sk_valid=sk_valid, q_offset=q_offset)
    y = K.flash_attention_bhsd_cuda(q, k, v, **kw)
    plain = flash_attention_bhsd_ref(q.float(), k.float(), v.float(), **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(y.float()).all())
    assert _err(y, plain) <= TOL[dtype]
    assert _within_rounding_bound(y, q, k, v, **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("B,Sq,Sk,H,Kh,dh,causal,window", [
    (1, 200, 330, 4, 2, 128, True, None),   # diagonal at key 130, not 64k
    (1, 1000, 1000, 2, 1, 256, True, 100),  # dh 256, window, Sk 1000
    (1, 1, 4095, 8, 1, 128, True, None),    # rep 8, one row, 4095 keys
    (2, 16, 300, 8, 2, 128, True, None),    # Sq 16: mma_decode
    (2, 17, 300, 8, 2, 128, True, None),    # Sq 17: mma
    (1, 77, 333, 4, 1, 100, True, None),    # dh 100 (plain loads), odd Sk
    (3, 5, 129, 6, 3, 64, True, 40),        # decode rows of 2 heads, window
    (1, 1, 4096, 4, 1, 256, True, 520),     # keys over 8 blocks, 3 with none
    (1, 16, 2048, 8, 1, 64, True, None),    # 8 row groups, keys split too
], ids=["diagonal-off-64", "dh256-window", "rep8-decode-4095",
        "decode-sq16", "prefill-sq17", "dh100-odd-sk", "decode-window",
        "decode-split-empty-blocks", "decode-groups-split"])
def test_bf16_tensor_core_paths_within_the_rounding_bound(cuda, B, Sq, Sk, H,
                                                         Kh, dh, causal,
                                                         window):
    q, k, v = _qkv(B, Sq, Sk, H, Kh, dh, torch.bfloat16, cuda, seed=Sk + dh)
    y = flash_attention(q, k, v, causal=causal, window=window)
    plain = attention_ref(q.float(), k.float(), v.float(), causal=causal,
                          window=window)
    torch.cuda.synchronize()
    assert y.shape == q.shape and y.dtype == torch.bfloat16
    assert bool(torch.isfinite(y.float()).all())
    assert _err(y, plain) <= TOL[torch.bfloat16]
    assert _within_rounding_bound(_fold(y), _fold(q), _fold(k), _fold(v),
                                  scale=dh ** -0.5, causal=causal,
                                  window=window, q_offset=Sk - Sq)


@pytest.mark.gpu
@pytest.mark.parametrize("BH,BK,Sq,q_offset", [
    (4, 2, 150, 0),      # mma: rows ≥ 119 see no key
    (8, 2, 1, 150),      # mma_decode: the one row sees no key
], ids=["mma", "mma_decode"])
def test_bf16_rows_without_a_valid_key_under_sk_valid_average_v(cuda, BH, BK,
                                                                Sq, q_offset):
    g = torch.Generator(device=cuda).manual_seed(Sq)
    Sk, dh = 200, 128
    q = torch.randn((BH, Sq, dh), generator=g, device=cuda).bfloat16()
    k, v = (torch.randn((BK, Sk, dh), generator=g, device=cuda).bfloat16()
            for _ in "kv")
    kw = dict(scale=dh ** -0.5, causal=True, window=20, sk_valid=100,
              q_offset=q_offset)
    y = K.flash_attention_bhsd_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    empty = torch.arange(Sq, device=cuda) + q_offset >= 100 + 20 - 1
    assert bool(empty.any())
    mean_v = v.float().mean(dim=1).repeat_interleave(BH // BK, dim=0)
    got = y.float()[:, empty]
    assert _err(got, mean_v[:, None].expand_as(got)) <= TOL[torch.bfloat16]
    assert _within_rounding_bound(y, q, k, v, **kw)


@pytest.mark.gpu
def test_bf16_and_f32_calls_each_count_one_launch_and_agree(cuda):
    q, k, v = _qkv(1, 96, 160, 8, 2, 128, torch.bfloat16, cuda, seed=4)
    K.reset_launches()
    y16 = flash_attention(q, k, v, causal=True)
    assert K.LAUNCHES == {"flash_attention": 1}
    y32 = flash_attention(q.float(), k.float(), v.float(), causal=True)
    assert K.LAUNCHES == {"flash_attention": 2}
    torch.cuda.synchronize()
    kw = dict(scale=128 ** -0.5, causal=True, q_offset=160 - 96)
    ref, bound = bf16_bound_bhsd(*(_fold(t).float() for t in (q, k, v)),
                                 f32_err=2 * TOL[torch.float32], **kw)
    assert _err(y32, ref.reshape(1, 8, 96, 128).transpose(1, 2)) \
        <= TOL[torch.float32]
    d = (_fold(y16).float() - _fold(y32)).abs()
    assert bool((d <= bound).all())


@pytest.mark.gpu
def test_rows_without_a_valid_key_average_v_over_all_keys(cuda):
    q, k, v = _qkv(1, 12, 5, 2, 1, 64, torch.float32, cuda, seed=1)
    y = flash_attention(q, k, v, causal=True)       # rows 0-6 see no key
    torch.cuda.synchronize()
    mean_v = v.mean(dim=1, keepdim=True).expand(1, 7, 2, 64)
    assert _err(y[:, :7], mean_v) <= TOL[torch.float32]


@pytest.mark.gpu
def test_launch_counter_counts_kernel_launches_only(cuda):
    q, k, v = _qkv(1, 16, 16, 2, 1, 64, torch.float32, cuda)
    K.reset_launches()
    flash_attention(q, k, v)
    flash_attention(q, k, v, impl="torch")
    flash_attention(q, k, v, causal=False)
    assert K.LAUNCHES == {"flash_attention": 2}


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q = torch.zeros((4, 8, 64), device=cuda)
    kv = torch.zeros((2, 8, 64), device=cuda)
    with pytest.raises(TypeError):
        K.flash_attention_bhsd_cuda(q, kv.bfloat16(), kv, scale=1.0)
    with pytest.raises(ValueError, match="split"):
        K.flash_attention_bhsd_cuda(q, kv[:1].expand(3, 8, 64).contiguous(),
                                    kv[:1].expand(3, 8, 64).contiguous(),
                                    scale=1.0)
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((2, 8, 512), device=cuda)
        K.flash_attention_bhsd_cuda(big, big, big, scale=1.0)
    with pytest.raises(ValueError, match="contiguous"):
        K.flash_attention_bhsd_cuda(q, kv.transpose(0, 1).contiguous()
                                    .transpose(0, 1), kv, scale=1.0)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    q, k, v = _qkv(1, 16, 16, 2, 1, 32, torch.float32, "cpu")
    K.reset_launches()
    assert torch.equal(flash_attention(q, k, v),
                       flash_attention(q, k, v, impl="torch"))
    assert K.LAUNCHES == {"flash_attention": 0}


def test_cuda_wrapper_refuses_cpu_tensors():
    q, k, v = _qkv(1, 16, 16, 2, 1, 32, torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="unknown flash_attention impl"):
        flash_attention(q, k, v, impl="pallas")
