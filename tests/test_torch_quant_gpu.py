"""The CUDA quantized matmul against its plain PyTorch version.

Imports no JAX.  The ``gpu`` tests need a card and skip without one
(decided inside the fixture); on the GPU run them with ``python -m
pytest -q -m gpu tests/test_torch_*.py``.  The CPU tests hold the
wrapper's routing: a CPU tensor takes the plain version and never counts
a launch, and the CUDA wrapper refuses CPU tensors instead of falling
back.

Tolerances, relative to the plain output's max magnitude: f32 ≤ 1e-5
(the same f32 products summed in another order), bf16 ≤ 2e-2 (the plain
version rounds the dequantized weight and its matmul output to bf16, the
kernel keeps the Pallas body's f32 until the store).  Every bf16 output
is also held elementwise within ``ref.bf16_bound``: the exact value plus
f32 sums in any order, the scale per element or per group, and the
output's rounding, which a K tile left out or a misplaced group scale
would break.  The bf16 cases cover both tensor-core variants, the
split-K decode (M ≤ 16, at full width too) and the prefill mainloop
(M > 16), with per-channel scales and groups of 16, 32 and 128 rows,
ragged and unaligned shapes, the routing of a group size that is not a
multiple of 16 to ``qmm_tiled``, and CUDA-graph replays that must equal
the eager call bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.quant_matmul import quant_matmul as K
from repro_torch.kernels.quant_matmul.ops import quant_matmul
from repro_torch.kernels.quant_matmul.ref import (bf16_bound, quantize_int4,
                                                  quantize_int8)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
QUANT = {"int8": quantize_int8, "int4": quantize_int4}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the quant_matmul kernel runs only "
                    "on the GPU")
    return torch.device("cuda")


def _inputs(lead, K_, N, mode, gs, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(K_, N)).astype(np.float32) * 0.05
    w[:, -3:] = 0.0                               # zero-scale columns
    q, s = QUANT[mode](torch.from_numpy(w), group_size=gs)
    x = torch.as_tensor(rng.normal(size=(*lead, K_)), dtype=dtype,
                        device=device)
    return x, q.to(device), s.to(device)


def _rel(y, ref):
    return ((y.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


def _bound_ratio(x, q, s, y):
    """max |y − ref| / bound over the elements, ``ref.bf16_bound``'s (a
    zero-scale column has ref and bound 0, and must be 0)."""
    ref, bound = bf16_bound(x.reshape(-1, x.shape[-1]), q, s)
    return ((y.reshape(ref.shape).double() - ref).abs()
            / bound.clamp_min(1e-300)).max().item()


def _variant(x, q, s):
    K_ = x.shape[-1]
    return K.variant(x.numel() // K_, K_, s.shape[0], x.dtype)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("gs", [None, 16])
@pytest.mark.parametrize("lead,K_,N", [
    ((8,), 256, 384),         # decode rows: the skinny split-K path
    ((3,), 96, 37),           # ragged N, odd columns (scalar code loads)
    ((13,), 512, 130),        # two skinny row tiles, ragged M and N
    ((2, 37), 160, 200),      # the tiled path, ragged M, N and K tiles
    ((300,), 96, 80),         # tests/test_quant.py's padded grid shape
])
def test_kernel_matches_plain(cuda, dtype, mode, gs, lead, K_, N):
    x, q, s = _inputs(lead, K_, N, mode, gs, dtype, cuda)
    y = quant_matmul(x, q, s)
    ref = quant_matmul(x, q, s, impl="torch")
    torch.cuda.synchronize()
    assert y.shape == ref.shape == (*lead, N) and y.dtype == dtype
    assert _rel(y, ref) <= TOL[dtype]
    assert bool((y[..., -3:] == 0).all())         # zero scales give 0
    if dtype == torch.bfloat16:
        assert _bound_ratio(x, q, s, y) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("M,K_,N,mode,gs,want", [
    (17, 1024, 512, "int8", None, "qmm_mma"),     # the first M of prefill
    (64, 1024, 384, "int4", 128, "qmm_mma"),
    (512, 4096, 4096, "int8", None, "qmm_mma"),   # phase 2's prefill call
    (512, 4096, 4096, "int4", 128, "qmm_mma"),
    (37, 200, 130, "int8", None, "qmm_mma"),      # ragged M, N, K (not / 64)
    (37, 208, 130, "int4", 16, "qmm_mma"),        # ragged, groups of 16
    (130, 160, 264, "int8", 32, "qmm_mma"),       # two row tiles, groups of 32
    (37, 240, 96, "int4", 48, "qmm_mma"),         # groups of 48 (3 k steps)
    (37, 120, 96, "int8", 24, "qmm_tiled"),       # 24 is not a multiple of 16
    (8, 120, 96, "int4", 24, "qmm_skinny"),
    (1, 4096, 4096, "int8", None, "qmm_mma_decode"),
    (8, 4096, 4096, "int8", None, "qmm_mma_decode"),   # phase 2's decode
    (8, 4096, 4096, "int4", 128, "qmm_mma_decode"),
    (9, 4096, 4096, "int4", 32, "qmm_mma_decode"),  # two n-tiles of rows
    (16, 4096, 1024, "int8", 16, "qmm_mma_decode"),
    (3, 4160, 200, "int8", None, "qmm_mma_decode"),  # ragged N, K / 64 odd
    (5, 208, 130, "int4", 16, "qmm_mma_decode"),   # ragged, K not / 128
    (5, 64, 130, "int8", 16, "qmm_mma_decode"),    # one split: y directly
])
def test_bf16_tensor_core_variants(cuda, M, K_, N, mode, gs, want):
    x, q, s = _inputs((M,), K_, N, mode, gs, torch.bfloat16, cuda, seed=M)
    assert _variant(x, q, s) == want
    K.reset_launches()
    y = quant_matmul(x, q, s)
    assert K.LAUNCHES == {"quant_matmul": 1}
    ref = quant_matmul(x, q, s, impl="torch")
    torch.cuda.synchronize()
    assert y.shape == (M, N) and bool(torch.isfinite(y.float()).all())
    assert _rel(y, ref) <= TOL[torch.bfloat16]
    assert bool((y[:, -3:] == 0).all())
    assert _bound_ratio(x, q, s, y) <= 1.0


def _offset(t, elems=1):
    """t's values in a view ``elems`` elements past a 16-byte boundary."""
    buf = torch.empty(t.numel() + elems, dtype=t.dtype, device=t.device)
    buf[elems:] = t.reshape(-1)
    return buf[elems:].view(t.shape)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,gs", [("int8", None), ("int4", 32)])
@pytest.mark.parametrize("M", [8, 64])
def test_bf16_unaligned_views_take_the_guarded_loads(cuda, M, mode, gs):
    """x one element and the codes one byte past a 16-byte boundary, K a
    multiple of 8 and N of 16 (so only the address forbids cp.async);
    then the slices of a (3, 152, 37) stack, per channel, whose offsets
    are not 16-byte aligned, as the model hands them over."""
    x, q, s = _inputs((M,), 256, 128, mode, gs, torch.bfloat16, cuda, seed=3)
    xo, qo = _offset(x), _offset(q)
    assert xo.data_ptr() % 16 and qo.data_ptr() % 16
    y = K.quant_matmul_cuda(xo, qo, s)
    ref = quant_matmul(x, q, s, impl="torch")
    torch.cuda.synchronize()
    assert _rel(y, ref) <= TOL[torch.bfloat16]
    assert _bound_ratio(x, q, s, y) <= 1.0
    rng = np.random.default_rng(4)
    w = torch.as_tensor(rng.normal(size=(3, 152, 37)) * 0.05,
                        dtype=torch.float32)
    qs, ss = zip(*(QUANT[mode](w[i]) for i in range(3)))
    qs, ss = torch.stack(qs).to(cuda), torch.stack(ss).to(cuda)
    x = x[:, :152].contiguous()
    assert qs[1].data_ptr() % 16
    for i in range(3):
        y = quant_matmul(x, qs[i], ss[i])
        ref = quant_matmul(x, qs[i], ss[i], impl="torch")
        torch.cuda.synchronize()
        assert _rel(y, ref) <= TOL[torch.bfloat16]
        assert _bound_ratio(x, qs[i], ss[i], y) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("M,mode,gs", [(8, "int8", None), (8, "int4", 128),
                                       (64, "int4", 128)])
def test_bf16_graph_replay_equals_eager(cuda, M, mode, gs):
    """Captured in a CUDA graph (the decode variant's workspace is then
    allocated from the graph's pool) and replayed: bit for bit the eager
    output, which is deterministic."""
    x, q, s = _inputs((M,), 4096, 1024, mode, gs, torch.bfloat16, cuda,
                      seed=5)
    eager = quant_matmul(x, q, s)
    assert torch.equal(eager, quant_matmul(x, q, s))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        quant_matmul(x, q, s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = quant_matmul(x, q, s)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


@pytest.mark.gpu
def test_stacked_slice_views_and_counter(cuda):
    """A (n_sb, K, N) stack's slice views, as the model hands them over,
    at offsets that are not 16-byte aligned; one count per call."""
    rng = np.random.default_rng(1)
    w = torch.as_tensor(rng.normal(size=(3, 64, 36)), dtype=torch.float32)
    x = torch.as_tensor(rng.normal(size=(4, 64)), dtype=torch.float32,
                        device=cuda)
    K.reset_launches()
    for quant in (quantize_int8, quantize_int4):
        q, s = quant(w)
        q, s = q.to(cuda), s.to(cuda)
        for i in range(3):
            y = quant_matmul(x, q[i], s[i])
            ref = quant_matmul(x, q[i], s[i], impl="torch")
            assert _rel(y, ref) <= TOL[torch.float32]
    assert K.LAUNCHES == {"quant_matmul": 6}


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x, q, s = _inputs((4,), 64, 32, "int8", None, torch.float32, cuda)
    with pytest.raises(TypeError):
        K.quant_matmul_cuda(x, q.to(torch.int16), s)
    with pytest.raises(TypeError):
        K.quant_matmul_cuda(x, q, s.double())
    with pytest.raises(ValueError, match="shape"):
        K.quant_matmul_cuda(x[:, :32].contiguous(), q, s)
    with pytest.raises(ValueError, match="contiguous"):
        K.quant_matmul_cuda(x, q.t().contiguous().t(), s)
    with pytest.raises(ValueError, match="divide"):
        K.quant_matmul_cuda(x, q, torch.ones(5, 32, device=cuda))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    x, q, s = _inputs((2, 3), 32, 16, "int4", 16, torch.float32, "cpu")
    K.reset_launches()
    y = quant_matmul(x, q, s)
    assert torch.equal(y, quant_matmul(x, q, s, impl="torch"))
    assert K.LAUNCHES == {"quant_matmul": 0}


def test_cuda_wrapper_refuses_cpu_tensors():
    x, q, s = _inputs((2,), 32, 16, "int8", None, torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        quant_matmul(x, q, s, impl="cuda")
    with pytest.raises(ValueError, match="unknown quant_matmul impl"):
        quant_matmul(x, q, s, impl="pallas")
