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
kernel keeps the Pallas body's f32 until the store).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.quant_matmul import quant_matmul as K
from repro_torch.kernels.quant_matmul.ops import quant_matmul
from repro_torch.kernels.quant_matmul.ref import quantize_int4, quantize_int8

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
