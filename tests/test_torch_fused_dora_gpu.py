"""The CUDA fused DoRA linear against its plain PyTorch version.

Imports no JAX.  The ``gpu`` tests need a card and skip without one
(decided inside the fixture); on the GPU run them with ``python -m
pytest -q -m gpu tests/test_torch_*.py``.  The CPU tests hold the
wrapper's routing: a CPU tensor takes the plain version and never counts
a launch, and the CUDA wrapper refuses CPU tensors instead of falling
back.

Tolerances, relative to the plain output's max magnitude: f32 ≤ 1e-4
and bf16 ≤ 2e-2, the bounds of tests/test_kernels.py's fused_dora sweep
(the kernel rounds x ⊙ A_mag, A_eff and h to bf16 at the Pallas body's
cast points, the plain version computes everything in f32).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_dora import fused_dora as K
from repro_torch.kernels.fused_dora.ops import fused_dora

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
ORDER = ("x", "w0", "a_dir", "a_mag", "b_dir", "b_mag", "da_dir", "db_mag")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fused_dora kernel runs only on "
                    "the GPU")
    return torch.device("cuda")


def _inputs(lead, K_, N, r, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return dict(
        x=t(rng.normal(size=(*lead, K_)), dtype),
        w0=t(rng.normal(size=(K_, N)) * 0.05, dtype),
        a_dir=t(rng.normal(size=(K_, r)) * 0.3),
        a_mag=t(rng.uniform(0.5, 1.5, size=(K_,))),
        b_dir=t(rng.normal(size=(r, N)) * 0.3),
        b_mag=t(rng.uniform(0.1, 0.5, size=(r,))),
        da_dir=t(rng.normal(size=(K_, r)) * 0.05),
        db_mag=t(rng.normal(size=(r,)) * 0.05))


def _run(v, impl, scale=2.0):
    return fused_dora(*(v[k] for k in ORDER), scale=scale, impl=impl)


def _rel(y, ref):
    return ((y.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("lead,K_,N,r", [
    ((8,), 512, 256, 8),            # decode rows: the skinny path
    ((2, 5), 300, 100, 16),         # two skinny row tiles, ragged K and N
    ((128,), 256, 128, 8),          # tests/test_kernels.py sweep shapes
    ((256,), 512, 256, 16),
    ((64,), 128, 384, 4),
    ((128,), 128, 128, 32),
    ((37,), 200, 160 + 64, 40),     # the tiled path, ragged; rank bucket 64
])
def test_kernel_matches_plain(cuda, dtype, lead, K_, N, r):
    v = _inputs(lead, K_, N, r, dtype, cuda)
    y = _run(v, None)
    ref = _run(v, "torch")
    torch.cuda.synchronize()
    assert y.shape == ref.shape == (*lead, N) and y.dtype == dtype
    assert _rel(y, ref) <= TOL[dtype]


@pytest.mark.gpu
def test_missing_deltas_and_counter(cuda):
    v = _inputs((4,), 64, 48, 4, torch.float32, cuda)
    K.reset_launches()
    y = fused_dora(*(v[k] for k in ORDER[:6]), scale=2.0)
    ref = fused_dora(*(v[k] for k in ORDER[:6]), scale=2.0, impl="torch")
    assert _rel(y, ref) <= TOL[torch.float32]
    assert K.LAUNCHES == {"fused_dora": 1}


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    v = _inputs((4,), 64, 48, 4, torch.float32, cuda)
    a_eff, b_mag = v["a_dir"] + v["da_dir"], v["b_mag"] + v["db_mag"]
    with pytest.raises(TypeError):
        K.fused_dora_cuda(v["x"], v["w0"].bfloat16(), a_eff, v["a_mag"],
                          v["b_dir"], b_mag)
    with pytest.raises(ValueError, match="contiguous"):
        K.fused_dora_cuda(v["x"], v["w0"].t().contiguous().t(), a_eff,
                          v["a_mag"], v["b_dir"], b_mag)
    big = _inputs((2,), 32, 16, 72, torch.float32, cuda)
    with pytest.raises(ValueError, match="rank"):
        _run(big, None)


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    v = _inputs((2, 3), 32, 16, 4, torch.float32, "cpu")
    K.reset_launches()
    assert torch.equal(_run(v, None), _run(v, "torch"))
    assert K.LAUNCHES == {"fused_dora": 0}


def test_cuda_wrapper_refuses_cpu_tensors():
    v = _inputs((2,), 32, 16, 4, torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        _run(v, "cuda")
    with pytest.raises(ValueError, match="unknown fused_dora impl"):
        _run(v, "pallas")
