"""The CUDA BGMV kernels against their plain PyTorch versions.

Imports no JAX, so it also runs where only the port is installed.  The
``gpu`` tests need a card and skip without one (decided inside the
fixture); on the GPU run them with ``python -m pytest -q -m gpu
tests/test_torch_*.py``.  The CPU tests hold the wrappers' routing: a
CPU tensor takes the plain version and never counts a launch, and the
CUDA wrappers refuse CPU tensors instead of falling back.

Tolerances: f32 ≤ 1e-5 of the output's max magnitude (sums taken in
another order), bf16 ≤ 2e-2 (the fused_dora bf16 band of
tests/test_kernels.py: the plain version rounds its bf16 matmul outputs
where the kernel keeps f32 until the stores).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.batched_lora import bgmv as K
from repro_torch.kernels.batched_lora.ops import bgmv, bgmv_mag

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the BGMV kernels run only on the GPU")
    return torch.device("cuda")


def _inputs(B, S, d, r, o, L, dtype, device, seed=0):
    rng = np.random.default_rng(seed)

    def t(a, dt=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    shape = (B, d) if S is None else (B, S, d)
    return dict(
        x=t(rng.normal(size=shape), dtype),
        a_pool=t(rng.normal(size=(L, d, r)) / np.sqrt(d)),
        b_pool=t(rng.normal(size=(L, r, o)) / np.sqrt(r)),
        a_dir=t(rng.normal(size=(d, r)) / np.sqrt(d)),
        a_mag=t(rng.uniform(0.5, 1.5, size=(d,))),
        b_mag=t(rng.normal(size=(r,))),
        dmag=t(rng.normal(size=(L, r))),
        b_dir=t(rng.normal(size=(r, o)) / np.sqrt(r)),
        idx=t(rng.integers(0, L, size=(B,)), torch.int32),
        # mixed ranks, including rank-0 slots (0 and the last, "null")
        ranks=t([0] + [int(v) for v in rng.integers(1, r + 1, size=L - 2)]
                + [0], torch.int32))


def _run(kind, v, impl, ranked):
    ranks = v["ranks"] if ranked else None
    if kind == "bgmv":
        return bgmv(v["x"], v["a_pool"], v["b_pool"], v["idx"], scale=2.0,
                    ranks=ranks, impl=impl)
    return bgmv_mag(v["x"], v["a_dir"], v["a_mag"], v["b_mag"], v["dmag"],
                    v["b_dir"], v["idx"], scale=4.0, ranks=ranks, impl=impl)


def _rel(y, ref):
    return ((y.float() - ref.float()).abs().max()
            / ref.float().abs().max().clamp_min(1e-30)).item()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bgmv", "bgmv_mag"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("ranked", [False, True], ids=["full", "ranked"])
@pytest.mark.parametrize("B,S,d,r,o,L", [
    (8, None, 256, 8, 192, 9),      # decode rows (B, d_in)
    (4, 13, 128, 16, 96, 5),        # odd S
    (3, 7, 64, 40, 64, 4),          # rank in the 64 bucket
])
def test_kernel_matches_plain(cuda, kind, dtype, ranked, B, S, d, r, o, L):
    v = _inputs(B, S, d, r, o, L, dtype, cuda)
    v["idx"][1] = v["idx"][0]                       # a repeated slot
    v["idx"][-1] = 0                                # a rank-0 slot
    y = _run(kind, v, None, ranked)
    ref = _run(kind, v, "torch", ranked)
    torch.cuda.synchronize()
    assert y.shape == ref.shape and y.dtype == dtype
    assert _rel(y, ref) <= TOL[dtype]
    if ranked:
        zero = (v["ranks"][v["idx"].long()] == 0).cpu()
        assert zero.any() and bool((y.cpu()[zero] == 0).all())


@pytest.mark.gpu
def test_launch_counter_counts_kernel_launches_only(cuda):
    v = _inputs(4, 3, 64, 8, 64, 5, torch.float32, cuda)
    K.reset_launches()
    _run("bgmv", v, None, True)
    _run("bgmv", v, "torch", True)
    _run("bgmv_mag", v, None, False)
    assert K.LAUNCHES == {"bgmv": 1, "bgmv_mag": 1}


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    v = _inputs(4, 3, 64, 8, 64, 5, torch.float32, cuda)
    with pytest.raises(TypeError):
        K.bgmv_cuda(v["x"], v["a_pool"].double(), v["b_pool"], v["idx"])
    with pytest.raises(TypeError):
        K.bgmv_cuda(v["x"], v["a_pool"], v["b_pool"], v["idx"].long())
    with pytest.raises(ValueError, match="contiguous"):
        K.bgmv_cuda(v["x"].transpose(0, 1), v["a_pool"], v["b_pool"],
                    v["idx"][:3])
    big = _inputs(2, 1, 32, 72, 32, 3, torch.float32, cuda)
    with pytest.raises(ValueError, match="rank"):
        K.bgmv_cuda(big["x"], big["a_pool"], big["b_pool"], big["idx"])


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    v = _inputs(4, 3, 32, 4, 16, 5, torch.float32, "cpu")
    K.reset_launches()
    for kind in ("bgmv", "bgmv_mag"):
        y = _run(kind, v, None, True)
        ref = _run(kind, v, "torch", True)
        assert torch.equal(y, ref)
    assert K.LAUNCHES == {"bgmv": 0, "bgmv_mag": 0}


@pytest.mark.parametrize("kind", ["bgmv", "bgmv_mag"])
def test_cuda_wrappers_refuse_cpu_tensors(kind):
    v = _inputs(2, 3, 32, 4, 16, 3, torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        _run(kind, v, "cuda", False)
    with pytest.raises(ValueError, match="unknown bgmv impl"):
        _run(kind, v, "pallas", False)
