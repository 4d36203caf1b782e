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
cast points, the plain version computes everything in f32).  Every bf16
output is also held elementwise within ``ref.bf16_bound``, the bound of
those cast points with f32 sums in any order, which a K tile left out
would break.  The bf16 cases cover both tensor-core variants: the split-K
decode (M ≤ 16, at full width too) and the prefill mainloop (M > 16),
ragged and unaligned shapes, and a CUDA-graph replay that must equal the
eager call bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_dora import fused_dora as K
from repro_torch.kernels.fused_dora.ops import fused_dora
from repro_torch.kernels.fused_dora.ref import bf16_bound

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


def _bound_ratio(v, y, scale=2.0):
    """max |y − ref| / bound over the elements, ``ref.bf16_bound``'s."""
    ref, bound = bf16_bound(*(v[k].reshape(-1, v[k].shape[-1]) if k == "x"
                              else v[k] for k in ORDER), scale)
    return ((y.float().reshape(ref.shape) - ref).abs() / bound).max().item()


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
    if dtype == torch.bfloat16:
        assert _bound_ratio(v, y) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("M,K_,N,r", [
    (8, 4096, 4096, 8),             # the decode split at full width
    (8, 4096, 4096, 16),
    (1, 4096, 4096, 8),
    (9, 4096, 4096, 8),             # two n-tiles of decode rows
    (16, 4096, 4096, 8),            # the last M of the decode variant
    (17, 4096, 4096, 8),            # the first M of the prefill variant
    (512, 4096, 4096, 8),           # the prefill at full width
    (3, 4160, 200, 64),             # decode, a rank-64 bucket, ragged N
    (130, 136, 264, 24),            # prefill, two row tiles, r 24 of 32
])
def test_bf16_tensor_core_variants(cuda, M, K_, N, r):
    v = _inputs((M,), K_, N, r, torch.bfloat16, cuda, seed=M)
    K.reset_launches()
    y = _run(v, None)
    assert K.LAUNCHES == {"fused_dora": 1}
    ref = _run(v, "torch")
    torch.cuda.synchronize()
    assert y.shape == (M, N) and bool(torch.isfinite(y.float()).all())
    assert _rel(y, ref) <= TOL[torch.bfloat16]
    assert _bound_ratio(v, y) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 64])
def test_bf16_unaligned_pointers_take_the_guarded_loads(cuda, M):
    """x, W0 and B_dir one element past a 16-byte boundary, K and N
    multiples of 8: the kernels must not issue cp.async from them."""
    v = _inputs((M,), 256, 192, 8, torch.bfloat16, cuda, seed=3)
    for k in ("x", "w0"):
        buf = torch.empty(v[k].numel() + 1, dtype=v[k].dtype, device=cuda)
        buf[1:] = v[k].reshape(-1)
        v[k] = buf[1:].view(v[k].shape)
    x, w0 = v["x"], v["w0"]
    a_eff = (v["a_dir"] + v["da_dir"]).bfloat16()
    b_eff = v["b_mag"] + v["db_mag"]
    bbuf = torch.empty(v["b_dir"].numel() + 1, dtype=torch.bfloat16,
                       device=cuda)
    bbuf[1:] = v["b_dir"].reshape(-1).bfloat16()
    b_dir = bbuf[1:].view(v["b_dir"].shape)
    y = K.fused_dora_cuda(x, w0, a_eff, v["a_mag"], b_dir, b_eff, scale=2.0)
    ref = _run(v, "torch")
    torch.cuda.synchronize()
    assert _rel(y, ref) <= TOL[torch.bfloat16]
    assert _bound_ratio(v, y) <= 1.0


@pytest.mark.gpu
@pytest.mark.parametrize("M", [8, 64])
def test_bf16_graph_replay_equals_eager(cuda, M):
    """Captured in a CUDA graph (the decode variant's workspace is then
    allocated from the graph's pool) and replayed: bit for bit the eager
    output, which is deterministic."""
    v = _inputs((M,), 1024, 512, 8, torch.bfloat16, cuda, seed=5)
    eager = _run(v, None)
    assert torch.equal(eager, _run(v, None))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _run(v, None)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = _run(v, None)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


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
