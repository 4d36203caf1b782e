"""The CUDA SSD chunked scan against its plain PyTorch versions.

Imports no JAX.  The ``gpu`` tests need a card and skip without one
(decided inside the fixture); on the GPU run them with ``python -m
pytest -q -m gpu tests/test_torch_*.py``.  The CPU tests hold the
wrapper's routing: a CPU tensor takes the plain version and never counts
a launch, and the CUDA wrapper refuses CPU tensors instead of falling
back.

Inputs are drawn as the model initialises them (A_log = log(linspace(1,
16, H)), dt = softplus(z − 2)) with x, B, C ~ N(0, 1).  Tolerances: f32
against the plain ``ssd_ref`` and the ``ssd_naive`` recurrence at rtol
1e-3, atol 1e-4, the bounds of tests/test_kernels.py's ssd sweep (both
the kernel and ``ssd_ref`` sum the log-decay in f64 and round it once, so
they hold the same l); bf16 within 2e-2 of max |y| of the plain version
on the same bf16 inputs, elementwise within
``ssd_scan/ref.py::bf16_bound`` (the reference's cast points and the
kernel's, f32 sums in any order, the output's rounding), and inside
``ssd_scan/ref.py::cast_point_interval`` (the kernel's own cast points
with exact sums; only f32 sums and exps in another order may move an
output, so a kernel that rounds the carried state to bf16 once lies
outside it).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.ssd_scan import ssd_scan as K
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (bf16_bound, cast_point_interval,
                                             ssd_naive)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ssd_scan kernel runs only on the "
                    "GPU")
    return torch.device("cuda")


def _inputs(b, S, H, G, P, N, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)

    def n(*shape):
        return torch.randn(shape, generator=g)
    v = dict(x=n(b, S, H, P).to(dtype),
             dt=torch.nn.functional.softplus(n(b, S, H) - 2.0),
             A_log=torch.log(torch.linspace(1.0, 16.0, H)),
             B=n(b, S, G, N).to(dtype), C=n(b, S, G, N).to(dtype))
    return {k: t.to(device) for k, t in v.items()}


ORDER = ("x", "dt", "A_log", "B", "C")


def _run(v, chunk, impl=None):
    return ssd_scan(*(v[k] for k in ORDER), chunk=chunk, impl=impl)


def _close(got, want):
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("b,S,H,G,P,N,chunk", [
    (2, 64, 4, 2, 16, 8, 16),       # tests/test_kernels.py sweep
    (1, 128, 2, 1, 32, 16, 32),
    (2, 32, 4, 4, 8, 8, 8),
    (1, 64, 2, 2, 16, 16, 64),
    (1, 256, 8, 1, 64, 128, 16),    # mamba2-2.7b's P and N
    (2, 512, 8, 2, 64, 128, 64),
    (1, 512, 8, 1, 64, 128, 128),   # mamba2-2.7b's chunk
    (1, 512, 4, 2, 64, 128, 256),   # the dispatcher's default chunk
    (1, 256, 8, 1, 64, 16, 128),    # jamba's N
    (1, 300, 3, 1, 24, 20, 100),    # ragged tiles: chunk 100, P 24, N 20
    (1, 128, 4, 1, 8, 8, 64),       # P 8 and N 8: less than one mma tile
    (1, 256, 8, 2, 64, 128, 128),   # two groups of 4 heads
    (4, 256, 8, 1, 64, 128, 128),   # b 4
    (1, 256, 4, 1, 64, 256, 128),   # N 256, the largest the kernel takes
])
def test_kernel_matches_plain(cuda, dtype, b, S, H, G, P, N, chunk):
    v = _inputs(b, S, H, G, P, N, dtype, cuda, seed=S + N)
    y, st = _run(v, chunk)
    y_p, st_p = _run(v, chunk, impl="torch")
    torch.cuda.synchronize()
    assert y.shape == y_p.shape == (b, S, H, P) and y.dtype == dtype
    assert st.shape == (b, H, P, N) and st.dtype == torch.float32
    assert bool(torch.isfinite(y.float()).all() and torch.isfinite(st).all())
    if dtype == torch.float32:
        _close(y, y_p)
        _close(st, st_p)
    else:
        rel = lambda a, r: ((a.float() - r.float()).abs().max()      # noqa: E731
                            / r.float().abs().max()).item()
        assert rel(y, y_p) <= 2e-2
        assert rel(st, st_p) <= 2e-2
        ref, bound = bf16_bound(*(v[k] for k in ORDER), min(chunk, S))
        assert ((y.float() - ref).abs() / bound).max().item() <= 1.0
        lo, hi = cast_point_interval(*(v[k] for k in ORDER), min(chunk, S))
        assert bool(((y >= lo) & (y <= hi)).all())


@pytest.mark.gpu
@pytest.mark.parametrize("chunk", [16, 64, 128])
def test_kernel_matches_the_recurrence(cuda, chunk):
    v = _inputs(1, 256, 4, 2, 64, 32, torch.float32, cuda, seed=chunk)
    y, st = _run(v, chunk)
    y_n, st_n = ssd_naive(*(v[k] for k in ORDER))
    torch.cuda.synchronize()
    _close(y, y_n)
    _close(st, st_n)


@pytest.mark.gpu
def test_launch_counter_counts_kernel_launches_only(cuda):
    v = _inputs(1, 32, 2, 1, 8, 8, torch.float32, cuda)
    K.reset_launches()
    _run(v, 16)
    _run(v, 16, impl="torch")
    _run(v, 32)
    assert K.LAUNCHES == {"ssd_scan": 2}


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((4, 32, 16), device=cuda)
    dt = torch.zeros((4, 32), device=cuda)
    a = torch.zeros((4,), device=cuda)
    B = torch.zeros((2, 32, 8), device=cuda)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        K.ssd_scan_bh_cuda(x, dt, a, B, B, chunk=12)
    with pytest.raises(TypeError):
        K.ssd_scan_bh_cuda(x, dt.double(), a, B, B, chunk=16)
    with pytest.raises(TypeError):
        K.ssd_scan_bh_cuda(x, dt, a, B, B.bfloat16(), chunk=16)
    with pytest.raises(ValueError, match="groups"):
        K.ssd_scan_bh_cuda(x, dt, a, B[:1].expand(3, 32, 8).contiguous(),
                           B[:1].expand(3, 32, 8).contiguous(), chunk=16)
    with pytest.raises(ValueError, match="head dim"):
        wide = torch.zeros((4, 32, 128), device=cuda)
        K.ssd_scan_bh_cuda(wide, dt, a, B, B, chunk=16)
    for n in (2048, 264):   # the kernel takes N up to 256
        with pytest.raises(RuntimeError, match="launch failed"):
            Bw = torch.zeros((2, 32, n), device=cuda)
            K.ssd_scan_bh_cuda(x, dt, a, Bw, Bw, chunk=16)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_graph_replay_equals_the_eager_call_bit_for_bit(cuda, dtype):
    # no atomics, every sum in a fixed order: a replay is the same call
    v = _inputs(1, 512, 8, 2, 64, 128, dtype, cuda, seed=3)
    y, st = _run(v, 128)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _run(v, 128)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        y_g, st_g = _run(v, 128)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(y, y_g) and torch.equal(st, st_g)


@pytest.mark.gpu
def test_variant_and_blocks(cuda):
    assert K.variant(torch.bfloat16) == "mma"
    assert K.variant(torch.float32) == "simt"
    # mamba2-2.7b, 1 x 4096, chunk 128: 32 chunks of 3 C.B^T tiles for the
    # one group; a block a head and chunk; 4 blocks of 256 chunks of 8
    # state entries a head (f32: of 8 entries of a state row, the same); one
    # block of 128 rows a head and chunk (f32: two of 64)
    assert K.blocks(80, 1, 4096, 64, 128, 128, torch.bfloat16) == {
        "ssd_cb": 96, "ssd_states": 2560, "ssd_pass": 320, "ssd_y": 2560}
    assert K.blocks(80, 1, 4096, 64, 128, 128, torch.float32) == {
        "ssd_cb": 96, "ssd_states": 2560, "ssd_pass": 320, "ssd_y": 5120}


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    v = _inputs(1, 32, 2, 1, 8, 8, torch.float32, "cpu")
    K.reset_launches()
    y, st = _run(v, 16)
    y_p, st_p = _run(v, 16, impl="torch")
    assert torch.equal(y, y_p) and torch.equal(st, st_p)
    assert K.LAUNCHES == {"ssd_scan": 0}


def test_cuda_wrapper_refuses_cpu_tensors():
    v = _inputs(1, 32, 2, 1, 8, 8, torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        _run(v, 16, impl="cuda")
    with pytest.raises(ValueError, match="unknown ssd_scan impl"):
        _run(v, 16, impl="pallas")
