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
where the kernel keeps f32 until the stores).  Every bf16 output of the
variant tests is also held elementwise within ``ref.bf16_bound``, the
bound of the Pallas cast points with f32 sums in any order, which a
dropped d_in slice would break.  Those tests reach both variants (decode
for B * S <= 16 rows, prefill above) and their edges: B * S at the
threshold and one above it, a ragged S, d_in and d_out that are no
multiple of the cluster's split, every rank bucket, repeated slots,
out-of-range slots (NaN rows) and rank-0 rows (exactly 0); and a
CUDA-graph replay must equal the eager call bit for bit.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.batched_lora import bgmv as K
from repro_torch.kernels.batched_lora.ops import bgmv, bgmv_mag
from repro_torch.kernels.batched_lora.ref import bf16_bound

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


def _bound_ratio(kind, v, y, ranked, scale=None):
    """max |y − ref| / bound over the elements, ``ref.bf16_bound``'s."""
    x = v["x"] if v["x"].dim() == 3 else v["x"][:, None]
    ranks = v["ranks"] if ranked else None
    if kind == "bgmv":
        ref, bound = bf16_bound(x, v["a_pool"], v["b_pool"], v["idx"],
                                scale or 2.0, ranks)
    else:
        ref, bound = bf16_bound(x, v["a_dir"], v["b_dir"], v["idx"],
                                scale or 4.0, ranks,
                                mag=(v["a_mag"], v["b_mag"], v["dmag"]))
    return ((y.double().reshape(ref.shape) - ref.double()).abs()
            / bound.double().clamp_min(1e-300)).max().item()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bgmv", "bgmv_mag"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("B,S,d,r,o,L,want", [
    (16, None, 4096, 8, 4096, 9, "decode"),     # B * S at the threshold
    (17, None, 4096, 8, 4096, 9, "prefill"),    # one row above it
    (2, 8, 4096, 8, 4096, 9, "decode"),         # 16 rows in two batch rows
    (1, 17, 4096, 8, 4096, 9, "prefill"),       # 17 rows in one
    (8, 1, 4096, 16, 4096, 9, "decode"),
    (8, 64, 4096, 8, 4096, 9, "prefill"),       # phase 2's prefill
    (8, 37, 4100, 5, 4092, 9, "prefill"),       # ragged S, d_in, d_out; r 5 of 8
    (5, 3, 4100, 12, 4092, 7, "decode"),        # r 12 of the 16 bucket
    (3, 40, 1000, 24, 1003, 5, "prefill"),      # r 24 of 32; d_in, d_out off the split
    (4, 2, 520, 64, 70, 5, "decode"),           # the 64 bucket
    (3, 33, 20, 32, 9, 4, "prefill"),           # d_in, d_out under the split
])
def test_variants_and_their_edges(cuda, kind, dtype, B, S, d, r, o, L, want):
    v = _inputs(B, S, d, r, o, L, dtype, cuda, seed=B * 100 + (S or 0))
    if B > 1:
        v["idx"][1] = v["idx"][0]                   # a repeated slot
        v["idx"][-1] = 0                            # a rank-0 slot
    assert K.variant(B, S or 1) == want
    for ranked in (False, True):
        K.reset_launches()
        y = _run(kind, v, None, ranked)
        assert K.LAUNCHES[kind] == 1
        ref = _run(kind, v, "torch", ranked)
        torch.cuda.synchronize()
        assert y.shape == ref.shape and y.dtype == dtype
        assert bool(torch.isfinite(y.float()).all())
        assert _rel(y, ref) <= TOL[dtype]
        if dtype == torch.bfloat16:
            assert _bound_ratio(kind, v, y, ranked) <= 1.0
        if ranked:
            zero = (v["ranks"][v["idx"].long()] == 0).cpu()
            assert zero.any() or B == 1
            assert bool((y.cpu()[zero] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bgmv", "bgmv_mag"])
@pytest.mark.parametrize("B,S", [(8, None), (8, 64), (4, 37)],
                         ids=["decode", "prefill", "ragged"])
def test_out_of_range_slots_give_nan_rows(cuda, kind, B, S):
    """Slots L and −1 read nothing and give NaN rows; the other rows are
    what they would be without them."""
    v = _inputs(B, S, 256, 8, 192, 5, torch.bfloat16, cuda, seed=3)
    bad = torch.zeros(B, dtype=torch.bool)
    bad[1], bad[2] = True, True
    y_ok = _run(kind, v, None, True)
    v["idx"][1], v["idx"][2] = 5, -1
    y = _run(kind, v, None, True)
    torch.cuda.synchronize()
    assert bool(torch.isnan(y[bad.to(cuda)].float()).all())
    assert torch.equal(y[~bad.to(cuda)], y_ok[~bad.to(cuda)])


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["bgmv", "bgmv_mag"])
@pytest.mark.parametrize("S", [None, 64], ids=["decode", "prefill"])
def test_graph_replay_equals_eager(cuda, kind, S):
    """Captured in a CUDA graph and replayed, at llama2-7b width: bit for
    bit the eager output, which is deterministic (no atomics)."""
    v = _inputs(8, S, 4096, 8, 4096, 9, torch.bfloat16, cuda, seed=5)
    eager = _run(kind, v, None, True)
    assert torch.equal(eager, _run(kind, v, None, True))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        _run(kind, v, None, True)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        captured = _run(kind, v, None, True)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(captured, eager)


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
