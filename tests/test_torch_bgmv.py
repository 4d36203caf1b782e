"""The port's plain BGMV ops against the JAX package's on the CPU.

The same numpy inputs go through ``repro.kernels.bgmv*`` (its einsum
oracle, and the Pallas kernel body in interpret mode) and through
``repro_torch.kernels.bgmv*`` on CPU tensors, which take the plain
PyTorch version.  Ranked and unranked, (B, d_in) decode rows and
(B, S, d_in) blocks, and an S that the Pallas grid has to pad.

Tolerance: f32 rtol = atol = 1e-5 (the reference's own kernel-vs-oracle
bound in tests/test_batched_lora.py; sums run in another order); bf16
2e-2 of the output's max magnitude (the two frameworks round their bf16
matmul outputs at different points).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.kernels import bgmv as j_bgmv
from repro.kernels import bgmv_mag as j_bgmv_mag
from repro_torch.kernels import bgmv as t_bgmv
from repro_torch.kernels import bgmv_mag as t_bgmv_mag


def _case(B, S, d, r, o, L, seed):
    rng = np.random.default_rng(seed)
    shape = (B, d) if S is None else (B, S, d)
    return dict(
        x=rng.normal(size=shape).astype(np.float32),
        a_pool=(rng.normal(size=(L, d, r)) * 0.3).astype(np.float32),
        b_pool=(rng.normal(size=(L, r, o)) * 0.3).astype(np.float32),
        a_dir=(rng.normal(size=(d, r)) * 0.3).astype(np.float32),
        a_mag=rng.uniform(0.5, 1.5, size=(d,)).astype(np.float32),
        b_mag=rng.normal(size=(r,)).astype(np.float32),
        dmag=rng.normal(size=(L, r)).astype(np.float32),
        b_dir=(rng.normal(size=(r, o)) * 0.3).astype(np.float32),
        idx=rng.integers(0, L, size=(B,)).astype(np.int32),
        # mixed ranks with a rank-0 slot (the last: the null slot)
        ranks=np.asarray([int(v) for v in rng.integers(1, r + 1, size=L - 1)]
                         + [0], np.int32))


def _jax(kind, c, ranked, impl, dtype=jnp.float32):
    a = {k: jnp.asarray(v) for k, v in c.items()}
    x = a["x"].astype(dtype)
    ranks = a["ranks"] if ranked else None
    if kind == "bgmv":
        y = j_bgmv(x, a["a_pool"], a["b_pool"], a["idx"], scale=2.0,
                   ranks=ranks, impl=impl)
    else:
        y = j_bgmv_mag(x, a["a_dir"], a["a_mag"], a["b_mag"], a["dmag"],
                       a["b_dir"], a["idx"], scale=4.0, ranks=ranks,
                       impl=impl)
    return np.asarray(y.astype(jnp.float32))


def _port(kind, c, ranked, dtype=torch.float32):
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    x = t["x"].to(dtype)
    ranks = t["ranks"] if ranked else None
    if kind == "bgmv":
        y = t_bgmv(x, t["a_pool"], t["b_pool"], t["idx"], scale=2.0,
                   ranks=ranks)
    else:
        y = t_bgmv_mag(x, t["a_dir"], t["a_mag"], t["b_mag"], t["dmag"],
                       t["b_dir"], t["idx"], scale=4.0, ranks=ranks)
    assert y.dtype == dtype
    return y.float().numpy()


CASES = {
    "blocks": (4, 16, 64, 8, 96, 5),
    "decode_rows": (8, None, 32, 16, 32, 9),
    "padded_S": (2, 300, 32, 4, 32, 3),     # 300 is no multiple of 256
}


@pytest.mark.parametrize("kind", ["bgmv", "bgmv_mag"])
@pytest.mark.parametrize("ranked", [False, True], ids=["full", "ranked"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_jax_einsum(kind, ranked, case):
    c = _case(*CASES[case], seed=len(case))
    want = _jax(kind, c, ranked, "einsum")
    got = _port(kind, c, ranked)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["bgmv", "bgmv_mag"])
@pytest.mark.parametrize("case", ["decode_rows", "padded_S"])
def test_plain_matches_pallas_interpret(kind, case):
    """The Pallas kernel body itself (interpret mode), ranked."""
    c = _case(*CASES[case], seed=7)
    want = _jax(kind, c, True, "interpret")
    got = _port(kind, c, True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["bgmv", "bgmv_mag"])
def test_plain_bf16_matches_jax(kind):
    c = _case(4, 5, 64, 8, 48, 5, seed=3)
    want = _jax(kind, c, True, "einsum", jnp.bfloat16)
    got = _port(kind, c, True, torch.bfloat16)
    assert np.abs(got - want).max() <= 2e-2 * np.abs(want).max()


@pytest.mark.parametrize("kind", ["bgmv", "bgmv_mag"])
def test_rank_zero_rows_are_exactly_zero(kind):
    c = _case(4, 3, 32, 4, 16, 5, seed=5)
    c["idx"][:] = [4, 0, 4, 1]                    # slot 4 has rank 0
    got = _port(kind, c, True)
    assert (got[[0, 2]] == 0).all() and np.abs(got[[1, 3]]).max() > 0


# --- ref.bf16_bound: the elementwise bound every bf16 kernel output is
# held to (chip_smoke.py phase 2, tests/test_torch_bgmv_gpu.py) ---------

from repro_torch.kernels.batched_lora.ref import (  # noqa: E402
    bf16_bound, bgmv_cast_ref, bgmv_ref)

BOUND_CASES = {
    "blocks": (4, 16, 256, 8, 192, 5),
    "decode_rows": (8, 1, 512, 16, 256, 9),
    "ragged": (3, 37, 300, 5, 200, 4),      # d_in, d_out no multiple of 8
}


def _bound_args(kind, t):
    """(a, b, mag) of ``bf16_bound`` / ``bgmv_cast_ref`` for ``kind``."""
    if kind == "bgmv":
        return t["a_pool"], t["b_pool"], None
    return t["a_dir"], t["b_dir"], (t["a_mag"], t["b_mag"], t["dmag"])


def _bound_case(case, seed):
    c = _case(*BOUND_CASES[case], seed=seed)
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    t["x"] = t["x"].bfloat16()
    return t


def _ratio(y, ref_bound):
    ref, bound = ref_bound
    return ((y.double() - ref.double()).abs()
            / bound.double().clamp_min(1e-300)).max().item()


@pytest.mark.parametrize("kind", ["bgmv", "bgmv_mag"])
@pytest.mark.parametrize("ranked", [False, True], ids=["full", "ranked"])
@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_bf16_bound_holds_the_cast_point_plain_version(kind, ranked, case):
    """f32 sums at the Pallas cast points lie within the bound of the f64
    evaluation at the same cast points (about 0.3 of it); so does the plain
    pairs version, which rounds where the Pallas body rounds."""
    t = _bound_case(case, seed=11)
    ranks = t["ranks"] if ranked else None
    a, b, mag = _bound_args(kind, t)
    rb = bf16_bound(t["x"], a, b, t["idx"], 4.0, ranks, mag=mag)
    assert rb[0].shape == (*t["x"].shape[:2], b.shape[-1])
    y = bgmv_cast_ref(t["x"], a, b, t["idx"], 4.0, ranks, mag=mag)
    assert y.dtype == torch.bfloat16
    assert _ratio(y, rb) <= 1.0
    if kind == "bgmv":
        plain = bgmv_ref(t["x"], a, b, t["idx"], 4.0, ranks=ranks)
        assert _ratio(plain, rb) <= 1.0


@pytest.mark.parametrize("kind", ["bgmv", "bgmv_mag"])
@pytest.mark.parametrize("case", ["decode_rows", "padded_S"])
def test_bf16_bound_holds_the_pallas_body(kind, case):
    """The Pallas kernel body itself (interpret mode), bf16, ranked: its
    cast points are the bound's, so its output lies within it."""
    c = _case(*CASES[case], seed=7)
    want = torch.from_numpy(np.array(_jax(kind, c, True, "interpret",
                                         jnp.bfloat16)))
    t = {k: torch.from_numpy(v) for k, v in c.items()}
    x = t["x"].bfloat16()
    if x.dim() == 2:
        x, want = x[:, None], want[:, None]
    a, b, mag = _bound_args(kind, t)
    scale = 2.0 if kind == "bgmv" else 4.0
    assert _ratio(want, bf16_bound(x, a, b, t["idx"], scale, t["ranks"],
                                   mag=mag)) <= 1.0


@pytest.mark.parametrize("kind", ["bgmv", "bgmv_mag"])
@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_bf16_bound_sees_a_dropped_d_in_slice(kind, case):
    """A kernel that left out one block's slice of d_in (an eighth, as a
    cluster of 8 splits it) reads many times the bound."""
    t = _bound_case(case, seed=13)
    a, b, mag = _bound_args(kind, t)
    rb = bf16_bound(t["x"], a, b, t["idx"], 4.0, t["ranks"], mag=mag)
    x = t["x"].clone()
    d = x.shape[-1]
    x[..., 3 * d // 8: 4 * d // 8] = 0
    y = bgmv_cast_ref(x, a, b, t["idx"], 4.0, t["ranks"], mag=mag)
    assert _ratio(y, rb) > 20.0


@pytest.mark.parametrize("case", sorted(BOUND_CASES))
def test_bf16_bound_sees_a_dropped_magnitude_delta(case):
    """bgmv_mag with ΔB_M left out (b_mag alone as the magnitude) reads
    many times the bound."""
    t = _bound_case(case, seed=17)
    a, b, mag = _bound_args("bgmv_mag", t)
    rb = bf16_bound(t["x"], a, b, t["idx"], 4.0, t["ranks"], mag=mag)
    no_delta = (mag[0], mag[1], torch.zeros_like(mag[2]))
    y = bgmv_cast_ref(t["x"], a, b, t["idx"], 4.0, t["ranks"], mag=no_delta)
    assert _ratio(y, rb) > 20.0
