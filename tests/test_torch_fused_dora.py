"""The port's fused-DoRA path against the JAX package on the CPU.

The plain ``fused_dora`` against JAX's oracle and its Pallas body
(interpret mode) on the two smallest cases of tests/test_kernels.py's
sweep, f32, relative to max |y| within 1e-4 (that sweep's own f32
bound).  ``linear(fused=True)`` against JAX ``linear(fused=True)`` at
f32 rtol = atol = 1e-5, the flag inert for raw LoRA and plain
projections, and pooled per-row routing outranking it.  The llama2-7b
smoke model with ``use_fused_dora``: ``forward`` hidden states and
``prefill`` logits against the JAX package's at 1e-4 (as
tests/test_torch_model.py holds the unfused model), hidden states
against the port's own unfused path at 1e-5, and ``greedy_generate``'s
tokens exactly.

In bf16: the port's cast-point plain version (``fused_dora_cast_ref``,
what the CUDA kernels compute up to the order of their f32 sums) and the
JAX Pallas body in interpret mode each lie elementwise within
``bf16_bound`` of the exact value at those cast points; the same
computation with one K tile of 32 left out lies outside it, at this
file's small size and at the width of the chip smoke's decode call.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.configs import llama2_7b as j_llama
from repro.core import peft as j_peft
from repro.kernels import fused_dora as j_fused
from repro.kernels import fused_dora_ref as j_fused_ref
from repro.launch import serve as j_serve
from repro.models import layers as JL
from repro.models import model as JM
from repro.utils import pytree as jpt
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import fused_dora
from repro_torch.kernels.fused_dora.ref import bf16_bound, fused_dora_cast_ref
from repro_torch.launch import serve as t_serve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM

J_SMOKE = dataclasses.replace(j_llama.SMOKE, lora_dropout=0.0,
                              use_fused_dora=True)
T_SMOKE = dataclasses.replace(get_smoke_config("llama2-7b"),
                              lora_dropout=0.0, use_fused_dora=True)


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


def _factors(rng, K, N, r, lead=()):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(x=f(*lead, K), w0=f(K, N) * 0.05, a_dir=f(K, r) * 0.3,
                a_mag=rng.uniform(0.5, 1.5, size=(K,)).astype(np.float32),
                b_dir=f(r, N) * 0.3,
                b_mag=rng.uniform(0.1, 0.5, size=(r,)).astype(np.float32),
                da_dir=f(K, r) * 0.05, db_mag=f(r) * 0.05)


ORDER = ("x", "w0", "a_dir", "a_mag", "b_dir", "b_mag", "da_dir", "db_mag")


@pytest.mark.parametrize("M,K,N,r", [(64, 128, 384, 4), (128, 128, 128, 32)])
def test_plain_matches_jax_oracle_and_pallas(M, K, N, r):
    v = _factors(np.random.default_rng(7), K, N, r, lead=(M,))
    got = fused_dora(*(torch.from_numpy(v[k]) for k in ORDER), scale=2.0)
    j = [jnp.asarray(v[k]) for k in ORDER]
    for want in (j_fused_ref(*j, 2.0), j_fused(*j, scale=2.0)):
        want = np.asarray(want)
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err < 1e-4, err


def test_plain_defaults_missing_deltas_to_zero():
    v = _factors(np.random.default_rng(8), 32, 16, 4, lead=(2, 3))
    t = {k: torch.from_numpy(v[k]) for k in ORDER}
    got = fused_dora(*(t[k] for k in ORDER[:6]), scale=2.0)
    zero = fused_dora(*(t[k] for k in ORDER[:6]), torch.zeros(32, 4),
                      torch.zeros(4), scale=2.0)
    assert got.shape == (2, 3, 16) and torch.equal(got, zero)
    want = j_fused(*(jnp.asarray(v[k]) for k in ORDER[:6]), scale=2.0)
    close(got, want, 1e-5)


def _bf16_factors(rng, M, K, N, r):
    """f32 numpy factors with x and W0 holding bf16 values."""
    v = _factors(rng, K, N, r, lead=(M,))
    for k in ("x", "w0"):
        v[k] = torch.from_numpy(v[k]).bfloat16().float().numpy()
    return v


def _port_bf16(v):
    return [torch.from_numpy(v[k]).bfloat16() if k in ("x", "w0")
            else torch.from_numpy(v[k]) for k in ORDER]


def _pallas_bf16(v):
    return np.asarray(j_fused(*(
        jnp.asarray(v[k], jnp.bfloat16) if k in ("x", "w0")
        else jnp.asarray(v[k]) for k in ORDER), scale=2.0).astype(jnp.float32))


def _worst(y, ref, bound):
    return (np.abs(np.asarray(y, np.float32) - ref.numpy())
            / bound.numpy()).max()


@pytest.mark.parametrize("M,K,N,r", [(64, 256, 128, 8), (37, 200, 96, 4)])
def test_cast_point_plain_and_pallas_within_the_bf16_bound(M, K, N, r):
    v = _bf16_factors(np.random.default_rng(11), M, K, N, r)
    t = _port_bf16(v)
    ref, bound = bf16_bound(*t, 2.0)
    got = fused_dora_cast_ref(*t, 2.0)
    assert got.dtype == torch.bfloat16 and got.shape == (M, N)
    want = _pallas_bf16(v)
    assert _worst(got.float(), ref, bound) <= 1.0
    assert _worst(want, ref, bound) <= 1.0
    # both round at the same points: they differ by rounding flips only
    np.testing.assert_allclose(got.float().numpy(), want,
                               rtol=2 ** -7, atol=bound.numpy().max())


@pytest.mark.parametrize("tile", [0, 3, 7])
def test_bf16_bound_sees_a_dropped_k_tile(tile):
    """The Pallas body with K tile ``tile`` of 32 (of 8) left out of the
    base product lies outside the bound of the whole computation."""
    M, K, N, r = 64, 256, 128, 8
    v = _bf16_factors(np.random.default_rng(11), M, K, N, r)
    ref, bound = bf16_bound(*_port_bf16(v), 2.0)
    v["w0"] = v["w0"].copy()
    v["w0"][32 * tile:32 * tile + 32] = 0
    assert _worst(_pallas_bf16(v), ref, bound) > 1.0


def test_bf16_bound_sees_a_dropped_k_tile_at_decode_width():
    """At chip_smoke.py's decode call (x (8, 4096), W0 (4096, 4096), r 8,
    its distributions): one K tile of 32 of 128 left out of the base
    product breaks the bound, the cast-point plain version does not."""
    rng = np.random.default_rng(7)
    M, K, N, r = 8, 4096, 4096, 8
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    a_dir = f(K, r) / K ** 0.5
    t = [torch.from_numpy(a) for a in (
        f(M, K), f(K, N) * 0.02, a_dir,
        rng.uniform(0.5, 1.5, size=K).astype(np.float32), f(r, N) / r ** 0.5,
        f(r), f(K, r) * np.sqrt((a_dir ** 2).mean()) / 6, f(r))]
    t[0], t[1] = t[0].bfloat16(), t[1].bfloat16()
    ref, bound = bf16_bound(*t, 4.0)
    assert _worst(fused_dora_cast_ref(*t, 4.0).float(), ref, bound) <= 1.0
    t[1] = t[1].clone()
    t[1][64 * 32:65 * 32] = 0
    assert _worst(fused_dora_cast_ref(*t, 4.0).float(), ref, bound) > 1.0


def _decomposed(rng, d=64, o=128, r=8):
    v = _factors(rng, d, o, r)
    return {"kernel": v["w0"], "A_dir": v["a_dir"], "A_mag": v["a_mag"],
            "B_dir": v["b_dir"], "B_mag": v["b_mag"], "dA_dir": v["da_dir"],
            "dB_mag": v["db_mag"]}


def _linear_both(p, x, **kw):
    idx = kw.pop("adapter_idx", None)
    want = JL.linear({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), lora_scale=2.0,
                     adapter_idx=None if idx is None else jnp.asarray(idx),
                     **kw)
    got = TL.linear({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), lora_scale=2.0,
                    adapter_idx=None if idx is None else torch.from_numpy(idx),
                    **kw)
    return got, want


@pytest.mark.parametrize("branch", ["decomposed", "lora", "plain", "pooled"])
def test_fused_linear_matches_reference(branch):
    """linear(fused=True): the fused kernel's plain version on a
    decomposed adapter; the flag inert for raw LoRA and plain projections;
    pooled per-row routing outranks it (the shared adapter leaves beside
    the pool must not be served to every tenant)."""
    rng = np.random.default_rng(3)
    p = _decomposed(rng)
    x = rng.normal(size=(2, 16, 64)).astype(np.float32)
    idx = None
    if branch == "lora":
        p = {"kernel": p["kernel"],
             "lora_A": rng.normal(size=(64, 4)).astype(np.float32),
             "lora_B": rng.normal(size=(4, 128)).astype(np.float32)}
    elif branch == "plain":
        p = {"kernel": p["kernel"]}
    elif branch == "pooled":
        L = 3
        p.update(bgmv_A_dir=p["A_dir"], bgmv_A_mag=p["A_mag"],
                 bgmv_B_mag=p["B_mag"], bgmv_B_dir=p["B_dir"],
                 pool_dB_mag=rng.normal(size=(L, 8)).astype(np.float32))
        idx = np.asarray([0, 2], np.int32)
    got, want = _linear_both(p, x, fused=True, adapter_idx=idx)
    close(got, want, 1e-5)
    unfused, _ = _linear_both(p, x, fused=False, adapter_idx=idx)
    if branch == "decomposed":
        close(got, unfused.numpy(), 2e-4)    # test_kernels.py's bound
    else:
        assert torch.equal(got, unfused)


@pytest.fixture(scope="module")
def smoke():
    """The llama2-7b smoke model merged with a decomposed adapter whose
    B_mag, dA_dir and dB_mag are all nonzero."""
    base = JM.init_params(jax.random.PRNGKey(0), J_SMOKE)
    ad = j_peft.add_lora(base, J_SMOKE, jax.random.PRNGKey(1),
                         decomposed=True)
    rng = np.random.default_rng(4)

    def bump(p, x):
        if p.endswith("B_mag"):
            return x + 0.25
        if p.endswith("dA_dir") or p.endswith("dB_mag"):
            return x + jnp.asarray(rng.normal(0, 0.05, size=x.shape),
                                   x.dtype)
        return x
    tree = jpt.merge_trees(base, jpt.tree_map_with_path(bump, ad))
    return tree, to_port(tree)


def test_fused_model_matches_reference(smoke):
    jtree, ttree = smoke
    toks = np.random.default_rng(7).integers(
        0, J_SMOKE.vocab_size, size=(2, 9)).astype(np.int32)
    jh, _, _ = JM.forward(jtree, {"tokens": jnp.asarray(toks)}, J_SMOKE)
    th, _, _ = TM.forward(ttree, {"tokens": torch.from_numpy(toks)}, T_SMOKE)
    close(th, jh, 1e-4)
    unfused, _, _ = TM.forward(ttree, {"tokens": torch.from_numpy(toks)},
                               dataclasses.replace(T_SMOKE,
                                                   use_fused_dora=False))
    close(th, unfused.numpy(), 1e-5)
    jl, _ = JM.prefill(jtree, {"tokens": jnp.asarray(toks)}, J_SMOKE)
    tl, _ = TM.prefill(ttree, {"tokens": torch.from_numpy(toks)}, T_SMOKE)
    close(tl, jl, 1e-4)
    want = j_serve.greedy_generate(jtree, {"tokens": jnp.asarray(toks)},
                                   J_SMOKE, n_new=6)
    got = t_serve.greedy_generate(ttree, {"tokens": toks}, T_SMOKE, n_new=6,
                                  device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
