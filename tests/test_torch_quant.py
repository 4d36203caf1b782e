"""The port's quantized serving path against the JAX package on the CPU.

Codecs: for the same f32 (or bf16) weights the int8/int4 codes are
byte-identical to the JAX package's and the scales equal, per channel
and per group, on 2-D and stacked 3-D leaves; ``unpack_int4`` and
``dequantize`` are equal too, and the error cases raise alike.  The
plain quantized matmul is held against JAX's oracle and its Pallas body
(interpret mode) at f32 rtol = atol = 1e-5 (the same f32 sums in another
order), and ``quantize_backbone`` quantizes the same leaf paths.  The
quantized engine (int8 per channel, int4 in groups of 16) serves the
same tokens as the JAX engine and, inside the port, as greedy decoding
over ``quantize_backbone(base)``: tokens exactly.

In bf16: the port's cast-point plain version (``quant_matmul_cast_ref``,
f32(x) · (f32(code) · scale) rounded once) and the JAX Pallas body lie
elementwise within ``bf16_bound`` of the exact value; at the decode
width the kernel runs at, a computation that leaves one K tile of 64 out,
or applies group g's scale to group g + 1, lies outside it.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.core import peft as j_peft
from repro.kernels.quant_matmul import ops as j_ops
from repro.kernels.quant_matmul import ref as j_ref
from repro.models import model as JM
from repro.models.config import ArchConfig as JArch
from repro.serve import AdapterStore as JStore
from repro.serve import ServeEngine as JEngine
from repro.utils import pytree as jpt
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.kernels.quant_matmul import ops as t_ops
from repro_torch.kernels.quant_matmul import ref as t_ref
from repro_torch.kernels.quant_matmul.ref import (bf16_bound,
                                                  quant_matmul_cast_ref)
from repro_torch.launch.serve import greedy_generate
from repro_torch.models.config import ArchConfig as TArch
from repro_torch.serve import AdapterStore, ServeEngine
from repro_torch.utils import pytree as tpt

CFG = dict(name="quant-t", family="dense", n_layers=2, d_model=32,
           n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
           dtype="float32", lora_rank=4, lora_dropout=0.0)
J_CFG, T_CFG = JArch(**CFG), TArch(**CFG)
QUANT = {"int8": (j_ref.quantize_int8, t_ref.quantize_int8),
         "int4": (j_ref.quantize_int4, t_ref.quantize_int4)}


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _w(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(
        np.float32) * 0.1


def _equal(got, want):
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == str(want.dtype)
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(32, 24), (3, 32, 24)])
@pytest.mark.parametrize("gs", [None, 16])
@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_codes_byte_identical(mode, gs, shape):
    """Codes, scales, unpacked codes and dequantized weights equal the JAX
    package's bit for bit; a zero channel and values on exact half-bins
    (rounding half to even) are included."""
    w = _w(*shape, seed=len(shape))
    w[..., -1] = 0.0
    w[..., 0, 1], w[..., 1, 1] = 0.5, 1.0      # |w| max 1: w/scale = 63.5
    jq, js = QUANT[mode][0](jnp.asarray(w), group_size=gs)
    tq, ts = QUANT[mode][1](torch.from_numpy(w), group_size=gs)
    _equal(tq, jq)
    _equal(ts, js)
    if mode == "int4":
        _equal(t_ref.unpack_int4(tq), j_ref.unpack_int4(jq))
    _equal(t_ref.dequantize(tq, ts), j_ref.dequantize(jq, js))


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_bf16_leaf_is_cast_to_f32_first(mode):
    w = jnp.asarray(_w(16, 8, seed=4), jnp.bfloat16)
    jq, js = QUANT[mode][0](w)
    tq, ts = QUANT[mode][1](to_port({"w": w})["w"])
    assert to_port({"w": w})["w"].dtype == torch.bfloat16
    _equal(tq, jq)
    _equal(ts, js)


def test_codec_error_cases():
    for j, t in ((j_ref.quantize_int4, t_ref.quantize_int4),):
        for fn, w in ((j, jnp.asarray(_w(15, 8))), (t, torch.zeros(15, 8))):
            with pytest.raises(ValueError, match="even d_in"):
                fn(w)
    for fn, w in ((j_ref.quantize_int8, jnp.asarray(_w(16, 8))),
                  (t_ref.quantize_int8, torch.zeros(16, 8))):
        with pytest.raises(ValueError, match="does not divide"):
            fn(w, group_size=5)
    for fn in (j_ops.quantize_backbone, t_ops.quantize_backbone):
        with pytest.raises(ValueError, match="backbone_quant"):
            fn({}, "fp8")
    q, s = t_ref.quantize_int8(torch.zeros(16, 8))
    with pytest.raises(ValueError, match="unknown quant_matmul impl"):
        t_ops.quant_matmul(torch.ones(2, 16), q, s, impl="pallas")


# ---------------------------------------------------------------------------
# the plain quantized matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 64, 48), (300, 96, 80),
                                   (2, 3, 32, 24)])
@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("gs", [None, 16])
def test_plain_matches_jax_oracle_and_pallas(shape, mode, gs):
    """The shapes of tests/test_quant.py's kernel sweep: one tile, M and N
    the JAX dispatcher pads, leading batch dims.  The port's plain version
    against the JAX oracle and the JAX Pallas body, f32, 1e-5."""
    *lead, d_in, d_out = shape
    x = np.random.default_rng(7).normal(size=(*lead, d_in)).astype(np.float32)
    jq, js = QUANT[mode][0](jnp.asarray(_w(d_in, d_out, seed=5)),
                            group_size=gs)
    tq = to_port({"q": jq, "s": js})
    got = t_ops.quant_matmul(torch.from_numpy(x), tq["q"], tq["s"])
    assert tuple(got.shape) == (*lead, d_out)
    for want in (j_ref.quant_matmul_ref(jnp.asarray(x), jq, js),
                 j_ops.quant_matmul(jnp.asarray(x), jq, js,
                                    impl="interpret")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)


def _worst(y, ref, bound):
    """max |y − ref| / bound over the elements."""
    return ((torch.as_tensor(np.asarray(y, np.float64)) - ref).abs()
            / bound.clamp_min(1e-300)).max().item()


@pytest.mark.parametrize("shape", [(8, 64, 48), (300, 96, 80),
                                   (2, 3, 32, 24)])
@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("gs", [None, 16])
def test_cast_point_plain_and_pallas_within_the_bf16_bound(shape, mode, gs):
    """bf16 x at the kernel sweep's shapes: the cast-point plain version
    and the Pallas body (interpret mode) both lie within the bound."""
    *lead, d_in, d_out = shape
    x = torch.from_numpy(np.random.default_rng(7).normal(
        size=(*lead, d_in)).astype(np.float32)).bfloat16()
    jq, js = QUANT[mode][0](jnp.asarray(_w(d_in, d_out, seed=5)),
                            group_size=gs)
    tq = to_port({"q": jq, "s": js})
    ref, bound = bf16_bound(x.reshape(-1, d_in), tq["q"], tq["s"])
    got = quant_matmul_cast_ref(x.reshape(-1, d_in), tq["q"], tq["s"])
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    want = j_ops.quant_matmul(jnp.asarray(x.float().numpy(), jnp.bfloat16),
                              jq, js, impl="interpret")
    assert want.dtype == jnp.bfloat16
    assert _worst(got.float(), ref, bound) <= 1.0
    assert _worst(np.asarray(want.astype(jnp.float32)).reshape(-1, d_out),
                  ref, bound) <= 1.0


def _decode_width(mode, gs):
    """x (8, 4096) N(0, 1) in bf16 and the codes of an N(0, 0.02²) 4096 x
    4096 weight: the decode call of chip_smoke.py's phase 2."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(8, 4096)).astype(
        np.float32)).bfloat16()
    w = torch.from_numpy(rng.normal(size=(4096, 4096)).astype(
        np.float32) * 0.02)
    q, s = QUANT[mode][1](w, group_size=gs)
    return x, q, s


@pytest.mark.parametrize("mode,gs", [("int8", None), ("int4", 128)])
def test_bf16_bound_sees_a_dropped_k_tile_at_decode_width(mode, gs):
    """The cast-point plain version lies within the bound; the same
    computation with K tile 31 of 64 (rows 1984-2047) left out does not."""
    x, q, s = _decode_width(mode, gs)
    ref, bound = bf16_bound(x, q, s)
    assert _worst(quant_matmul_cast_ref(x, q, s).float(), ref, bound) <= 1.0
    dropped = x.clone()
    dropped[:, 31 * 64:32 * 64] = 0
    assert _worst(quant_matmul_cast_ref(dropped, q, s).float(), ref,
                  bound) > 1.0


@pytest.mark.parametrize("mode", ["int8", "int4"])
def test_bf16_bound_sees_a_misplaced_group_scale_at_decode_width(mode):
    """In groups of 128: group 15's scale applied to group 16 as well
    (instead of group 16's own) lies outside the bound."""
    x, q, s = _decode_width(mode, 128)
    ref, bound = bf16_bound(x, q, s)
    assert _worst(quant_matmul_cast_ref(x, q, s).float(), ref, bound) <= 1.0
    misplaced = s.clone()
    misplaced[16] = s[15]
    assert _worst(quant_matmul_cast_ref(x, q, misplaced).float(), ref,
                  bound) > 1.0


# ---------------------------------------------------------------------------
# quantize_backbone and the quantized engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def world():
    """A JAX base, a decomposed shared adapter with nonzero B_mag and two
    tenants' ΔB_M — JAX side and port side."""
    base = JM.init_params(jax.random.PRNGKey(0), J_CFG)
    shared = j_peft.add_lora(base, J_CFG, jax.random.PRNGKey(1),
                             decomposed=True)
    shared = jpt.tree_map_with_path(
        lambda p, x: x + 0.5 if p.endswith("B_mag") else x, shared)
    rng = np.random.default_rng(0)
    deltas = [jax.tree.map(
        lambda x: jnp.asarray(rng.normal(0, 0.5, size=x.shape), jnp.float32),
        jpt.filter_tree(shared, lambda p: p.endswith("dB_mag")))
        for _ in range(2)]
    return dict(j=dict(base=base, shared=shared, deltas=deltas),
                t=dict(base=to_port(base), shared=to_port(shared),
                       deltas=[to_port(d) for d in deltas]))


@pytest.mark.parametrize("mode,gs", [("int8", None), ("int4", 16)])
def test_quantize_backbone_matches_reference(world, mode, gs):
    """The same leaf paths quantize, to the same codes and scales; every
    other leaf is carried over unchanged.  The JAX package's quantized
    tree also crosses the bridge unchanged (int8 and uint8 codes bit for
    bit, f32 scales exact)."""
    jt = j_ops.quantize_backbone(world["j"]["base"], mode, group_size=gs)
    tt = t_ops.quantize_backbone(world["t"]["base"], mode, group_size=gs)
    bridged = to_port(jt)
    assert sorted(tpt.tree_paths(tt)) == sorted(jpt.tree_paths(jt))
    assert any(p.endswith("kernel_q") for p in tpt.tree_paths(tt))
    for p in tpt.tree_paths(tt):
        _equal(tpt.tree_get(tt, p), jpt.tree_get(jt, p))
        _equal(tpt.tree_get(bridged, p), jpt.tree_get(jt, p))


@pytest.mark.parametrize("mode,gs", [("int8", None), ("int4", 16)])
def test_quantized_engine_matches_reference(world, mode, gs):
    """ServeEngine with cfg.backbone_quant over a dora_mag store: the same
    tokens as the JAX engine, and as greedy decoding over the quantized
    tree merged with the pool (the null tenant: the bare quantized
    backbone) inside the port."""
    j, t = world["j"], world["t"]
    jcfg = dataclasses.replace(J_CFG, backbone_quant=mode,
                               backbone_quant_group=gs)
    tcfg = dataclasses.replace(T_CFG, backbone_quant=mode,
                               backbone_quant_group=gs)
    js = JStore(j["base"], J_CFG, n_slots=2, kind="dora_mag",
                shared=j["shared"])
    ts = AdapterStore(t["base"], T_CFG, n_slots=2, kind="dora_mag",
                      shared=t["shared"], device="cpu")
    for i in range(2):
        js.register(f"t{i}", j["deltas"][i])
        ts.register(f"t{i}", t["deltas"][i])
    kw = dict(max_rows=2, max_prompt_len=8, max_len=24, decode_chunk=4)
    je = JEngine(j["base"], jcfg, js, **kw)
    te = ServeEngine(t["base"], tcfg, ts, device="cpu", **kw)
    assert "kernel_q" in tpt.tree_get(te.base, "blocks/sub0/attn/q_proj")
    rng = np.random.default_rng(5)
    reqs = [(tn, rng.integers(0, 64, size=n).astype(np.int32))
            for tn, n in (("t0", 8), (None, 5), ("t1", 7))]
    jout = je.generate(reqs, n_new=6)
    tout = te.generate(reqs, n_new=6)
    for a, b in zip(tout, jout):
        np.testing.assert_array_equal(a, b)
    ref = greedy_generate(t_ops.quantize_backbone(t["base"], mode,
                                                  group_size=gs),
                          {"tokens": reqs[1][1][None]}, T_CFG, n_new=6,
                          device="cpu")
    np.testing.assert_array_equal(tout[1], ref[0].numpy())
