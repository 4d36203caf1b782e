"""The port's flash attention against the JAX package's on the CPU.

The same numpy inputs go through ``repro.kernels.flash_attention`` (the
Pallas body in interpret mode, as tests/test_kernels.py runs it) or its
oracle ``attention_ref``, and through ``repro_torch.kernels``'
``flash_attention`` on CPU tensors, which takes the plain version.  The
cases are tests/test_kernels.py's flash sweep; the bhsd plain version,
with its ``sk_valid`` and ``q_offset`` knobs, is held against the
Pallas ``flash_attention_bhsd`` in interpret mode.

Tolerances, absolute, those of tests/test_kernels.py's flash sweep: f32
2e-5, bf16 2e-2.  Elementwise besides, in bf16: the port's plain output
and the JAX oracle's, each the f32 result rounded to bf16, within one
bf16 ulp of each other (2^-7 |want| + 2e-5); the Pallas body in interpret
mode, which rounds the softmax weights and its output to bf16, within
``bf16_bound_bhsd``'s bound of the port's plain f32 result.  Rows with no valid key (Sq > Sk under causal, keys cut
by ``sk_valid`` and the window) must give the plain average of v over all
Sk keys, as the −1e30 mask does, and never NaN.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.kernels import attention_ref as j_ref
from repro.kernels import flash_attention as j_flash
from repro.kernels.flash_attention.flash_attention import \
    flash_attention_bhsd as j_bhsd
from repro_torch.kernels import attention_ref, flash_attention
from repro_torch.kernels.flash_attention import flash_attention as K
from repro_torch.kernels.flash_attention.ref import (bf16_bound_bhsd,
                                                     flash_attention_bhsd_ref)

TOL = {"f32": 2e-5, "bf16": 2e-2}
J_DT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
T_DT = {"f32": torch.float32, "bf16": torch.bfloat16}

SWEEP = [   # tests/test_kernels.py::test_flash_attention_sweep
    dict(B=2, Sq=256, Sk=256, H=4, K=2, dh=64, causal=True, window=None),
    dict(B=1, Sq=128, Sk=128, H=4, K=4, dh=32, causal=True, window=48),
    dict(B=2, Sq=256, Sk=256, H=8, K=1, dh=64, causal=False, window=None),
    dict(B=1, Sq=512, Sk=512, H=2, K=2, dh=128, causal=True, window=128),
    dict(B=1, Sq=128, Sk=256, H=2, K=2, dh=64, causal=True, window=None),
]
IDS = ["gqa2", "window", "mqa-noncausal", "dh128-window", "sq<sk"]


def _qkv(c, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(c["B"], S, h, c["dh"])).astype(np.float32)
            for S, h in ((c["Sq"], c["H"]), (c["Sk"], c["K"]), (c["Sk"], c["K"]))]


def _port(arrs, dt, **kw):
    out = flash_attention(*(torch.from_numpy(a).to(T_DT[dt]) for a in arrs),
                          **kw)
    return out.float().numpy()


def _jax(fn, arrs, dt, **kw):
    out = fn(*(jnp.asarray(a, J_DT[dt]) for a in arrs), **kw)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("c", SWEEP, ids=IDS)
def test_plain_matches_jax_oracle(c, dt):
    arrs = _qkv(c, seed=c["Sq"] + c["H"])
    kw = dict(causal=c["causal"], window=c["window"])
    y = _port(arrs, dt, **kw)
    assert y.shape == (c["B"], c["Sq"], c["H"], c["dh"])
    want = _jax(j_ref, arrs, dt, **kw)
    assert np.abs(y - want).max() < TOL[dt]
    if dt == "bf16":                          # within one bf16 ulp
        assert (np.abs(y - want) <= 2.0 ** -7 * np.abs(want) + 2e-5).all()


def _fold(a):
    """(B, S, H, dh) → (B·H, S, dh), as the dispatcher folds heads."""
    t = torch.from_numpy(np.array(a, np.float32))
    return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])


@pytest.mark.parametrize("c", [SWEEP[0], SWEEP[1], SWEEP[3], SWEEP[4]],
                         ids=["gqa2", "window", "dh128-window", "sq<sk"])
def test_jax_pallas_bf16_within_the_rounding_bound(c):
    # the Pallas body's bf16 cast points, as the CUDA kernel keeps them
    arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
            for a in _qkv(c, seed=13)]
    kw = dict(causal=c["causal"], window=c["window"])
    want = _jax(j_flash, arrs, "bf16", interpret=True, **kw)
    ref, bound = bf16_bound_bhsd(*map(_fold, arrs), scale=c["dh"] ** -0.5,
                                 q_offset=c["Sk"] - c["Sq"], **kw)
    err = (_fold(want) - ref).abs()
    assert err.max() < TOL["bf16"]
    assert bool((err <= bound).all())
    y = _port(arrs, "bf16", **kw)                 # the plain output, rounded
    assert bool(((_fold(y) - ref).abs() <= bound).all())


def test_rounding_bound_rejects_an_output_ten_percent_off():
    # over 2048 keys |y| is a few hundredths: 2e-2 absolute lets an output
    # 10% off pass, the elementwise bound does not
    rng = np.random.default_rng(17)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, S, 64)).astype(np.float32))
               for S in (64, 2048, 2048))
    ref, bound = bf16_bound_bhsd(q, k, v, scale=0.125, causal=False)
    off = ref * 1.1
    assert (off - ref).abs().max() < TOL["bf16"]
    assert not bool(((off - ref).abs() <= bound).all())


@pytest.mark.parametrize("c", [SWEEP[0], SWEEP[1], SWEEP[4]],
                         ids=["gqa2", "window", "sq<sk"])
def test_plain_matches_jax_pallas_interpret(c):
    arrs = _qkv(c, seed=7)
    kw = dict(causal=c["causal"], window=c["window"])
    y = _port(arrs, "f32", **kw)
    want = _jax(j_flash, arrs, "f32", interpret=True, **kw)
    assert np.abs(y - want).max() < TOL["f32"]


@pytest.mark.parametrize("kw", [
    dict(causal=True, window=None, sk_valid=100, q_offset=64),
    dict(causal=True, window=16, sk_valid=40, q_offset=0),   # rows ≥ 55 empty
    dict(causal=False, window=None, sk_valid=20, q_offset=0),
], ids=["sk_valid-offset", "sk_valid-window-empty-rows", "sk_valid-full"])
def test_bhsd_plain_matches_jax_pallas_interpret(kw):
    rng = np.random.default_rng(3)
    q = rng.normal(size=(4, 64, 32)).astype(np.float32)
    k, v = (rng.normal(size=(2, 128, 32)).astype(np.float32) for _ in "kv")
    y = flash_attention_bhsd_ref(*map(torch.from_numpy, (q, k, v)),
                                 scale=0.2, **kw).numpy()
    want = np.asarray(j_bhsd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             scale=0.2, bq=64, bk=64, interpret=True, **kw))
    assert np.abs(y - want).max() < TOL["f32"]


def test_fully_masked_rows_average_v_as_the_reference_does():
    # Sq 8 > Sk 4 under causal: query rows 0-3 sit before every key
    c = dict(B=1, Sq=8, Sk=4, H=2, K=1, dh=16)
    arrs = _qkv(c, seed=5)
    y = _port(arrs, "f32", causal=True)
    assert np.isfinite(y).all()
    mean_v = arrs[2].mean(axis=1)                        # (B, K, dh)
    np.testing.assert_allclose(y[:, :4], np.broadcast_to(
        mean_v[:, None], (1, 4, 2, 16)), rtol=0, atol=TOL["f32"])
    assert np.abs(y - _jax(j_ref, arrs, "f32", causal=True)).max() < TOL["f32"]
    want = _jax(j_flash, arrs, "f32", causal=True, interpret=True)
    assert np.abs(y - want).max() < TOL["f32"]


def test_dispatcher_folds_heads_and_aligns_ends_for_the_kernel(monkeypatch):
    # the CUDA route's layout code, with the bhsd plain version standing in
    # for the kernel
    from repro_torch.kernels.flash_attention import ops
    calls = []

    def fake(q, k, v, **kw):
        calls.append(kw)
        assert q.is_contiguous() and k.is_contiguous() and v.is_contiguous()
        return flash_attention_bhsd_ref(q, k, v, **kw)
    monkeypatch.setattr(ops, "flash_attention_bhsd_cuda", fake)
    c = dict(B=2, Sq=24, Sk=40, H=6, K=3, dh=16)
    q, k, v = (torch.from_numpy(a) for a in _qkv(c, seed=9))
    y = flash_attention(q, k, v, causal=True, window=10, impl="cuda")
    assert calls == [dict(scale=0.25, causal=True, window=10, q_offset=16)]
    assert y.shape == q.shape
    want = attention_ref(q, k, v, causal=True, window=10)
    assert torch.allclose(y, want, rtol=0, atol=TOL["f32"])


def test_ragged_lengths_need_no_padding():
    c = dict(B=1, Sq=67, Sk=67, H=2, K=1, dh=24, causal=True, window=None)
    arrs = _qkv(c, seed=11)
    y = _port(arrs, "f32", causal=True)
    assert np.abs(y - _jax(j_ref, arrs, "f32", causal=True)).max() < TOL["f32"]


def test_cuda_wrapper_refuses_cpu_tensors_and_counts_nothing():
    q, kv = torch.zeros(1, 8, 2, 16), torch.zeros(1, 8, 1, 16)
    K.reset_launches()
    assert torch.equal(flash_attention(q, kv, kv),
                       flash_attention(q, kv, kv, impl="torch"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        K.flash_attention_bhsd_cuda(q[0], kv[0], kv[0], scale=1.0)
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention(q, kv, kv, impl="cuda")
    with pytest.raises(ValueError, match="unknown flash_attention impl"):
        flash_attention(q, kv, kv, impl="pallas")
    assert K.LAUNCHES == {"flash_attention": 0}


# --- the shapes the GPU tests give the tensor-core kernels ---------------

EDGES = [   # tests/test_torch_flash_attention_gpu.py's bf16 edge cases
    dict(B=1, Sq=200, Sk=330, H=4, K=2, dh=128, causal=True, window=None),
    dict(B=1, Sq=1000, Sk=1000, H=2, K=1, dh=256, causal=True, window=100),
    dict(B=1, Sq=1, Sk=4095, H=8, K=1, dh=128, causal=True, window=None),
    dict(B=2, Sq=16, Sk=300, H=8, K=2, dh=128, causal=True, window=None),
    dict(B=2, Sq=17, Sk=300, H=8, K=2, dh=128, causal=True, window=None),
    dict(B=1, Sq=77, Sk=333, H=4, K=1, dh=100, causal=True, window=None),
    dict(B=3, Sq=5, Sk=129, H=6, K=3, dh=64, causal=True, window=40),
    dict(B=1, Sq=1, Sk=4096, H=4, K=1, dh=256, causal=True, window=520),
    dict(B=1, Sq=16, Sk=2048, H=8, K=1, dh=64, causal=True, window=None),
]
EDGE_IDS = ["diagonal-off-64", "dh256-window", "rep8-decode-4095",
            "decode-sq16", "prefill-sq17", "dh100-odd-sk", "decode-window",
            "decode-split-empty-blocks", "decode-groups-split"]


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("c", EDGES, ids=EDGE_IDS)
def test_plain_matches_jax_oracle_at_the_gpu_edge_shapes(c, dt):
    # the GPU tests hold the kernel against this plain version
    arrs = _qkv(c, seed=c["Sk"] + c["dh"])
    kw = dict(causal=c["causal"], window=c["window"])
    y = _port(arrs, dt, **kw)
    assert y.shape == (c["B"], c["Sq"], c["H"], c["dh"])
    assert np.isfinite(y).all()
    want = _jax(j_ref, arrs, dt, **kw)
    assert np.abs(y - want).max() < TOL[dt]
    if dt == "bf16":                          # within one bf16 ulp
        assert (np.abs(y - want) <= 2.0 ** -7 * np.abs(want) + 2e-5).all()


# --- chip_smoke.py's readers of the flash build (no card needed) ----------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_ptxas_report_is_read_per_kernel():
    log = """ptxas info    : Compiling entry function '_Z3fooPf' for 'sm_90a'
ptxas info    : Function properties for _Z3fooPf
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 384 bytes cmem[0]
ptxas info    : Compiling entry function '_Z3barPf' for 'sm_90a'
ptxas info    : Function properties for _Z3barPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 204 registers, used 1 barriers, 384 bytes cmem[0]
"""
    assert _chip_smoke().ptxas_usage(log) == {
        "_Z3fooPf": dict(stack=8, spill_stores=4, spill_loads=4, registers=168),
        "_Z3barPf": dict(stack=0, spill_stores=0, spill_loads=0, registers=204)}


def test_sass_opcodes_are_counted_per_function():
    sass = """
\tcode for sm_90a
\t\tFunction : _Z3fooPf
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0020*/               @P0 HMMA.16816.F32.BF16 R4, R8, R14, R4 ;
        /*0030*/                   FMUL R2, R3, R4 ;  // HMMA in a comment
\t\tFunction : _Z3barPf
        /*0000*/                   FFMA R2, R3, R4, R5 ;
"""
    assert _chip_smoke().count_opcode(sass, "HMMA") == {"_Z3fooPf": 2, "_Z3barPf": 0}
