"""The port's dense decoder against the JAX package on the CPU.

Parameters and adapters are drawn by the JAX package (threefry streams
cannot be reproduced in torch) and carried across by
``checkpoint.bridge``; inputs come from numpy seeds.  Layers run at a
GQA config (n_kv_heads < n_heads) so the grouped-head path is held even
though llama2 is MHA; the model runs at llama2_7b.SMOKE.

Tolerance: f32 rtol = atol = 1e-5 on layers and 1e-4 on whole-model
hidden states and logits (the same f32 arithmetic summed in another
order by another BLAS, over a few layers); greedy tokens must be equal.
"""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.configs import llama2_7b as j_llama
from repro.core import dora as j_dora
from repro.core import peft as j_peft
from repro.launch import serve as j_serve
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import ArchConfig as JArch
from repro.utils import pytree as jpt
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import dora as t_dora
from repro_torch.core import peft as t_peft
from repro_torch.launch import serve as t_serve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import ArchConfig as TArch
from repro_torch.utils import pytree as tpt

ROOT = Path(__file__).resolve().parents[1]
GQA = dict(name="gqa-t", family="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=96, dtype="float32",
           lora_rank=4, lora_dropout=0.0)
J_GQA, T_GQA = JArch(**GQA), TArch(**GQA)
J_SMOKE = dataclasses.replace(j_llama.SMOKE, lora_dropout=0.0)
T_SMOKE = dataclasses.replace(get_smoke_config("llama2-7b"), lora_dropout=0.0)


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def np_(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x)


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(np_(got), np_(want), rtol=tol, atol=tol)


def _bump(tree, key, value):
    return jpt.tree_map_with_path(
        lambda p, x: x + value if p.endswith(key) else x, tree)


@pytest.fixture(scope="module")
def gqa_base():
    return JM.init_params(jax.random.PRNGKey(0), J_GQA)


@pytest.fixture(scope="module")
def gqa(gqa_base):
    """GQA base + decomposed adapter (nonzero B_mag, dA_dir, dB_mag), JAX
    side and port side."""
    base = gqa_base
    ad = j_peft.add_lora(base, J_GQA, jax.random.PRNGKey(1), decomposed=True)
    ad = _bump(_bump(_bump(ad, "B_mag", 0.5), "dB_mag", -0.2), "dA_dir", 0.01)
    merged = jpt.merge_trees(base, ad)
    return merged, to_port(merged)


def _layer0(tree):
    return jax.tree.map(lambda x: x[0], tree["blocks"]["sub0"])


def _layer0_t(tree):
    return tpt.tree_map(lambda x: x[0], tree["blocks"]["sub0"])


# ---------------------------------------------------------------------------
# configs, bridge, dora, peft
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["llama2-7b", "deepseek-7b", "granite-34b",
                                  "qwen3-32b", "gemma3-1b",
                                  "qwen3-moe-30b-a3b", "mixtral-8x22b",
                                  "mamba2-2.7b", "jamba-v0.1-52b",
                                  "qwen2-vl-2b", "seamless-m4t-large-v2"])
def test_configs_equal_the_reference(arch):
    from repro.configs import get_config as j_get, get_smoke_config as j_smoke
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(j_get(arch))
    assert (dataclasses.asdict(get_smoke_config(arch))
            == dataclasses.asdict(j_smoke(arch)))
    t_sb, t_tail, t_pat = get_config(arch).blocks_layout()
    j_sb, j_tail, j_pat = j_get(arch).blocks_layout()
    assert (t_sb, t_tail) == (j_sb, j_tail)
    assert ([dataclasses.astuple(s) for s in t_pat]
            == [dataclasses.astuple(s) for s in j_pat])


def test_unported_architectures_raise_not_implemented():
    """Every id of the reference's registry resolves in the port since
    A12e (qwen2-vl-2b and seamless-m4t-large-v2 were the last refused,
    with NotImplementedError); an unknown id still raises KeyError."""
    from repro.configs import ARCH_IDS as J_IDS
    from repro_torch.configs import ARCH_IDS as T_IDS
    assert sorted(T_IDS) == sorted(J_IDS)
    for arch in ("qwen2-vl-2b", "seamless-m4t-large-v2",
                 "qwen2_vl_2b", "seamless_m4t_large_v2"):
        assert get_config(arch).name == arch.replace("_", "-")
        assert get_smoke_config(arch).n_layers == 2
    with pytest.raises(KeyError):
        get_config("no-such-model")


def test_bridge_carries_bf16_leaves_bit_for_bit():
    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, 5)), jnp.bfloat16)
    tree = {"a": {"w": x, "n": jnp.arange(4, dtype=jnp.int32)}}
    out = to_port(tree)
    assert out["a"]["w"].dtype == torch.bfloat16
    assert out["a"]["n"].dtype == torch.int32
    np.testing.assert_array_equal(
        out["a"]["w"].view(torch.int16).numpy().view(np.uint16),
        np.asarray(x).view(np.uint16))
    f32 = params_from_numpy(jax.tree.map(np.asarray, tree), "cpu",
                            dtype=torch.float32)
    np.testing.assert_array_equal(f32["a"]["w"].numpy(),
                                  np.asarray(x.astype(jnp.float32)))


def test_dora_matches_reference():
    x = np.random.default_rng(1).normal(size=(2, 8, 4)).astype(np.float32)
    jm, jd = j_dora.decompose(jnp.asarray(x))
    tm, td = t_dora.decompose(torch.from_numpy(x))
    close(tm, jm, 1e-6)
    close(td, jd, 1e-6)
    c = {"A_dir": jd, "A_mag": jm, "B_dir": jd.swapaxes(-1, -2)[..., :4, :],
         "B_mag": jm[..., :4], "dA_dir": jd * 0.1, "dB_mag": jm[..., :4] * 2}
    ja, jb = j_dora.recompose_lora_pair(c)
    ta, tb = t_dora.recompose_lora_pair(
        {k: torch.from_numpy(np.array(v)) for k, v in c.items()})
    close(ta, ja, 1e-6)
    close(tb, jb, 1e-6)


@pytest.mark.parametrize("decomposed", [False, True])
def test_add_lora_matches_reference_layout(gqa_base, decomposed):
    base = gqa_base
    want = j_peft.add_lora(base, J_GQA, jax.random.PRNGKey(1),
                           decomposed=decomposed, rank=3)
    got = t_peft.add_lora(to_port(base), T_GQA,
                          torch.Generator().manual_seed(0),
                          decomposed=decomposed, rank=3)
    assert sorted(tpt.tree_paths(got)) == sorted(jpt.tree_paths(want))
    for p in tpt.tree_paths(got):
        assert tuple(tpt.tree_get(got, p).shape) == jpt.tree_get(want, p).shape
    if decomposed:       # B_mag = 0, unit-norm directions: ΔW = 0 exactly
        q = tpt.tree_get(got, "blocks/sub0/attn/q_proj")
        assert not q["B_mag"].any() and not q["dB_mag"].any()
        close(torch.linalg.vector_norm(q["B_dir"], dim=-1),
              np.ones((2, 3)), 1e-5)


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rms_norm_and_rope_match_reference():
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(16,)).astype(np.float32)
    close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(w)),
          JL.rms_norm(jnp.asarray(x), jnp.asarray(w)), 1e-6)
    pos = rng.integers(0, 40, size=(2, 5)).astype(np.int32)
    close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos)),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos)), 1e-5)


def _pooled(kind, d, o, r, L, rng):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    p = {"kernel": f(d, o) * 0.05,
         "pool_ranks": np.asarray([r, 1, 0, r - 1][:L], np.int32)}
    if kind == "pairs":
        p.update(pool_A=f(L, d, r) * 0.3, pool_B=f(L, r, o) * 0.3)
    else:
        p.update(bgmv_A_dir=f(d, r) * 0.3, bgmv_A_mag=f(d) ** 2,
                 bgmv_B_mag=f(r), bgmv_B_dir=f(r, o) * 0.3,
                 pool_dB_mag=f(L, r))
    return p


@pytest.mark.parametrize("branch", ["plain", "lora", "decomposed",
                                    "pooled_pairs", "pooled_mag"])
def test_linear_branches_match_reference(branch):
    rng = np.random.default_rng(3)
    d, o, r, L = 24, 20, 4, 4
    x = rng.normal(size=(4, 3, d)).astype(np.float32)
    idx = None
    if branch == "plain":
        p = {"kernel": rng.normal(size=(d, o)).astype(np.float32)}
    elif branch == "lora":
        p = {"kernel": rng.normal(size=(d, o)).astype(np.float32),
             "lora_A": rng.normal(size=(d, r)).astype(np.float32),
             "lora_B": rng.normal(size=(r, o)).astype(np.float32)}
    elif branch == "decomposed":
        p = {"kernel": rng.normal(size=(d, o)).astype(np.float32),
             "A_dir": rng.normal(size=(d, r)).astype(np.float32),
             "A_mag": rng.uniform(0.5, 1.5, size=(d,)).astype(np.float32),
             "B_dir": rng.normal(size=(r, o)).astype(np.float32),
             "B_mag": rng.normal(size=(r,)).astype(np.float32),
             "dA_dir": rng.normal(size=(d, r)).astype(np.float32) * 0.1,
             "dB_mag": rng.normal(size=(r,)).astype(np.float32) * 0.1}
    else:
        p = _pooled(branch.split("_")[1], d, o, r, L, rng)
        idx = np.asarray([0, 2, 1, 3], np.int32)
    want = JL.linear({k: jnp.asarray(v) for k, v in p.items()},
                     jnp.asarray(x), lora_scale=2.0,
                     adapter_idx=None if idx is None else jnp.asarray(idx))
    got = TL.linear({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), lora_scale=2.0,
                    adapter_idx=None if idx is None else torch.from_numpy(idx))
    close(got, want)


def test_linear_refuses_unported_paths():
    """FedALT's dual pair and the Houlsby adapter, which these layers
    refused until ROADMAP A8a, now run and match the reference (the
    fused flag leaves a raw pair on the plain path); what they still
    refuse (pooled leaves on the SSM mixer and the encoder) is held in
    tests/test_torch_ssm.py and tests/test_torch_multimodal.py."""
    rng = np.random.default_rng(6)

    def draw(shapes):                # N(0, 1 / fan_in), O(1) activations
        return {k: (rng.normal(size=v) / np.sqrt(v[0])).astype(np.float32)
                if isinstance(v, tuple) else draw(v)
                for k, v in shapes.items()}
    dual = draw({"kernel": (4, 4), "lora_A": (4, 2), "lora_B": (2, 4),
                 "local_A": (4, 2), "local_B": (2, 4)})
    x = rng.normal(size=(3, 4)).astype(np.float32)
    want = JL.linear(jax.tree.map(jnp.asarray, dual), jnp.asarray(x),
                     lora_scale=2.0)
    for fused in (False, True):
        close(TL.linear(params_from_numpy(dual, "cpu"), torch.from_numpy(x),
                        lora_scale=2.0, fused=fused), want)
    ffn = draw({"gate_proj": {"kernel": (64, 16)},
                "up_proj": {"kernel": (64, 16)},
                "down_proj": {"kernel": (16, 64)},
                "adapter_down": (64, 3), "adapter_up": (3, 64)})
    # gelu's inputs of a few units, where its tanh form (jax.nn.gelu's
    # default) and the exact one differ by up to 5e-4
    ffn["adapter_down"] *= 6.0
    h = rng.normal(size=(1, 2, 64)).astype(np.float32)
    close(TL.dense_ffn(params_from_numpy(ffn, "cpu"), torch.from_numpy(h),
                       T_GQA),
          JL.dense_ffn(jax.tree.map(jnp.asarray, ffn), jnp.asarray(h), J_GQA))


def test_attention_prefill_with_cache_matches_reference(gqa):
    jtree, ttree = gqa
    x = np.random.default_rng(4).normal(size=(2, 7, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7), (2, 7)).astype(np.int32)
    jy, jc = JL.attention(_layer0(jtree)["attn"], jnp.asarray(x),
                          jnp.asarray(pos), J_GQA, lora_scale=8.0,
                          return_cache=True, cache_len=12)
    ty, tc = TL.attention(_layer0_t(ttree)["attn"], torch.from_numpy(x),
                          torch.from_numpy(pos), T_GQA, lora_scale=8.0,
                          return_cache=True, cache_len=12)
    close(ty, jy)
    assert tuple(tc["k"].shape) == jc["k"].shape == (2, 12, 2, 16)
    close(tc["k"], jc["k"])
    close(tc["v"], jc["v"])


@pytest.mark.parametrize("per_row", [False, True], ids=["scalar", "per_row"])
def test_attention_decode_matches_reference(gqa, per_row):
    jtree, ttree = gqa
    rng = np.random.default_rng(5)
    B, Sc = 3, 10
    x = rng.normal(size=(B, 1, 64)).astype(np.float32)
    ck = rng.normal(size=(B, Sc, 2, 16)).astype(np.float32)
    cv = rng.normal(size=(B, Sc, 2, 16)).astype(np.float32)
    if per_row:             # one row past the buffer: its write is dropped
        idx = np.asarray([2, 9, 12], np.int32)
        pos = idx[:, None]
    else:
        idx = np.asarray(6, np.int32)
        pos = np.full((B, 1), 6, np.int32)
    jy, jc = JL.attention(_layer0(jtree)["attn"], jnp.asarray(x),
                          jnp.asarray(pos), J_GQA, lora_scale=8.0,
                          cache={"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
                          cache_index=jnp.asarray(idx))
    tcache = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    ty, tc = TL.attention(_layer0_t(ttree)["attn"], torch.from_numpy(x),
                          torch.from_numpy(pos), T_GQA, lora_scale=8.0,
                          cache=tcache,
                          cache_index=torch.from_numpy(idx) if per_row
                          else int(idx))
    assert tc is tcache                 # written in place
    close(ty, jy)
    close(tc["k"], jc["k"])
    close(tc["v"], jc["v"])


def test_dense_ffn_matches_reference(gqa):
    jtree, ttree = gqa
    x = np.random.default_rng(6).normal(size=(2, 5, 64)).astype(np.float32)
    close(TL.dense_ffn(_layer0_t(ttree)["mlp"], torch.from_numpy(x), T_GQA),
          JL.dense_ffn(_layer0(jtree)["mlp"], jnp.asarray(x), J_GQA))


# ---------------------------------------------------------------------------
# the SMOKE model
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=["backbone", "decomposed"])
def smoke(request):
    base = JM.init_params(jax.random.PRNGKey(0), J_SMOKE)
    tree = base
    if request.param == "decomposed":
        ad = j_peft.add_lora(base, J_SMOKE, jax.random.PRNGKey(1),
                             decomposed=True)
        tree = jpt.merge_trees(base, _bump(_bump(ad, "B_mag", 0.25),
                                           "dB_mag", 0.1))
    return tree, to_port(tree)


def test_forward_prefill_decode_match_reference(smoke):
    jtree, ttree = smoke
    toks = np.random.default_rng(7).integers(
        0, J_SMOKE.vocab_size, size=(2, 9)).astype(np.int32)
    jh, _, _ = JM.forward(jtree, {"tokens": jnp.asarray(toks)}, J_SMOKE)
    th, _, _ = TM.forward(ttree, {"tokens": torch.from_numpy(toks)}, T_SMOKE)
    close(th, jh, 1e-4)
    jl, jc = JM.prefill(jtree, {"tokens": jnp.asarray(toks)}, J_SMOKE,
                        cache_len=12)
    tl, tc = TM.prefill(ttree, {"tokens": torch.from_numpy(toks)}, T_SMOKE,
                        cache_len=12)
    close(tl, jl, 1e-4)
    close(tc["blocks"]["sub0"]["attn"]["k"], jc["blocks"]["sub0"]["attn"]["k"],
          1e-4)
    tok = np.asarray([3, 77], np.int32)
    jl, _ = JM.decode_step(jtree, jnp.asarray(tok), jc, jnp.asarray(9),
                           J_SMOKE)
    tl, _ = TM.decode_step(ttree, torch.from_numpy(tok), tc, 9, T_SMOKE)
    close(tl, jl, 1e-4)


def test_greedy_generate_matches_reference(smoke):
    jtree, ttree = smoke
    toks = np.random.default_rng(8).integers(
        0, J_SMOKE.vocab_size, size=(2, 10)).astype(np.int32)
    want = j_serve.greedy_generate(jtree, {"tokens": jnp.asarray(toks)},
                                   J_SMOKE, n_new=8)
    got = t_serve.greedy_generate(ttree, {"tokens": toks}, T_SMOKE, n_new=8,
                                  device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    ref = t_serve.greedy_generate_reference(ttree, {"tokens": toks}, T_SMOKE,
                                            n_new=8, device="cpu")
    assert torch.equal(ref, got)


def test_argmax_takes_the_first_index_on_ties():
    logits = torch.tensor([[0.0, 2.0, 2.0, 1.0], [5.0, 5.0, 5.0, 5.0]],
                          dtype=torch.bfloat16).float()
    got = TM.argmax_first(logits)
    assert got.tolist() == np.asarray(jnp.argmax(jnp.asarray(
        logits.numpy()), axis=-1)).tolist() == [1, 0]


# ---------------------------------------------------------------------------
# entry points: the card by default, no silent fallback, no JAX
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the no-card refusal cannot be shown")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_params(torch.Generator().manual_seed(0), T_SMOKE)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TM.init_cache(T_SMOKE, 1, 4)


# qk-norm, sliding windows and local/global layers (tests/
# test_torch_dense_attention.py), MoE (tests/test_torch_moe.py), the SSM
# and hybrid families (tests/test_torch_ssm.py), and since A12e M-RoPE,
# the frontends and the encoder-decoder (tests/test_torch_multimodal.py)
# are ported: the four changes that were refused with NotImplementedError
# now build, each with the layout the reference's init_params gives it
@pytest.mark.parametrize("change,item", [
    (dict(mrope=True), "A12"), (dict(frontend="vision"), "A12"),
    (dict(n_enc_layers=2), "A12"), (dict(family="vlm"), "A12"),
])
def test_unported_features_raise_not_implemented(change, item):
    cfg = dataclasses.replace(T_SMOKE, **change)
    jcfg = dataclasses.replace(J_SMOKE, **change)
    got = TM.init_params(torch.Generator().manual_seed(0), cfg,
                         device="cpu")
    jtree = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                  jcfg))
    want = {p: tuple(x.shape) for p, x in zip(jpt.tree_paths(jtree),
                                              jax.tree.leaves(jtree))}
    assert {p: tuple(x.shape)
            for p, x in tpt.tree_leaves_with_path(got)} == want, item
    assert ("encoder" in got) == bool(cfg.n_enc_layers)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(f.name, m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert bad == []
