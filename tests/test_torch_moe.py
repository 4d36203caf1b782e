"""Mixture of experts in the port against the JAX package, on the CPU:
the router, the sort + capacity grouping, the grouped expert SwiGLU and
the combine (``layers.moe_*``), the aux loss through ``forward`` and
``loss_and_metrics``, and the SMOKE configs of qwen3-moe-30b-a3b and
mixtral-8x22b (sliding window, and its split expert slots at
``ep_fsplit = 2``) served and trained.

Parameters are drawn by the JAX package (or from numpy seeds) and
carried across by ``checkpoint.bridge``; inputs come from numpy seeds.
The JAX runs are shared through module fixtures, and the port's
``FedSim`` runs on one intra-op thread.

Tolerances (f32 arithmetic summed in another order by another BLAS):
- top-k indices, the grouping's slot rows (``dest``), its drops
  (``keep``) and token order equal; router weights within 1e-6, the
  grouped rows equal (copies); one MoE layer's output within 1e-5 of
  max |y| at every capacity factor and split; aux within 1e-6;
- hidden states, prefill logits and caches, per-row decode logits within
  1e-4 of max |value| over the SMOKE configs' 2 layers; greedy and
  ``ServeEngine`` tokens equal;
- the loss, the ce / aux split and the adapter gradients within 1e-5;
- the ``run_federated`` leaves by ``tests/test_torch_fed_methods.py``'s
  AdamW-eps rule against the port's f64 run.
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.configs import get_config as j_get, get_smoke_config as j_smoke
from repro.core import fedlora as j_fedlora
from repro.core import peft as j_peft
from repro.data import loader as j_loader
from repro.data import partition as j_part
from repro.data import synthetic as j_syn
from repro.fed.simulate import FedHyper as JHyper
from repro.launch import serve as j_serve
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import ArchConfig as JArch
from repro.serve import AdapterStore as JStore, ServeEngine as JEngine
from repro.utils import pytree as jpt
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_config as t_get
from repro_torch.configs import get_smoke_config as t_smoke
from repro_torch.core import fedlora as t_fedlora
from repro_torch.core import methods as t_methods
from repro_torch.core import peft as t_peft
from repro_torch.data import loader as t_loader
from repro_torch.data import partition as t_part
from repro_torch.data import synthetic as t_syn
from repro_torch.fed.simulate import FedHyper as THyper
from repro_torch.launch import serve as t_serve
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models.config import ArchConfig as TArch
from repro_torch.serve import AdapterStore as TStore, ServeEngine as TEngine
from repro_torch.utils import pytree as tpt
from test_torch_fed_methods import assert_leaves

ARCHS = ("qwen3-moe-30b-a3b", "mixtral-8x22b")
PROMPT = {"mixtral-8x22b": 48}  # + 32 new tokens wraps the 64-slot ring
N_NEW = 32
# one MoE layer: tests/test_moe.py's config
LAYER = dict(name="m", family="moe", n_layers=2, d_model=32, n_heads=2,
             n_kv_heads=1, d_ff=64, vocab_size=64, dtype="float32",
             n_experts=4, top_k=2)
CAPACITIES = (8.0, 1.25, 0.25)          # drop-free, published, tight
SPLITS = (1, 2)


def configs(arch, **kw):
    kw = dict(lora_dropout=0.0, **kw)
    return (dataclasses.replace(j_smoke(arch), **kw),
            dataclasses.replace(t_smoke(arch), **kw))


def to_port(tree, dtype=None):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu", dtype)


def np_(x):
    return x.detach().float().numpy() if torch.is_tensor(x) else np.asarray(x)


def rel(got, want):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def flat(tree):
    if all(torch.is_tensor(x) for x in tpt.tree_leaves(tree)):
        return {p: x.detach().numpy()
                for p, x in tpt.tree_leaves_with_path(tree)}
    return dict(zip(jpt.tree_paths(tree), map(np.asarray,
                                              jax.tree.leaves(tree))))


def tokens(vocab, B, S, seed):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)).astype(
        np.int32)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# configs and the parameter layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_layout_equal_the_reference(arch):
    """ARCH and SMOKE field for field and their block layout; the SMOKE
    tree (and mixtral's at ep_fsplit 2, in slot layout) with the
    reference's paths, shapes and dtypes: the f32 router, the expert
    slots in the model dtype."""
    assert dataclasses.asdict(t_get(arch)) == dataclasses.asdict(j_get(arch))
    for t, j in ((t_get(arch), j_get(arch)), configs(arch)[::-1]):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
        (ts, tt, tp), (js, jt, jp) = t.blocks_layout(), j.blocks_layout()
        assert (ts, tt) == (js, jt)
        assert ([dataclasses.astuple(s) for s in tp]
                == [dataclasses.astuple(s) for s in jp])
    splits = (1, 2) if arch == "mixtral-8x22b" else (1,)
    for fs in splits:
        jc, tc = configs(arch, ep_fsplit=fs)
        jtree = jax.eval_shape(lambda: JM.init_params(jax.random.PRNGKey(0),
                                                      jc))
        want = {p: (tuple(x.shape), str(x.dtype))
                for p, x in zip(jpt.tree_paths(jtree), jax.tree.leaves(jtree))}
        ttree = TM.init_params(torch.Generator().manual_seed(0), tc,
                               device="meta")
        got = {p: (tuple(x.shape), str(x.dtype).replace("torch.", ""))
               for p, x in tpt.tree_leaves_with_path(ttree)}
        assert got == want
        assert got["blocks/sub0/moe/experts/gate"][0] == (
            tc.n_layers, tc.n_experts * fs, tc.d_model, tc.d_ff // fs)


def test_full_size_draw_makes_one_layer_f32_at_a_time(monkeypatch):
    """init_params draws every stacked leaf layer by layer: no f32 draw
    holds more than one layer's expert stack (E·fsplit, D, F/fsplit)."""
    drawn = []
    real = TM._normal

    def spy(g, shape, scale, dtype, device):
        drawn.append(tuple(shape))
        return real(g, shape, scale, dtype, device)
    monkeypatch.setattr(TM, "_normal", spy)
    _, tc = configs("mixtral-8x22b", ep_fsplit=2, n_layers=3)
    TM.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    one = tc.n_experts * 2 * tc.d_model * tc.d_ff // 2
    assert (tc.n_experts * 2, tc.d_model, tc.d_ff // 2) in drawn
    assert max(int(np.prod(s)) for s in drawn[1:-1]) == one   # not embed/head


# ---------------------------------------------------------------------------
# one MoE layer: router, grouping, experts, combine
# ---------------------------------------------------------------------------

def inputs(seed, *shape):
    return (np.random.default_rng(seed).normal(size=shape) + 0.5).astype(
        np.float32)


def layer_params(seed, fsplit, d=32, E=4, F=64):
    rng = np.random.default_rng(seed)
    n = lambda *s: (rng.normal(size=s) * 0.2).astype(np.float32)  # noqa: E731
    # expert 0's column leans toward inputs of positive mean (``inputs``):
    # it is in nearly every token's top-k, so capacity 1.25 drops picks
    router = n(d, E)
    router[:, 0] += 0.5
    return {"router": {"kernel": router},
            "experts": {"gate": n(E * fsplit, d, F // fsplit),
                        "up": n(E * fsplit, d, F // fsplit),
                        "down": n(E * fsplit, F // fsplit, d)}}


@pytest.mark.parametrize("fsplit", SPLITS)
@pytest.mark.parametrize("cf", CAPACITIES)
def test_moe_layer_matches_reference(cf, fsplit):
    """At each capacity factor and split: the router's indices, weights
    and aux; the grouping's slot rows, drops and token order and the
    grouped rows; the layer's output and aux."""
    jc = JArch(**LAYER, capacity_factor=cf, ep_fsplit=fsplit)
    tc = TArch(**LAYER, capacity_factor=cf, ep_fsplit=fsplit)
    p = layer_params(int(cf * 8) + fsplit, fsplit)
    x = inputs(1, 2, 16, 32)
    jp, tp = jax.tree.map(jnp.asarray, p), jax.tree.map(torch.as_tensor, p)
    xt_j, xt_t = jnp.asarray(x.reshape(32, 32)), torch.as_tensor(x).reshape(
        32, 32)
    ji, jw, ja = JL.moe_router(jp, xt_j, jc, fsplit)
    ti, tw, ta = TL.moe_router(tp, xt_t, tc)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert rel(tw, jw) <= 1e-6 and abs(float(ta) - float(ja)) <= 1e-6
    E_slots = 4 * fsplit
    C = TL.moe_capacity(tc, 32)
    assert C == min(max(1, int(np.ceil(2 * 32 * cf / 4))), 32)
    jxg, (jst, _, jdest, jkeep) = JL._group_by_expert(xt_j, ji, jw, E_slots,
                                                      C, fsplit)
    txg, (order, _, tdest, tkeep) = TL._group_by_expert(xt_t, ti, tw,
                                                        E_slots, C, fsplit)
    k = 2 * fsplit
    np.testing.assert_array_equal(tdest.numpy(), np.asarray(jdest))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal((order // k).numpy(), np.asarray(jst))
    np.testing.assert_array_equal(txg.numpy(), np.asarray(jxg))
    assert bool(tkeep.all()) == (cf == 8.0)     # 1.25 and 0.25 drop picks
    jy, ja = JL.moe_ffn_local(jp, jnp.asarray(x), jc)
    ty, ta = TL.moe_ffn_local(tp, torch.as_tensor(x), tc)
    assert rel(ty, jy) <= 1e-5 and abs(float(ta) - float(ja)) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_router_breaks_ties_toward_the_lower_index(dtype):
    """Router columns 4-7 copy columns 0-3 and one token's logits are all
    equal: every top-3 has tied logits, and the port picks what
    ``lax.top_k`` picks on the same logits (the lower index first);
    ``torch.topk`` promises no order."""
    cfg = TArch(**dict(LAYER, n_experts=8, top_k=3))
    rng = np.random.default_rng(5)
    half = rng.normal(size=(32, 4)).astype(np.float32)
    router = np.concatenate([half, half], axis=1)
    xt = rng.normal(size=(64, 32)).astype(np.float32)
    xt[0] = 0.0                                  # all eight logits 0
    dt = getattr(torch, dtype)
    x = torch.as_tensor(xt).to(dt)
    top_i, _, _ = TL.moe_router({"router": {"kernel": torch.as_tensor(
        router)}}, x, cfg)
    logits = (x @ torch.as_tensor(router).to(dt)).float().numpy()
    _, want = jax.lax.top_k(jnp.asarray(logits), 3)
    np.testing.assert_array_equal(top_i.numpy(), np.asarray(want))
    np.testing.assert_array_equal(top_i[0].numpy(), [0, 1, 2])
    picked = np.take_along_axis(logits, top_i.numpy(), -1)
    assert (picked[:, 0] == picked[:, 1]).sum() > 1      # ties were picked
    if dtype == "float32":
        # the top logit's two copies, lower first, then the second's
        # lower copy (a bf16 product may round a column and its copy
        # apart)
        ti = top_i[1:].numpy()
        assert (ti[:, 0] < 4).all() and (ti[:, 1] == ti[:, 0] + 4).all()
        assert (ti[:, 2] < 4).all()


def test_grouped_equals_the_dense_oracle_and_the_split_layout():
    """Drop-free (capacity 8): the grouped layer equals
    ``moe_ffn_dense_ref`` (every expert on every token), which equals
    the reference's oracle; the fsplit-1 experts re-laid into 2 slots
    each (gate / up split along d_ff, down along its rows) give the
    same output (tests/test_moe.py's re-layout)."""
    tc1 = TArch(**LAYER, capacity_factor=8.0)
    tc2 = dataclasses.replace(tc1, ep_fsplit=2)
    p = layer_params(3, 1)
    tp = jax.tree.map(torch.as_tensor, p)
    x = torch.as_tensor(inputs(2, 2, 16, 32))
    y, aux = TL.moe_ffn_local(tp, x, tc1)
    yd, auxd = TL.moe_ffn_dense_ref(tp, x, tc1)
    jd, jauxd = JL.moe_ffn_dense_ref(jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x.numpy()),
                                     JArch(**LAYER, capacity_factor=8.0))
    assert rel(y, yd) <= 1e-5 and rel(yd, jd) <= 1e-5
    assert abs(float(aux) - float(auxd)) <= 1e-7
    assert abs(float(auxd) - float(jauxd)) <= 1e-6
    E, D, F = 4, 32, 64

    def relay_up(w):
        return w.reshape(E, D, 2, F // 2).permute(0, 2, 1, 3).reshape(
            2 * E, D, F // 2)

    def relay_down(w):
        return w.reshape(2 * E, F // 2, D)
    e = tp["experts"]
    p2 = {"router": tp["router"],
          "experts": {"gate": relay_up(e["gate"]), "up": relay_up(e["up"]),
                      "down": relay_down(e["down"])}}
    y2, aux2 = TL.moe_ffn_local(p2, x, tc2)
    assert rel(y2, y) <= 1e-5 and float(aux2) == float(aux)


def test_capacity_drops_zero_a_pick_and_depend_on_the_batch():
    """At capacity 0.25 a token whose picks all overflow gets 0, and a
    row's output changes with the rows beside it (the reference's
    semantics); drop-free, a row's output is its own."""
    p = jax.tree.map(torch.as_tensor, layer_params(4, 1))
    x = torch.as_tensor(inputs(6, 4, 8, 32))
    tight = TArch(**LAYER, capacity_factor=0.25)
    y, _ = TL.moe_ffn_local(p, x, tight)
    assert (y.reshape(-1, 32).abs().sum(-1) == 0).any()
    assert not torch.allclose(TL.moe_ffn_local(p, x[:1], tight)[0], y[:1])
    free = TArch(**LAYER, capacity_factor=8.0)
    assert rel(TL.moe_ffn_local(p, x[:1], free)[0],
               TL.moe_ffn_local(p, x, free)[0][:1]) <= 1e-6


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

j_forward = jax.jit(JM.forward, static_argnames="cfg")
j_prefill = jax.jit(JM.prefill, static_argnames=("cfg", "cache_len"))
j_greedy = jax.jit(j_serve.greedy_generate, static_argnames=("cfg", "n_new"))
# (arch, config overrides) whose hidden states and aux are held: the
# SMOKE configs (drop-free), qwen3-moe at the published capacity (the
# same drops), mixtral's split slots
HIDDEN = (("qwen3-moe-30b-a3b", {}), ("mixtral-8x22b", {}),
          ("qwen3-moe-30b-a3b", {"capacity_factor": 1.25}),
          ("mixtral-8x22b", {"ep_fsplit": 2}))
HIDDEN_IDS = ["qwen3-moe", "mixtral", "qwen3-moe-cf1.25", "mixtral-fsplit2"]


@pytest.fixture(scope="module")
def models():
    """Per config: both configs, the JAX params and their port, the
    prompt, and the JAX package's prefill logits and cache and greedy
    tokens; per ``HIDDEN`` case its hidden states and aux."""
    out = {}
    for arch in ARCHS:
        jc, tc = configs(arch)
        jp = JM.init_params(jax.random.PRNGKey(1), jc)
        S = PROMPT.get(arch, 40)
        prompt = tokens(jc.vocab_size, 2, S, seed=5)
        logits, cache = j_prefill(jp, {"tokens": jnp.asarray(prompt)},
                                  cfg=jc, cache_len=S + N_NEW)
        greedy = np.asarray(j_greedy(jp, {"tokens": jnp.asarray(prompt)},
                                     cfg=jc, n_new=N_NEW))
        out[arch] = dict(jc=jc, tc=tc, jp=jp, tp=to_port(jp), prompt=prompt,
                         logits=np.asarray(logits),
                         cache=jax.tree.map(np.asarray, cache), greedy=greedy)
    hidden = {}
    tok = tokens(512, 2, 48, seed=7)
    for i, (arch, kw) in enumerate(HIDDEN):
        jc, tc = configs(arch, **kw)
        jp = (out[arch]["jp"] if "ep_fsplit" not in kw
              else JM.init_params(jax.random.PRNGKey(2), jc))
        h, _, aux = j_forward(jp, {"tokens": jnp.asarray(tok)}, cfg=jc)
        hidden[HIDDEN_IDS[i]] = (tc, to_port(jp), np.asarray(h), float(aux))
    out["hidden"] = (tok, hidden)
    return out


@pytest.mark.parametrize("case", HIDDEN_IDS)
def test_hidden_states_and_aux_match_reference(models, case):
    tok, hidden = models["hidden"]
    tc, tp, want, want_aux = hidden[case]
    with torch.no_grad():
        got, _, aux = TM.forward(tp, {"tokens": torch.as_tensor(tok)}, tc)
    assert rel(got, want) <= 1e-4
    assert abs(float(aux) - want_aux) <= 1e-6 * tc.n_layers
    assert float(aux) > 0.5 * tc.n_layers      # E·Σ f·p ≈ 1 a layer


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_reference(models, arch):
    m = models[arch]
    S = m["prompt"].shape[1]
    with torch.no_grad():
        logits, cache = TM.prefill(m["tp"], {"tokens": torch.as_tensor(
            m["prompt"])}, m["tc"], cache_len=S + N_NEW)
    assert rel(logits, m["logits"]) <= 1e-4
    got, want = flat(cache), flat(m["cache"])
    assert set(got) == set(want)
    for p in want:
        assert rel(got[p], want[p]) <= 1e-4, p


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_tokens_match_reference(models, arch):
    """32 new tokens: mixtral's 48 + 32 positions wrap its 64-slot ring."""
    m = models[arch]
    got = t_serve.greedy_generate(m["tp"], {"tokens": m["prompt"]}, m["tc"],
                                  n_new=N_NEW, device="cpu")
    np.testing.assert_array_equal(got.numpy(), m["greedy"])


def test_per_row_decode_matches_reference_across_the_wrap(models):
    """mixtral, two rows at their own positions ((B,) cache_index), 24
    steps from a prefilled cache: rows run 48-71 and 56-79, both wrap
    the ring; logits every step and the caches at the end."""
    m = models["mixtral-8x22b"]
    S = m["prompt"].shape[1]
    offset = np.array([0, 8])
    jlog, jcache = j_prefill(m["jp"], {"tokens": jnp.asarray(m["prompt"])},
                             cfg=m["jc"], cache_len=S + N_NEW)
    with torch.no_grad():
        _, tcache = TM.prefill(m["tp"], {"tokens": torch.as_tensor(
            m["prompt"])}, m["tc"], cache_len=S + N_NEW)
    tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    j_step = jax.jit(JM.decode_step, static_argnames="cfg")
    for i in range(24):
        idx = (S + offset + i).astype(np.int32)
        jlog, jcache = j_step(m["jp"], jnp.asarray(tok), jcache,
                              jnp.asarray(idx), cfg=m["jc"])
        with torch.no_grad():
            tlog, tcache = TM.decode_step(m["tp"], torch.as_tensor(tok),
                                          tcache, torch.as_tensor(idx),
                                          m["tc"])
        assert rel(tlog, jlog) <= 1e-4, i
        tok = np.asarray(jnp.argmax(jlog, axis=-1)).astype(np.int32)
    got, want = flat(tcache), flat(jcache)
    for p in want:
        assert rel(got[p], want[p]) <= 1e-4, p


def _shared_adapter(m, seed):
    """A decomposed rank-4 adapter on q/v with B_mag moved off 0, so that
    every factor carries a gradient and changes the model."""
    shared = j_peft.add_lora(m["jp"], m["jc"], jax.random.PRNGKey(seed),
                             decomposed=True)
    return jpt.tree_map_with_path(
        lambda p, x: x + 0.25 if p.endswith("B_mag") else x, shared)


def test_serve_engine_tokens_match_reference(models):
    """qwen3-moe (drop-free SMOKE capacity): six requests of three
    dora_mag tenants and the null tenant through three rows, ragged
    prompts and n_new: the same tokens as the JAX engine, through
    ``bgmv_mag``'s plain version on the CPU."""
    m = models["qwen3-moe-30b-a3b"]
    shared = _shared_adapter(m, 3)
    rng = np.random.default_rng(8)
    deltas = [jax.tree.map(lambda x: jnp.asarray(
        rng.normal(0, 0.3, size=x.shape), jnp.float32),
        jpt.filter_tree(shared, lambda p: p.endswith("dB_mag")))
        for _ in range(3)]
    js = JStore(m["jp"], m["jc"], n_slots=3, kind="dora_mag", shared=shared)
    ts = TStore(m["tp"], m["tc"], n_slots=3, kind="dora_mag",
                shared=to_port(shared), device="cpu")
    for i, d in enumerate(deltas):
        js.register(f"t{i}", d)
        ts.register(f"t{i}", to_port(d))
    kw = dict(max_rows=3, max_prompt_len=12, max_len=24, decode_chunk=3)
    je = JEngine(m["jp"], m["jc"], js, **kw)
    te = TEngine(m["tp"], m["tc"], ts, device="cpu", **kw)
    reqs = [(None if i == 3 else f"t{i % 3}",
             rng.integers(0, m["jc"].vocab_size, size=int(L)).astype(np.int32),
             int(k)) for i, (L, k) in enumerate(zip(
                 rng.integers(3, 13, size=6), rng.integers(2, 9, size=6)))]
    jr = [je.submit(*r) for r in reqs]
    tr = [te.submit(*r) for r in reqs]
    jout, tout = je.run(), te.run()
    for (_, _, k), a, b in zip(reqs, jr, tr):
        assert tout[b].shape == (k,)
        np.testing.assert_array_equal(tout[b], jout[a])


def test_pooled_greedy_equals_merged(models):
    """qwen3-moe drop-free: two dora_mag tenants in one batch through
    greedy_generate with adapter_idx equal, row by row, their merged
    models' tokens (at the drop-free capacity a row's routing is its
    own)."""
    m = models["qwen3-moe-30b-a3b"]
    shared = to_port(_shared_adapter(m, 4))
    g = torch.Generator().manual_seed(2)
    store = TStore(m["tp"], m["tc"], n_slots=2, kind="dora_mag",
                   shared=shared, device="cpu")
    deltas = [tpt.tree_map(lambda x: torch.randn(x.shape, generator=g),
                           tpt.filter_tree(shared,
                                           lambda p: p.endswith("/dB_mag")))
              for _ in range(2)]
    for t, d in enumerate(deltas):
        store.register(f"t{t}", d)
    idx = torch.tensor([store.slot_of("t0"), store.slot_of("t1")])
    pooled = t_serve.greedy_generate(
        tpt.merge_trees(m["tp"], store.overlay()), {"tokens": m["prompt"]},
        m["tc"], n_new=8, adapter_idx=idx, device="cpu")
    for t, d in enumerate(deltas):
        merged = t_serve.greedy_generate(
            tpt.merge_trees(m["tp"], tpt.merge_trees(shared, d)),
            {"tokens": m["prompt"][t:t + 1]}, m["tc"], n_new=8, device="cpu")
        assert torch.equal(pooled[t:t + 1], merged), t


# ---------------------------------------------------------------------------
# training: the aux in the loss, remat, run_federated
# ---------------------------------------------------------------------------

def test_loss_metrics_and_adapter_gradients_match_reference(models):
    """qwen3-moe at the published capacity (drops), a decomposed adapter
    on q/v: loss = ce + 0.01·aux with the reference's metric keys, ce
    and aux; every adapter gradient (the aux reaches q/v through the
    hidden states) within 1e-5 of its max."""
    m = models["qwen3-moe-30b-a3b"]
    jc, tc = configs("qwen3-moe-30b-a3b", capacity_factor=1.25)
    shared = _shared_adapter(m, 5)
    tok = tokens(jc.vocab_size, 2, 40, seed=9)
    mask = (np.arange(40)[None] >= np.array([[4], [10]])).astype(np.float32)
    jb = {"tokens": jnp.asarray(tok), "loss_mask": jnp.asarray(mask)}

    def j_loss(ad):
        return JM.loss_and_metrics(jpt.merge_trees(m["jp"], ad), jb, jc)
    (jl, jmet), jg = jax.jit(jax.value_and_grad(j_loss, has_aux=True))(
        shared)
    ad = tpt.tree_map(lambda x: x.clone().requires_grad_(True),
                      to_port(shared))
    tl, tmet = TM.loss_and_metrics(tpt.merge_trees(m["tp"], ad), {
        "tokens": torch.as_tensor(tok), "loss_mask": torch.as_tensor(mask)},
        tc)
    tl.backward()
    assert set(tmet) == set(jmet)
    for k in ("ce", "aux", "acc", "n_tok"):
        assert abs(float(tmet[k].detach()) - float(jmet[k])) <= 1e-5 * max(
            1.0, abs(float(jmet[k]))), k
    assert abs(float(tl.detach()) - float(jl)) <= 1e-5 * float(jl)
    assert float(tl.detach()) == pytest.approx(
        float(tmet["ce"].detach()) + 0.01 * float(tmet["aux"].detach()),
        rel=1e-6)
    want = flat(jg)
    for p, x in tpt.tree_leaves_with_path(ad):
        assert rel(x.grad, want[p]) <= 1e-5, p


@pytest.mark.parametrize("remat", [True, "dots"])
def test_remat_keeps_the_aux_and_the_gradients(models, remat):
    """Each superblock under ``torch.utils.checkpoint``: the aux comes out
    of the checkpointed body, and the loss, aux and adapter gradients
    equal the plain forward's bit for bit (mixtral, split slots)."""
    _, tc = configs("mixtral-8x22b", ep_fsplit=2, capacity_factor=1.25)
    base = TM.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
    ad = t_peft.add_lora(base, tc, torch.Generator().manual_seed(1),
                         decomposed=True)
    ad = tpt.tree_map_with_path(
        lambda p, x: x + 0.5 if p.endswith("B_mag") else x, ad)
    batch = {"tokens": torch.as_tensor(tokens(tc.vocab_size, 2, 80, 3),
                                       dtype=torch.int64),
             "loss_mask": torch.ones(2, 80)}
    out = {}
    for r in (False, remat):
        leaves = tpt.tree_map(lambda x: x.clone().requires_grad_(True), ad)
        loss, met = TM.loss_and_metrics(tpt.merge_trees(base, leaves), batch,
                                        tc, remat=r)
        loss.backward()
        out[r] = (loss, met["aux"], [x.grad for x in tpt.tree_leaves(leaves)])
    assert float(out[False][1].detach()) > 0
    assert torch.equal(out[False][0], out[remat][0])
    assert torch.equal(out[False][1], out[remat][1])
    for a, b in zip(out[False][2], out[remat][2]):
        assert torch.equal(a, b)


C, B, S = 4, 2, 24
FED = dict(n_clients=C, rounds=1, local_steps=2, batch=B, seq_len=S,
           global_steps=1, personal_steps=1, lr=3e-3, server_lr=2e-3,
           seed=0)


def _capturing(monkeypatch, module):
    """Swap ``module.FedSim`` for a subclass that records each instance,
    the metrics of its local rounds, and the client adapters before and
    after each ``aggregate``."""
    made = []

    class Captured(module.FedSim):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            self.round_mets = []
            made.append(self)

        def local_round(self, *a, **k):
            mets = super().local_round(*a, **k)
            self.round_mets.append(mets)
            return mets

        def aggregate(self, **kw):
            self.pre_aggregate = flat(self.client_adapters)
            self.aggregated = super().aggregate(**kw)
            return self.aggregated
    monkeypatch.setattr(module, "FedSim", Captured)
    return made


def test_run_federated_pipeline_matches_reference(models, monkeypatch):
    """fedlora_opt through both packages' run_federated at qwen3-moe's
    SMOKE config at the published capacity (per-client drops; the aux in
    every stage's loss): 4 dolly clients, 1 round of 2 steps, a stage-2
    and a stage-3 step.  The port starts from the reference's backbone
    and adapter, and runs again in f64 as the witness."""
    m = models["qwen3-moe-30b-a3b"]
    jc, tc = configs("qwen3-moe-30b-a3b", capacity_factor=1.25)
    jm = t_methods.get_method("fedlora_opt")

    def make(base, cfg, generator):
        from repro.core.methods import get_method as jget
        _, r_ad = jax.random.split(jax.random.PRNGKey(FED["seed"]))
        dt = tpt.tree_leaves(base)[0].dtype
        return tpt.tree_map(lambda x: x.to(dt), to_port(
            jget("fedlora_opt").make_adapter(m["jp"], jc, r_ad)))
    monkeypatch.setitem(t_methods._REGISTRY, "fedlora_opt",
                        dataclasses.replace(jm, make_adapter=make))
    j_sims = _capturing(monkeypatch, j_fedlora)
    t_sims = _capturing(monkeypatch, t_fedlora)

    def data(pkg, part):
        fam = pkg.make_dataset_family("dolly", vocab_size=jc.vocab_size)
        p = part.specialist_partition(C, 4)
        return ([pkg.SyntheticInstructionDataset(fam, p[c], client_seed=c)
                 for c in range(C)],
                pkg.SyntheticInstructionDataset(fam, np.ones(4) / 4,
                                                client_seed=99))
    j_ds, j_srv = data(j_syn, j_part)
    t_ds, t_srv = data(t_syn, t_part)
    want = j_fedlora.run_federated(
        jc, JHyper(method="fedlora_opt", **FED), j_ds, j_srv,
        j_loader.eval_batches(j_srv, B, S, 1, seed=11),
        [j_loader.client_batch(j_ds, np.random.default_rng(9), B, S)],
        base=m["jp"])
    runs = []
    for dt in (torch.float32, torch.float64):
        runs.append(t_fedlora.run_federated(
            tc, THyper(method="fedlora_opt", **FED), t_ds, t_srv,
            t_loader.eval_batches(t_srv, B, S, 1, seed=11, device="cpu"),
            [t_loader.client_batch(t_ds, np.random.default_rng(9), B, S,
                                   device="cpu")],
            base=to_port(m["jp"], dt), device="cpu"))
    (js,), (ts, t64) = j_sims, t_sims
    (jm_,), (tm_,) = js.round_mets, ts.round_mets
    assert set(tm_) == set(jm_) and "aux" in tm_
    for k in ("ce", "aux"):
        np.testing.assert_allclose(np_(tm_[k]), np.asarray(jm_[k]),
                                   rtol=1e-5, err_msg=k)
    (tg,), (jg,) = runs[0].history, want.history
    assert abs(tg["train_ce"] - jg["train_ce"]) <= 1e-5 * jg["train_ce"]
    assert abs(tg["ce"] - jg["ce"]) <= 1e-5 * jg["ce"]
    assert runs[0].comm_bytes == want.comm_bytes > 0
    assert_leaves(ts.pre_aggregate, js.pre_aggregate, t64.pre_aggregate,
                  "stage 1")
    assert_leaves(ts.aggregated, js.aggregated, t64.aggregated, "aggregate")
    assert_leaves(ts.client_adapters, js.client_adapters,
                  t64.client_adapters, "client adapters after run_federated")
