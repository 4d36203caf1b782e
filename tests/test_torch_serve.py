"""The port's serving path (AdapterStore → ServeEngine) on the CPU.

Against the JAX package: the store's pooled overlay leaf by leaf (both
kinds, mixed ranks, LRU eviction), the batcher, and the engine's tokens
for the same tenants and requests (continuous batching with more
requests than rows, mixed ranks, the null tenant).  Parameters and
adapters are drawn by the JAX package and carried across by
``checkpoint.bridge``.

Inside the port: a mixed batch through the pooled BGMV path equals
per-tenant merged generation.  Tokens must be identical.  Prefill logits
are bit-identical when the merged run has at least two rows; a one-row
merged run is held to 1e-5 instead, because torch's CPU matmul sends a
single row through a GEMV kernel that sums in another order than the
GEMM the R-row batch takes (the op order itself is the same).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro.configs import llama2_7b as j_llama
from repro.core import peft as j_peft
from repro.models import model as JM
from repro.serve import AdapterStore as JStore
from repro.serve import ContinuousBatcher as JBatcher
from repro.serve import ServeEngine as JEngine
from repro.utils import pytree as jpt
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import greedy_generate, merge_adapters
from repro_torch.models import model as TM
from repro_torch.serve import AdapterStore, ContinuousBatcher, ServeEngine
from repro_torch.utils import pytree as tpt

J_CFG = dataclasses.replace(j_llama.SMOKE, lora_dropout=0.0)
T_CFG = dataclasses.replace(get_smoke_config("llama2-7b"), lora_dropout=0.0)
RANKS = [2, 4, 8, 4, 2]


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def world():
    """JAX base, a rank-8 decomposed shared adapter (B_mag nonzero),
    per-tenant ΔB_M deltas and raw-LoRA trees at RANKS — JAX side and
    port side."""
    base = JM.init_params(jax.random.PRNGKey(0), J_CFG)
    shared = j_peft.add_lora(base, J_CFG, jax.random.PRNGKey(1),
                             decomposed=True, rank=8)
    shared = jpt.tree_map_with_path(
        lambda p, x: x + 0.25 if p.endswith("B_mag") else x, shared)
    rng = np.random.default_rng(0)
    deltas, loras = [], []
    for t, r in enumerate(RANKS):
        deltas.append(jax.tree.map(
            lambda x: jnp.asarray(rng.normal(0, 0.3, size=x.shape)
                                  * (np.arange(x.shape[-1]) < r), jnp.float32),
            jpt.filter_tree(shared, lambda p: p.endswith("dB_mag"))))
        lora = j_peft.add_lora(base, J_CFG, jax.random.PRNGKey(100 + t),
                               rank=r)
        loras.append(jpt.tree_map_with_path(
            lambda p, x: x * 50.0 if p.endswith("lora_B") else x, lora))
    return dict(j=dict(base=base, shared=shared, deltas=deltas, loras=loras),
                t=dict(base=to_port(base), shared=to_port(shared),
                       deltas=[to_port(d) for d in deltas],
                       loras=[to_port(lo) for lo in loras]))


def _stores(world, kind, n_slots):
    j, t = world["j"], world["t"]
    js = JStore(j["base"], J_CFG, n_slots=n_slots, kind=kind, rank=8,
                shared=j["shared"] if kind == "dora_mag" else None)
    ts = AdapterStore(t["base"], T_CFG, n_slots=n_slots, kind=kind, rank=8,
                      shared=t["shared"] if kind == "dora_mag" else None,
                      device="cpu")
    key = "deltas" if kind == "dora_mag" else "loras"
    for i, r in enumerate(RANKS):
        js.register(f"t{i}", j[key][i], rank=r)
        ts.register(f"t{i}", t[key][i], rank=r)
    return js, ts


@pytest.mark.parametrize("kind", ["dora_mag", "pairs"])
def test_overlay_matches_reference(world, kind):
    """Five tenants of mixed ranks through four slots (one LRU eviction):
    the same slots, ranks and pooled leaves as the JAX store."""
    js, ts = _stores(world, kind, n_slots=4)
    assert ts.tenants == js.tenants
    for name in ts.tenants:
        assert ts.slot_of(name) == js.slot_of(name)
        assert ts.rank_of(name) == js.rank_of(name)
    jo, to = js.overlay(), ts.overlay()
    assert sorted(tpt.tree_paths(to)) == sorted(jpt.tree_paths(jo))
    for p in tpt.tree_paths(to):
        got, want = tpt.tree_get(to, p), np.asarray(jpt.tree_get(jo, p))
        assert str(got.dtype).split(".")[-1] == str(want.dtype), p
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-7, atol=0,
                                   err_msg=p)


def test_batcher_matches_reference():
    jb, tb = JBatcher(3, 6, 12), ContinuousBatcher(3, 6, 12)
    rng = np.random.default_rng(1)
    for i in range(5):
        toks = rng.integers(0, 50, size=1 + i)
        assert jb.submit(f"t{i}", toks, 4) == tb.submit(f"t{i}", toks, 4)
    with pytest.raises(ValueError):
        tb.submit("x", np.zeros(7, np.int32), 1)
    ja, ta = jb.admit([2, 0]), tb.admit([2, 0])
    assert [(r, q.rid) for r, q in ta] == [(r, q.rid) for r, q in ja]
    slots = {q.rid: q.rid + 10 for _, q in ta}
    for a, b in zip(jb.pack_prompts(ja, slots, 9), tb.pack_prompts(ta, slots, 9)):
        np.testing.assert_array_equal(a, b)
    assert tb.pending == jb.pending == 3
    assert tb.queued_tenants(limit=2) == jb.queued_tenants(limit=2)


def _requests(n, rng):
    tenants = [f"t{i % len(RANKS)}" for i in range(n)]
    tenants[3] = None                                   # the null tenant
    lens = rng.integers(3, 13, size=n)
    n_news = rng.integers(1, 9, size=n)
    return [(t, rng.integers(0, J_CFG.vocab_size, size=L).astype(np.int32),
             int(k)) for t, L, k in zip(tenants, lens, n_news)]


@pytest.mark.parametrize("kind", ["dora_mag", "pairs"])
def test_engine_tokens_match_reference(world, kind):
    """Eight requests through three rows: ragged prompts and n_new, mixed
    ranks, the null tenant — the same tokens as the JAX engine."""
    js, ts = _stores(world, kind, n_slots=len(RANKS))
    kw = dict(max_rows=3, max_prompt_len=12, max_len=24, decode_chunk=3)
    je = JEngine(world["j"]["base"], J_CFG, js, **kw)
    te = ServeEngine(world["t"]["base"], T_CFG, ts, device="cpu", **kw)
    reqs = _requests(8, np.random.default_rng(2))
    jr = [je.submit(t, p, k) for t, p, k in reqs]
    tr = [te.submit(t, p, k) for t, p, k in reqs]
    jout, tout = je.run(), te.run()
    for (_, _, k), a, b in zip(reqs, jr, tr):
        assert tout[b].shape == (k,) and tout[b].dtype == np.int32
        np.testing.assert_array_equal(tout[b], jout[a])
    assert te.last_run["prefills"] >= 3 and te._tenant_of_rid == {}


def _merged_tenant(t, kind, i):
    """Tenant i's own merged tree (rank-masked shared model + its ΔB_M,
    or its own-rank LoRA pair)."""
    if kind == "pairs":
        return t["loras"][i]
    r = RANKS[i]

    def one(p, x):
        if p.endswith("dB_mag"):
            return tpt.tree_get(t["deltas"][i], p)
        if p.rsplit("/", 1)[-1] in ("A_dir", "dA_dir", "B_mag"):
            return x * (torch.arange(x.shape[-1]) < r)
        if p.endswith("B_dir"):
            return x * (torch.arange(x.shape[-2]) < r)[:, None]
        return x
    return tpt.tree_map_with_path(one, t["shared"])


@pytest.mark.parametrize("kind", ["dora_mag", "pairs"])
def test_mixed_batch_equals_per_tenant_merged(world, kind):
    t = world["t"]
    _, ts = _stores(world, kind, n_slots=len(RANKS))
    eng = ServeEngine(t["base"], T_CFG, ts, max_rows=4, max_prompt_len=10,
                      max_len=24, decode_chunk=4, device="cpu")
    prompts = np.random.default_rng(3).integers(
        0, T_CFG.vocab_size, size=(4, 10)).astype(np.int32)
    names = ["t0", "t1", "t2", None]
    outs = eng.generate(list(zip(names, prompts)), n_new=6)
    pooled, _ = TM.prefill(
        merge_adapters(t["base"], ts.overlay()),
        {"tokens": torch.from_numpy(prompts),
         "adapter_idx": torch.as_tensor(
             [ts.slot_of(n) if n else ts.null_slot for n in names],
             dtype=torch.int32)}, T_CFG)
    for i, name in enumerate(names):
        tree = (t["base"] if name is None else
                merge_adapters(t["base"], _merged_tenant(t, kind, i)))
        ref = greedy_generate(tree, {"tokens": prompts[i:i + 1]}, T_CFG,
                              n_new=6, device="cpu")
        np.testing.assert_array_equal(outs[i], ref[0].numpy())
        one, _ = TM.prefill(tree, {"tokens": torch.from_numpy(prompts[i:i + 1])},
                            T_CFG)
        np.testing.assert_allclose(pooled[i].numpy(), one[0].numpy(),
                                   rtol=1e-5, atol=1e-5)
        if kind == "dora_mag" and RANKS[i] == 8 or name is None:
            two, _ = TM.prefill(tree, {"tokens": torch.from_numpy(
                np.repeat(prompts[i:i + 1], 2, axis=0))}, T_CFG)
            assert torch.equal(pooled[i], two[0])


def test_slot_reuse_masks_stale_high_rank_rows(world):
    t = world["t"]
    store = AdapterStore(t["base"], T_CFG, n_slots=1, kind="pairs", rank=8,
                         device="cpu")
    slot = store.register("big", t["loras"][2])             # rank 8
    store.evict("big")
    assert store.register("small", t["loras"][0]) == slot   # rank 2
    assert store.rank_of("small") == 2
    eng = ServeEngine(t["base"], T_CFG, store, max_rows=1, max_prompt_len=8,
                      max_len=16, decode_chunk=4, device="cpu")
    prompt = np.arange(8, dtype=np.int32) + 5
    out = eng.generate([("small", prompt)], n_new=4)[0]
    ref = greedy_generate(merge_adapters(t["base"], t["loras"][0]),
                          {"tokens": prompt[None]}, T_CFG, n_new=4,
                          device="cpu")
    np.testing.assert_array_equal(out, ref[0].numpy())


def test_store_and_engine_refuse_what_they_do_not_take(world):
    t = world["t"]
    store = AdapterStore(t["base"], T_CFG, n_slots=2, kind="pairs", rank=4,
                         device="cpu")
    with pytest.raises(ValueError, match="mismatch"):
        store.register("too-big", t["loras"][2])            # rank 8 > 4
    with pytest.raises(ValueError, match="unknown AdapterStore kind"):
        AdapterStore(t["base"], T_CFG, kind="nope", device="cpu")
    with pytest.raises(KeyError):
        store.install_batch(["nobody"])                     # never registered
    with pytest.raises(ValueError, match="sliding-window"):
        ServeEngine(t["base"], dataclasses.replace(T_CFG, sliding_window=4),
                    store, device="cpu")
    eng = ServeEngine(t["base"], T_CFG, store, device="cpu")
    with pytest.raises(KeyError):
        eng.submit("nobody", np.ones(3, np.int32), 2)
