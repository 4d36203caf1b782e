"""The port's AdapterStore checkpoints and TieredAdapterStore on the CPU.

Against the JAX package, wherever a file is involved: the JAX stores
write the checkpoints and shards the port's stores read (and the port's
files are byte for byte the JAX stores'), covering
``tests/test_adapter_store.py``'s checkpoint and legacy-migration tests,
``tests/test_het_ckpt.py``'s pool tests and ``tests/test_tiered_store.py``
(its telemetry test run through both packages' stores: the same
counters, gauges and events, but for ``ts``).  Inside the port:
the tier mechanics (T1 registration, spill, promotion, queue-informed
and pinned eviction, prefetch and its determinism contract) and tokens
served through promoted adapters equal to the flat pool's and to
per-tenant merged generation; one churn case through both packages'
engines gives the same tokens.  Pool rows and tokens must be equal
exactly; a legacy migration re-derives ΔB_M with one f32 rounding
(1e-6, as the reference's test holds it).

Config: the reference's ``hetck-t`` (2 layers, d 32, rank 8, f32).
Every prefetch barrier is ``wait_prefetch(timeout)`` held to True.
"""
import os
import sys
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro import obs as j_obs
from repro.core import peft as j_peft
from repro.models import model as JM
from repro.models.config import ArchConfig as JArch
from repro.serve import AdapterStore as JStore
from repro.serve import ServeEngine as JEngine
from repro.serve import TieredAdapterStore as JTiered
from repro.utils import pytree as jpt
from repro_torch import obs
from repro_torch.checkpoint import list_shards, msgpack_codec
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.launch.serve import greedy_generate, merge_adapters
from repro_torch.models.config import ArchConfig as TArch
from repro_torch.serve import AdapterStore, ServeEngine, TieredAdapterStore
from repro_torch.serve.adapter_store import _Prefetcher
from repro_torch.utils import pytree as tpt
from test_adapter_store import _legacy_b_mag_checkpoint

HETCK = dict(name="hetck-t", family="dense", n_layers=2, d_model=32,
             n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
             dtype="float32", lora_rank=8, lora_dropout=0.0)
J_CFG, T_CFG = JArch(**HETCK), TArch(**HETCK)
N_T = 8                       # tenants drawn for the tests
RANKS = [2, 4, 8, 4, 2, 8, 4, 2]


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


@pytest.fixture(scope="module")
def world():
    """JAX base, a decomposed shared adapter (B_mag + 0.25), per-tenant
    raw-LoRA trees at RANKS (B × 50) and ΔB_M overlays, JAX side and
    port side."""
    base = JM.init_params(jax.random.PRNGKey(0), J_CFG)
    shared = jpt.tree_map_with_path(
        lambda p, x: x + 0.25 if p.endswith("B_mag") else x,
        j_peft.add_lora(base, J_CFG, jax.random.PRNGKey(1),
                        decomposed=True))
    rng = np.random.default_rng(0)
    pairs, mags = [], []
    for t, r in enumerate(RANKS):
        lora = j_peft.add_lora(base, J_CFG, jax.random.PRNGKey(300 + t),
                               rank=r)
        pairs.append(jpt.tree_map_with_path(
            lambda p, x: x * 50.0 if p.endswith("lora_B") else x, lora))
        mags.append(jax.tree.map(
            lambda x: jnp.asarray(rng.normal(0, 0.3, size=x.shape)
                                  * (np.arange(x.shape[-1]) < r),
                                  jnp.float32),
            jpt.filter_tree(shared, lambda p: p.endswith("dB_mag"))))
    return dict(j=dict(base=base, shared=shared, pairs=pairs, mags=mags),
                t=dict(base=to_port(base), shared=to_port(shared),
                       pairs=[to_port(x) for x in pairs],
                       mags=[to_port(x) for x in mags]))


def flat_store(pkg, world, kind="pairs", n_slots=4):
    w = world[pkg]
    cls, extra = (JStore, {}) if pkg == "j" else (AdapterStore,
                                                  {"device": "cpu"})
    return cls(w["base"], J_CFG if pkg == "j" else T_CFG, n_slots=n_slots,
               kind=kind, rank=8,
               shared=w["shared"] if kind == "dora_mag" else None,
               **extra)


def tiered(world, path, kind="pairs", n_slots=2, host_capacity=8, pkg="t"):
    w = world[pkg]
    if pkg == "j":
        return JTiered(w["base"], J_CFG, shard_dir=str(path),
                       host_capacity=host_capacity, n_slots=n_slots,
                       kind=kind, rank=8,
                       shared=w["shared"] if kind == "dora_mag" else None)
    return TieredAdapterStore(
        w["base"], T_CFG, shard_dir=str(path), host_capacity=host_capacity,
        n_slots=n_slots, kind=kind, rank=8,
        shared=w["shared"] if kind == "dora_mag" else None, device="cpu")


def adapter(world, pkg, kind, t):
    return world[pkg]["pairs" if kind == "pairs" else "mags"][t]


def pool_row(store, prefix, key, slot):
    lead, _, _ = store.targets[prefix]
    arr = np.asarray(store._pools[prefix][key])
    return arr[:, slot] if lead else arr[slot]


def assert_rows(store, slot, packed):
    """Every pool leaf's row ``slot`` equals ``packed`` exactly."""
    for prefix in store.targets:
        for key, want in packed[prefix].items():
            np.testing.assert_array_equal(pool_row(store, prefix, key, slot),
                                          np.asarray(want),
                                          err_msg=f"{prefix}/{key}")


def assert_overlays_equal(got, want):
    """Port overlay against a JAX overlay, leaf for leaf, exactly."""
    go, wo = got.overlay(), want.overlay()
    assert sorted(tpt.tree_paths(go)) == sorted(jpt.tree_paths(wo))
    for p in tpt.tree_paths(go):
        np.testing.assert_array_equal(tpt.tree_get(go, p).numpy(),
                                      np.asarray(jpt.tree_get(wo, p)),
                                      err_msg=p)


def same_bytes(a, b):
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def prompts(n, S, seed=11):
    return np.asarray(np.random.default_rng(seed).integers(
        5, T_CFG.vocab_size, size=(n, S)), np.int32)


def serve(world, store, reqs, n_new=6):
    eng = ServeEngine(world["t"]["base"], T_CFG, store, max_rows=4,
                      max_prompt_len=8, max_len=24, decode_chunk=4,
                      device="cpu")
    return eng.generate(reqs, n_new=n_new)


# ---------------------------------------------------------------------------
# flat-store checkpoints, against files the JAX store writes
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_matches_reference(world, tmp_path):
    """A dora_mag store saved by each package gives the same bytes; the
    JAX store's file loads into the port's with the same tenants, slots,
    overlay and LRU state."""
    paths = {}
    for pkg in ("j", "t"):
        st = flat_store(pkg, world, "dora_mag", n_slots=3)
        st.register("alice", adapter(world, pkg, "dora_mag", 1))
        st.register("bob", adapter(world, pkg, "dora_mag", 2))
        st.slot_of("alice")
        paths[pkg] = str(tmp_path / f"{pkg}.msgpack")
        st.save(paths[pkg], step=7)
        if pkg == "j":
            ref = st
    assert same_bytes(paths["j"], paths["t"])
    fresh = flat_store("t", world, "dora_mag", n_slots=3)
    assert fresh.load(paths["j"]) == 7
    assert fresh.tenants == ref.tenants
    assert fresh.slot_of("alice") == ref._slot_of["alice"]
    assert_overlays_equal(fresh, ref)
    fresh.register("carol", adapter(world, "t", "dora_mag", 3))
    fresh.register("dave", adapter(world, "t", "dora_mag", 4))   # evicts bob
    assert "bob" not in fresh and "alice" in fresh


def _legacy(world, path, n_slots=3, shift=0.0):
    """A pre-raw-delta checkpoint, written by the JAX package's own test
    helper from its store with alice (and bob) registered."""
    js = flat_store("j", world, "dora_mag", n_slots=n_slots)
    js.register("alice", adapter(world, "j", "dora_mag", 1))
    js.register("bob", adapter(world, "j", "dora_mag", 2))
    _legacy_b_mag_checkpoint(js, path, step=5, b_mag_shift=shift)


def test_legacy_pool_b_mag_checkpoint_migrates(world, tmp_path):
    path = str(tmp_path / "legacy.msgpack")
    _legacy(world, path)
    own = flat_store("t", world, "dora_mag", n_slots=3)
    own.register("alice", adapter(world, "t", "dora_mag", 1))
    own.register("bob", adapter(world, "t", "dora_mag", 2))
    fresh = flat_store("t", world, "dora_mag", n_slots=3)
    with pytest.warns(UserWarning, match="pool_B_mag"):
        assert fresh.load(path) == 5
    assert fresh.tenants == ["alice", "bob"]
    assert fresh.rank_of("alice") == 8
    go, wo = fresh.overlay(), own.overlay()
    for p in tpt.tree_paths(wo):
        # (db + b_mag) - b_mag costs one f32 rounding
        np.testing.assert_allclose(tpt.tree_get(go, p).numpy(),
                                   tpt.tree_get(wo, p).numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=p)


def test_legacy_migration_rejects_foreign_b_mag(world, tmp_path):
    path = str(tmp_path / "legacy-foreign.msgpack")
    _legacy(world, path, shift=0.5)
    fresh = flat_store("t", world, "dora_mag", n_slots=3)
    with pytest.warns(UserWarning, match="pool_B_mag"), \
            pytest.raises(ValueError, match="different shared B_mag"):
        fresh.load(path)


def test_legacy_migration_rejects_shape_mismatch(world, tmp_path):
    path = str(tmp_path / "legacy-shape.msgpack")
    _legacy(world, path)
    fresh = flat_store("t", world, "dora_mag", n_slots=5)
    with pytest.warns(UserWarning, match="pool_B_mag"), \
            pytest.raises(ValueError, match="not convertible"):
        fresh.load(path)


def test_het_pool_roundtrip_preserves_ranks(world, tmp_path):
    """Tenants at ranks 2 / 4 / 8 in a rank-8 pairs pool: the JAX file
    loads with each rank and the same overlay (``pool_ranks`` too)."""
    path = str(tmp_path / "pool.msgpack")
    js = flat_store("j", world, "pairs", n_slots=4)
    for i, t in enumerate(("alice", "bob", "carol")):
        js.register(t, adapter(world, "j", "pairs", i), rank=RANKS[i])
    js.save(path, step=11)
    fresh = flat_store("t", world, "pairs", n_slots=4)
    assert fresh.load(path) == 11
    assert fresh.tenants == js.tenants
    for i, t in enumerate(("alice", "bob", "carol")):
        assert fresh.rank_of(t) == RANKS[i]
    assert_overlays_equal(fresh, js)
    assert fresh.bytes_per_tenant("alice") == js.bytes_per_tenant("alice")
    assert fresh.bytes_per_tenant() == js.bytes_per_tenant()


def test_pre_het_pool_checkpoint_defaults_to_full_rank(world, tmp_path):
    """A JAX checkpoint with its ``meta/slot_ranks`` leaf taken out (by
    the port's codec) restores the occupied slot at the pool's rank and
    the others at 0."""
    path = str(tmp_path / "old.msgpack")
    js = flat_store("j", world, "pairs", n_slots=3)
    js.register("legacy", adapter(world, "j", "pairs", 2))
    js.save(path, step=2)
    with open(path, "rb") as f:
        payload = msgpack_codec.unpackb(f.read())
    del payload["leaves"]["meta/slot_ranks"]
    with open(path, "wb") as f:
        msgpack_codec.pack_to(f, payload)
    fresh = flat_store("t", world, "pairs", n_slots=3)
    assert fresh.load(path) == 2
    assert fresh.rank_of("legacy") == 8
    empties = [s for s in range(4) if s != fresh.slot_of("legacy")]
    assert all(fresh._slot_ranks[s] == 0 for s in empties)


def test_cross_kind_pool_load_still_raises(world, tmp_path):
    path = str(tmp_path / "mag.msgpack")
    flat_store("j", world, "dora_mag", n_slots=2).save(path, step=5)
    with pytest.raises(KeyError, match="pool_A"):
        flat_store("t", world, "pairs", n_slots=2).load(path)


# ---------------------------------------------------------------------------
# tier mechanics
# ---------------------------------------------------------------------------

def test_register_goes_to_t1_install_promotes(world, tmp_path):
    ts = tiered(world, tmp_path / "s")
    for t in range(4):
        assert ts.register(f"t{t}", adapter(world, "t", "pairs", t)) == -1
    assert ts.tenants == ["t0", "t1", "t2", "t3"]
    assert ts.resident_tenants == []
    assert all(v.device.type == "cpu" for e in ts._t1.values()
               for leaves in e[0].values() for v in leaves.values())
    pools = {(p, k): v for p, pool in ts._pools.items()
             for k, v in pool.items()}
    version = ts.version
    slots = ts.install_batch(["t0", "t1"])
    assert sorted(slots.values()) == [0, 1]
    assert ts.resident_tenants == ["t0", "t1"]
    assert ts.version == version + 1          # one install for both rows
    assert all(ts._pools[p][k] is v for (p, k), v in pools.items())
    packed, _ = ts._pack_adapter("t0", adapter(world, "t", "pairs", 0))
    assert_rows(ts, slots["t0"], packed)


def test_t1_capacity_spills_dirty_entries_to_shards(world, tmp_path):
    """Five tenants through a T1 of 2: three spill, as the JAX store's
    spill, byte for byte; a spilled tenant promotes from its shard."""
    for pkg in ("j", "t"):
        ts = tiered(world, tmp_path / pkg, host_capacity=2, pkg=pkg)
        for t in range(5):
            ts.register(f"t{t}", adapter(world, pkg, "pairs", t))
        assert len(ts._t1) == 2
        assert list_shards(ts.shard_dir) == ["t0", "t1", "t2"]
    for t in range(3):
        name = f"{f't{t}'.encode().hex()}.msgpack"
        assert same_bytes(tmp_path / "j" / name, tmp_path / "t" / name)
    slot = ts.slot_of("t0")
    packed, _ = ts._pack_adapter("t0", adapter(world, "t", "pairs", 0))
    assert_rows(ts, slot, packed)


def test_queued_tenants_evicted_only_as_last_resort(world, tmp_path):
    ts = tiered(world, tmp_path / "s", n_slots=3)
    for t in range(5):
        ts.register(f"t{t}", adapter(world, "t", "pairs", t))
    ts.install_batch(["t0", "t1", "t2"])
    ts.install_batch(["t3"], queued={"t0", "t2"})        # t1 goes, not t0
    assert "t0" in ts.resident_tenants and "t2" in ts.resident_tenants
    assert "t1" not in ts.resident_tenants
    ts.install_batch(["t4"], pinned={"t3"}, queued={"t0", "t2"})
    assert "t4" in ts.resident_tenants and "t3" in ts.resident_tenants


def test_pinned_slots_are_never_evicted(world, tmp_path):
    ts = tiered(world, tmp_path / "s")
    for t in range(3):
        ts.register(f"t{t}", adapter(world, "t", "pairs", t))
    ts.install_batch(["t0", "t1"])
    with pytest.raises(RuntimeError, match="pinned"):
        ts.install_batch(["t2"], pinned={"t0", "t1"})
    assert ts.resident_tenants == ["t0", "t1"]


def test_reregister_refreshes_resident_row(world, tmp_path):
    ts = tiered(world, tmp_path / "s", host_capacity=4)
    ts.register("t0", adapter(world, "t", "pairs", 0))
    slot = ts.slot_of("t0")
    assert ts.register("t0", adapter(world, "t", "pairs", 5)) == slot
    packed, _ = ts._pack_adapter("t0", adapter(world, "t", "pairs", 5))
    assert_rows(ts, slot, packed)


def test_unknown_tenant_raises(world, tmp_path):
    ts = tiered(world, tmp_path / "s")
    with pytest.raises(KeyError, match="register"):
        ts.install_batch(["ghost"])


def test_missing_shard_raises_sync_and_is_dropped_by_prefetch(world,
                                                               tmp_path):
    ts = tiered(world, tmp_path / "s")
    ts.register("t0", adapter(world, "t", "pairs", 0))
    ts.flush()
    ts._t1.clear()
    (tmp_path / "s" / f"{b't0'.hex()}.msgpack").unlink()
    ts.prefetch(["t0"])
    assert ts.wait_prefetch(timeout=10.0)
    ts.drain_prefetch()
    assert "t0" not in ts._t1
    assert isinstance(ts._prefetcher.last_error, FileNotFoundError)
    with pytest.raises(FileNotFoundError):
        ts.install_batch(["t0"])


# ---------------------------------------------------------------------------
# prefetch
# ---------------------------------------------------------------------------

def test_prefetch_folds_into_t1_with_identical_bytes(world, tmp_path):
    ts = tiered(world, tmp_path / "s", host_capacity=4)
    for t in range(3):
        ts.register(f"t{t}", adapter(world, "t", "pairs", t))
    ts.flush()
    ts._t1.clear()
    ts.prefetch(["t1"])
    assert ts.wait_prefetch(timeout=10.0)
    ts.drain_prefetch()
    assert "t1" in ts._t1
    packed_pf = ts._t1["t1"][0]
    packed_sync, _ = ts._read_shard("t1")
    for prefix in ts.targets:
        for key in packed_sync[prefix]:
            assert torch.equal(packed_pf[prefix][key],
                               packed_sync[prefix][key])
    assert ts._t1["t1"][2] is False


def test_stale_prefetch_is_discarded_after_reregister(world, tmp_path):
    ts = tiered(world, tmp_path / "s", host_capacity=4)
    ts.register("t0", adapter(world, "t", "pairs", 0))
    ts.flush()
    ts._t1.clear()
    ts.prefetch(["t0"])
    assert ts.wait_prefetch(timeout=10.0)
    ts.register("t0", adapter(world, "t", "pairs", 1))
    ts._t1.clear()
    ts.drain_prefetch()
    assert "t0" not in ts._t1


def test_prefetcher_wait_times_out_and_stress():
    """A blocked load makes ``wait`` return False at its timeout, not
    hang; then 64 tenants submitted from four threads at once with a
    short switch interval all arrive, each exactly once, and the worker
    thread is gone when the queue is empty."""
    gate = threading.Event()

    def load(t):
        if t == "slow":
            gate.wait(10.0)
        return {"p": {"k": torch.full((2,), float(len(t)))}}, len(t)
    pf = _Prefetcher(load)
    pf.submit("slow", 0)
    t0 = time.monotonic()
    assert pf.wait(timeout=0.2) is False
    assert time.monotonic() - t0 < 5.0
    gate.set()
    assert pf.wait(timeout=10.0)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        names = [f"tenant{i}" for i in range(64)]
        subs = [threading.Thread(target=lambda k=k: [
            pf.submit(n, 1) for n in names[k::4]]) for k in range(4)]
        for th in subs:
            th.start()
        for th in subs:
            th.join(10.0)
            assert not th.is_alive()
        assert pf.wait(timeout=10.0)
    finally:
        sys.setswitchinterval(switch)
    got = pf.drain()
    assert sorted(got) == sorted(names + ["slow"])
    assert all(r == len(n) and g == (0 if n == "slow" else 1)
               for n, (_p, r, g) in got.items())
    deadline = time.monotonic() + 10.0
    while pf._thread is not None and time.monotonic() < deadline:
        assert pf.wait(timeout=1.0)
    assert pf._thread is None and not pf._work and not pf._inflight


# ---------------------------------------------------------------------------
# promotion parity
# ---------------------------------------------------------------------------

def test_promoted_mixed_batch_bit_identical_to_flat_pool(world, tmp_path):
    """Tokens through T1- and T2-promoted adapters equal the all-resident
    flat pool's and each tenant's merged-backbone generation."""
    t = world["t"]
    reqs = [(f"t{i % 6}", p) for i, p in enumerate(prompts(12, 8))]
    flat = flat_store("t", world, "pairs", n_slots=8)
    for i in range(6):
        flat.register(f"t{i}", t["pairs"][i], rank=RANKS[i])
    out_flat = serve(world, flat, reqs, n_new=8)

    ts = tiered(world, tmp_path / "s", n_slots=4, host_capacity=3)
    for i in range(6):
        ts.register(f"t{i}", t["pairs"][i], rank=RANKS[i])
    ts.flush()
    while len(ts._t1) > 2:                    # some T1, some T2-only
        ts._t1.popitem(last=False)
    out_tier = serve(world, ts, reqs, n_new=8)
    for a, b in zip(out_flat, out_tier):
        np.testing.assert_array_equal(a, b)
    for i in range(6):
        ref = greedy_generate(merge_adapters(t["base"], t["pairs"][i]),
                              {"tokens": reqs[i][1][None]}, T_CFG, n_new=8,
                              device="cpu")
        np.testing.assert_array_equal(out_tier[i], ref[0].numpy())


def test_dora_mag_promotion_parity(world, tmp_path):
    """The paper's deployment layout (shared factors, per-tenant raw
    ΔB_M) served through T2 promotion equals merged generation."""
    t = world["t"]
    ts = tiered(world, tmp_path / "s", kind="dora_mag", n_slots=4,
                host_capacity=2)
    for i in range(4):
        ts.register(f"m{i}", t["mags"][i], rank=RANKS[i])
    ts.flush()
    ts._t1.clear()
    ps = prompts(4, 8)
    outs = serve(world, ts, [(f"m{i}", ps[i]) for i in range(4)])
    for i in range(4):
        full = tpt.tree_map_with_path(
            lambda p, x: tpt.tree_get(t["mags"][i], p, x), t["shared"])
        if RANKS[i] < 8:                      # the slot serves rank rows only
            full = tpt.tree_map_with_path(
                lambda p, x: _cut(p, x, RANKS[i]), full)
        ref = greedy_generate(merge_adapters(t["base"], full),
                              {"tokens": ps[i:i + 1]}, T_CFG, n_new=6,
                              device="cpu")
        np.testing.assert_array_equal(outs[i], ref[0].numpy())


def _cut(path, x, r):
    """A decomposed leaf with its rank rows above ``r`` zeroed (A_mag is
    per input feature and has none)."""
    if path.rsplit("/", 1)[-1] in ("A_dir", "dA_dir", "B_mag", "dB_mag"):
        return x * (torch.arange(x.shape[-1]) < r)
    if path.endswith("B_dir"):
        return x * (torch.arange(x.shape[-2]) < r)[:, None]
    return x


def test_seeded_churn_is_deterministic_with_and_without_prefetch(world,
                                                                 tmp_path):
    """Eight tenants through four slots and a T1 of three: the same
    tokens run to run, and with the prefetcher a no-op."""
    t = world["t"]
    order = np.random.default_rng(7).integers(0, N_T, size=16)
    ps = prompts(16, 8)
    reqs = [(f"t{order[i]}", ps[i]) for i in range(16)]

    def run(tag, use_prefetch):
        ts = tiered(world, tmp_path / f"s{tag}", n_slots=4, host_capacity=3)
        for i in range(N_T):
            ts.register(f"t{i}", t["pairs"][i], rank=RANKS[i])
        ts.flush()
        ts._t1.clear()
        if not use_prefetch:
            ts.prefetch = lambda tenants: None
        return serve(world, ts, reqs)

    a, b, c = run(0, True), run(1, True), run(2, False)
    for x, y, z in zip(a, b, c):
        np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(x, z)


# ---------------------------------------------------------------------------
# tiered checkpoints and shards, against the JAX tiered store's files
# ---------------------------------------------------------------------------

def test_tiered_checkpoint_written_by_reference_loads(world, tmp_path):
    """The JAX tiered store's checkpoint and shards restore into the
    port's: directory, residents, ranks, and a demote / re-promote cycle
    serving the JAX store's packed bytes.  The port's own save of the
    restored store writes the same bytes."""
    js = tiered(world, tmp_path / "s", pkg="j", host_capacity=4)
    for i in range(5):
        js.register(f"t{i}", adapter(world, "j", "pairs", i), rank=RANKS[i])
    js.install_batch(["t0", "t1"])
    path = str(tmp_path / "tier.ckpt")
    js.save(path)
    assert list_shards(js.shard_dir) == [f"t{i}" for i in range(5)]

    ts = tiered(world, tmp_path / "s", host_capacity=4)
    ts.load(path)
    assert ts.tenants == js.tenants
    assert ts.resident_tenants == ["t0", "t1"]
    assert [ts.rank_of(f"t{i}") for i in range(5)] == RANKS[:5]
    assert_overlays_equal(ts, js)
    ts.save(str(tmp_path / "again.ckpt"))
    assert same_bytes(path, tmp_path / "again.ckpt")
    ts.install_batch(["t3", "t4"])
    slot = ts.slot_of("t0")
    packed, _ = js._pack_adapter("t0", adapter(world, "j", "pairs", 0),
                                 RANKS[0])
    assert_rows(ts, slot, packed)


def test_legacy_flat_checkpoint_loads_unchanged(world, tmp_path):
    """The JAX flat store's checkpoint restores into the tiered store
    with the same residents and pools, and a demoted resident comes back
    intact."""
    js = flat_store("j", world, "pairs", n_slots=2)
    js.register("a", adapter(world, "j", "pairs", 0))
    js.register("b", adapter(world, "j", "pairs", 1))
    path = str(tmp_path / "flat.ckpt")
    js.save(path)
    ts = tiered(world, tmp_path / "s", host_capacity=4)
    ts.load(path)
    assert ts.tenants == ["a", "b"] and ts.resident_tenants == ["a", "b"]
    assert_overlays_equal(ts, js)
    ts.register("c", adapter(world, "t", "pairs", 2))
    ts.install_batch(["c"])
    demoted = [t for t in ("a", "b") if t not in ts.resident_tenants]
    assert demoted
    back = ts.slot_of(demoted[0])
    packed, _ = js._pack_adapter(
        demoted[0], adapter(world, "j", "pairs", "ab".index(demoted[0])))
    assert_rows(ts, back, packed)


def test_reference_shards_promote_into_the_port(world, tmp_path):
    """Shards the JAX tiered store spilled and flushed are adopted by a
    port tiered store on the same directory and promote to the JAX
    store's packed rows, for both kinds."""
    for kind in ("pairs", "dora_mag"):
        d = tmp_path / kind
        js = tiered(world, d, kind=kind, pkg="j", host_capacity=2)
        for i in range(5):
            js.register(f"t{i}", adapter(world, "j", kind, i), rank=RANKS[i])
        js.flush()
        ts = tiered(world, d, kind=kind, n_slots=4)
        assert ts.tenants == [f"t{i}" for i in range(5)]
        slots = ts.install_batch([f"t{i}" for i in (4, 0, 2, 1)])
        for i in (4, 0, 2, 1):
            packed, r = js._pack_adapter(f"t{i}", adapter(world, "j", kind, i),
                                         RANKS[i])
            assert ts.rank_of(f"t{i}") == r == RANKS[i]
            assert_rows(ts, slots[f"t{i}"], packed)


def test_engine_churn_matches_reference_engine(world, tmp_path):
    """Twelve requests over eight tenants through a four-slot tiered pool
    with n_slots == max_rows, one package's engine beside the other's:
    the same tokens, and a flat store's.  The first four requests'
    lengths differ, so two rows retire while two stay active, and the
    next admission must evict the retired rows' tenants, not the active
    rows' (older in LRU order, and queued for nothing): the engine pins
    them."""
    order = [0, 1, 2, 3, 4, 5, 6, 7, 4, 5, 6, 7]
    n_new = [12, 12, 2, 2] + [6] * 8
    ps = prompts(12, 8, seed=5)
    outs = {}
    for pkg in ("j", "t"):
        st = tiered(world, tmp_path / pkg, kind="dora_mag", n_slots=4,
                    host_capacity=3, pkg=pkg)
        for i in range(N_T):
            st.register(f"t{i}", adapter(world, pkg, "dora_mag", i),
                        rank=RANKS[i])
        if pkg == "j":
            eng = JEngine(world["j"]["base"], J_CFG, st, max_rows=4,
                          max_prompt_len=8, max_len=24, decode_chunk=4)
        else:
            eng = ServeEngine(world["t"]["base"], T_CFG, st, max_rows=4,
                              max_prompt_len=8, max_len=24, decode_chunk=4,
                              device="cpu")
        rids = [eng.submit(f"t{order[i]}", ps[i], n_new[i])
                for i in range(12)]
        res = eng.run()
        outs[pkg] = [np.asarray(res[r]) for r in rids]
    flat = flat_store("t", world, "dora_mag", n_slots=N_T)
    for i in range(N_T):
        flat.register(f"t{i}", adapter(world, "t", "dora_mag", i),
                      rank=RANKS[i])
    eng = ServeEngine(world["t"]["base"], T_CFG, flat, max_rows=4,
                      max_prompt_len=8, max_len=24, decode_chunk=4,
                      device="cpu")
    rids = [eng.submit(f"t{order[i]}", ps[i], n_new[i]) for i in range(12)]
    res = eng.run()
    for a, b, r in zip(outs["j"], outs["t"], rids):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(b, res[r])


def test_tier_metrics_and_events(world, tmp_path):
    """``tests/test_tiered_store.py::test_tier_metrics_and_events``'s
    schedule through both packages' stores with telemetry on: the port's
    counters, gauges and events (but for ``ts``) are the reference's,
    and the reference test's own checks hold."""
    out = {}
    for pkg, mod in (("j", j_obs), ("t", obs)):
        path = str(tmp_path / f"{pkg}.jsonl")
        tel = mod.enable(path)
        try:
            ts = tiered(world, tmp_path / pkg, host_capacity=2, pkg=pkg)
            for t in range(4):
                ts.register(f"t{t}", adapter(world, pkg, "pairs", t))
            ts.install_batch(["t0", "t1"])    # t0 / t1 spilled: T2 reads
            ts.install_batch(["t0"])          # a T0 hit
            ts.prefetch(["t2"])
            assert ts.wait_prefetch(timeout=10.0)
            ts.drain_prefetch()
            ts.install_batch(["t2"])          # a T1 hit from the prefetch
            snap = tel.metrics.snapshot()
        finally:
            mod.disable()
        out[pkg] = (snap, [{k: (os.path.basename(v) if k == "path" else v)
                            for k, v in e.items() if k != "ts"}
                           for e in mod.read_events(path)])
    assert out["t"] == out["j"]
    m = out["t"][0]

    def value(kind, name, **labels):
        return sum(s["value"] for s in m[kind][name]
                   if labels.items() <= s["labels"].items())
    assert value("counters", "pool/tier_hits", tier="t0") >= 1
    assert value("counters", "pool/tier_hits", tier="t1") >= 1
    assert value("counters", "pool/tier_misses", tier="t1") >= 1
    assert value("counters", "pool/promotions", src="t2") >= 1
    assert value("counters", "pool/promotions", src="t1") >= 1
    assert value("counters", "pool/prefetched") >= 1
    assert value("counters", "pool/t1_spills") >= 1
    assert value("gauges", "pool/t1_occupancy") > 0
    assert {"pool_promote", "pool_prefetch", "pool_register"} <= {
        e["kind"] for e in out["t"][1]}


def test_legacy_migration_events_match_reference(world, tmp_path):
    """Loading a legacy ``pool_B_mag`` checkpoint with telemetry on: the
    port's ``ckpt_restore`` and ``ckpt_migrate`` events and counters are
    the reference's (but for ``ts`` and the path's directory)."""
    path = str(tmp_path / "legacy.msgpack")
    _legacy(world, path)
    out = {}
    for pkg, mod in (("j", j_obs), ("t", obs)):
        log = str(tmp_path / f"{pkg}.jsonl")
        tel = mod.enable(log)
        try:
            with pytest.warns(UserWarning, match="pool_B_mag"):
                flat_store(pkg, world, "dora_mag", n_slots=3).load(path)
            snap = tel.metrics.snapshot()
        finally:
            mod.disable()
        out[pkg] = (snap, [{k: v for k, v in e.items() if k != "ts"}
                           for e in mod.read_events(log)])
    assert out["t"] == out["j"]
    assert [e["kind"] for e in out["t"][1]][-1] == "ckpt_migrate"
    assert out["t"][1][-1]["tenants"] == 2
