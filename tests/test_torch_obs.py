"""The port's telemetry (``repro_torch.obs`` and its call sites) against
the JAX package's ``repro.obs``, on the CPU.

- The same registry and event-log calls give identical snapshots,
  identical Prometheus text and identical event lines but for ``ts``
  (rotation and ``keep`` included).
- Telemetry changes no result: ``FedSim`` and ``ServeEngine`` give the
  same tensors and tokens, bit for bit, with it on and off; with it off
  and no profiler recording, a served run enters no
  ``torch.profiler.record_function`` and ``obs`` reads no clock.
- The same run in both packages, with telemetry on, gives the same
  event kinds in the same order, the same counters and gauges, the same
  histogram counts and the same event fields: exactly, but for times
  (``ts``, ``wall``, ``wait``, tokens/s, never compared) and the
  ``fed_round`` metrics ``ce``, ``grad_norm`` and ``drift``, within 1e-4
  of the reference's, relative to their max (f32 sums in another order;
  ``tests/test_torch_fed.py``).  Runs: ``FedSim`` (fedlora_opt, two
  rounds, stages 2 and 3) then two faulted cohort rounds over a bank and
  a cohort checkpoint, from carried-across state at ``lora_dropout =
  0``; a tiered store serving through the engine, then its checkpoint,
  and a flat store's LRU churn.  Prefetch is made deterministic by
  waiting for the prefetcher before each drain, in both packages.
- The reference's report (``launch/report.telemetry_section``) renders
  the port's file with the same cohort rows and round rows as its own.

Config: the reference's ``obs-t`` (2 layers, d 32, rank 4, f32).
"""
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro import obs as j_obs
from repro.core import peft as j_peft
from repro.fed import CohortSim as JCohort
from repro.fed import FaultPlan as JPlan
from repro.fed.simulate import FedHyper as JHyper, FedSim as JSim
from repro.launch.report import telemetry_section
from repro.models import model as JM
from repro.models.config import ArchConfig as JArch
from repro.serve import AdapterStore as JStore
from repro.serve import ServeEngine as JEngine
from repro.serve import TieredAdapterStore as JTiered
from repro.utils import pytree as jpt
from repro_torch import obs
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.fed import CohortSim, FaultPlan
from repro_torch.fed.simulate import FedHyper as THyper, FedSim as TSim
from repro_torch.models.config import ArchConfig as TArch
from repro_torch.obs import tracing
from repro_torch.serve import AdapterStore, ServeEngine, TieredAdapterStore
from repro_torch.utils import pytree as tpt

OBS_T = dict(name="obs-t", family="dense", n_layers=2, d_model=32,
             n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
             dtype="float32", lora_rank=4, lora_dropout=0.0)
J_CFG, T_CFG = JArch(**OBS_T), TArch(**OBS_T)
C = 2
FED_HP = dict(method="fedlora_opt", n_clients=C, local_steps=1, lr=1e-2,
              global_steps=1, personal_steps=1)
PLAN = dict(dropout_rate=0.3, straggler_rate=0.3, straggler_delay=(1, 1),
            corrupt_rate=0.5, corrupt_scale=2.0, seed=4)
TIMES = {"ts", "wall", "wait", "tokens_per_s"}
METRIC_TOL = 1e-4
RANKS = (2, 4, 4, 2, 4, 1)


@pytest.fixture(autouse=True)
def _null_sinks():
    obs.disable()
    j_obs.disable()
    yield
    obs.disable()
    j_obs.disable()


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


# ---------------------------------------------------------------------------
# the same calls, the same output
# ---------------------------------------------------------------------------

def registry_calls(reg, lat_bounds):
    reg.counter("fed/comm_bytes").inc(100, method="lora", comm="psum")
    reg.counter("fed/comm_bytes").inc(20, comm="psum", method="lora")
    reg.counter("fed/comm_bytes").inc(7.5, method="lora_trimmed",
                                      comm="all_gather")
    reg.counter("pool/lookups").inc()
    reg.gauge("serve/queue_depth").set(3)
    reg.gauge("serve/queue_depth").set(1)
    reg.gauge("pool/occupancy").set(0.75, kind="dora_mag")
    h = reg.histogram("span_seconds")
    for v in (80e-6, 600e-6, 0.002, 0.02, 0.02, 3.0, 2e3):
        h.observe(v, span="fed/round")
    h.observe(0.5, span='odd "label" \\ here')
    lat = reg.histogram("serve/admission_wait_seconds", lat_bounds)
    for v in (8e-6, 80e-6, 600e-6, 11.0):
        lat.observe(v, tenant="t0")
    reg.histogram("serve/admission_wait_seconds").observe(1e-3, tenant="t1")
    reg.histogram("custom/lat", (0.25, 0.5, 1.0)).observe(0.3)
    reg.histogram("custom/lat", (9.0,)).observe(2.0)   # first creation wins


def test_registry_snapshots_and_prometheus_text_are_the_references():
    t_reg, j_reg = obs.MetricsRegistry(), j_obs.MetricsRegistry()
    registry_calls(t_reg, obs.LATENCY_BOUNDS)
    registry_calls(j_reg, j_obs.LATENCY_BOUNDS)
    assert obs.DEFAULT_BOUNDS == j_obs.DEFAULT_BOUNDS
    assert obs.LATENCY_BOUNDS == j_obs.LATENCY_BOUNDS
    snap = t_reg.snapshot()
    assert snap == j_reg.snapshot()
    assert obs.to_prometheus(snap) == j_obs.to_prometheus(j_reg.snapshot())
    assert obs.to_prometheus(obs.MetricsRegistry().snapshot()) == ""
    t_reg.reset()
    assert t_reg.snapshot() == {"counters": {}, "gauges": {},
                                "histograms": {}}
    null = obs.NullRegistry()
    registry_calls(null, obs.LATENCY_BOUNDS)
    assert null.snapshot() == j_obs.NullRegistry().snapshot()
    assert null.counter("x").value() == 0.0
    assert null.histogram("x").series() is None


def event_calls(log):
    log.emit("fed_round", step=np.int64(3), ce=np.asarray([1.5, 2.0]),
             wall={"scan": 0.25})
    log.emit("serve_run", tokens=np.int64(64), rate=np.float32(0.5))
    for i in range(40):
        log.emit("tick", i=i, pad="x" * (i % 7))


def strip_ts(evs):
    return [{k: v for k, v in e.items() if k != "ts"} for e in evs]


def test_event_lines_and_rotation_are_the_references(tmp_path, monkeypatch):
    # one clock for both, so every line has the same length in both
    monkeypatch.setattr("time.time", lambda: 1792000000.125)
    for keep in (0, 2):
        logs = {}
        for pkg, mod in (("t", obs), ("j", j_obs)):
            path = str(tmp_path / f"{pkg}{keep}" / "ev.jsonl")
            log = mod.EventLog(path, max_bytes=400, keep=keep)
            event_calls(log)
            log.close()
            files = sorted(os.listdir(os.path.dirname(path)))
            logs[pkg] = (files, strip_ts(mod.read_events(path)))
        t_files = logs["t"][0]
        assert logs["t"] == logs["j"]
        if keep:
            assert "ev.jsonl.2" in t_files and "ev.jsonl.3" not in t_files
        assert strip_ts(obs.read_events(
            str(tmp_path / f"t{keep}" / "ev.jsonl"), kind="serve_run")) \
            == [e for e in logs["j"][1] if e["kind"] == "serve_run"]
    # the tensors a port call site may hand in: 0-d and CPU tensors
    # become Python values; a card tensor is refused like any object
    path = str(tmp_path / "tensors.jsonl")
    log = obs.EventLog(path)
    log.emit("tensors", a=torch.tensor(2.5), b=torch.arange(3),
             c=torch.ones((2, 1), dtype=torch.bfloat16))
    with pytest.raises(TypeError, match="not JSON-serializable"):
        log.emit("bad", x=object())
    log.close()
    assert strip_ts(obs.read_events(path)) == [
        {"kind": "tensors", "a": 2.5, "b": [0, 1, 2], "c": [[1.0], [1.0]]}]


def test_enable_disable_lifecycle_as_the_reference(tmp_path):
    out = {}
    for pkg, mod in (("t", obs), ("j", j_obs)):
        path = str(tmp_path / f"{pkg}.jsonl")
        assert not mod.enabled()
        mod.inc("dropped")
        tel = mod.enable(path)
        assert mod.enabled() and mod.active() is tel
        mod.inc("kept", method="m")
        mod.set_gauge("g", 2.0, k="v")
        mod.observe("h", 3e-6, bounds=mod.LATENCY_BOUNDS)
        mod.event("ping", n=1)
        mod.enable(path)                       # replaces, appends
        mod.event("pong")
        snap = mod.emit_snapshot()
        mod.disable()
        assert not mod.enabled()
        out[pkg] = (snap, strip_ts(mod.read_events(path)))
    assert out["t"] == out["j"]


# ---------------------------------------------------------------------------
# telemetry changes no result, and costs nothing when it is off
# ---------------------------------------------------------------------------

def fed_arrays(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(5, 64, size=(C, 2, 16)).astype(np.int32),
             "loss_mask": np.ones((C, 2, 16), np.float32)}
            for _ in range(n)]


def t_batches(arrays):
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in arrays]


def j_batches(arrays):
    return [{k: jnp.asarray(v) for k, v in b.items()} for b in arrays]


def port_fed_run():
    sim = TSim(T_CFG, THyper(**dict(FED_HP, local_steps=2)), device="cpu")
    for r in range(2):
        sim.run_round(t_batches(fed_arrays(2, seed=r)))
    agg = sim.aggregate()
    sim.global_stage(agg, [tpt.tree_map(lambda x: x[0], b)
                           for b in t_batches(fed_arrays(1, seed=7))])
    sim.personalize(t_batches(fed_arrays(1, seed=8)))
    return sim


def test_fed_sim_invariant_under_telemetry(tmp_path):
    ref = port_fed_run()
    obs.enable(str(tmp_path / "fed.jsonl"))
    got = port_fed_run()
    obs.disable()
    for tree in ("client_adapters", "opt_state"):
        a, b = getattr(ref, tree), getattr(got, tree)
        for p, x in tpt.tree_leaves_with_path(a):
            assert torch.equal(x, tpt.tree_get(b, p)), (tree, p)
    assert ref.comm_bytes == got.comm_bytes
    evs = obs.read_events(str(tmp_path / "fed.jsonl"))
    assert [e["kind"] for e in evs] == ["fed_round", "fed_round",
                                        "fed_stage", "fed_stage"]
    assert evs[0]["clients"] == C
    assert set(evs[0]["wall"]) == {"scan", "aggregate", "rebroadcast",
                                   "total"}


@pytest.fixture(scope="module")
def serve_world():
    """The reference's backbone, a decomposed shared adapter (B_mag +
    0.25) and per-tenant ΔB_M overlays at RANKS, both packages' trees."""
    base = JM.init_params(jax.random.PRNGKey(0), J_CFG)
    shared = jpt.tree_map_with_path(
        lambda p, x: x + 0.25 if p.endswith("B_mag") else x,
        j_peft.add_lora(base, J_CFG, jax.random.PRNGKey(1), decomposed=True))
    rng = np.random.default_rng(0)
    mags = [jax.tree.map(
        lambda x: jnp.asarray(rng.normal(0, 0.3, size=x.shape)
                              * (np.arange(x.shape[-1]) < r), jnp.float32),
        jpt.filter_tree(shared, lambda p: p.endswith("dB_mag")))
        for r in RANKS]
    return {"j": dict(base=base, shared=shared, mags=mags),
            "t": dict(base=to_port(base), shared=to_port(shared),
                      mags=[to_port(m) for m in mags])}


def port_serve(w, n_new=6):
    store = AdapterStore(w["base"], T_CFG, n_slots=2, kind="dora_mag",
                         shared=w["shared"], device="cpu")
    for t in range(2):
        store.register(f"t{t}", w["mags"][t], rank=RANKS[t])
    eng = ServeEngine(w["base"], T_CFG, store, max_rows=2, max_prompt_len=8,
                      max_len=24, decode_chunk=4, device="cpu")
    ps = np.random.default_rng(7).integers(5, 64, size=(3, 8)).astype(
        np.int32)
    return eng.generate([("t0", ps[0]), ("t1", ps[1]), (None, ps[2])],
                        n_new=n_new), eng


def test_serve_engine_invariant_under_telemetry(serve_world, tmp_path,
                                                monkeypatch):
    prom = tmp_path / "metrics.prom"
    monkeypatch.setenv("REPRO_PROM_PATH", str(prom))
    ref, _ = port_serve(serve_world["t"])
    assert not prom.exists()
    obs.enable(str(tmp_path / "serve.jsonl"))
    got, eng = port_serve(serve_world["t"])
    snap = obs.emit_snapshot()
    obs.disable()
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)
    evs = obs.read_events(str(tmp_path / "serve.jsonl"))
    kinds = {e["kind"] for e in evs}
    assert {"pool_register", "serve_admit", "compile", "serve_run"} <= kinds
    (run,) = [e for e in evs if e["kind"] == "serve_run"]
    assert run["requests"] == 3 and run["tokens"] == 3 * 6 \
        == eng.last_run["tokens"]
    spans = {s["labels"]["span"]: s["count"]
             for s in snap["histograms"]["span_seconds"]}
    assert spans == {"serve/prefill": eng.last_run["prefills"],
                     "serve/decode_chunk": len(eng.last_run["chunk_seconds"])}
    text = prom.read_text()
    assert "repro_serve_prefill_seconds_bucket" in text
    assert not (tmp_path / "metrics.prom.tmp").exists()


class _Clock:
    """Stands in for ``tracing``'s ``time`` module, counting clock reads."""

    def __init__(self):
        self.reads = 0

    def perf_counter(self):
        self.reads += 1
        return 0.0


def test_disabled_path_enters_no_record_function_and_reads_no_clock(
        serve_world, monkeypatch):
    calls = []
    real = torch.profiler.record_function

    def counting(name, *a, **k):
        calls.append(name)
        return real(name, *a, **k)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    clock = _Clock()
    monkeypatch.setattr(tracing, "time", clock)
    port_serve(serve_world["t"])
    assert calls == [] and clock.reads == 0
    assert tracing.named_scope("kernels/bgmv") is tracing._NO_SCOPE
    # a recording profiler names the kernels with telemetry still off ...
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        port_serve(serve_world["t"], n_new=2)
    assert "kernels/bgmv_mag" in calls and "serve/prefill" in calls
    assert clock.reads == 0
    # ... and so does enabled telemetry, whose span reads the clock
    calls.clear()
    obs.enable()
    port_serve(serve_world["t"], n_new=2)
    with obs.span("fed/round", method="m"):
        pass
    snap = obs.emit_snapshot()
    obs.disable()
    assert calls.count("serve/decode_chunk") >= 1 and clock.reads == 2
    assert {"method": "m", "span": "fed/round"} in [
        s["labels"] for s in snap["histograms"]["span_seconds"]]


# ---------------------------------------------------------------------------
# the same run in both packages
# ---------------------------------------------------------------------------

def fed_run(pkg, path, start=None):
    """FedSim two rounds, one more aggregate, stages 2 and 3, then two
    faulted cohort rounds over a 4-client bank and a cohort checkpoint,
    with telemetry on.  The JAX run returns its starting state (backbone,
    client adapters, template) as port trees, which the port's run
    takes as ``start``."""
    mod = j_obs if pkg == "j" else obs
    if pkg == "j":
        sim = JSim(J_CFG, JHyper(**FED_HP))
        start = {k: to_port(getattr(sim, k)) for k in
                 ("base", "client_adapters", "adapter_template")}
        batches = j_batches

        def key(r):
            return jax.random.PRNGKey(r)
    else:
        sim = TSim(T_CFG, THyper(**FED_HP), base=start["base"],
                   device="cpu")
        sim.client_adapters = start["client_adapters"]
        sim.adapter_template = start["adapter_template"]
        batches = t_batches

        def key(r):
            return None
    mod.enable(path)
    for r in range(2):
        sim.run_round(batches(fed_arrays(1, seed=r)), key(r))
    agg = sim.aggregate()
    srv = [{k: v[0] for k, v in b.items()} for b in fed_arrays(1, seed=7)]
    sim.global_stage(agg, batches(srv), key(5))
    sim.personalize(batches(fed_arrays(1, seed=8)), key(6))
    cohort_cls, plan = ((JCohort, JPlan) if pkg == "j"
                        else (CohortSim, FaultPlan))
    cs = cohort_cls(sim, 4, faults=plan(**PLAN), seed=3)
    for r in range(2):
        cs.run_round(batches(fed_arrays(1, seed=10 + r)), key(10 + r))
    ck = os.path.join(os.path.dirname(path), "cohort.msgpack")
    cs.save(ck)
    cohort_cls(sim, 4, faults=plan(**PLAN), seed=3).load(ck)
    mod.emit_snapshot()
    mod.disable()
    return start


@pytest.fixture(scope="module")
def fed_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("obs_fed_ref")
    path = str(d / "run.jsonl")
    start = fed_run("j", path)
    return {"start": start, "path": path, "events": j_obs.read_events(path)}


def close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    assert np.abs(got - want).max() <= METRIC_TOL * max(
        np.abs(want).max(), 1.0), (what, got, want)


def same_event(got, want, tol_keys=()):
    assert got["kind"] == want["kind"]
    assert set(got) == set(want), (got["kind"], set(got) ^ set(want))
    for k, w in want.items():
        if k in TIMES and k != "wall":
            continue
        g = got[k]
        if k == "wall":
            assert (set(g) == set(w)) if isinstance(w, dict) else \
                isinstance(g, float), (want["kind"], k)
        elif k == "path":
            assert os.path.basename(g) == os.path.basename(w)
        elif k in tol_keys:
            close(g, w, f"{want['kind']} {k}")
        else:
            assert g == w, (want["kind"], k, g, w)


def same_snapshot(got, want, gauge_tol=()):
    assert got["counters"] == want["counters"]
    assert set(got["gauges"]) == set(want["gauges"])
    for name, series in want["gauges"].items():
        gs = got["gauges"][name]
        assert [s["labels"] for s in gs] == [s["labels"] for s in series]
        for g, w in zip(gs, series):
            if name in gauge_tol:
                close(g["value"], w["value"], name)
            else:
                assert g["value"] == w["value"], name
    assert set(got["histograms"]) == set(want["histograms"])
    for name, series in want["histograms"].items():
        assert [(s["labels"], s["count"]) for s in got["histograms"][name]] \
            == [(s["labels"], s["count"]) for s in series], name


def test_fed_run_telemetry_matches_reference(fed_ref, tmp_path):
    path = str(tmp_path / "run.jsonl")
    fed_run("t", path, fed_ref["start"])
    got, want = obs.read_events(path), fed_ref["events"]
    assert [e["kind"] for e in got] == [e["kind"] for e in want]
    assert [e["kind"] for e in want].count("fed_round") == 2
    for g, w in zip(got[:-1], want[:-1]):
        same_event(g, w, tol_keys=("ce", "grad_norm", "drift",
                                   "loss_spread"))
    same_snapshot(got[-1]["snapshot"], want[-1]["snapshot"],
                  gauge_tol=("fed/loss_spread",))
    counters = got[-1]["snapshot"]["counters"]
    assert counters["fed/rounds"] == [{"labels": {"method": "fedlora_opt"},
                                       "value": 2.0}]
    assert sum(s["value"] for s in counters["fed/comm_bytes"]) > 0
    assert [e["comm_bytes"] for e in got if e["kind"] == "fed_cohort"] == \
        [e["comm_bytes"] for e in want if e["kind"] == "fed_cohort"]


def rows(text, heading):
    """The table rows under ``heading`` in a rendered section."""
    lines = text.splitlines()
    i = lines.index(heading) + 4
    out = []
    while i < len(lines) and lines[i].startswith("|"):
        out.append([c.strip() for c in lines[i].strip("|").split("|")])
        i += 1
    return out


def test_reference_report_renders_the_ports_file(fed_ref, tmp_path):
    path = str(tmp_path / "run.jsonl")
    fed_run("t", path, fed_ref["start"])
    got, want = telemetry_section(path), telemetry_section(fed_ref["path"])
    head = "### Cohort rounds (partial participation)"
    assert rows(got, head) == rows(want, head) and len(rows(want, head)) == 2
    head = "### Federated rounds"
    g_rows, w_rows = rows(got, head), rows(want, head)
    assert len(g_rows) == len(w_rows) == 2
    for g, w in zip(g_rows, w_rows):
        assert g[:4] + g[8:9] == w[:4] + w[8:9]       # engine .. comm bytes
        for i in (4, 5, 6, 7):                        # the means, 4 places
            assert abs(float(g[i]) - float(w[i])) <= 2e-4, (i, g, w)
    assert ("### Pipeline stages" in got) == ("### Pipeline stages" in want)


def store_run(pkg, w, d):
    """A tiered store serving 10 requests over 6 tenants through the
    engine (prefetch waited for before each drain), its checkpoint
    loaded into a fresh store, and a flat store's LRU churn, with
    telemetry on; returns the tokens."""
    mod = j_obs if pkg == "j" else obs
    cfg = J_CFG if pkg == "j" else T_CFG
    dev = {} if pkg == "j" else {"device": "cpu"}
    tiered_cls, flat_cls, eng_cls = ((JTiered, JStore, JEngine) if pkg == "j"
                                     else (TieredAdapterStore, AdapterStore,
                                           ServeEngine))
    mod.enable(os.path.join(d, "serve.jsonl"))

    def tiered():
        st = tiered_cls(w["base"], cfg, shard_dir=os.path.join(d, "shards"),
                        host_capacity=3, n_slots=4, kind="dora_mag",
                        shared=w["shared"], **dev)
        drain = st.drain_prefetch

        def waited():
            assert st.wait_prefetch(timeout=30.0)
            drain()
        st.drain_prefetch = waited
        return st

    st = tiered()
    for i, r in enumerate(RANKS):
        st.register(f"t{i}", w["mags"][i], rank=r)
    eng = eng_cls(w["base"], cfg, st, max_rows=4, max_prompt_len=8,
                  max_len=24, decode_chunk=4, **dev)
    ps = np.random.default_rng(5).integers(5, 64, size=(10, 8)).astype(
        np.int32)
    order = [0, 1, 2, 3, 4, 5, 0, None, 3, 5]
    n_new = [10, 10, 2, 2, 6, 6, 6, 6, 6, 6]
    rids = [eng.submit(None if t is None else f"t{t}", ps[i], n_new[i])
            for i, t in enumerate(order)]
    res = eng.run()
    st.save(os.path.join(d, "tier.msgpack"))
    tiered().load(os.path.join(d, "tier.msgpack"))
    flat = flat_cls(w["base"], cfg, n_slots=2, kind="dora_mag",
                    shared=w["shared"], **dev)
    for i in (0, 1, 2, 0):
        flat.register(f"t{i}", w["mags"][i], rank=RANKS[i])
        flat.slot_of(f"t{i}")
    mod.emit_snapshot()
    mod.disable()
    return [np.asarray(res[r]) for r in rids]


def test_stores_engine_and_checkpoints_match_reference(serve_world,
                                                       tmp_path):
    outs, evs = {}, {}
    for pkg in ("j", "t"):
        d = str(tmp_path / pkg)
        outs[pkg] = store_run(pkg, serve_world[pkg], d)
        evs[pkg] = obs.read_events(os.path.join(d, "serve.jsonl"))
    for a, b in zip(outs["j"], outs["t"]):
        np.testing.assert_array_equal(b, a)
    got, want = evs["t"], evs["j"]
    kinds = [e["kind"] for e in want]
    assert [e["kind"] for e in got] == kinds
    for k in ("pool_register", "pool_promote", "pool_evict",
              "pool_prefetch", "serve_admit", "compile", "serve_run",
              "ckpt_save", "ckpt_restore"):
        assert k in kinds, k
    for g, w in zip(got[:-1], want[:-1]):
        same_event(g, w)
    same_snapshot(got[-1]["snapshot"], want[-1]["snapshot"])
    c = got[-1]["snapshot"]["counters"]
    for name in ("pool/tier_hits", "pool/tier_misses", "pool/promotions",
                 "pool/t1_spills", "pool/t1_evictions", "pool/prefetched",
                 "pool/evictions", "serve/completed", "ckpt/saves",
                 "ckpt/restores"):
        assert sum(s["value"] for s in c[name]) > 0, name
