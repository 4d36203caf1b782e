"""The port's cohort rounds (``fed/cohort.py``, ``FedSim.run_cohort_round``)
against the JAX package's, on the CPU.

Both packages draw cohorts, faults and straggler delays with numpy from
the same seeds, so those must be equal exactly; so must participation,
staleness, deliveries, the bank's sync rounds and every comm byte.  The
port's sims carry the reference's backbone and adapter template
(``checkpoint.bridge``) and train on the same batches at
``lora_dropout = 0``; the bank's adapters after each faulted round must
be within 1e-4 of the reference's, relative to each leaf's max |value|
(the f32 sums differ in order; ``tests/test_torch_fed.py`` explains the
bound), and each round's per-client ce within 1e-5 relative.
Checkpoint files must be the reference's byte for byte wherever the
state is the same bit for bit (a fresh bank, a state one package loaded
from the other's file), and each package restores the other's.

Config: the reference's ``cohort-t`` (2 layers, d 32, rank 4, f32); C =
3 slots of 5 or 6 clients, 1 local step a round.  The reference's runs
are shared by a module fixture.
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import jax.numpy as jnp
import torch

from repro import obs as j_obs
from repro.fed import ClientBank as JBank
from repro.fed import CohortSampler as JSampler
from repro.fed import CohortSim as JCohort
from repro.fed import FaultPlan as JPlan
from repro.fed.simulate import FedHyper as JHyper, FedSim as JSim
from repro.launch.report import telemetry_section
from repro.models.config import ArchConfig as JArch
from repro.utils import pytree as jpt
from repro_torch import obs
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.fed import ClientBank, CohortSampler, CohortSim, FaultPlan
from repro_torch.fed.cohort import STALENESS_BOUNDS
from repro_torch.fed.simulate import FedHyper as THyper, FedSim as TSim
from repro_torch.models.config import ArchConfig as TArch
from repro_torch.utils import pytree as tpt

COHORT_T = dict(name="cohort-t", family="dense", n_layers=2, d_model=32,
                n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                dtype="float32", lora_rank=4, lora_dropout=0.0)
J_CFG, T_CFG = JArch(**COHORT_T), TArch(**COHORT_T)
C, N_TOTAL, ROUNDS = 3, 5, 3
HP = dict(n_clients=C, local_steps=1, lr=2e-2)
# every round drops a client, rounds 0 and 2 have a straggler (round 0's
# delivers in round 1), rounds 0 and 1 a corrupted update
PLAN = dict(dropout_rate=0.25, straggler_rate=0.25, straggler_delay=(1, 1),
            corrupt_rate=0.4, corrupt_scale=3.0, seed=12)
METHODS = ("lora", "lora_fedbuff")
TOL = 1e-4


@pytest.fixture(autouse=True)
def _null_sinks():
    obs.disable()
    j_obs.disable()
    yield
    obs.disable()
    j_obs.disable()


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def batch_arrays(n, seed):
    rng = np.random.default_rng(seed)
    return [{"tokens": rng.integers(5, 64, size=(C, 2, 16)).astype(np.int32),
             "loss_mask": np.ones((C, 2, 16), np.float32)}
            for _ in range(n)]


def j_batches(arrays):
    return [{k: jnp.asarray(v) for k, v in b.items()} for b in arrays]


def t_batches(arrays):
    return [{k: torch.from_numpy(v) for k, v in b.items()} for b in arrays]


def j_sim(method):
    return JSim(J_CFG, JHyper(method=method, **HP))


def t_sim(method, js=None):
    """A port sim; with ``js``, carrying its backbone and adapter
    template (a bank is drawn from the template)."""
    if js is None:
        return TSim(T_CFG, THyper(method=method, **HP), device="cpu")
    ts = TSim(T_CFG, THyper(method=method, **HP), base=to_port(js.base),
              device="cpu")
    ts.adapter_template = to_port(js.adapter_template)
    return ts


def flat(tree):
    if all(torch.is_tensor(x) for x in tpt.tree_leaves(tree)):
        return {p: x.numpy() for p, x in tpt.tree_leaves_with_path(tree)}
    return dict(zip(jpt.tree_paths(tree),
                    map(np.asarray, jax.tree.leaves(tree))))


def assert_leaves(got, want, tol, what):
    got, want = flat(got), flat(want)
    assert set(got) == set(want), what
    for p, w in want.items():
        err = np.abs(got[p] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (what, p, err)


def assert_equal_leaves(got, want, what):
    got, want = flat(got), flat(want)
    assert set(got) == set(want), what
    for p, w in want.items():
        assert got[p].dtype == w.dtype and np.array_equal(got[p], w), \
            (what, p)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's faulted cohort runs, one a method: per-round
    outputs, the bank after each round, the comm bill, and a checkpoint
    written after round 1 with a straggler in flight."""
    d = tmp_path_factory.mktemp("cohort_ref")
    arrays = batch_arrays(1, seed=4)
    out = {"arrays": arrays}
    for method in METHODS:
        js = j_sim(method)
        cs = JCohort(js, N_TOTAL, faults=JPlan(**PLAN), seed=0)
        rounds, banks, bills = [], [], []
        for r in range(ROUNDS):
            rounds.append(cs.run_round(j_batches(arrays),
                                       jax.random.PRNGKey(r)))
            banks.append(jax.tree.map(np.copy, cs.bank.adapters))
            bills.append(js.comm_bytes)
            if r == 0:
                path = str(d / f"{method}_r1.msgpack")
                cs.save(path)
                pending = [(p["client"], p["deliver_at"], p["trained_round"])
                           for p in cs._pending]
        out[method] = dict(js=js, rounds=rounds,
                           banks=banks, bills=bills, path=path,
                           pending=pending,
                           last_sync=cs.bank.last_sync.copy(),
                           unit=js.client_comm_bytes())
    return out


# ---------------------------------------------------------------------------
# sampler and fault plan: numpy draws, equal exactly
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 5, 11])
@pytest.mark.parametrize("dist", ["uniform", "lognormal", "pareto"])
def test_sampler_and_fault_draws_match_reference(seed, dist):
    for n_total, cohort in ((50, 5), (16, 4), (3, 3)):
        t, j = CohortSampler(n_total, cohort, seed), JSampler(n_total,
                                                              cohort, seed)
        for r in range(6):
            np.testing.assert_array_equal(t.sample(r), j.sample(r))
    kw = dict(dropout_rate=0.2, straggler_rate=0.3, straggler_delay=(1, 9),
              straggler_dist=dist, straggler_tail=1.5, corrupt_rate=0.4,
              corrupt_scale=7.0, seed=seed)
    tp, jp = FaultPlan(**kw), JPlan(**kw)
    assert tp.any == jp.any
    for r in range(4):
        got, want = tp.draw(r, 64), jp.draw(r, 64)
        assert set(got) == set(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sampler_and_plan_refuse_what_the_reference_refuses():
    for bad in (dict(n_total=4, cohort=5), dict(n_total=4, cohort=0)):
        with pytest.raises(ValueError, match="cohort size"):
            CohortSampler(**bad)
    for bad, match in ((dict(dropout_rate=0.7, straggler_rate=0.5),
                        "dropout_rate"),
                       (dict(straggler_delay=(0, 2)), "straggler_delay"),
                       (dict(straggler_delay=(3, 1)), "straggler_delay"),
                       (dict(straggler_dist="cauchy"), "straggler_dist"),
                       (dict(straggler_dist="pareto", straggler_tail=0.0),
                        "straggler_tail")):
        with pytest.raises(ValueError, match=match):
            FaultPlan(**bad)
        with pytest.raises(ValueError, match=match):
            JPlan(**bad)
    assert not FaultPlan().any


# ---------------------------------------------------------------------------
# the bank
# ---------------------------------------------------------------------------

def test_bank_gather_scatter_mask_semantics():
    sim = t_sim("lora")
    bank = ClientBank.from_sim(sim, n_total=8)
    leaf0 = tpt.tree_leaves(bank.adapters)[0]
    assert leaf0.shape[0] == 8 and leaf0.device.type == "cpu"
    idx = np.asarray([1, 4, 6])
    ad, ost = bank.gather(idx)
    assert tpt.tree_leaves(ad)[0].shape[0] == 3
    before = tpt.tree_map(torch.clone, bank.adapters)
    # perturb all three slots, scatter back only slots 0 and 2
    ad = tpt.tree_map(lambda x: x + 1.0, ad)
    bank.scatter(idx, ad, ost, round_idx=5,
                 mask=np.asarray([True, False, True]))
    for p, new in tpt.tree_leaves_with_path(bank.adapters):
        old = tpt.tree_get(before, p)
        assert torch.equal(new[[1, 6]], old[[1, 6]] + 1.0), p
        assert torch.equal(new[4], old[4]), p
        assert torch.equal(new[[0, 2, 3, 5, 7]], old[[0, 2, 3, 5, 7]]), p
    np.testing.assert_array_equal(bank.last_sync, [0, 5, 0, 0, 0, 0, 5, 0])
    np.testing.assert_array_equal(bank.staleness([1, 4, 6], 7),
                                  np.asarray([2.0, 7.0, 2.0], np.float32))
    # a gathered cohort is a copy: writing it leaves the bank as it was
    ad2, _ = bank.gather(idx)
    snap = tpt.tree_map(torch.clone, bank.adapters)
    for x in tpt.tree_leaves(ad2):
        x.add_(5.0)
    assert_equal_leaves(bank.adapters, snap, "gather copies")


def test_bank_rejects_mixed_rank_fleet():
    sim = TSim(T_CFG, THyper(method="lora", n_clients=2, local_steps=1,
                             client_ranks=(2, 4)), device="cpu")
    with pytest.raises(ValueError, match="uniform-rank fleet"):
        ClientBank.from_sim(sim, n_total=8)
    with pytest.raises(ValueError, match="n_total"):
        ClientBank.from_sim(t_sim("lora"), n_total=0)


def test_fresh_bank_file_is_the_references_byte_for_byte(ref, tmp_path):
    js = j_sim("lora")
    ts = t_sim("lora", js)
    JBank.from_sim(js, 6).save(str(tmp_path / "j.msgpack"), round_idx=2)
    ClientBank.from_sim(ts, 6).save(str(tmp_path / "t.msgpack"), round_idx=2)
    assert ((tmp_path / "j.msgpack").read_bytes()
            == (tmp_path / "t.msgpack").read_bytes())
    bank = ClientBank.from_sim(ts, 6)
    assert bank.load(str(tmp_path / "j.msgpack")) == 2
    assert all(x.device.type == "cpu"
               for x in tpt.tree_leaves(bank.adapters))


# ---------------------------------------------------------------------------
# FedSim.run_cohort_round
# ---------------------------------------------------------------------------

def test_cohort_round_without_faults_is_run_round_bit_for_bit():
    """No fault argument: no transform, the round is ``run_round``'s bit
    for bit (staleness alone is not a fault; FedBuff reads it)."""
    arrays = batch_arrays(2, seed=1)
    for method in ("fedlora_opt", "lora_fedbuff"):
        a, b = t_sim(method), t_sim(method)
        a.run_round(t_batches(arrays))
        b.run_cohort_round(t_batches(arrays),
                           staleness=np.zeros((C,), np.float32))
        assert b.last_trained is None
        assert_equal_leaves(b.client_adapters, a.client_adapters, method)
        assert_equal_leaves(b.opt_state, a.opt_state, method)
        assert a.comm_bytes == b.comm_bytes > 0


def test_dropped_client_reverts_bit_for_bit_and_is_not_billed():
    arrays = batch_arrays(1, seed=2)
    sim = t_sim("lora")
    start_ad = tpt.tree_map(torch.clone, sim.client_adapters)
    start_ost = tpt.tree_map(torch.clone, sim.opt_state)
    sim.run_cohort_round(t_batches(arrays),
                         participation=np.asarray([1, 0, 1], np.float32),
                         update_scale=np.asarray([1, 1, 4], np.float32))
    assert sim.comm_bytes == 2 * sim.client_comm_bytes()
    for p, x in tpt.tree_leaves_with_path(sim.opt_state):
        assert torch.equal(x[1], tpt.tree_get(start_ost, p)[1]), p
    # the dropped client's scaled state survives in last_trained only
    for p, x in tpt.tree_leaves_with_path(sim.last_trained["adapters"]):
        if p.endswith("lora_B"):
            assert not torch.equal(x[1], tpt.tree_get(start_ad, p)[1]), p
    # every client dropped: nothing aggregates, nothing is billed
    before = tpt.tree_map(torch.clone, sim.client_adapters)
    bill = sim.comm_bytes
    sim.run_cohort_round(t_batches(arrays),
                         participation=np.zeros((C,), np.float32))
    assert sim.comm_bytes == bill
    assert_equal_leaves(sim.client_adapters, before, "all dropped")


@pytest.mark.parametrize("method", METHODS)
def test_faulted_cohort_rounds_match_reference(ref, method):
    """Three faulted rounds from the reference's initial state: draws,
    participation, staleness, deliveries, sync rounds and comm bytes
    exact; ce within 1e-5; the bank's adapters within 1e-4."""
    r = ref[method]
    ts = t_sim(method, r["js"])
    cs = CohortSim(ts, N_TOTAL, faults=FaultPlan(**PLAN), seed=0)
    assert ts.client_comm_bytes() == r["unit"]
    for rnd in range(ROUNDS):
        out = cs.run_round(t_batches(ref["arrays"]), None)
        want = r["rounds"][rnd]
        for k in ("cohort", "participation", "staleness"):
            np.testing.assert_array_equal(out[k], want[k], err_msg=k)
        for k in ("delivered", "delivered_billed", "pending"):
            assert out[k] == want[k], (rnd, k)
        got_ce = np.asarray(out["metrics"]["ce"], np.float64)
        want_ce = np.asarray(want["metrics"]["ce"], np.float64)
        assert np.abs(got_ce - want_ce).max() <= 1e-5 * np.abs(want_ce).max()
        assert ts.comm_bytes == r["bills"][rnd], rnd
        assert_leaves(cs.bank.adapters, r["banks"][rnd], TOL,
                      f"{method} round {rnd}")
    np.testing.assert_array_equal(cs.bank.last_sync, r["last_sync"])
    # every wire byte: live clients in round, stragglers at arrival
    assert ts.comm_bytes == r["unit"] * sum(
        int(o["participation"].sum()) + o["delivered_billed"]
        for o in r["rounds"])


def test_stale_delivery_is_billed_but_discarded():
    """A straggler whose client synced again before its update arrived:
    the upload is billed, the state discarded."""
    sim = TSim(T_CFG, THyper(method="lora", n_clients=2, local_steps=1),
               device="cpu")
    cs = CohortSim(sim, n_total=2, faults=FaultPlan(seed=0), seed=0)
    arrays = [{"tokens": a["tokens"][:2], "loss_mask": a["loss_mask"][:2]}
              for a in batch_arrays(1, seed=1)]
    cs.run_round(t_batches(arrays))                       # honest round 0
    stale_ad = tpt.tree_map(lambda x: x[0].clone() + 99.0,
                            sim.client_adapters)
    stale_ost = tpt.tree_map(lambda x: x[0].clone(), sim.opt_state)
    cs._pending.append({"client": 0, "deliver_at": 1, "trained_round": -1,
                        "adapters": stale_ad, "opt_state": stale_ost})
    bill = sim.comm_bytes
    before = tpt.tree_map(torch.clone, cs.bank.adapters)
    out = cs.run_round(t_batches(arrays))
    assert out["delivered_billed"] == 1 and out["delivered"] == 0
    assert sim.comm_bytes == bill + 3 * sim.client_comm_bytes()
    for p, new in tpt.tree_leaves_with_path(cs.bank.adapters):
        old = tpt.tree_get(before, p)
        assert not torch.any(new.abs() > old.abs().max() + 50.0), p


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def pending_keys(cs):
    return [(d["client"], d["deliver_at"], d["trained_round"])
            for d in cs._pending]


@pytest.mark.parametrize("method", METHODS)
def test_checkpoints_cross_restore_byte_for_byte(ref, method, tmp_path):
    """The reference's file (round 1, a straggler in flight) loads into
    the port; the port saves it again to the same bytes; and the
    reference loads the port's file to the port's state bit for bit."""
    r = ref[method]
    ts = t_sim(method, r["js"])
    cs = CohortSim(ts, N_TOTAL, faults=FaultPlan(**PLAN), seed=0)
    assert cs.load(r["path"]) == 1
    assert pending_keys(cs) == r["pending"] and r["pending"]
    assert all(x.device.type == "cpu" for x in tpt.tree_leaves(
        cs.bank.adapters))
    mine = tmp_path / "port.msgpack"
    cs.save(str(mine))
    with open(r["path"], "rb") as f:
        assert mine.read_bytes() == f.read()
    # the port's own run, saved, restores in the reference bit for bit
    ts2 = t_sim(method, r["js"])
    cs2 = CohortSim(ts2, N_TOTAL, faults=FaultPlan(**PLAN), seed=0)
    cs2.run_round(t_batches(ref["arrays"]))
    cs2.save(str(tmp_path / "run.msgpack"))
    jc = JCohort(j_sim(method), N_TOTAL, faults=JPlan(**PLAN), seed=0)
    assert jc.load(str(tmp_path / "run.msgpack")) == 1
    assert_equal_leaves(jc.bank.adapters, cs2.bank.adapters, "bank")
    assert_equal_leaves(jc.bank.opt_state, cs2.bank.opt_state, "opt")
    np.testing.assert_array_equal(jc.bank.last_sync, cs2.bank.last_sync)
    assert jc.sim.comm_bytes == ts2.comm_bytes
    assert [(d["client"], d["deliver_at"], d["trained_round"])
            for d in jc._pending] == pending_keys(cs2)
    for dj, dt in zip(jc._pending, cs2._pending):
        assert_equal_leaves(dj["adapters"], dt["adapters"], "pending")
        assert_equal_leaves(dj["opt_state"], dt["opt_state"], "pending")


def test_restart_mid_delay_delivers_at_original_round(tmp_path):
    """A straggler buffered before a checkpoint delivers, and is billed,
    at its original round after a restart.  With the FedSim's own file
    beside the cohort file (its step counter, which AdamW's bias
    correction reads, is in neither package's cohort file), the resumed
    rounds are the uninterrupted run's bit for bit; from the cohort file
    alone they are not."""
    arrays = batch_arrays(2, seed=3)
    sim = t_sim("lora_fedbuff")
    cs = CohortSim(sim, n_total=9,
                   faults=FaultPlan(straggler_rate=1.0,
                                    straggler_delay=(2, 2), seed=7), seed=5)
    cs.run_round(t_batches(arrays))           # round 0: all straggle
    pend = pending_keys(cs)
    assert len(pend) == C and all(d == 2 for _, d, _ in pend)
    buffered = [d["adapters"] for d in cs._pending]
    path = str(tmp_path / "mid_delay.msgpack")
    cs.save(path)
    sim.save(str(tmp_path / "sim.msgpack"), round_idx=1)

    cs2 = CohortSim(t_sim("lora_fedbuff"), n_total=9,
                    faults=FaultPlan(seed=7), seed=5)   # no new faults
    assert cs2.load(path) == 1
    assert pending_keys(cs2) == pend
    for a, d in zip(buffered, cs2._pending):
        assert_equal_leaves(d["adapters"], a, "buffer")
    bill = cs2.sim.comm_bytes
    out1 = cs2.run_round(t_batches(arrays))   # round 1: too early
    assert out1["delivered"] == 0 and out1["delivered_billed"] == 0
    out2 = cs2.run_round(t_batches(arrays))   # round 2: matures
    assert out2["delivered_billed"] == C and cs2._pending == []
    unit = cs2.sim.client_comm_bytes()
    assert cs2.sim.comm_bytes == bill + unit * (
        int(out1["participation"].sum()) + int(out2["participation"].sum())
        + C)

    cs.faults = FaultPlan(seed=7)                 # as cs2's from round 1
    cs3 = CohortSim(t_sim("lora_fedbuff"), n_total=9,
                    faults=FaultPlan(seed=7), seed=5)
    assert cs3.sim.load(str(tmp_path / "sim.msgpack")) == 1
    assert cs3.load(path) == 1
    for _ in range(2):
        cs.run_round(t_batches(arrays))
        cs3.run_round(t_batches(arrays))
    assert_equal_leaves(cs3.bank.adapters, cs.bank.adapters, "resumed")
    assert_equal_leaves(cs3.bank.opt_state, cs.bank.opt_state, "resumed")
    np.testing.assert_array_equal(cs3.bank.last_sync, cs.bank.last_sync)
    assert cs3.sim.comm_bytes == cs.sim.comm_bytes == cs2.sim.comm_bytes
    assert not all(torch.equal(x, tpt.tree_get(cs.bank.adapters, p))
                   for p, x in tpt.tree_leaves_with_path(cs2.bank.adapters))


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------

def test_cohort_telemetry_metrics_and_events(tmp_path):
    path = str(tmp_path / "cohort.jsonl")
    sim = t_sim("lora")
    cs = CohortSim(sim, n_total=8,
                   faults=FaultPlan(dropout_rate=0.3, straggler_rate=0.3,
                                    seed=1), seed=0)
    arrays = batch_arrays(1, seed=5)
    obs.enable(path)
    draws = []
    for r in range(4):
        cs.run_round(t_batches(arrays))
        draws.append(cs.faults.draw(r, C))
    snap = obs.emit_snapshot()
    obs.disable()

    g = snap["gauges"]["fed/participation_rate"]
    assert g and 0.0 <= g[0]["value"] <= 1.0
    (h,) = snap["histograms"]["fed/staleness_rounds"]
    assert h["count"] >= 1
    assert set(h["buckets"]) <= {f"le_{b:g}" for b in STALENESS_BOUNDS} \
        | {"le_inf"}
    for name, key in (("fed/dropouts", "dropout"),
                      ("fed/stragglers", "straggler")):
        (s,) = snap["counters"][name]
        assert s["value"] == sum(int(d[key].sum()) for d in draws), name

    evs = obs.read_events(path, kind="fed_cohort")
    assert len(evs) == 4
    assert evs[0]["round"] == 0 and len(evs[0]["cohort"]) == 3
    assert evs[-1]["comm_bytes"] == sim.comm_bytes
    text = telemetry_section(path)
    assert "### Cohort rounds (partial participation)" in text
    assert "| lora | 0 | 3 |" in text


def test_honest_cohort_emits_full_participation(tmp_path):
    path = str(tmp_path / "honest.jsonl")
    sim = TSim(T_CFG, THyper(method="lora", n_clients=2, local_steps=1),
               device="cpu")
    cs = CohortSim(sim, n_total=5, seed=0)            # no FaultPlan
    arrays = [{"tokens": a["tokens"][:2], "loss_mask": a["loss_mask"][:2]}
              for a in batch_arrays(1, seed=0)]
    obs.enable(path)
    out = cs.run_round(t_batches(arrays))
    snap = obs.emit_snapshot()
    obs.disable()
    assert out["participation"].all() and out["pending"] == 0
    assert snap["gauges"]["fed/participation_rate"][0]["value"] == 1.0
    assert snap["counters"]["fed/dropouts"][0]["value"] == 0.0

