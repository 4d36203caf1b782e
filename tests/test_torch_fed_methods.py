"""Each baseline of the registry through both packages' ``run_federated``,
on the CPU.

One run a method: 4 specialist clients on the dolly tasks, 1 round of 2
local steps, 1 personalization step, on ``tests/test_fed.py``'s tiny f32
config at ``lora_dropout = 0``, µ = 0.5 for FedProx and client weights
1:2:3:4 for the FedBuff and trimmed-mean runs.  Both start from the backbone and the
adapter the JAX package draws (the port's method is swapped for one
whose factory returns it, through ``monkeypatch``), and train on the
same numpy batches.  The sims both ``run_federated``s build are
captured (``monkeypatch`` of each ``fedlora.FedSim``), with the client
adapters each ``aggregate`` was given.

The port also runs each method a second time with its backbone and
adapter in f64 (the reference computes in f32 whatever its weights'
dtype, so only the port can), the witness of where f32 itself cannot
resolve a leaf.

Tolerances:
- every client adapter leaf after the run, after stage 1 and in the
  aggregate within 1e-4 of the leaf's max |value| on every element but
  those where f32 itself is off: an element beyond 1e-4 must be one
  where the port's f32 run is more than 1e-5 of the leaf's max from its
  f64 run, at most 0.1% of the leaf's elements (2 at least), and within
  1e-2.  Those are AdamW's eps regime: an element whose gradient is
  near eps = 1e-8 turns an f32 sum-order difference of ~1e-10 into an
  update difference of up to ~1e-3 · lr, and a leaf that starts at 0
  (adapter_up, local_B) has max |value| of a few lr.  Measured against
  the reference: adapter_up 4.3e-4 on 6 of 8192 elements after stage 1,
  each 0.53-4.7e-4 from the port's f64 run; FedALT's q_proj local_B
  1.2e-3 on 1 of 2048 (2.0e-4 from f64, and the reference 1.0e-3 from
  it); the trimmed mean's q_proj lora_B 1.7e-4 on 1 of 2048 after stage
  3 (7.8e-5 from f64); every other element and leaf within 1e-4;
- comm bytes exactly; train and global CE within 1e-5 relative;
  accuracies within one answer token (1/B);
- ``lora_fedavg_q8``, whose rounding stream cannot match the
  reference's, statistically: stage 1 and the CE of its round as above;
  its aggregate within one quantization step (the clients' mean
  max |x| / 127) of the plain mean of the same client tensors, per
  coordinate; after the run every coordinate within two steps plus
  2·lr of the reference's (the two aggregates lie one step each from
  the same mean, and one AdamW step moves a coordinate by at most lr).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import torch

from repro.core import fedlora as j_fedlora
from repro.core import methods as j_methods
from repro.data import loader as j_loader
from repro.data import partition as j_part
from repro.data import synthetic as j_syn
from repro.fed.simulate import FedHyper as JHyper
from repro.models import model as JM
from repro.models.config import ArchConfig as JArch
from repro.utils import pytree as jpt
from repro_torch.checkpoint.bridge import params_from_numpy
from repro_torch.core import aggregation as t_agg
from repro_torch.core import fedlora as t_fedlora
from repro_torch.core import methods as t_methods
from repro_torch.data import loader as t_loader
from repro_torch.data import partition as t_part
from repro_torch.data import synthetic as t_syn
from repro_torch.fed.simulate import FedHyper as THyper
from repro_torch.models.config import ArchConfig as TArch
from repro_torch.utils import pytree as tpt

TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32",
            lora_rank=4, lora_dropout=0.0)
J_CFG, T_CFG = JArch(**TINY), TArch(**TINY)
C, B, S = 4, 2, 24
HP = dict(n_clients=C, rounds=1, local_steps=2, batch=B, seq_len=S,
          personal_steps=1, lr=3e-3, prox_mu=0.5, seed=0)
METHODS = ("ffa_lora", "fedprox", "prompt", "adapter", "fedalt",
           "lora_trimmed", "lora_fedbuff", "lora_fedavg_q8",
           "lora_fedavg_topk")
# per-client aggregation weights: FedBuff's discount multiplies them, the
# trimmed mean ignores them
WEIGHTS = {"lora_fedbuff": (1.0, 2.0, 3.0, 4.0),
           "lora_trimmed": (1.0, 2.0, 3.0, 4.0)}


def to_port(tree):
    return params_from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def flat(tree):
    if all(torch.is_tensor(x) for x in tpt.tree_leaves(tree)):
        return {p: x.detach().numpy() for p, x in
                tpt.tree_leaves_with_path(tree)}
    return dict(zip(jpt.tree_paths(tree), map(np.asarray,
                                              jax.tree.leaves(tree))))


def assert_leaves(got, want, witness, what, tol=1e-4, wtol=1e-5,
                  share=1e-3, outlier_tol=1e-2):
    """Every element of ``got`` within ``tol`` of ``want``'s leaf max
    |value| but where f32 cannot resolve it: each element beyond must be
    more than ``wtol`` from ``witness`` (the port's f64 run), a
    ``share`` of the leaf at most (2 at least), within ``outlier_tol``."""
    got, want, witness = flat(got), flat(want), flat(witness)
    assert set(got) == set(want) == set(witness), what
    for p, w in want.items():
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(got[p] - w) / scale
        out = err > tol
        n_out = int(out.sum())
        assert n_out <= max(2, share * err.size), (what, p, n_out, err.size)
        assert err.max() <= outlier_tol, (what, p, err.max())
        off64 = np.abs(got[p] - witness[p])[out] / scale
        assert (off64 > wtol).all(), (what, p, err[out], off64)


def assert_rel(got, want, tol, what):
    err = abs(got - want) / max(abs(want), 1e-30)
    assert err <= tol, (what, got, want)


@pytest.fixture(scope="module")
def setting():
    """The JAX backbone (and its port) and both packages' datasets and
    eval batches."""
    def data(pkg, part):
        fam = pkg.make_dataset_family("dolly", vocab_size=256)
        p = part.specialist_partition(C, 4)
        return ([pkg.SyntheticInstructionDataset(fam, p[c], client_seed=c)
                 for c in range(C)],
                pkg.SyntheticInstructionDataset(fam, np.ones(4) / 4,
                                                client_seed=99))
    j_ds, j_srv = data(j_syn, j_part)
    t_ds, t_srv = data(t_syn, t_part)
    j_base = JM.init_params(jax.random.PRNGKey(0), J_CFG)
    return {
        "j": (j_base, j_ds, j_srv,
              j_loader.eval_batches(j_srv, B, S, 1, seed=11),
              [j_loader.client_batch(j_ds, np.random.default_rng(9), B, S)]),
        "t": (to_port(j_base), t_ds, t_srv,
              t_loader.eval_batches(t_srv, B, S, 1, seed=11, device="cpu"),
              [t_loader.client_batch(t_ds, np.random.default_rng(9), B, S,
                                     device="cpu")])}


def capturing(monkeypatch, module):
    """Swap ``module.FedSim`` for a subclass that records each instance
    and, at each ``aggregate``, the client adapters it was given (as
    numpy) and what it returned."""
    made = []

    class Captured(module.FedSim):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

        def aggregate(self, **kw):
            self.pre_aggregate = flat(self.client_adapters)
            self.aggregated = super().aggregate(**kw)
            return self.aggregated
    monkeypatch.setattr(module, "FedSim", Captured)
    return made


def carry(monkeypatch, name):
    """Swap the port's method for one whose factory returns the adapter
    the reference's FedSim draws (``split(PRNGKey(seed))[1]``), in the
    dtype of the backbone it is given."""
    jm = j_methods.get_method(name)

    def make(base, cfg, generator):
        _, r_ad = jax.random.split(jax.random.PRNGKey(HP["seed"]))
        dt = tpt.tree_leaves(base)[0].dtype
        j_base = jax.tree.map(
            lambda x: jax.numpy.asarray(x.float().numpy()), base)
        return tpt.tree_map(lambda x: x.to(dt), to_port(
            jm.make_adapter(j_base, J_CFG, r_ad)))
    monkeypatch.setitem(t_methods._REGISTRY, name, dataclasses.replace(
        t_methods.get_method(name), make_adapter=make))


def q8_step(pre):
    """Per leaf, the clients' mean quantization step max |x_c| / 127."""
    return {p: float(np.mean([np.abs(x[c]).max() for c in range(C)])) / 127
            for p, x in pre.items()}


@pytest.mark.parametrize("method", METHODS)
def test_run_federated_matches_reference(setting, monkeypatch, method):
    carry(monkeypatch, method)
    j_sims = capturing(monkeypatch, j_fedlora)
    t_sims = capturing(monkeypatch, t_fedlora)
    j_base, j_ds, j_srv, j_g, j_l = setting["j"]
    t_base, t_ds, t_srv, t_g, t_l = setting["t"]
    hp = dict(HP, client_weights=WEIGHTS.get(method))
    want = j_fedlora.run_federated(J_CFG, JHyper(method=method, **hp), j_ds,
                                   j_srv, j_g, j_l, base=j_base)
    got = t_fedlora.run_federated(T_CFG, THyper(method=method, **hp), t_ds,
                                  t_srv, t_g, t_l, base=t_base, device="cpu")
    t_fedlora.run_federated(T_CFG, THyper(method=method, **hp), t_ds, t_srv,
                            t_g, t_l, base=tpt.tree_map(torch.Tensor.double,
                                                        t_base),
                            device="cpu")
    (js,), (ts, t64) = j_sims, t_sims
    assert got.comm_bytes == want.comm_bytes > 0
    (tg,), (jg,) = got.history, want.history
    assert_rel(tg["train_ce"], jg["train_ce"], 1e-5, "train_ce")
    assert_leaves(ts.pre_aggregate, js.pre_aggregate, t64.pre_aggregate,
                  "stage 1")
    if method == "lora_fedavg_q8":
        # the codec's bounds in place of leaf parity (module docstring)
        step = q8_step(ts.pre_aggregate)
        for p, x in ts.pre_aggregate.items():
            mean = x.mean(axis=0)
            for agg in (flat(ts.aggregated)[p], flat(js.aggregated)[p]):
                assert np.abs(agg - mean).max() <= step[p] * (1 + 1e-5), p
        t_end, j_end = flat(ts.client_adapters), flat(js.client_adapters)
        for p, s in step.items():
            bound = 2 * s + 2 * HP["lr"] + 1e-6 * np.abs(j_end[p]).max()
            assert np.abs(t_end[p] - j_end[p]).max() <= bound, p
        return
    assert_leaves(ts.aggregated, js.aggregated, t64.aggregated, "aggregate")
    assert_leaves(ts.client_adapters, js.client_adapters, t64.client_adapters,
                  "client adapters after run_federated")
    assert_rel(tg["ce"], jg["ce"], 1e-5, "global ce")
    assert abs(tg["acc"] - jg["acc"]) <= 1.0 / B
    assert abs(got.local_acc - want.local_acc) <= 1.0 / B
    assert np.abs(np.subtract(got.per_client, want.per_client)).max() <= 1 / B
    if method == "fedalt":
        for p, x in flat(ts.aggregated).items():
            assert (not x.any()) == p.endswith(("local_A", "local_B")), p
    if method == "lora_trimmed":
        # 4 clients at trim ratio 0.25: the mean of the middle two
        pre = ts.pre_aggregate["blocks/sub0/attn/q_proj/lora_A"]
        mid = np.sort(pre, axis=0)[1:3].mean(axis=0)
        assert np.abs(flat(ts.aggregated)["blocks/sub0/attn/q_proj/lora_A"]
                      - mid).max() <= 1e-6 * np.abs(mid).max()


def test_fedprox_round_reference_follows_the_rebroadcast(setting):
    """The round reference is the client adapters as the first round
    found them, then the rebroadcast of each ``aggregate``, never the
    adapters as trained."""
    from repro_torch.fed.simulate import FedSim
    t_base, t_ds, *_ = setting["t"]
    sim = FedSim(T_CFG, THyper(method="fedprox", **HP), base=t_base,
                 device="cpu")
    start = sim.client_adapters
    rng = np.random.default_rng(0)

    def batches(n):
        return [t_loader.client_batch(t_ds, rng, B, S, device="cpu")
                for _ in range(n)]
    sim.local_round(batches(1))
    sim.local_round(batches(1))
    assert sim._round_ref is start
    sim.aggregate()
    assert sim._round_ref is sim.client_adapters
    bcast = sim.client_adapters
    sim.local_round(batches(1))
    assert sim._round_ref is bcast and sim.client_adapters is not bcast
    lora = FedSim(T_CFG, THyper(method="lora", **HP), base=t_base,
                  device="cpu")
    lora.local_round(batches(1))
    assert lora._round_ref is None           # no prox term, no reference
    assert t_agg.topk_ratio(t_methods.get_method("lora_fedavg_topk")) == 0.05
