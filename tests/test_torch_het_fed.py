"""Mixed-rank fleets through both packages' ``run_federated``, on the CPU.

The fleet: 4 specialist dolly clients at ranks (1, 2, 3, 4), so the
allocated rank is 4 (``server_rank`` 10 = Σrᵢ for one ``lora_exact``
run), 1 round of 2 local steps, 1 personalization step (and the
pipeline's global stage for ``fedlora_opt``), on ``tests/test_fed.py``'s
tiny f32 config at ``lora_dropout = 0``.  Both packages start from the
backbone and the *unmasked* adapter the JAX package draws at the
allocated rank; each masks its own client stack.  The port also runs
each case with its backbone and adapter in f64, the witness of where
f32 itself cannot resolve a leaf (``tests/test_torch_fed_methods.py``).

Tolerances (``test_torch_fed_methods.assert_leaves``):
- every client adapter leaf after stage 1, the aggregate and every
  client leaf after the run within 1e-4 of the leaf's max |value| but
  on elements f32 cannot resolve (each more than 1e-5 from the port's
  f64 run, at most 0.1% of the leaf, within 1e-2);
- ``lora_exact``: QR and SVD fix each rank column of the aggregate only
  up to its sign, and every later step is equivariant under the flip
  (AdamW's m flips with the gradient, v does not; the clip norm is
  unchanged).  So the port's aggregate is sign-aligned to the
  reference's column by column, and that alignment is carried to the
  client leaves after the run; the products A·B are held without it,
  by the same scheme;
- rows above each client's rank exactly 0 after every stage, bit for bit;
- comm bytes exactly; train and global CE within 1e-5 relative;
  accuracies within one answer token (1/B).
"""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax", reason="parity tests need the JAX package")
import torch

from repro.core import fedlora as j_fedlora
from repro.core import methods as j_methods
from repro.fed.simulate import FedHyper as JHyper, FedSim as JSim
from repro_torch.core import fedlora as t_fedlora
from repro_torch.core import methods as t_methods
from repro_torch.core import peft as t_peft
from repro_torch.fed.simulate import FedHyper as THyper, FedSim as TSim
from repro_torch.utils import pytree as tpt
from test_torch_fed_methods import (B, HP, J_CFG, T_CFG, assert_leaves,
                                    assert_rel, flat, setting, to_port)

RANKS = (1, 2, 3, 4)
RUNS = {"lora_zeropad": 0, "lora_replication": 0, "lora_exact": 0,
        "fedlora_opt": 0, "lora_exact@10": 10}       # name → server_rank


def carry(monkeypatch, name):
    """Swap the port's method for one whose factory returns the adapter
    the reference's FedSim draws (``split(PRNGKey(seed))[1]``, at the
    allocated ``rank``), in the dtype of the backbone it is given."""
    jm = j_methods.get_method(name)

    def make(base, cfg, generator, rank=0):
        _, r_ad = jax.random.split(jax.random.PRNGKey(HP["seed"]))
        dt = tpt.tree_leaves(base)[0].dtype
        j_base = jax.tree.map(
            lambda x: jax.numpy.asarray(x.float().numpy()), base)
        return tpt.tree_map(lambda x: x.to(dt), to_port(
            jm.make_adapter(j_base, J_CFG, r_ad, rank=rank)))
    monkeypatch.setitem(t_methods._REGISTRY, name, dataclasses.replace(
        t_methods.get_method(name), make_adapter=make))


def zero_rows(tree, what):
    for p, x in tpt.tree_leaves_with_path(tree):
        ax = t_peft.rank_axis(p)
        for c, r in enumerate(RANKS if ax is not None else ()):
            assert not torch.count_nonzero(x[c].movedim(ax, 0)[r:]), (
                what, p, c)


def capturing(monkeypatch, module, check=False):
    """Swap ``module.FedSim`` for a subclass that records each instance,
    the client adapters each ``aggregate`` was given (as numpy) and what
    it returned; with ``check``, the zero rows after every stage."""
    made = []

    class Captured(module.FedSim):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made.append(self)

        def held(self, what):
            if check:
                zero_rows(self.client_adapters, what)

        def local_round(self, *a, **k):
            self.held("init")
            out = super().local_round(*a, **k)
            self.held("stage 1")
            return out

        def aggregate(self, **kw):
            self.pre_aggregate = flat(self.client_adapters)
            self.aggregated = super().aggregate(**kw)
            self.held("aggregate")
            return self.aggregated

        def global_stage(self, *a, **k):
            out = super().global_stage(*a, **k)
            self.held("stage 2")
            return out

        def personalize(self, *a, **k):
            super().personalize(*a, **k)
            self.held("stage 3")
    monkeypatch.setattr(module, "FedSim", Captured)
    return made


def products(tree):
    """{lora_A path: A·B} of each pair of a flat aggregate."""
    return {p: tree[p] @ tree[p[:-1] + "B"] for p in tree
            if p.endswith("/lora_A")}


def column_signs(got, want):
    """{lora_A path: the sign of each rank column of ``got``'s A against
    ``want``'s}, shape (*lead, 1, r) (1 where a column is 0)."""
    out = {}
    for p, a in got.items():
        if p.endswith("/lora_A"):
            s = np.sign(np.sum(a * want[p], axis=-2, keepdims=True))
            s[s == 0] = 1
            out[p] = s
    return out


def aligned(tree, signs):
    """A flat tree (aggregate or client stack) with each pair's rank
    columns flipped by ``signs`` (A's columns and B's rows together)."""
    out = dict(tree)
    for pa, s in signs.items():
        pb = pa[:-1] + "B"
        out[pa] = tree[pa] * s
        out[pb] = tree[pb] * np.swapaxes(s, -1, -2)
    return out


@pytest.mark.parametrize("run", list(RUNS))
def test_mixed_rank_run_federated_matches_reference(setting, monkeypatch,
                                                    run):
    method = run.split("@")[0]
    carry(monkeypatch, method)
    j_sims = capturing(monkeypatch, j_fedlora)
    t_sims = capturing(monkeypatch, t_fedlora, check=True)
    j_base, j_ds, j_srv, j_g, j_l = setting["j"]
    t_base, t_ds, t_srv, t_g, t_l = setting["t"]
    hp = dict(HP, client_ranks=RANKS, server_rank=RUNS[run])
    want = j_fedlora.run_federated(J_CFG, JHyper(method=method, **hp), j_ds,
                                   j_srv, j_g, j_l, base=j_base)
    got = t_fedlora.run_federated(T_CFG, THyper(method=method, **hp), t_ds,
                                  t_srv, t_g, t_l, base=t_base, device="cpu")
    t_fedlora.run_federated(T_CFG, THyper(method=method, **hp), t_ds, t_srv,
                            t_g, t_l, base=tpt.tree_map(torch.Tensor.double,
                                                        t_base),
                            device="cpu")
    (js,), (ts, t64) = j_sims, t_sims
    assert ts.alloc_rank == js.alloc_rank == (RUNS[run] or max(RANKS))
    assert got.comm_bytes == want.comm_bytes > 0
    (tg,), (jg,) = got.history, want.history
    assert_rel(tg["train_ce"], jg["train_ce"], 1e-5, "train_ce")
    assert_leaves(ts.pre_aggregate, js.pre_aggregate, t64.pre_aggregate,
                  "stage 1")
    t_agg, j_agg, w_agg = (flat(s.aggregated) for s in (ts, js, t64))
    t_end, j_end, w_end = (flat(s.client_adapters) for s in (ts, js, t64))
    if method == "lora_exact":
        assert_leaves(*(products(a) for a in (t_agg, j_agg, w_agg)),
                      "aggregate A·B")
        s_t, s_w = column_signs(t_agg, j_agg), column_signs(w_agg, j_agg)
        t_agg, w_agg = aligned(t_agg, s_t), aligned(w_agg, s_w)
        t_end, w_end = aligned(t_end, s_t), aligned(w_end, s_w)
    assert_leaves(t_agg, j_agg, w_agg, "aggregate")
    assert_leaves(t_end, j_end, w_end, "client adapters after run_federated")
    assert_rel(tg["ce"], jg["ce"], 1e-5, "global ce")
    assert abs(tg["acc"] - jg["acc"]) <= 1.0 / B
    assert abs(got.local_acc - want.local_acc) <= 1.0 / B
    assert np.abs(np.subtract(got.per_client, want.per_client)).max() <= 1 / B


@pytest.mark.parametrize("method", ["prompt", "adapter"])
def test_methods_without_a_rank_axis_raise_the_reference_error(method):
    hp = dict(n_clients=4, client_ranks=RANKS)
    with pytest.raises(ValueError) as want:
        JSim(J_CFG, JHyper(method=method, **hp))
    with pytest.raises(ValueError) as got:
        TSim(T_CFG, THyper(method=method, **hp), device="cpu")
    assert str(got.value) == str(want.value)
