"""The port's production round engine (``launch/train.py``) on 4 gloo
ranks on the CPU.

One ``ClientPool`` of 4 ranks serves the module (``tests/
torch_engine_ranks.py`` holds the rank side).  The config is the
reference's parity harness's (``tests/test_distributed.py``): 1 layer,
d 32, 2 heads over 1 kv head, vocab 64, rank 4, 4 clients, 2 local steps
of 2 x 16 tokens, 2 rounds or pipeline iterations of 2 stage-2 and 2
stage-3 steps, lr 1e-2, server lr 5e-3, λ 1e-2, µ 0.05 for FedProx,
``lora_dropout`` 0 but where stated.

Against the port's ``FedSim``, in f64 (backbone and adapters), so that
AdamW's eps regime cannot hide a wrong collective: every client leaf and
every leaf of the server model within 1e-9 of the leaf's max |value|
(``lora_exact``: the products A·B of each pair; its factors are fixed up
to a sign per rank column).  One ``fedlora_opt`` pipeline runs at
jamba-v0.1-52b's SMOKE config instead (the hybrid family: attention,
Mamba and MoE sublayers), and one at seamless-m4t-large-v2's (the
encoder-decoder, with frontend_emb in every batch).  Measured: 0 on every leaf of every case
but two kinds, each held at its own stated tolerance: the weighted
fleets (TOL_WEIGHTED: FedSim normalizes the weights in f32) and the
sharded stage 2 over ragged loss masks (TOL_RAGGED: the CE runs in f32).

Against the JAX package's production engine (``repro.launch.train``, 4
host devices in a subprocess), in f32: the ``fedlora_opt`` pipeline (2
iterations, the sharded stage 2) and 2 faulted ``lora_fedbuff`` rounds,
at the reference harness's rtol 2e-4 / atol 2e-5, or by the f64-witness
rule of ``tests/test_torch_fed_methods.py`` where AdamW's eps regime
needs it (an element outside must be more than 1e-5 of the leaf's max
from the port's f64 run, at most 0.1% of the leaf, 2 at least, within
1e-2 of its max).
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

import torch_engine_ranks as R
from repro_torch.configs import get_smoke_config
from repro_torch.core import aggregation as agg
from repro_torch.core import peft
from repro_torch.core.methods import FedMethod, available_methods, get_method
from repro_torch.fed.simulate import FedHyper, FedSim
from repro_torch.launch.mesh import ClientPool, make_client_mesh
from repro_torch.launch.train import (TrainSettings, make_fed_pipeline_step,
                                      make_fed_train_step,
                                      pick_micro_batches, rank_slice,
                                      stack_ranks)
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.utils import pytree as pt

C, T, B, S, ROUNDS = 4, 2, 2, 16, 2
TG, TP = 2, 2
TINY = dict(name="t", family="dense", n_layers=1, d_model=32, n_heads=2,
            n_kv_heads=1, d_ff=64, vocab_size=64, dtype="float32",
            lora_rank=4, lora_dropout=0.0)
CFG = ArchConfig(**TINY)
# the same at MoE, 4 experts top-2 at the published capacity factor: each
# rank's capacity comes from its own micro-batch (a stage-2 slice of 16
# tokens takes 10 rows a slot, FedSim's whole batch 40)
TINY_MOE = dict(TINY, family="moe", n_experts=4, top_k=2,
                capacity_factor=1.25)
CFG_MOE = ArchConfig(**TINY_MOE)
# jamba's SMOKE config, the hybrid family: 2 layers of d 256, vocab 512
CFG_JAMBA = dataclasses.replace(get_smoke_config("jamba-v0.1-52b"),
                                lora_dropout=0.0)
# seamless-m4t's SMOKE config, the encoder-decoder family: 2 + 2 layers of
# d 256, vocab 512; its batches carry ENC_F frames of frontend_emb a row
CFG_ENCDEC = dataclasses.replace(get_smoke_config("seamless-m4t-large-v2"),
                                 lora_dropout=0.0)
ENC_F = 12
HP = dict(n_clients=C, local_steps=T, batch=B, seq_len=S, lr=1e-2,
          server_lr=5e-3, global_steps=TG, personal_steps=TP, lam=1e-2)
TOL = 1e-9
# FedSim normalizes client weights in f32 (w / Σw), so its weight ratios
# are f32-rounded: a weighted fleet's mean is off the exact Σwᵢxᵢ / Σwᵢ
# (the all-reduce's) by up to ~1e-7 of the leaf, in any dtype
TOL_WEIGHTED = 2e-6
# the CE runs in f32 whatever the adapters' dtype (model._ce_chunk), so a
# sharded step with uneven token counts rounds each slice's 1/n_r in f32
# where FedSim rounds 1/N once: measured at most 3.1e-6 of a leaf's max
# (lora) and 1.0e-6 (fedlora_opt); a mean of the slices' means is at least
# 3.5e-2 / 5.0e-4 off
TOL_RAGGED = 1e-5
METHODS = tuple(available_methods())
SRC = os.path.join(os.path.dirname(__file__), "..", "src")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """FedSim in this process on one intra-op thread, as each rank: the
    tiny config gains nothing from more, and beside the 4 ranks and the
    other test workers more threads only contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with ClientPool(C, str(tmp_path_factory.mktemp("pool"))) as p:
        yield p


def prox(name):
    return 0.05 if get_method(name).prox else 0.0


def settings(name, **kw):
    """The engine's settings matching FedHyper(**HP, **kw)."""
    return dict(lr=HP["lr"], micro_batches=1, clip=1.0, remat=False,
                method=name, local_steps=T, server_lr=HP["server_lr"],
                global_steps=TG, personal_steps=TP, lam=HP["lam"], **kw)


def sim64(name, cfg=CFG, **kw):
    """The port's FedSim on the CPU with its backbone, adapters and
    optimizer state in f64."""
    base = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    sim = FedSim(cfg, FedHyper(method=name, **HP, **kw),
                 base=pt.tree_map(torch.Tensor.double, base), device="cpu")
    sim.client_adapters = pt.tree_map(torch.Tensor.double,
                                      sim.client_adapters)
    sim.opt_state = sim._init_clients(sim.opt)
    return sim


def data(name):
    """A name-keyed numpy stream (cases do not depend on each other)."""
    return np.random.default_rng(zlib.crc32(name.encode()))


def frames(rng, lead, d):
    """``frontend_emb`` rows: N(0, 1) frames of width d behind ``lead``."""
    return torch.as_tensor(rng.normal(size=(*lead, ENC_F, d)))


def client_batches(rng, n=T, cfg=CFG):
    out = []
    for _ in range(n):
        b = {"tokens": torch.as_tensor(rng.integers(5, 64, size=(C, B, S))),
             "loss_mask": torch.ones((C, B, S))}
        if cfg.frontend:
            b["frontend_emb"] = frames(rng, (C, B), cfg.d_model)
        out.append(b)
    return out


def server_batches(rng, rows=B, ragged=False, cfg=CFG):
    """TG server batches; ``ragged``: each row's loss mask opens at a
    random position (as an instruction's prompt is masked), so that the
    ranks' slices of a sharded step count different tokens."""
    out = []
    for _ in range(TG):
        tokens = torch.as_tensor(rng.integers(5, 64, size=(rows, S)))
        mask = torch.ones((rows, S))
        if ragged:
            start = rng.integers(0, S - 2, size=rows)
            mask = torch.as_tensor(
                (np.arange(S)[None] >= start[:, None]).astype(np.float32))
        b = {"tokens": tokens, "loss_mask": mask}
        if cfg.frontend:
            b["frontend_emb"] = frames(rng, (rows,), cfg.d_model)
        out.append(b)
    return out


def cat(bs, dim):
    return {k: torch.cat([b[k] for b in bs], dim) for k in bs[0]}


def assert_parity(name, got, want, tol=TOL):
    """Every leaf within ``tol`` of its max |value| (lora_exact: the
    products of its pairs); returns the largest relative error."""
    got, want = dict(got), dict(want)
    assert set(got) == set(want), name
    worst = 0.0
    if name == "lora_exact":
        for pa in sorted(p for p in want if p.endswith("lora_A")):
            pb = pa[:-1] + "B"
            g = np.einsum("...ir,...ro->...io", got.pop(pa), got.pop(pb))
            w = np.einsum("...ir,...ro->...io", want.pop(pa), want.pop(pb))
            got[pa], want[pa] = g, w
    for p, w in want.items():
        err = np.abs(got[p] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (name, p, err)
        worst = max(worst, err)
    return worst


def run_rounds(pool, name, *, ranks=None, weights=None, micro=1):
    kw = dict(prox_mu=prox(name), client_ranks=ranks, client_weights=weights)
    sim, rng = sim64(name, **kw), data(name)
    # copies: passing the adapters to the pool moves their storage into
    # shared memory, and a numpy view would keep pointing at the old one
    start = {p: x.copy() for p, x in R.host(sim.client_adapters).items()}
    per_round = [client_batches(rng) for _ in range(ROUNDS)]
    st = dict(settings(name, **kw), micro_batches=micro)
    res = pool.run(R.rounds, CFG, st, sim.base, sim.client_adapters,
                   sim.opt_state, [cat(bs, 1) for bs in per_round])
    for bs in per_round:
        sim_met = sim.run_round(bs)
    want = R.host(sim.client_adapters)
    assert any(not np.array_equal(want[p], start[p]) for p in want), name
    # the last round's metrics: the means over the ranks of FedSim's
    # per-client ce and pre-clip grad_norm
    for k in ("ce", "grad_norm"):
        np.testing.assert_allclose(res[0][2][-1][k], sim_met[k].mean(),
                                   rtol=1e-6, err_msg=f"{name} {k}")
    return assert_parity(name, R.stack(res), want,
                         TOL if weights is None else TOL_WEIGHTED)


def run_pipeline(pool, name, *, ranks=None, weights=None, server_rows=B,
                 ragged=False, cfg=CFG):
    kw = dict(prox_mu=prox(name), client_ranks=ranks, client_weights=weights)
    sim, rng = sim64(name, cfg, **kw), data(name)
    iters = []
    for _ in range(ROUNDS):
        cb = client_batches(rng, cfg=cfg)
        sb = server_batches(rng, server_rows, ragged, cfg=cfg)
        pb = client_batches(rng, TP, cfg=cfg)
        iters.append((cb, sb, pb))
    res = pool.run(R.pipeline, cfg, settings(name, **kw), sim.base,
                   sim.client_adapters, sim.opt_state,
                   [(cat(cb, 1), cat(sb, 0), cat(pb, 1))
                    for cb, sb, pb in iters])
    for cb, sb, pb in iters:
        sim.local_round(cb)
        a = sim.aggregate()
        a = sim.global_stage(a, sb)
        sim.personalize(pb)
    assert all(r[4] for r in res), f"{name}: stage 2 moved a keep-local leaf"
    for r in res[1:]:                     # one server model on every rank
        for p, x in r[2].items():
            np.testing.assert_array_equal(x, res[0][2][p], err_msg=p)
    tol = (TOL_RAGGED if ragged else TOL) if weights is None else TOL_WEIGHTED
    return max(assert_parity(name, R.stack(res), R.host(sim.client_adapters),
                             tol),
               assert_parity(name, res[0][2], R.host(a), tol))


# ---------------------------------------------------------------------------
# against the port's FedSim, f64
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", METHODS)
def test_round_parity_all_methods(pool, name):
    """Two production rounds on 4 ranks == two FedSim.run_round (every
    collective kind: wmean, coverage, staleness, gather_exact,
    gather_trimmed, q8, topk)."""
    run_rounds(pool, name)


KINDS = {"wmean": agg.WMEAN, "coverage": agg.COVERAGE,
         "staleness": agg.STALENESS, "gather_exact": agg.GATHER_EXACT,
         "gather_trimmed": agg.gather_trimmed(0.25),
         "q8": agg.COMPRESSED_Q8, "topk": agg.compressed_topk(0.05)}


@pytest.mark.parametrize("kind", tuple(KINDS))
def test_collective_kinds_against_their_definitions(pool, kind):
    """Each CollectiveAgg kind on 4 ranks, f64 client trees (pairs at
    ranks 1-4, weights 1:2:3:4, staleness 0/2/5/1): the psum kinds
    within 1e-12 of Σwᵢxᵢ / Σwᵢ in numpy f64 (coverage per rank row;
    staleness with FedSim's f32 discount; q8 and top-k over each client
    encoded as FedSim encodes it), the gather kinds equal to the host
    aggregator on the stacked trees; one result on every rank."""
    rng = np.random.default_rng(zlib.crc32(kind.encode()))
    ranks, w = (1, 2, 3, 4), np.array([1., 2., 3., 4.])
    tau = np.array([0., 2., 5., 1.])
    tree = {"q": {"lora_A": torch.as_tensor(rng.normal(size=(C, 8, 4))),
                  "lora_B": torch.as_tensor(rng.normal(size=(C, 4, 6)))},
            "b": torch.as_tensor(rng.normal(size=(C, 5)))}
    covers = peft.client_rank_masks(pt.tree_map(lambda x: x[0], tree), ranks)
    tree = peft.apply_rank_masks(tree, covers)
    res = pool.run(R.collective, KINDS[kind], tree, covers, w, tau, 3)
    for r in res[1:]:
        for p, x in r.items():
            np.testing.assert_array_equal(x, res[0][p], err_msg=p)
    got, x, cov = res[0], R.host(tree), R.host(covers)
    if kind == "gather_exact":
        want = R.host(agg.exact_fedavg(tree, torch.tensor(w)))
        np.testing.assert_array_equal(got["q/lora_A"] @ got["q/lora_B"],
                                      want["q/lora_A"] @ want["q/lora_B"])
        np.testing.assert_array_equal(got["b"], want["b"])
        return
    if kind == "gather_trimmed":
        want = R.host(agg.trimmed_fedavg(tree, trim_ratio=0.25))
        for p in want:
            np.testing.assert_array_equal(got[p], want[p], err_msg=p)
        return
    if kind in ("q8", "topk"):
        enc = [R.host(agg.compress_update(
            pt.tree_map(lambda t: t[c], tree), mode=kind, step=3,
            client_idx=c, topk_ratio=0.05)) for c in range(C)]
        x = {p: np.stack([e[p] for e in enc]) for p in x}
    if kind == "staleness":
        w = (torch.tensor(w, dtype=torch.float32)
             * agg.staleness_scale(torch.tensor(tau), 0.5)).double().numpy()
    for p, v in x.items():
        wb = w.reshape((C,) + (1,) * (v.ndim - 1))
        c = cov[p] if kind == "coverage" else np.ones_like(wb)
        want = (v * c * wb).sum(0) / (c * wb).sum(0)
        err = np.abs(got[p] - want).max() / np.abs(want).max()
        assert err <= 1e-12, (kind, p, err)


@pytest.mark.parametrize("name", METHODS)
def test_pipeline_parity_all_methods(pool, name):
    """Two pipeline iterations == FedSim's local_round → aggregate →
    global_stage → personalize: the client adapters and the server
    model; stage 2 leaves the keep-local leaves alone."""
    run_pipeline(pool, name)


HET_CASES = (("fedlora_opt", (1, 2, 3, 4), None),
             ("lora_zeropad", (1, 2, 3, 4), None),
             ("lora_replication", (1, 2, 3, 4), (1., 2., 3., 4.)),
             ("lora_exact", (1, 2, 3, 4), (4., 3., 2., 1.)),
             ("fedalt", (2, 4, 4, 2), None),
             ("lora", None, (1., 2., 3., 4.)))


@pytest.mark.parametrize("name,ranks,weights", HET_CASES,
                         ids=[c[0] for c in HET_CASES])
def test_pipeline_parity_het_and_weighted_fleets(pool, name, ranks, weights):
    run_pipeline(pool, name, ranks=ranks, weights=weights)


def test_hybrid_pipeline_parity(pool):
    """fedlora_opt at jamba's SMOKE config (an attention + dense and a
    Mamba + MoE sublayer; adapters on q / v): each rank runs the plain
    scan under autograd and ``moe_ffn_local`` on its own micro-batch
    (capacity 8: nothing dropped), two iterations == FedSim's."""
    run_pipeline(pool, "fedlora_opt", cfg=CFG_JAMBA)


def test_encoder_decoder_pipeline_parity(pool):
    """fedlora_opt at seamless-m4t's SMOKE config (a non-causal encoder,
    decoder layers of self-attention and cross-attention; adapters on
    q / v of all three): every batch carries frontend_emb (12 frames
    against 16 tokens), which each rank slices per micro-batch as it
    slices the tokens (sharded in stage 2), two iterations == FedSim's."""
    run_pipeline(pool, "fedlora_opt", cfg=CFG_ENCDEC)


@pytest.mark.parametrize("name", ("lora", "fedlora_opt"))
def test_pipeline_stage2_sharded_server_batch(pool, name):
    """Server batches of 4 rows (8 a stage, divisible over 4 ranks): each
    rank grads its slice and the token-weighted all-reduce gives the
    full-batch gradient."""
    run_pipeline(pool, name, server_rows=4)


@pytest.mark.parametrize("name", ("lora", "fedlora_opt"))
def test_pipeline_stage2_sharded_ragged_loss_masks(pool, name):
    """The sharded stage 2 with each server row's loss mask opening at
    its own position: the ranks' slices count different tokens, so only
    the token-weighted all-reduce (Σ n_r·g_r / Σ n_r) gives FedSim's
    full-batch gradient; a mean of the slices' means does not (held
    within TOL_RAGGED: the f32 CE rounds each slice's 1/n_r)."""
    run_pipeline(pool, name, server_rows=4, ragged=True)


def test_micro_batches_two_against_one(pool):
    """Two micro-batches of 1 row a step accumulate the gradient FedSim
    takes on the whole step (uniform loss masks)."""
    run_rounds(pool, "fedlora_opt", micro=2)


FAULT_CASES = (
    ("lora", (1., 2., 3., 4.),
     [{"participation": (1., 0., 1., 1.)},
      {"participation": (0., 1., 1., 0.)}]),
    ("lora_trimmed", None,
     [{"participation": (1., 1., 1., 1.), "update_scale": (1., 25., 1., 1.)},
      {"participation": (1., 0., 1., 1.), "update_scale": (1., 1., 40., 1.)}]),
    ("lora_fedbuff", None,
     [{"participation": (1., 1., 0., 1.), "staleness": (0., 2., 5., 1.)},
      {"participation": (1., 1., 1., 0.), "staleness": (3., 0., 0., 7.)}]))


@pytest.mark.parametrize("name,weights,faults", FAULT_CASES,
                         ids=[c[0] for c in FAULT_CASES])
def test_collective_parity_faulted_and_async_rounds(pool, name, weights,
                                                    faults):
    """Participation / update_scale / staleness vectors == FedSim
    .run_cohort_round; FedSim bills only live clients, and the engine's
    analytic round bill is FedSim's unit for every client."""
    sim, rng = sim64(name, client_weights=weights), data(name)
    per_round = [client_batches(rng) for _ in faults]
    res = pool.run(R.rounds, CFG, settings(name, client_weights=weights),
                   sim.base, sim.client_adapters, sim.opt_state,
                   [cat(bs, 1) for bs in per_round], faults=faults)
    for bs, f in zip(per_round, faults):
        sim.run_cohort_round(bs, **f)
    assert_parity(name, R.stack(res), R.host(sim.client_adapters),
                  TOL_WEIGHTED)
    live = sum(sum(p > 0 for p in f["participation"]) for f in faults)
    assert sim.comm_bytes == live * sim.client_comm_bytes()


def test_round_bill_equals_fedsim(pool):
    """comm_bytes_round on 4 ranks is FedSim's bill for one round of
    every client, a mixed fleet billed at each client's rank."""
    for name, ranks in (("lora_exact", (1, 2, 3, 4)), ("fedlora_opt", None),
                        ("lora_trimmed", None), ("lora_fedavg_q8", None),
                        ("lora_fedavg_topk", None)):
        sim = sim64(name, client_ranks=ranks)
        sim.aggregate()
        assert pool.run(_bill, name, ranks) == [sim.comm_bytes] * C, name


def _bill(group, name, ranks):
    return make_fed_pipeline_step(
        CFG, group, TrainSettings(method=name, client_ranks=ranks),
        device="cpu").comm_bytes_round


# ---------------------------------------------------------------------------
# dropout, remat
# ---------------------------------------------------------------------------

def test_dropout_trains_at_the_configured_rate(pool):
    """lora_dropout 0.3: every draw keeps ≈70% of its nonzero inputs
    (each of thousands of elements), the ranks draw different masks, the
    same seed retrains the same adapters, another seed others."""
    cfg = dataclasses.replace(CFG, lora_dropout=0.3)
    sim = FedSim(cfg, FedHyper(method="lora", **HP), device="cpu")
    rng = data("dropout")
    big = [cat(client_batches(rng), 1)]
    st = settings("lora")
    a = pool.run(R.dropout_rates, cfg, st, sim.base, sim.client_adapters,
                 big, 7)
    b = pool.run(R.dropout_rates, cfg, st, sim.base, sim.client_adapters,
                 big, 7)
    c = pool.run(R.dropout_rates, cfg, st, sim.base, sim.client_adapters,
                 big, 8)
    shares = np.concatenate([r[1] for r in a])
    assert shares.size == C * T * 2 and abs(shares.mean() - 0.7) < 0.02
    assert np.all(np.abs(shares - 0.7) < 0.1), shares
    assert len({tuple(r[1]) for r in a}) == C        # masks differ by rank
    for p, x in R.stack(a).items():
        np.testing.assert_array_equal(x, R.stack(b)[p], err_msg=p)
        assert np.all(np.isfinite(x))
    assert any(not np.array_equal(x, R.stack(c)[p])
               for p, x in R.stack(a).items())


@pytest.mark.parametrize("remat", (True, "dots"))
def test_remat_equals_no_remat(remat):
    """Checkpointed superblocks give the loss and gradients of the plain
    forward bit for bit, adapter dropout included (the explicit
    generator is rewound for the recomputation and left where the
    forward pass left it)."""
    cfg = dataclasses.replace(CFG, n_layers=3, lora_dropout=0.3)
    base = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    ad = get_method("fedlora_opt").make_adapter(
        base, cfg, torch.Generator().manual_seed(1))
    ad = pt.tree_map(lambda x: x + 0.01, ad)
    batch = {"tokens": torch.randint(0, 64, (2, 16),
                                     generator=torch.Generator().manual_seed(2)),
             "loss_mask": torch.ones(2, 16)}
    out = {}
    for r in (False, remat):
        leaves = pt.tree_map(lambda x: x.detach().requires_grad_(True), ad)
        g = torch.Generator().manual_seed(5)
        loss, _ = M.loss_and_metrics(pt.merge_trees(base, leaves), batch,
                                     cfg, rng=g, remat=r)
        grads = torch.autograd.grad(loss, pt.tree_leaves(leaves))
        out[r] = (loss, grads, g.get_state())
    assert torch.equal(out[False][0], out[remat][0])
    for x, y in zip(out[False][1], out[remat][1]):
        assert torch.equal(x, y)
    assert torch.equal(out[False][2], out[remat][2])


# ---------------------------------------------------------------------------
# single process: construction, telemetry, events
# ---------------------------------------------------------------------------

def test_fed_train_step_rejects_bad_fleets():
    """The reference's construction errors, with its messages."""
    mesh = make_client_mesh(1)
    with pytest.raises(ValueError, match="entries for"):
        make_fed_train_step(CFG, mesh, TrainSettings(
            method="lora", client_ranks=(2, 4)), device="cpu")
    with pytest.raises(ValueError, match="entries for"):
        make_fed_train_step(CFG, mesh, TrainSettings(
            method="lora", client_weights=(1.0, 2.0)), device="cpu")
    with pytest.raises(ValueError, match="het_ranks=False"):
        make_fed_train_step(CFG, mesh, TrainSettings(
            method="prompt", client_ranks=(4,)), device="cpu")
    with pytest.raises(ValueError, match="use_fused_dora"):
        make_fed_train_step(dataclasses.replace(CFG, use_fused_dora=True),
                            mesh, TrainSettings(), device="cpu")
    # MoE configs build (each rank runs moe_ffn_local on its own
    # micro-batch), and since A12e so do the vision-language and
    # encoder-decoder families, which were refused with
    # NotImplementedError: nothing of the reference's registry is refused
    for cfg in (CFG_MOE, dataclasses.replace(CFG, family="vlm"), CFG_ENCDEC):
        step_fn, opt_init = make_fed_train_step(cfg, mesh, TrainSettings(),
                                                device="cpu")
        assert callable(step_fn) and callable(opt_init)
    custom = FedMethod(name="custom", make_adapter=lambda *a, **k: {},
                       train_mask=lambda t: t, aggregate=lambda t: t)
    with pytest.raises(ValueError, match="no shard_map collective form"):
        agg.collective_form(custom)
    import functools
    mismatched = FedMethod(
        name="excl", make_adapter=lambda *a, **k: {},
        train_mask=lambda t: t,
        aggregate=functools.partial(agg.fedavg_excluding,
                                    exclude_rx=r"foo$"),
        keep_local=r"bar$")
    with pytest.raises(ValueError, match="no shard_map collective form"):
        agg.collective_form(mismatched)
    assert agg.comm_class(custom) == "psum"
    with pytest.raises(RuntimeError, match="needs torch.distributed"):
        make_client_mesh(2)


def test_train_step_telemetry_flag_changes_only_metrics():
    """telemetry=True adds the per-client metric leaves and nothing else
    (one client, no process group)."""
    mesh = make_client_mesh(1)
    sim = FedSim(CFG, FedHyper(method="fedlora_opt", n_clients=1,
                               local_steps=2, lr=1e-2), device="cpu")
    rng = np.random.default_rng(3)
    big = {"tokens": torch.as_tensor(rng.integers(5, 64, size=(1, 2 * B, S))),
           "loss_mask": torch.ones((1, 2 * B, S))}
    outs = {}
    for tele in (False, True):
        step_fn, opt_init = make_fed_train_step(
            CFG, mesh, TrainSettings(lr=1e-2, micro_batches=1, clip=1.0,
                                     remat=False, local_steps=2,
                                     telemetry=tele), device="cpu")
        outs[tele] = step_fn(sim.base, sim.client_adapters,
                             opt_init(sim.client_adapters), 0, big)[::2]
    (na0, met0), (na1, met1) = outs[False], outs[True]
    for p, x in pt.tree_leaves_with_path(na0):
        assert torch.equal(x, pt.tree_get(na1, p)), p
    assert set(met1) - set(met0) == {"client_ce", "client_grad_norm",
                                     "client_drift"}
    np.testing.assert_allclose(float(met1["client_ce"].mean()),
                               float(met1["ce"]), rtol=1e-6)
    np.testing.assert_allclose(float(met1["client_grad_norm"].mean()),
                               float(met1["grad_norm"]), rtol=1e-6)


def reference_events(path):
    """The events the reference's FedPipeline._emit_round_event writes
    for one iteration of 4 clients (called directly: no program runs)."""
    pytest.importorskip("jax")
    from repro import obs as jobs
    from repro.core.methods import get_method as jget
    from repro.launch.train import FedPipeline as JPipeline
    pipe = JPipeline(None, None, None, None, jget("fedlora_opt"),
                     telemetry=True, comm_bytes_round=1, comm_class="psum")
    four = np.ones(C)
    jobs.enable(path)
    try:
        pipe._emit_round_event(0, {"client_ce": four, "client_grad_norm": four,
                                   "client_drift": four},
                               {"ce": 1.0}, {"ce": 1.0}, (1.0, 1.0, 1.0, 3.0))
    finally:
        jobs.disable()
    from repro.obs import read_events as jread
    return jread(path)


def test_run_pipeline_emits_the_reference_events(pool, tmp_path):
    """run_pipeline with telemetry on rank 0: the reference's fed_round
    and fed_stage events (kinds, order, fields); per-client ce,
    grad_norm and drift against FedSim's own fed_round event."""
    from repro_torch import obs
    from repro_torch.obs import read_events
    name, path = "fedlora_opt", str(tmp_path / "engine.jsonl")
    sim, rng = sim64(name), data("events")
    cb, sb, pb = client_batches(rng), server_batches(rng), client_batches(
        rng, TP)
    res = pool.run(R.pipeline, CFG, settings(name, telemetry=True), sim.base,
                   sim.client_adapters, sim.opt_state,
                   [(cat(cb, 1), cat(sb, 0), cat(pb, 1))],
                   telemetry_path=path)
    obs.enable(str(tmp_path / "sim.jsonl"))
    try:
        sim.run_round(cb)
    finally:
        obs.disable()
    evs = read_events(path)
    ref = reference_events(str(tmp_path / "reference.jsonl"))
    assert [e["kind"] for e in evs] == [e["kind"] for e in ref]
    for e, r in zip(evs, ref):
        assert set(e) == set(r), (e["kind"], set(e) ^ set(r))
        assert e.get("stage") == r.get("stage")
        if isinstance(r.get("wall"), dict):
            assert set(e["wall"]) == set(r["wall"])
    rnd = evs[0]
    (want,) = [e for e in read_events(str(tmp_path / "sim.jsonl"))
               if e["kind"] == "fed_round"]
    assert rnd["engine"] == "pipeline" and rnd["clients"] == C
    assert rnd["step"] == 0
    for k in ("ce", "grad_norm", "drift"):
        np.testing.assert_allclose(rnd[k], want[k], atol=2e-6, err_msg=k)
    assert rnd["comm_bytes"] == want["comm_bytes"]
    assert res[0][3][0]["round"]["client_ce"].shape == (C,)


def test_rank_slices_round_trip():
    tree = {"a": {"b": torch.arange(12.).reshape(4, 3)}, "c": torch.ones(4)}
    parts = [rank_slice(tree, r) for r in range(4)]
    assert parts[2]["a"]["b"].shape == (1, 3)
    back = stack_ranks(parts)
    assert torch.equal(back["a"]["b"], tree["a"]["b"])
    assert torch.equal(back["c"], tree["c"])


def test_pool_raises_the_failing_ranks_traceback(pool):
    with pytest.raises(RuntimeError, match="rank 2 was told to fail"):
        pool.run(R.fail_on, 2)
    assert pool.run(R.fail_on, -1) == [0, 1, 2, 3]    # the pool lives on


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_collective_form_resolves_as_the_reference():
    """collective_form of every registry method: the reference's kind,
    comm class and parameters."""
    jax = pytest.importorskip("jax")       # noqa: F841
    from repro.core import aggregation as jagg
    from repro.core.methods import get_method as jget
    for name in METHODS:
        t, j = agg.collective_form(get_method(name)), jagg.collective_form(
            jget(name))
        for f in ("kind", "comm", "trim_ratio", "topk_ratio", "seed",
                  "alpha"):
            assert getattr(t, f) == getattr(j, f), (name, f)


def test_pick_micro_batches_matches_the_reference():
    pytest.importorskip("jax")
    from repro.configs import get_config as jcfg
    from repro.launch.train import pick_micro_batches as jpick
    from repro_torch.configs import get_config
    for name in ("llama2-7b", "deepseek-7b"):
        for b, s in ((1, 128), (4, 128), (16, 2048), (64, 4096), (8, 512)):
            for budget in (1e9, 2.5e8):
                assert pick_micro_batches(get_config(name), b, s, budget) \
                    == jpick(jcfg(name), b, s, budget), (name, b, s, budget)


JAX_ENGINES = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from repro.fed.simulate import FedHyper, FedSim
from repro.launch.mesh import make_client_mesh
from repro.launch.train import (TrainSettings, make_fed_pipeline_step,
                                make_fed_train_step)
from repro.models.config import ArchConfig
from repro.utils import pytree as pt

cfg = ArchConfig(**TINY)
mesh = make_client_mesh(C)
rng = np.random.default_rng(0)
out = {}


def put(prefix, tree):
    for p, x in zip(pt.tree_paths(tree), jax.tree.leaves(tree)):
        out[f"{prefix}/{p}"] = np.asarray(x)


def batch(shape):
    tok = rng.integers(5, cfg.vocab_size, size=shape).astype(np.int32)
    return tok, {"tokens": jnp.asarray(tok),
                 "loss_mask": jnp.ones(shape, jnp.float32)}


sim = FedSim(cfg, FedHyper(method="fedlora_opt", **HP))
put("base", sim.base)
put("pipe/ad0", sim.client_adapters)
pipe = make_fed_pipeline_step(cfg, mesh, TrainSettings(**ST_PIPE))
na, no, step = sim.client_adapters, sim.opt_state, 0
for r in range(2):
    out[f"pipe/cb{r}"], cb = batch((C, T * B, S))
    out[f"pipe/sb{r}"], sb = batch((TG * 4, S))     # 8 rows: sharded
    out[f"pipe/pb{r}"], pb = batch((C, TP * B, S))
    na, no, agg, _ = pipe.round_step(sim.base, na, no, jnp.int32(step), cb)
    agg, na, _ = pipe.global_step(sim.base, agg, na, sb)
    na, _ = pipe.personal_step(sim.base, na, pb)
    step += T
put("pipe/ad", na)
put("pipe/agg", agg)

cfg_moe = ArchConfig(**TINY_MOE)
msim = FedSim(cfg_moe, FedHyper(method="fedlora_opt", **HP))
put("moe/base", msim.base)
put("moe/ad0", msim.client_adapters)
pipe = make_fed_pipeline_step(cfg_moe, mesh, TrainSettings(**ST_PIPE))
na, no, step = msim.client_adapters, msim.opt_state, 0
for r in range(2):
    out[f"moe/cb{r}"], cb = batch((C, T * B, S))
    out[f"moe/sb{r}"], sb = batch((TG * 4, S))
    out[f"moe/pb{r}"], pb = batch((C, TP * B, S))
    na, no, agg, met = pipe.round_step(msim.base, na, no, jnp.int32(step), cb)
    out[f"moe/aux{r}"] = np.asarray(met["aux"])
    agg, na, _ = pipe.global_step(msim.base, agg, na, sb)
    na, _ = pipe.personal_step(msim.base, na, pb)
    step += T
put("moe/ad", na)
put("moe/agg", agg)

sim = FedSim(cfg, FedHyper(method="lora_fedbuff", **HP), base=sim.base)
put("fault/ad0", sim.client_adapters)
step_fn, _ = make_fed_train_step(cfg, mesh, TrainSettings(**ST_FAULT))
na, no, step = sim.client_adapters, sim.opt_state, 0
for r, f in enumerate(FAULTS):
    out[f"fault/cb{r}"], cb = batch((C, T * B, S))
    na, no, _ = step_fn(sim.base, na, no, jnp.int32(step), cb,
                        **{k: jnp.asarray(v, jnp.float32)
                           for k, v in f.items()})
    step += T
put("fault/ad", na)
np.savez(sys.argv[1], **out)
"""
FAULTS = FAULT_CASES[2][2]


@pytest.fixture(scope="module", autouse=True)
def jax_engines(tmp_path_factory):
    """The reference's engines on 4 host devices, in a subprocess started
    with the module, so that it runs beside the other tests: (process,
    .npz path of its initial state, batches and results)."""
    try:
        import jax  # noqa: F401
    except ImportError:
        yield None
        return
    path = str(tmp_path_factory.mktemp("jax") / "engines.npz")
    head = "\n".join([
        f"TINY = {TINY!r}", f"TINY_MOE = {TINY_MOE!r}", f"HP = {HP!r}",
        f"C, T, B, S, TG, TP = {C}, {T}, {B}, {S}, {TG}, {TP}",
        f"ST_PIPE = {settings('fedlora_opt')!r}",
        f"ST_FAULT = {settings('lora_fedbuff')!r}",
        f"FAULTS = {json.loads(json.dumps(FAULTS))!r}"])
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen([sys.executable, "-c", head + JAX_ENGINES, path],
                            env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    yield proc, path
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def jax_run(jax_engines):
    if jax_engines is None:
        pytest.skip("the comparison with the reference needs JAX")
    proc, path = jax_engines
    _, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err[-3000:]
    with np.load(path) as z:
        return dict(z)


def tree_of(run, prefix, dtype):
    from repro_torch.checkpoint.bridge import params_from_numpy
    tree: dict = {}
    for k, v in run.items():
        if k.startswith(prefix + "/"):
            pt.set_leaf(tree, k[len(prefix) + 1:], v)
    return params_from_numpy(tree, "cpu", dtype)


def assert_close_or_witness(got, want, witness, what, rtol=2e-4, atol=2e-5,
                            wtol=1e-5, share=1e-3, outlier_tol=1e-2):
    """rtol / atol elementwise, but where f32 cannot resolve an element:
    each element outside is more than ``wtol`` of the leaf's max from
    the port's f64 run, a ``share`` of the leaf at most (2 at least),
    within ``outlier_tol`` of the leaf's max."""
    assert set(got) == set(want) == set(witness), what
    for p, w in want.items():
        out = ~np.isclose(got[p], w, rtol=rtol, atol=atol)
        if not out.any():
            continue
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(got[p] - w) / scale
        assert out.sum() <= max(2, share * out.size), (what, p, out.sum())
        assert err.max() <= outlier_tol, (what, p, err.max())
        off64 = np.abs(got[p] - witness[p])[out] / scale
        assert (off64 > wtol).all(), (what, p, err[out], off64)


def test_pipeline_matches_the_jax_engine(pool, jax_run):
    """fedlora_opt, 2 iterations with the sharded stage 2, f32 on 4
    ranks against the reference's shard_map engine on 4 devices."""
    def iters(run, dt):
        def b(k):
            tok = torch.as_tensor(run[k].astype(np.int64))
            return {"tokens": tok, "loss_mask": torch.ones(tok.shape,
                                                           dtype=dt)}
        return [(b(f"pipe/cb{r}"), b(f"pipe/sb{r}"), b(f"pipe/pb{r}"))
                for r in range(2)]
    out = {}
    for dt in (torch.float32, torch.float64):
        out[dt] = pool.run(R.pipeline, CFG, settings("fedlora_opt"),
                           tree_of(jax_run, "base", dt),
                           tree_of(jax_run, "pipe/ad0", dt), None,
                           iters(jax_run, dt))
    want_ad = {k[len("pipe/ad/"):]: v for k, v in jax_run.items()
               if k.startswith("pipe/ad/")}
    want_agg = {k[len("pipe/agg/"):]: v for k, v in jax_run.items()
                if k.startswith("pipe/agg/")}
    assert_close_or_witness(R.stack(out[torch.float32]), want_ad,
                            R.stack(out[torch.float64]), "client adapters")
    assert_close_or_witness(out[torch.float32][0][2], want_agg,
                            out[torch.float64][0][2], "server model")


def test_moe_pipeline_matches_the_jax_engine(pool, jax_run):
    """fedlora_opt at MoE (capacity 1.25), 2 iterations with the sharded
    stage 2, f32 on 4 ranks, each running ``moe_ffn_local`` on its own
    micro-batch and slice, against the reference's engine on 4 devices,
    where ``moe_ffn_manual`` groups each shard's tokens at that shard's
    capacity and exchanges them by all-to-all; the round metrics carry
    the aux, the shards' mean."""
    def iters(run, dt):
        def b(k):
            tok = torch.as_tensor(run[k].astype(np.int64))
            return {"tokens": tok, "loss_mask": torch.ones(tok.shape,
                                                           dtype=dt)}
        return [(b(f"moe/cb{r}"), b(f"moe/sb{r}"), b(f"moe/pb{r}"))
                for r in range(2)]
    out = {}
    for dt in (torch.float32, torch.float64):
        out[dt] = pool.run(R.pipeline, CFG_MOE, settings("fedlora_opt"),
                           tree_of(jax_run, "moe/base", dt),
                           tree_of(jax_run, "moe/ad0", dt), None,
                           iters(jax_run, dt))
    for r in range(2):
        got = np.mean([res[3][r]["round"]["aux"]
                       for res in out[torch.float32]])
        np.testing.assert_allclose(got, jax_run[f"moe/aux{r}"], rtol=1e-5)
    want_ad = {k[len("moe/ad/"):]: v for k, v in jax_run.items()
               if k.startswith("moe/ad/")}
    want_agg = {k[len("moe/agg/"):]: v for k, v in jax_run.items()
                if k.startswith("moe/agg/")}
    assert_close_or_witness(R.stack(out[torch.float32]), want_ad,
                            R.stack(out[torch.float64]), "client adapters")
    assert_close_or_witness(out[torch.float32][0][2], want_agg,
                            out[torch.float64][0][2], "server model")


def test_faulted_rounds_match_the_jax_engine(pool, jax_run):
    """lora_fedbuff, 2 rounds with dropouts and staleness, f32 on 4 ranks
    against the reference's make_fed_train_step."""
    out = {}
    for dt in (torch.float32, torch.float64):
        big = [{"tokens": torch.as_tensor(jax_run[f"fault/cb{r}"].astype(
                    np.int64)),
                "loss_mask": torch.ones((C, T * B, S), dtype=dt)}
               for r in range(2)]
        out[dt] = pool.run(R.rounds, CFG, settings("lora_fedbuff"),
                           tree_of(jax_run, "base", dt),
                           tree_of(jax_run, "fault/ad0", dt), None, big,
                           faults=FAULTS)
    want = {k[len("fault/ad/"):]: v for k, v in jax_run.items()
            if k.startswith("fault/ad/")}
    assert_close_or_witness(R.stack(out[torch.float32]), want,
                            R.stack(out[torch.float64]), "lora_fedbuff")
