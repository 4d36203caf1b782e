"""The port's production round engine on the card: 4 gloo ranks on one
GPU, sharing the test process's backbone by CUDA IPC.

Imports no JAX.  The ``gpu`` tests need a card and skip without one.
Config: 2 layers of llama2-7b width (d 4096, 32 heads, d_ff 11008, vocab
32000), f32, rank 8 on q/v, 4 clients, 2 local steps of 2 x 16 tokens;
TF32 off.  The round (2 rounds): within 1e-5 of each leaf's max |value|
of FedSim on the card (the all-reduce sums in another order than
FedSim's mean), and within 1e-4 of FedSim on the CPU but where f32
cannot resolve an element (``tests/test_torch_fed_methods.py``'s rule:
an element beyond must be more than 1e-5 of the leaf's max from
FedSim's f64 run on the CPU, at most 0.1% of the leaf, 2 at least,
within 1e-2).  The pipeline (one iteration, 2 stage-2 steps of 2 server
rows, the replicated path; the sharded one is held by ``chip_smoke.py``
phase 12 and, in f64, ``tests/test_torch_train_engine.py``; 2 stage-3
steps): each stage within 1e-5 of FedSim's on the card from the
engine's own input to it.  Held end to end instead, two iterations
measured 3.6e-4 of max |dA_dir| on an H100 80GB HBM3 (700 W): ΔA_D's
gradient cancels in f32, so the aggregate's 1e-7 rounding moves it.
"""
import dataclasses

import numpy as np
import pytest
import torch

import torch_engine_ranks as R
from repro_torch.configs import get_config
from repro_torch.fed.simulate import FedHyper, FedSim
from repro_torch.launch.mesh import ClientPool
from repro_torch.models import model as M
from repro_torch.utils import pytree as pt

pytestmark = pytest.mark.gpu

C, T, B, S, TG, TP = 4, 2, 2, 16, 2, 2
CFG = dataclasses.replace(get_config("llama2-7b"), n_layers=2,
                          dtype="float32", lora_dropout=0.0)
HP = dict(n_clients=C, local_steps=T, batch=B, seq_len=S, lr=1e-3,
          server_lr=5e-4, global_steps=TG, personal_steps=TP, lam=1e-2)
ST = dict(lr=HP["lr"], micro_batches=1, clip=1.0, remat=True,
          method="fedlora_opt", local_steps=T, server_lr=HP["server_lr"],
          global_steps=TG, personal_steps=TP, lam=HP["lam"])


@pytest.fixture(scope="module")
def card(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this holds the production engine's "
                    "ranks on the GPU against FedSim")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    base = M.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    with ClientPool(C, str(tmp_path_factory.mktemp("pool"))) as pool:
        yield pool, base
    torch.backends.cuda.matmul.allow_tf32 = tf32


def sim_on(device, base, dtype=torch.float32):
    sim = FedSim(CFG, FedHyper(method="fedlora_opt", **HP),
                 base=pt.tree_map(lambda t: t.to(device, dtype), base),
                 device=device)
    # the CPU's adapter on every device (each generator draws its own)
    ad = sim.method.make_adapter(base, CFG, torch.Generator().manual_seed(1))
    sim.client_adapters = pt.tree_map(
        lambda x: x[None].expand(C, *x.shape).clone().to(device, dtype), ad)
    sim.opt_state = sim._init_clients(sim.opt)
    return sim


SIMS = {"card": ("cuda", torch.float32), "cpu": ("cpu", torch.float32),
        "f64": ("cpu", torch.float64)}


def batches(rng, n, rows=B, clients=True):
    shape = (C, rows, S) if clients else (rows, S)
    return [{"tokens": torch.as_tensor(rng.integers(5, CFG.vocab_size,
                                                    size=shape)),
             "loss_mask": torch.ones(shape)} for _ in range(n)]


def cat(bs, dim, device):
    return {k: torch.cat([b[k] for b in bs], dim).to(device) for k in bs[0]}


def within(got, want, tol, what):
    for p, w in want.items():
        err = np.abs(got[p] - w).max() / max(np.abs(w).max(), 1e-30)
        assert err <= tol, (what, p, err)


def within_or_witness(got, want, witness, what, tol=1e-4, wtol=1e-5,
                      share=1e-3, outlier_tol=1e-2):
    for p, w in want.items():
        scale = max(np.abs(w).max(), 1e-30)
        err = np.abs(got[p] - w) / scale
        out = err > tol
        assert out.sum() <= max(2, share * out.size), (what, p, out.sum())
        assert err.max() <= outlier_tol, (what, p, err.max())
        off64 = np.abs(got[p] - witness[p])[out] / scale
        assert (off64 > wtol).all(), (what, p, err[out], off64)


def test_round_on_the_card(card):
    pool, base = card
    rng = np.random.default_rng(0)
    per_round = [batches(rng, T) for _ in range(2)]
    sims = {k: sim_on(dev, base, dt) for k, (dev, dt) in SIMS.items()}
    sim = sims["card"]
    res = pool.run(R.rounds, CFG, ST, sim.base, sim.client_adapters,
                   sim.opt_state, [cat(bs, 1, "cuda") for bs in per_round],
                   device="cuda")
    for s in sims.values():
        dev = s.device
        for bs in per_round:
            s.run_round([{k: v.to(dev) for k, v in b.items()} for b in bs])
    got = R.stack(res)
    host = {k: R.host(s.client_adapters) for k, s in sims.items()}
    within(got, host["card"], 1e-5, "card FedSim")
    within_or_witness(got, host["cpu"], host["f64"], "CPU FedSim")


def test_pipeline_on_the_card(card):
    """One pipeline iteration on the card, each stage held against
    FedSim on the card from the engine's own input to it (a 1e-7
    difference of the aggregate moves ΔA_D, whose gradient cancels in
    f32, by up to 3.6e-4 of its max a stage later)."""
    pool, base = card
    rng = np.random.default_rng(1)
    cb, sb, pb = (batches(rng, T), batches(rng, TG, 2, clients=False),
                  batches(rng, TP))
    sim = sim_on("cuda", base)
    res = pool.run(R.pipeline, CFG, ST, sim.base, sim.client_adapters,
                   sim.opt_state,
                   [(cat(cb, 1, "cuda"), cat(sb, 0, "cuda"),
                     cat(pb, 1, "cuda"))], device="cuda", stages=True)
    assert all(r[4] for r in res)

    def stage(key):
        return R.stack([(r[5][key],) for r in res])

    def tree(flat):
        out = {}
        for p, x in flat.items():
            pt.set_leaf(out, p, torch.as_tensor(x, device="cuda"))
        return out

    def on(bs):
        return [{k: v.to("cuda") for k, v in b.items()} for b in bs]
    sim.local_round(on(cb))
    within(res[0][5]["agg1"], R.host(sim.aggregate()), 1e-5, "aggregate")
    within(stage("ad1"), R.host(sim.client_adapters), 1e-5, "rebroadcast")
    sim.client_adapters = tree(stage("ad1"))
    agg2 = sim.global_stage(tree(res[0][5]["agg1"]), on(sb))
    within(res[0][5]["agg2"], R.host(agg2), 1e-5, "stage 2")
    within(stage("ad2"), R.host(sim.client_adapters), 1e-5,
           "stage 2's rebroadcast")
    sim.client_adapters = tree(stage("ad2"))
    sim.personalize(on(pb))
    within(stage("ad3"), R.host(sim.client_adapters), 1e-5, "stage 3")
    stats = pool.run(R.collective_stats)[0]
    assert stats["all_reduce"]["calls"] > 0, stats
    print("gloo collectives on CUDA tensors:", stats)
