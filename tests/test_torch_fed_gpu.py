"""The port's training pipeline on the card against itself on the CPU.

Imports no JAX.  The ``gpu`` tests need a card and skip without one
(the training path runs through torch autograd, so the CPU holds the
card's arithmetic).  Config: 2 layers, d 64, 4 heads over 2 kv heads,
f32, rank 4; TF32 off.  Tolerance: every client adapter leaf after
``run_federated`` within 1e-4 of the leaf's max |value| (f32 sums in
another order, through AdamW's eps regime: ``tests/test_torch_fed.py``),
the history's CE within 1e-5 relative, comm bytes exactly; one step's
loss within 1e-5 relative and the gradients of each new adapter kind
(FedALT's dual pair, Houlsby, prompt) within 1e-4 of each leaf's max |g|;
a mixed-rank ``lora_exact`` round: one stage-1 step's leaves within
1e-4 of each leaf's max |value|, the rows above each client's rank
exactly 0, and the aggregate's products A·B within 1e-5 (Frobenius,
relative) of the CPU's ``exact_fedavg`` of the same client stacks.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import aggregation as agg
from repro_torch.core import fedlora
from repro_torch.data import (SyntheticInstructionDataset, client_batch,
                              eval_batches, make_dataset_family,
                              specialist_partition, to_device)
from repro_torch.fed import simulate
from repro_torch.fed.simulate import FedHyper
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.utils import pytree as pt

CFG = ArchConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                 n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                 dtype="float32", lora_rank=4, lora_dropout=0.0)
HP = FedHyper(method="fedlora_opt", n_clients=3, rounds=2, local_steps=2,
              batch=2, seq_len=24, global_steps=2, personal_steps=2,
              lr=3e-3, server_lr=2e-3, lam=1e-2)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this holds the training path on the "
                    "GPU against the CPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def run(monkeypatch, device, cfg=CFG, hp=HP, captured=None):
    """run_federated on ``device`` from one CPU-drawn backbone and
    adapter; the FedSim it builds goes into ``captured``."""
    fam = make_dataset_family("dolly", vocab_size=cfg.vocab_size)
    part = specialist_partition(hp.n_clients, 4)
    cds = [SyntheticInstructionDataset(fam, part[c], client_seed=c)
           for c in range(hp.n_clients)]
    sds = SyntheticInstructionDataset(fam, np.ones(4) / 4, client_seed=99)
    base = M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    base = pt.tree_map(lambda t: t.to(device), base)

    class Capture(simulate.FedSim):
        """FedSim starting from an adapter drawn on the CPU's generator
        (each device's generator draws its own)."""
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            ad = self.method.make_adapter(
                pt.tree_map(lambda t: t.cpu(), self.base), self.cfg,
                torch.Generator().manual_seed(1))
            self.client_adapters = pt.tree_map(
                lambda t: t.to(self.device),
                agg.broadcast_to_clients(ad, self.hp.n_clients))
            if captured is not None:
                captured.append(self)
    monkeypatch.setattr(fedlora, "FedSim", Capture)
    return fedlora.run_federated(
        cfg, hp, cds, sds, eval_batches(sds, 2, 24, 2, device=device),
        [client_batch(cds, np.random.default_rng(1), 2, 24, device=device)],
        base=base, device=device)


@pytest.mark.gpu
def test_run_federated_on_the_card_matches_the_cpu(cuda, monkeypatch):
    sims, res = {}, {}
    for dev in ("cpu", "cuda"):
        cap = []
        res[dev] = run(monkeypatch, dev, captured=cap)
        sims[dev] = cap[0]
    assert res["cuda"].comm_bytes == res["cpu"].comm_bytes
    for hc, hg in zip(res["cpu"].history, res["cuda"].history):
        assert hg["train_ce"] == pytest.approx(hc["train_ce"], rel=1e-5)
        assert hg["ce"] == pytest.approx(hc["ce"], rel=1e-5)
    for p, x in pt.tree_leaves_with_path(sims["cpu"].client_adapters):
        y = pt.tree_get(sims["cuda"].client_adapters, p).cpu()
        err = float((y - x).abs().max() / x.abs().max().clamp(min=1e-30))
        assert err <= 1e-4, (p, err)


@pytest.mark.gpu
def test_dropout_runs_on_the_card(cuda, monkeypatch):
    """Adapter dropout draws from a CUDA generator: a stage-1 round with
    lora_dropout 0.1 runs on the card and gives finite metrics."""
    cfg = dataclasses.replace(CFG, lora_dropout=0.1)
    res = run(monkeypatch, "cuda", cfg=cfg,
              hp=dataclasses.replace(HP, rounds=1))
    assert np.isfinite(res.history[0]["train_ce"])


@pytest.mark.gpu
@pytest.mark.parametrize("method,zero_init", [
    ("fedalt", "local_B"), ("adapter", "adapter_up"), ("prompt", None)])
def test_adapter_kind_grads_on_the_card_match_the_cpu(cuda, method,
                                                      zero_init):
    """One stage-1 loss and the gradients of every adapter leaf of each
    new adapter kind (dual pair, Houlsby, prompt) on the card against the
    CPU, within 1e-4 of each leaf's max |g|; the zero-initialized factor
    is drawn nonzero, so every leaf has a gradient."""
    hp = dataclasses.replace(HP, method=method, n_clients=1)
    base = M.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    sims = {dev: simulate.FedSim(CFG, hp, base=pt.tree_map(
        lambda t: t.to(dev), base), device=dev) for dev in ("cpu", "cuda")}
    g = torch.Generator().manual_seed(1)
    ad = pt.tree_map_with_path(
        lambda p, x: (0.1 * torch.randn(x.shape, generator=g)
                      if zero_init and p.endswith(zero_init) else x),
        sims["cpu"].adapter_template)
    fam = make_dataset_family("dolly", vocab_size=CFG.vocab_size)
    ds = SyntheticInstructionDataset(fam, specialist_partition(1, 4)[0])
    batch = ds.sample_batch(np.random.default_rng(1), 2, 24)
    out = {dev: sim.loss_and_grad(pt.tree_map(lambda t: t.to(dev), ad),
                                  to_device(batch, dev))
           for dev, sim in sims.items()}
    (l_cpu, _, g_cpu), (l_gpu, _, g_gpu) = out["cpu"], out["cuda"]
    assert float(l_gpu) == pytest.approx(float(l_cpu), rel=1e-5)
    for p, want in pt.tree_leaves_with_path(g_cpu):
        got = pt.tree_get(g_gpu, p).cpu()
        assert float(want.abs().max()) > 0, p
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-4, (p, err)


@pytest.mark.gpu
def test_mixed_rank_exact_round_on_the_card_matches_the_cpu(cuda):
    """One stage-1 step of a lora_exact fleet at ranks (1, 2, 3, 4) on the
    card and on the CPU from one adapter and batch, then the card's
    aggregate against the CPU's exact_fedavg of the card's client stack
    (QR and SVD on each device; the factors' column signs may differ,
    so the products are compared)."""
    ranks = (1, 2, 3, 4)
    hp = dataclasses.replace(HP, method="lora_exact", n_clients=4,
                             client_ranks=ranks)
    base = M.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    sims = {dev: simulate.FedSim(CFG, hp, base=pt.tree_map(
        lambda t: t.to(dev), base), device=dev) for dev in ("cpu", "cuda")}
    sims["cuda"].client_adapters = pt.tree_map(
        lambda t: t.to("cuda"), sims["cpu"].client_adapters)
    fam = make_dataset_family("dolly", vocab_size=CFG.vocab_size)
    part = specialist_partition(4, 4)
    cds = [SyntheticInstructionDataset(fam, part[c], client_seed=c)
           for c in range(4)]
    batch = client_batch(cds, np.random.default_rng(1), 2, 24, device="cpu")
    for dev, sim in sims.items():
        sim.local_round([to_device(batch, dev)])
    for p, want in pt.tree_leaves_with_path(sims["cpu"].client_adapters):
        got = pt.tree_get(sims["cuda"].client_adapters, p).cpu()
        err = float((got - want).abs().max() / want.abs().max())
        assert err <= 1e-4, (p, err)
    clients = sims["cuda"].client_adapters
    aggregated = sims["cuda"].aggregate()
    host = agg.exact_fedavg(pt.tree_map(lambda t: t.cpu(), clients),
                            ranks=ranks)
    for p, x in pt.tree_leaves_with_path(sims["cuda"].client_adapters):
        ax = -1 if p.endswith("lora_A") else -2
        for c, r in enumerate(ranks):
            assert not torch.count_nonzero(x[c].movedim(ax, 0)[r:]), (p, c)
        if p.endswith("lora_A"):
            pb = p[:-1] + "B"
            got = (pt.tree_get(aggregated, p) @ pt.tree_get(aggregated, pb)
                   ).cpu().double()
            want = (pt.tree_get(host, p) @ pt.tree_get(host, pb)).double()
            err = float(torch.linalg.matrix_norm(got - want).max()
                        / torch.linalg.matrix_norm(want).min())
            assert err <= 1e-5, (p, err)
