"""Checkpoints and the tiered adapter store on the card against the CPU.

Imports no JAX.  The ``gpu`` tests need a card and skip without one.
Config: 2 layers, d 32, rank 8, f32 (the ``hetck-t`` shape of
``tests/test_torch_ckpt.py``).  Everything must be equal exactly: a
``FedSim`` saved on the card loads into a CPU sim (and the other way
round) leaf for leaf and saves again to the same bytes, and a tiered
store promoting under churn on the card holds the same pool rows, slots
and ranks as the same store on the CPU after every install, its T0 on
the card, its T1 on the host, and registration allocating nothing on
the card.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import peft
from repro_torch.fed.simulate import FedHyper, FedSim
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.serve import TieredAdapterStore
from repro_torch.utils import pytree as pt

CFG = ArchConfig(name="hetck-t", family="dense", n_layers=2, d_model=32,
                 n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                 dtype="float32", lora_rank=8, lora_dropout=0.0)
C = 3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this holds checkpoints and the "
                    "tiered store on the GPU against the CPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def base_on(device):
    base = M.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    return pt.tree_map(lambda t: t.to(device), base)


def batches(n, seed, device):
    rng = np.random.default_rng(seed)
    return [{"tokens": torch.as_tensor(rng.integers(5, 64, size=(C, 2, 16)),
                                       dtype=torch.int32, device=device),
             "loss_mask": torch.ones((C, 2, 16), device=device)}
            for _ in range(n)]


@pytest.mark.gpu
@pytest.mark.parametrize("ranks", [None, (2, 4, 8)], ids=["uniform", "ranks"])
@pytest.mark.parametrize("src,dst", [("cuda", "cpu"), ("cpu", "cuda")])
def test_fedsim_checkpoint_crosses_devices(cuda, tmp_path, src, dst, ranks):
    hp = FedHyper(method="fedlora_opt", n_clients=C, local_steps=2,
                  lr=3e-3, client_ranks=ranks)
    sim = FedSim(CFG, hp, base=base_on(src), device=src)
    sim.local_round(batches(2, 0, src))
    sim.aggregate()
    path = str(tmp_path / "sim.msgpack")
    sim.save(path, round_idx=1)
    other = FedSim(CFG, hp, base=base_on(dst), device=dst)
    assert other.load(path) == 1
    want, got = sim.state_tree(), other.state_tree()
    assert pt.tree_paths(got) == pt.tree_paths(want)
    for p, x in pt.tree_leaves_with_path(got):
        w = pt.tree_get(want, p)
        if torch.is_tensor(x):
            if p.startswith(("client_adapters/", "opt_state/")):
                assert x.device.type == dst, p
            assert x.dtype == w.dtype and torch.equal(x.cpu(), w.cpu()), p
        else:
            np.testing.assert_array_equal(x, w, err_msg=p)
    other.save(str(tmp_path / "again.msgpack"), round_idx=1)
    with open(path, "rb") as a, open(tmp_path / "again.msgpack", "rb") as b:
        assert a.read() == b.read()


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["dora_mag", "pairs"])
def test_tiered_store_on_card_matches_cpu(cuda, tmp_path, kind):
    g = torch.Generator().manual_seed(1)
    base = base_on("cpu")
    shared = peft.add_lora(base, CFG, g, decomposed=True)
    shared = pt.tree_map_with_path(
        lambda p, x: x + 0.25 if p.endswith("B_mag") else x, shared)
    rng = np.random.default_rng(0)
    adapters = []
    for i in range(10):
        r = (2, 4, 8)[i % 3]
        if kind == "pairs":
            adapters.append((peft.add_lora(base, CFG, g, rank=r), r))
        else:
            adapters.append((pt.tree_map(
                lambda x: torch.as_tensor(rng.normal(size=(*x.shape[:-1], r)),
                                          dtype=torch.float32),
                pt.filter_tree(shared, lambda p: p.endswith("dB_mag"))), r))
    stores = {}
    for dev in ("cpu", "cuda"):
        stores[dev] = TieredAdapterStore(
            base_on(dev), CFG, shard_dir=str(tmp_path / dev), n_slots=4,
            host_capacity=3, kind=kind, rank=8,
            shared=(pt.tree_map(lambda t: t.to(dev), shared)
                    if kind == "dora_mag" else None), device=dev)
    allocs = torch.cuda.memory_stats()["allocation.all.allocated"]
    for dev, st in stores.items():
        for i, (ad, r) in enumerate(adapters):
            assert st.register(f"t{i}", ad, rank=r) == -1
    assert torch.cuda.memory_stats()["allocation.all.allocated"] == allocs
    order = np.random.default_rng(7).integers(0, 10, size=(12, 3))
    for step, idx in enumerate(order):
        want = [f"t{i}" for i in idx]
        pinned = {f"t{i}" for i in order[step - 1][:1]} if step else set()
        pinned &= set(stores["cpu"].resident_tenants)
        queued = {f"t{i}" for i in order[(step + 1) % 12]}
        for st in stores.values():
            st.prefetch(queued)
            assert st.wait_prefetch(timeout=10.0)
        slots = {dev: st.install_batch(want, pinned=pinned, queued=queued)
                 for dev, st in stores.items()}
        assert slots["cuda"] == slots["cpu"]
        cpu, card = stores["cpu"], stores["cuda"]
        assert np.array_equal(card._slot_ranks, cpu._slot_ranks)
        for prefix, pool in card._pools.items():
            for key, t in pool.items():
                assert t.device.type == "cuda", (prefix, key)
                assert torch.equal(t.cpu(), cpu._pools[prefix][key]), \
                    (step, prefix, key)
    assert all(v.device.type == "cpu" for e in stores["cuda"]._t1.values()
               for leaves in e[0].values() for v in leaves.values())
