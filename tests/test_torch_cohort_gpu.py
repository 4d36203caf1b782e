"""The port's faulted cohort rounds on the card against the CPU.

Imports no JAX.  The ``gpu`` tests need a card and skip without one.
Config: 2 layers, d 32, rank 4, f32, TF32 off.  One ``CohortSim`` of 3
slots over 6 clients runs the same faulted rounds on each device from
one CPU-drawn backbone and adapter template: cohorts, participation,
staleness, deliveries and comm bytes exactly; the bank's adapters (host
memory on both) within 1e-4 of each leaf's max |value| (f32 sums in
another order); a dropped client's bank entry bit for bit its own.
"""
import numpy as np
import pytest
import torch

from repro_torch import obs
from repro_torch.fed import CohortSim, FaultPlan
from repro_torch.fed.simulate import FedHyper, FedSim
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.utils import pytree as pt

CFG = ArchConfig(name="cohort-t", family="dense", n_layers=2, d_model=32,
                 n_heads=2, n_kv_heads=2, d_ff=64, vocab_size=64,
                 dtype="float32", lora_rank=4, lora_dropout=0.0)
C, N_TOTAL, ROUNDS = 3, 6, 3
PLAN = dict(dropout_rate=0.25, straggler_rate=0.25, straggler_delay=(1, 1),
            corrupt_rate=0.4, corrupt_scale=3.0, seed=12)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: this holds faulted cohort rounds on "
                    "the GPU against the CPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def batches(device, seed=4):
    rng = np.random.default_rng(seed)
    return [{"tokens": torch.from_numpy(rng.integers(
                5, 64, size=(C, 2, 16)).astype(np.int32)).to(device),
             "loss_mask": torch.ones((C, 2, 16), device=device)}]


def run(device, method):
    base = M.init_params(torch.Generator().manual_seed(0), CFG, device="cpu")
    sim = FedSim(CFG, FedHyper(method=method, n_clients=C, local_steps=1,
                               lr=2e-2),
                 base=pt.tree_map(lambda t: t.to(device), base),
                 device=device)
    sim.adapter_template = sim.method.make_adapter(
        base, CFG, torch.Generator().manual_seed(1))
    cs = CohortSim(sim, N_TOTAL, faults=FaultPlan(**PLAN), seed=0)
    outs, banks = [], []
    for _ in range(ROUNDS):
        before = pt.tree_map(torch.clone, cs.bank.adapters)
        out = cs.run_round(batches(device))
        outs.append(out)
        banks.append((before, pt.tree_map(torch.clone, cs.bank.adapters)))
    return cs, outs, banks


@pytest.mark.gpu
@pytest.mark.parametrize("method", ["lora", "lora_fedbuff"])
def test_faulted_cohort_rounds_on_the_card_match_the_cpu(cuda, method,
                                                         tmp_path):
    obs.enable(str(tmp_path / "gpu.jsonl"))
    try:
        gpu, g_outs, g_banks = run(cuda, method)
    finally:
        obs.disable()
    cpu, c_outs, _ = run(torch.device("cpu"), method)
    assert all(x.device.type == "cpu"
               for x in pt.tree_leaves(gpu.bank.adapters))
    for g, c in zip(g_outs, c_outs):
        for k in ("cohort", "participation", "staleness"):
            np.testing.assert_array_equal(g[k], c[k], err_msg=k)
        for k in ("delivered", "delivered_billed", "pending"):
            assert g[k] == c[k], k
    assert gpu.sim.comm_bytes == cpu.sim.comm_bytes > 0
    np.testing.assert_array_equal(gpu.bank.last_sync, cpu.bank.last_sync)
    for p, x in pt.tree_leaves_with_path(cpu.bank.adapters):
        y = pt.tree_get(gpu.bank.adapters, p)
        err = (y - x).abs().max() / x.abs().max().clamp_min(1e-30)
        assert err <= 1e-4, (p, float(err))
    # a client that dropped, and received no delivery, keeps its entry
    for out, (before, after) in zip(g_outs, g_banks):
        for slot in np.nonzero(~out["participation"])[0]:
            c = int(out["cohort"][slot])
            if gpu.bank.last_sync[c] == 0:
                for p, x in pt.tree_leaves_with_path(after):
                    assert torch.equal(x[c], pt.tree_get(before, p)[c]), p
    evs = obs.read_events(str(tmp_path / "gpu.jsonl"), kind="fed_cohort")
    assert [e["comm_bytes"] for e in evs][-1] == gpu.sim.comm_bytes
