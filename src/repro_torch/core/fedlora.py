"""FedLoRA-Optimizer, the paper's pipeline (Fig. 2); port of
``repro/core/fedlora.py``.

Per round:
  stage 1  every client LoRA-fine-tunes locally (D-M-decomposed adapters,
           base components trainable, pipeline deltas frozen);
  agg      decomposed FedAvg of (Ā_D, Ā_M, B̄_M, B̄_D)          (Eqs. 5-8)
  stage 2  global optimizer trains ΔA_D on the global task mix  (Eq. 9)
After the final round:
  stage 3  local optimizer trains ΔB_M per client with the
           λ/2‖ΔM‖²_F regularizer                               (Eqs. 10-12)

``pipeline=False`` is the Fig. 3 "non-pipeline" ablation: the LoRA-tuned
client models go straight to the local optimizer.

Batches come from the same numpy rng chain as the reference's
(``hp.seed + 1``), so the two packages train on the same bytes; adapter
dropout draws from torch generators seeded ``hp.seed * 1000 + round``
(stages 1 and 2 of a round) and ``hp.seed * 77 + 5`` (stage 3).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import numpy as np
import torch

from repro_torch.core.methods import get_method
from repro_torch.data.loader import client_batch, to_device
from repro_torch.data.synthetic import SyntheticInstructionDataset
from repro_torch.fed.simulate import FedHyper, FedSim, client
from repro_torch.models.config import ArchConfig


@dataclasses.dataclass
class RunResult:
    global_acc: float
    local_acc: float
    per_client: list
    history: list
    comm_bytes: int


def run_federated(cfg: ArchConfig, hp: FedHyper,
                  client_datasets: Sequence[SyntheticInstructionDataset],
                  server_dataset: SyntheticInstructionDataset,
                  eval_global_batches: list[dict],
                  eval_local_stacked: list[dict],
                  log: Callable[[str], None] = lambda s: None,
                  base=None, *, device="cuda") -> RunResult:
    """Run any method (ours or the baseline) through the same round loop.
    ``eval_*`` batches are dicts of tensors on ``device``."""
    sim = FedSim(cfg, hp, base=base, device=device)
    dev = sim.device
    method = get_method(hp.method)
    rng = np.random.default_rng(hp.seed + 1)
    history = []
    aggregated = None
    for rnd in range(hp.rounds):
        gen = torch.Generator(device=dev).manual_seed(hp.seed * 1000 + rnd)
        batches = [client_batch(client_datasets, rng, hp.batch, hp.seq_len,
                                device=dev)
                   for _ in range(hp.local_steps)]
        mets = sim.local_round(batches, gen)
        if hp.pipeline or not method.pipeline:
            aggregated = sim.aggregate()
        else:
            # non-pipeline ablation: clients keep their own adapters
            aggregated = client(sim.client_adapters, 0)
        if hp.pipeline and method.pipeline:
            sbatches = [to_device(server_dataset.sample_batch(
                rng, hp.batch, hp.seq_len), dev)
                for _ in range(hp.global_steps)]
            aggregated = sim.global_stage(aggregated, sbatches, gen)
        ev = sim.eval_global(aggregated, eval_global_batches)
        history.append({"round": rnd, "train_ce": float(np.mean(mets["ce"])),
                        **ev})
        log(f"[{hp.method}] round {rnd}: train_ce="
            f"{history[-1]['train_ce']:.3f} global_acc={ev['acc']:.3f}")

    # final personalization (stage 3 for ours; a plain local fine-tune for
    # the baseline)
    pbatches = [client_batch(client_datasets, rng, hp.batch, hp.seq_len,
                             device=dev)
                for _ in range(hp.personal_steps)]
    sim.personalize(pbatches, torch.Generator(device=dev).manual_seed(
        hp.seed * 77 + 5))
    loc = sim.eval_personalized(eval_local_stacked)
    glob = sim.eval_global(aggregated, eval_global_batches)
    return RunResult(global_acc=glob["acc"], local_acc=loc["acc"],
                     per_client=loc["per_client"], history=history,
                     comm_bytes=sim.comm_bytes)
