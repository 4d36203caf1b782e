"""End-to-end federated fine-tuning example (port of
``examples/fed_finetune_e2e.py``).

    PYTHONPATH=src python -m repro_torch.examples.fed_finetune_e2e \
        [--profile 25m|100m] [--rounds 8] [--pretrain-steps 300] \
        [--seq 64] [--device cuda|cpu]

Full path: backbone pretraining (cached under ``$REPRO_CACHE`` or the
checkout's ``.cache/``) → heterogeneous client split (one task per
client, as in the paper) → FedLoRA-Optimizer rounds (stage-1 local,
Eqs. 5-8 aggregation, stage-2 global ΔA_D) → stage-3 ΔB_M
personalization → eval table + a history checkpoint under
``experiments/`` of the working directory.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.core.fedlora import run_federated
from repro_torch.data import (TASK_TYPES, SyntheticInstructionDataset,
                              client_batch, eval_batches, make_dataset_family)
from repro_torch.device import resolve_device
from repro_torch.fed.pretrain import get_pretrained_base
from repro_torch.fed.simulate import FedHyper
from repro_torch.models.config import ArchConfig
from repro_torch.utils.pytree import tree_count_params

PROFILES = {
    "25m": ArchConfig(name="e2e-25m", family="dense", n_layers=6,
                      d_model=384, n_heads=6, n_kv_heads=2, d_ff=1536,
                      vocab_size=2048, dtype="float32", lora_rank=8,
                      lora_dropout=0.0),
    "100m": ArchConfig(name="e2e-100m", family="dense", n_layers=12,
                       d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
                       vocab_size=8192, dtype="float32", lora_rank=8,
                       lora_dropout=0.0),
}
TASKS = ("causal", "qa", "ie")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", default="25m", choices=PROFILES)
    ap.add_argument("--rounds", type=int, default=8)
    ap.add_argument("--pretrain-steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = PROFILES[args.profile]
    fam = make_dataset_family("dolly", vocab_size=cfg.vocab_size)
    mix = SyntheticInstructionDataset(fam, [1 / 3, 1 / 3, 1 / 3, 0],
                                      client_seed=0)
    t0 = time.time()
    base = get_pretrained_base(cfg, mix, steps=args.pretrain_steps, log=print,
                               device=dev)
    print(f"backbone: {tree_count_params(base)/1e6:.1f} M params "
          f"(pretrain {time.time()-t0:.0f}s)")

    cds = [SyntheticInstructionDataset(
        fam, [1.0 if t == TASKS[c] else 0.0 for t in TASK_TYPES],
        client_seed=0) for c in range(3)]
    eg = eval_batches(mix, 32, args.seq, 4, device=dev)
    rng = np.random.default_rng(1)
    el = [client_batch(cds, rng, 32, args.seq, device=dev) for _ in range(3)]

    hp = FedHyper(method="fedlora_opt", n_clients=3, rounds=args.rounds,
                  local_steps=5, batch=8, seq_len=args.seq, lr=2e-3,
                  server_lr=5e-4, global_steps=3, personal_steps=20,
                  lam=1e-3)
    res = run_federated(cfg, hp, cds, mix, eg, el, base=base, log=print,
                        device=dev)
    print("\n=== results ===")
    print(f"global model acc : {res.global_acc:.3f}")
    print(f"personalized acc : {res.local_acc:.3f}")
    for c, a in enumerate(res.per_client):
        print(f"  client {c} ({TASKS[c]}): {a:.3f}")
    print(f"adapter comm     : {res.comm_bytes/1e6:.2f} MB "
          f"over {args.rounds} rounds")
    save_checkpoint(f"experiments/e2e_{args.profile}.msgpack",
                    {"history": torch.tensor([h["acc"] for h in res.history],
                                             dtype=torch.float32)})
    print("history checkpoint → experiments/")
    return res


if __name__ == "__main__":
    main()
