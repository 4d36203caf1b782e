"""Batch iterators bridging numpy generation to torch tensors on a device
(port of ``repro/data/loader.py``).  Every batch is drawn by the same
numpy calls as the reference's, so the same seeds give the same bytes."""
from __future__ import annotations

from typing import Iterator, Sequence

import numpy as np
import torch

from repro_torch.data.synthetic import SyntheticInstructionDataset
from repro_torch.device import resolve_device


def to_device(batch: dict, device="cuda") -> dict:
    """numpy batch → dict of tensors on ``device``, dtypes kept."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in batch.items()}


def batch_iterator(dataset: SyntheticInstructionDataset, batch: int,
                   seq_len: int, steps: int, seed: int = 0,
                   device="cuda") -> Iterator[dict]:
    """``steps`` training batches from ``np.random.default_rng(seed)``,
    each as tensors on ``device``."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        yield to_device(dataset.sample_batch(rng, batch, seq_len), device)


def eval_batches(dataset: SyntheticInstructionDataset, batch: int,
                 seq_len: int, n_batches: int, task: str | None = None,
                 seed: int = 10_000, device="cuda") -> list[dict]:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_batches):
        if task is None:
            b = dataset.sample_batch(rng, batch, seq_len)
        else:
            b = dataset.sample_task_batch(rng, batch, seq_len, task)
        out.append(to_device(b, device))
    return out


def client_batch(datasets: Sequence[SyntheticInstructionDataset],
                 rng: np.random.Generator, per_client_batch: int,
                 seq_len: int, device="cuda") -> dict:
    """Stacked (C, B, S) batch across clients for the federated step."""
    outs = [d.sample_batch(rng, per_client_batch, seq_len) for d in datasets]
    return to_device({k: np.stack([o[k] for o in outs]) for k in outs[0]},
                     device)
