"""Backbone pretraining (port of ``repro/fed/pretrain.py``).

The paper fine-tunes *pretrained* 7B checkpoints; offline the repo makes
its own backbone competence.  ``pretrain_base`` trains every backbone
leaf of the model on the task-family mixture (AdamW, global-norm clip 1,
through autograd: no hand-written kernel has a backward); the federated
PEFT experiments then adapt on top of it, frozen, as in the paper.

``get_pretrained_base`` caches the trained base on disk, keyed by
(config, steps, seed, family) as the reference keys it: the same
``repr`` of the config, hashed the same way, names the same file, in the
reference's msgpack format, so either package restores the other's
file.  The cache directory is ``$REPRO_CACHE``, read at each call, or
else the checkout's ``.cache/`` (listed in ``.gitignore``).
"""
from __future__ import annotations

import hashlib
import os
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.data.loader import to_device
from repro_torch.data.synthetic import SyntheticInstructionDataset
from repro_torch.device import resolve_device
from repro_torch.fed.simulate import value_and_grad
from repro_torch.launch.specs import abstract_params
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import init_params, loss_and_metrics
from repro_torch.optim import adamw, apply_updates, chain_clip

_CHECKOUT = Path(__file__).resolve().parents[3]


def _key(cfg: ArchConfig, steps: int, seed: int, family: str) -> str:
    blob = f"{cfg}|{steps}|{seed}|{family}".encode()
    return hashlib.blake2s(blob).hexdigest()[:16]


def cache_path(cfg: ArchConfig, steps: int, seed: int, family: str) -> str:
    """The file ``get_pretrained_base`` reads and writes, under
    ``$REPRO_CACHE`` or the checkout's ``.cache/``."""
    root = os.environ.get("REPRO_CACHE") or str(_CHECKOUT / ".cache")
    key = _key(cfg, steps, seed, family)
    return os.path.join(root, f"base_{cfg.name}_{key}.msgpack")


def _train_step(params, ost, batch, cfg, opt, step):
    """One full-parameter step: every leaf's gradient through autograd,
    then the optimizer's update outside the graph.  Returns (params,
    ost, met)."""
    _, met, grads = value_and_grad(
        lambda p: loss_and_metrics(p, batch, cfg), params)
    with torch.no_grad():
        upd, ost = opt.update(grads, ost, params, step)
        del grads
        params = apply_updates(params, upd)
    return params, ost, met


def pretrain_base(cfg: ArchConfig, dataset: SyntheticInstructionDataset,
                  steps: int = 600, batch: int = 32, seq_len: int = 48,
                  lr: float = 3e-3, seed: int = 0,
                  log: Callable[[str], None] = lambda s: None, *,
                  device="cuda"):
    """Train a backbone drawn from ``seed`` on ``dataset`` for ``steps``
    steps of (batch, seq_len) from ``np.random.default_rng(seed)``;
    logs ``ce`` / ``acc`` every 100 steps.  Returns the parameter tree
    on ``device``."""
    dev = resolve_device(device)
    params = init_params(torch.Generator(device=dev).manual_seed(seed), cfg,
                         device=dev)
    opt = chain_clip(adamw(lr), 1.0)
    ost = opt.init(params)
    rng = np.random.default_rng(seed)
    met = {}
    for i in range(steps):
        b = to_device(dataset.sample_batch(rng, batch, seq_len), dev)
        params, ost, met = _train_step(params, ost, b, cfg, opt, i)
        if i % 100 == 0:
            log(f"pretrain step {i}: ce={float(met['ce']):.3f} "
                f"acc={float(met['acc']):.3f}")
    log(f"pretrain done: acc={float(met['acc']):.3f}")
    return params


def get_pretrained_base(cfg: ArchConfig,
                        dataset: SyntheticInstructionDataset,
                        steps: int = 600, seed: int = 0,
                        log: Callable[[str], None] = lambda s: None, *,
                        device="cuda"):
    """Disk-cached pretrained backbone on ``device``: restored from
    ``cache_path`` when the file is there (no training), else trained by
    ``pretrain_base`` and written there."""
    dev = resolve_device(device)
    path = cache_path(cfg, steps, seed, dataset.family.name)
    if os.path.exists(path):
        params, _ = restore_checkpoint(path, abstract_params(cfg),
                                       device=dev)
        log(f"restored pretrained base from {path}")
        return params
    params = pretrain_base(cfg, dataset, steps=steps, seed=seed, log=log,
                           device=dev)
    save_checkpoint(path, params, step=steps)
    return params
