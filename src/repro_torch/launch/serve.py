"""Greedy generation: batched prefill, then a decode loop.

Per-tenant adapters, two deployment modes:

  * merge-per-tenant (``merge_adapters`` + one generate call per tenant)
    — the reference path the engine is held against;
  * mixed-batch multi-tenant via ``repro_torch.serve`` — one batch
    spanning many tenants, adapters gathered per row from pooled storage
    by the BGMV kernels (never merged into the backbone).

The reference runs the decode steps as one jitted ``lax.scan``; PyTorch
runs eagerly, so here they are a Python loop with no host sync inside.
``make_prefill_step`` / ``make_decode_step`` bind the model's serving
steps to a config (the reference's mesh argument has no counterpart on
one card).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.utils import pytree as pt

Params = Any


def make_prefill_step(cfg: ArchConfig):
    """``prefill_step(params, batch, enc_out=None) → (last logits,
    cache)``: ``models.model.prefill`` bound to ``cfg``."""
    def prefill_step(params, batch, enc_out=None):
        return M.prefill(params, batch, cfg, enc_out=enc_out)

    return prefill_step


def make_decode_step(cfg: ArchConfig):
    """``decode_step(params, new_token, cache, cache_index, enc_out=None)
    → (logits, cache)``: ``models.model.decode_step`` bound to ``cfg``
    (an encoder-decoder needs ``enc_out``)."""
    def decode_step(params, new_token, cache, cache_index, enc_out=None):
        return M.decode_step(params, new_token, cache, cache_index, cfg,
                             enc_out=enc_out)

    return decode_step


def greedy_generate(params, prompt_batch: dict, cfg: ArchConfig,
                    n_new: int = 16, adapter_idx=None, *, device="cuda"):
    """Greedy prefill → decode loop; returns (B, n_new) int64 tokens.
    ``prompt_batch`` holds ``tokens`` (B, S) and optionally
    ``frontend_emb`` and ``positions``, numpy or tensors; they and
    ``adapter_idx`` (B,) move to ``device``, where ``params`` must live.

    A frontend's F rows sit in front of the tokens', so the cache holds
    F + S + n_new positions and decoding starts at F + S (the reference
    pads to S + n_new and starts at S, inside the prefix).  An
    encoder-decoder's encoder runs once, and each decode step reads its
    output (the reference's decode loop drops it, ROADMAP C)."""
    dev = resolve_device(device)
    check_on(params["embed"]["embedding"], dev, "params")
    batch = {k: torch.as_tensor(prompt_batch[k], device=dev)
             for k in ("tokens", "frontend_emb", "positions")
             if prompt_batch.get(k) is not None}
    S = batch["tokens"].shape[1]
    if cfg.frontend and not cfg.n_enc_layers and "frontend_emb" in batch:
        S += batch["frontend_emb"].shape[1]
    if adapter_idx is not None:
        adapter_idx = torch.as_tensor(adapter_idx, dtype=torch.int32,
                                      device=dev)
        batch["adapter_idx"] = adapter_idx
    enc_out = (M._encode(params, batch["frontend_emb"], cfg)
               if cfg.n_enc_layers else None)
    logits, cache = M.prefill(params, batch, cfg, cache_len=S + n_new,
                              enc_out=enc_out)
    tok = M.argmax_first(logits)
    out = [tok]
    for i in range(n_new - 1):
        logits, cache = M.decode_step(params, tok, cache, S + i, cfg,
                                      enc_out=enc_out,
                                      adapter_idx=adapter_idx)
        tok = M.argmax_first(logits)
        out.append(tok)
    return torch.stack(out, dim=1)


def greedy_generate_reference(params, prompt_batch: dict, cfg: ArchConfig,
                              n_new: int = 16, *, device="cuda"):
    """The reference's per-step parity oracle.  In the port
    ``greedy_generate`` is already a per-step loop, so this is that loop
    without pooled-adapter routing (and, like it, decoding from F + S
    with the encoder's output)."""
    return greedy_generate(params, prompt_batch, cfg, n_new, device=device)


def merge_adapters(base: Params, adapters: Params) -> Params:
    return pt.merge_trees(base, adapters)
