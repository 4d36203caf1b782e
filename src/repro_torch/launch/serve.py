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
steps to a config and, with ``mesh`` (a ``launch/mesh.Grid``), to this
rank's place on a grid: the rank passes its shard of the backbone
(``launch/specs.shard_tree``) and the whole batch; the batch's rows are
split over the data ranks when they divide (else every data rank runs
them all, the reference's small-batch path), the backbone over the model
ranks, and the logits come back for every row and the whole vocabulary.
``greedy_generate(mesh=)`` decodes on the grid the same way.  A grid
whose ``seq_shard_kv`` layout is on (``grid.replace(seq_shard_kv=True)``)
splits the decode cache on its sequence over the model ranks where the
kv heads do not divide over them: ``greedy_generate`` reads the cache's
length from its own arguments, and a prefill step needs none; a decode
step of ``make_decode_step`` reads it from the grid
(``grid.replace(seq_shard_kv=True, kv_len=cache_len)``).  Every
family runs on a grid: an encoder-decoder's encoder runs there too, over
the rank's frame rows, and its output is passed to every decode step.
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.device import check_on, resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.utils import pytree as pt

Params = Any


def _rows(batch: dict, mesh):
    """This data rank's rows of a whole batch, on the rank's device, and
    the grid marked with how they lie: split when B divides over the data
    ranks, else every row on every data rank."""
    B, dp = batch["tokens"].shape[0], mesh.data.size
    split = B % dp == 0
    n, d = (B // dp, mesh.data.rank) if split else (B, 0)
    return ({k: (v[d * n:(d + 1) * n].to(mesh.device)
                 if torch.is_tensor(v) and v.dim() else v)
             for k, v in batch.items()}, mesh.replace(rows_split=split))


def _all_rows(x, grid):
    """Every row's ``x`` from the data ranks' rows, in rank order."""
    if not grid.rows_split or grid.data.size == 1:
        return x
    return torch.cat(list(grid.data.all_gather([x])[0].unbind(0)))


def make_prefill_step(cfg: ArchConfig, mesh=None):
    """``prefill_step(params, batch, enc_out=None, cache_len=0) → (last
    logits, cache)``: ``models.model.prefill`` bound to ``cfg``; with
    ``mesh``, this rank's part of it (module docstring): its shard of
    ``params``, the whole ``batch``, every row's logits and the rank's
    cache (its rows, its kv heads and SSM heads)."""

    def prefill_step(params, batch, enc_out=None, cache_len=0):
        if mesh is None:
            return M.prefill(params, batch, cfg, enc_out=enc_out,
                             cache_len=cache_len)
        local, grid = _rows(batch, mesh)
        logits, cache = M.prefill(params, local, cfg, enc_out=enc_out,
                                  cache_len=cache_len, mesh=grid)
        return _all_rows(logits, grid), cache

    return prefill_step


def make_decode_step(cfg: ArchConfig, mesh=None):
    """``decode_step(params, new_token, cache, cache_index, enc_out=None)
    → (logits, cache)``: ``models.model.decode_step`` bound to ``cfg``
    (an encoder-decoder needs ``enc_out``); with ``mesh``, the rank's
    part: every row's new_token, the rank's cache (from its prefill
    step; an encoder-decoder's ``enc_out`` of the rank's rows, whole
    over the model group), every row's logits."""

    def decode_step(params, new_token, cache, cache_index, enc_out=None):
        if mesh is None:
            return M.decode_step(params, new_token, cache, cache_index, cfg,
                                 enc_out=enc_out)
        # per-row (B,) positions are cut to the rank's rows with the tokens
        local, grid = _rows({"tokens": new_token, "index": cache_index},
                            mesh)
        logits, cache = M.decode_step(params, local["tokens"], cache,
                                      local["index"], cfg, enc_out=enc_out,
                                      mesh=grid)
        return _all_rows(logits, grid), cache

    return decode_step


def greedy_generate(params, prompt_batch: dict, cfg: ArchConfig,
                    n_new: int = 16, adapter_idx=None, *, device="cuda",
                    mesh=None):
    """Greedy prefill → decode loop; returns (B, n_new) int64 tokens.
    ``prompt_batch`` holds ``tokens`` (B, S) and optionally
    ``frontend_emb`` and ``positions``, numpy or tensors; they and
    ``adapter_idx`` (B,) move to ``device``, where ``params`` must live.

    A frontend's F rows sit in front of the tokens', so the cache holds
    F + S + n_new positions and decoding starts at F + S (the reference
    pads to S + n_new and starts at S, inside the prefix).  An
    encoder-decoder's encoder runs once, and each decode step reads its
    output (the reference's decode loop drops it, ROADMAP C).

    ``mesh``: this rank's part on a grid, with its shard of ``params``
    and the whole prompt batch; returns every row's tokens.  With the
    grid's ``seq_shard_kv`` layout the cache of S + n_new positions is
    split on its sequence where the reference's rule splits it (a
    length that does not divide over the model ranks stays whole).  Pooled
    adapters are not served on a grid (the reference raises too)."""
    dev = resolve_device(device)
    check_on(params["embed"]["embedding"], dev, "params")
    if mesh is not None:
        if adapter_idx is not None:
            raise NotImplementedError(
                "pooled-adapter routing (adapter_idx) is not served on a "
                "grid; serve merged per-tenant models")
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
    grid = None
    if mesh is not None:
        batch, grid = _rows(batch, mesh)
        if grid.seq_shard_kv:
            grid = grid.replace(kv_len=S + n_new)
    enc_out = (M._encode(params, batch["frontend_emb"], cfg, mesh=grid)
               if cfg.n_enc_layers else None)
    logits, cache = M.prefill(params, batch, cfg, cache_len=S + n_new,
                              enc_out=enc_out, mesh=grid)
    tok = M.argmax_first(logits)
    out = [tok]
    for i in range(n_new - 1):
        logits, cache = M.decode_step(params, tok, cache, S + i, cfg,
                                      enc_out=enc_out,
                                      adapter_idx=adapter_idx, mesh=grid)
        tok = M.argmax_first(logits)
        out.append(tok)
    toks = torch.stack(out, dim=1)
    return toks if grid is None else _all_rows(toks, grid)


def greedy_generate_reference(params, prompt_batch: dict, cfg: ArchConfig,
                              n_new: int = 16, *, device="cuda"):
    """The reference's per-step parity oracle.  In the port
    ``greedy_generate`` is already a per-step loop, so this is that loop
    without pooled-adapter routing (and, like it, decoding from F + S
    with the encoder's output)."""
    return greedy_generate(params, prompt_batch, cfg, n_new, device=device)


def merge_adapters(base: Params, adapters: Params) -> Params:
    return pt.merge_trees(base, adapters)
