"""Rank-side tasks of the grid's tests (``tests/test_torch_tp.py``), run
on every rank of a ``ClientPool`` grid (``n_model=``).  Each task takes
whole trees, cuts this rank's shard (``launch/specs``), runs the port on
the grid and returns host numpy arrays.  Imports no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.launch import specs as SP
from repro_torch.launch.serve import (_rows, greedy_generate,
                                      make_decode_step, make_prefill_step)
from repro_torch.launch.train import (TrainSettings, make_fed_pipeline_step,
                                      rank_slice)
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.utils import pytree as pt
from repro_torch.utils.sharding import DEFAULT_PARAM_RULES, tree_specs


def host(tree):
    """{path: a numpy copy} (not a view: a decode step writes its cache
    in place)."""
    return {p: x.detach().cpu().numpy().copy() for p, x in
            pt.tree_leaves_with_path(tree)}


def shard(grid, cfg, params):
    """This rank's shard of a whole backbone (``param_specs``)."""
    return SP.shard_tree(params, SP.param_specs(cfg, grid, params), grid)


def serve(grid, cfg, params, batch, n_new):
    """On the grid, from this rank's shard of ``params`` and the whole
    ``batch`` (tokens, and frontend_emb for a frontend): the prefill
    step's logits and ``n_new`` - 1 decode steps' (every row), each step
    fed the greedy tokens; the rank's cache after the prefill; and
    ``greedy_generate``'s tokens."""
    mine = shard(grid, cfg, params)
    S = batch["tokens"].shape[1]
    if "frontend_emb" in batch and not cfg.n_enc_layers:
        S += batch["frontend_emb"].shape[1]
    prefill, decode = make_prefill_step(cfg, grid), make_decode_step(cfg, grid)
    with torch.no_grad():
        logits, cache = prefill(mine, batch, cache_len=S + n_new)
        first = host(cache)
        enc_out = None
        if cfg.n_enc_layers:        # the rank's rows, whole over its row
            local, g = _rows(batch, grid)
            enc_out = M._encode(mine, local["frontend_emb"], cfg, mesh=g)
        steps = [logits.numpy()]
        tok = logits.argmax(-1)
        for i in range(n_new - 1):
            logits, cache = decode(mine, tok, cache, S + i, enc_out=enc_out)
            steps.append(logits.numpy())
            tok = logits.argmax(-1)
        toks = greedy_generate(mine, batch, cfg, n_new, device="cpu",
                               mesh=grid)
    return {"steps": np.stack(steps), "cache": first,
            "tokens": toks.numpy()}


def moe_ep(grid, cfg, p, x):
    """``layers.moe_ffn_ep`` over this rank's slots (the rule table's
    ``("data", None, "model")``) on x (B, S, D): each data rank's rows
    when B divides over the data ranks, else all of them on every rank.
    Returns every row's y and the aux."""
    specs = tree_specs({"moe": p}, DEFAULT_PARAM_RULES, grid)
    mine = SP.shard_tree({"moe": p}, specs, grid)["moe"]
    x = torch.as_tensor(x)
    dp, d = grid.data.size, grid.data.rank
    split = x.shape[0] % dp == 0
    n = x.shape[0] // dp
    with torch.no_grad():
        y, aux = L.moe_ffn_ep(mine, x[d * n:(d + 1) * n] if split else x,
                              cfg, grid.replace(rows_split=split))
        if split:
            y = torch.cat(list(grid.data.all_gather([y])[0].unbind(0)))
    return y.numpy(), float(aux)


def moe_ep_grad(grid, cfg, p, x, w, c):
    """The gradient of the rank's loss Σ w ⊙ y + c · aux through
    ``layers.moe_ffn_ep`` with respect to its x: its data rank's rows of
    x and w when the batch divides over the data ranks, else all of
    them.  Returns (dx, aux)."""
    specs = tree_specs({"moe": p}, DEFAULT_PARAM_RULES, grid)
    mine = SP.shard_tree({"moe": p}, specs, grid)["moe"]
    dp, d = grid.data.size, grid.data.rank
    split = x.shape[0] % dp == 0
    n = x.shape[0] // dp
    rows = slice(d * n, (d + 1) * n) if split else slice(None)
    xr = torch.as_tensor(x[rows]).requires_grad_(True)
    y, aux = L.moe_ffn_ep(mine, xr, cfg, grid.replace(rows_split=split))
    (torch.sum(y * torch.as_tensor(w[rows])) + c * aux).backward()
    return xr.grad.numpy(), float(aux)


def pipeline(grid, cfg, settings: dict, base, adapters, iters,
             data_only=False):
    """``len(iters)`` fedlora_opt pipeline iterations (round_step →
    global_step → personal_step) of the rank's client (its data index)
    from client-stacked ``adapters``; ``data_only``: on the rank's data
    column as a client group with the whole backbone (the engine without
    a model axis), else on the grid with the rank's shard.  Returns
    (client adapters (1, ...), server model) as numpy."""
    st = TrainSettings(**settings)
    mesh = grid.data if data_only else grid
    mine = base if data_only else shard(grid, cfg, base)
    pipe = make_fed_pipeline_step(cfg, mesh, st, device="cpu")
    me = grid.data.rank
    ad = rank_slice(adapters, me)
    ost = pipe.opt_init(ad)
    step, anchor, agg = 0, None, None
    for cb, sb, pb in iters:
        ad, ost, agg, _ = pipe.round_step(mine, ad, ost, step,
                                          rank_slice(cb, me), anchor)
        anchor = ad if pipe.method.prox else None
        agg, ad, _ = pipe.global_step(mine, agg, ad, sb)
        ad, _ = pipe.personal_step(mine, ad, rank_slice(pb, me))
        step += st.local_steps
    return host(ad), host(agg)


def grads(grid, cfg, base, adapters, batch):
    """One stage-1 step's adapter gradient on the grid, summed over the
    model row as the engine sums it, and the loss metrics; the rank's
    client is its data index of the client-stacked ``adapters`` and
    ``batch``."""
    from repro_torch.fed.simulate import stage_loss, value_and_grad
    mine = shard(grid, cfg, base)
    me = grid.data.rank
    ad = pt.tree_map(lambda x: x[me], adapters)
    b = {k: v[me] for k, v in batch.items()}
    _, met, g = value_and_grad(lambda leaves: stage_loss(
        mine, leaves, b, cfg, mesh=grid.replace(manual=True)), ad)
    paths = pt.tree_paths(g)
    g = dict(zip(paths, grid.model.all_reduce(pt.tree_leaves(g))))
    return ({p: x.numpy() for p, x in g.items()},
            {k: float(v) for k, v in met.items()})


def argmax_ties(grid, logits):
    """``model.argmax_over_shards`` of the rank's vocabulary columns of
    whole ``logits`` (..., V)."""
    from repro_torch.models.model import argmax_over_shards
    n = logits.shape[-1] // grid.model.size
    m = grid.model.rank
    return argmax_over_shards(logits[..., m * n:(m + 1) * n], grid.model)


def collectives(grid, x):
    """Each gradient-carrying collective of ``utils/collectives`` on the
    rank's x (a different value a rank: x + rank), forward and backward
    under a loss Σ w ⊙ y with w fixed (times 1 + rank for ``mean_over``
    and ``sum_over``, whose backwards mean and sum the ranks' weights):
    {name: (y, dL/dx)}."""
    from repro_torch.utils import collectives as K
    out = {}
    g = grid.model
    for name, fn, k in (
            ("copy_to", lambda t: K.copy_to(t, g), 1),
            ("reduce_from", lambda t: K.reduce_from(t, g), 1),
            ("gather_from", lambda t: K.gather_from(t, g, -1), 1),
            ("all_to_all", lambda t: K.all_to_all(t, grid.data), 1),
            ("mean_over", lambda t: K.mean_over(t, grid.data),
             1 + grid.rank),
            ("sum_over", lambda t: K.sum_over(t, g), 1 + grid.rank)):
        t = (torch.as_tensor(x) + grid.rank).requires_grad_(True)
        y = fn(t)
        w = torch.arange(y.numel(), dtype=y.dtype).reshape(y.shape) / 7 * k
        (y * w).sum().backward()
        out[name] = (y.detach().numpy(), t.grad.numpy())
    return out


def seq_serve(grid, cfg, params, batch, n_new, cache_len, rowpos=0):
    """On the grid's ``seq_shard_kv`` layout, from this rank's shard of
    ``params`` and the whole ``batch``: the prefill step with a cache of
    ``cache_len`` positions and ``n_new`` - 1 decode steps fed the greedy
    tokens (row r at position S + i + r · ``rowpos`` when ``rowpos``,
    per-row positions), every row's logits; the rank's cache after the
    prefill, the largest difference of its slots from the default
    layout's prefill cache cut to them (the kv heads whole on every
    rank), and the rank's cache after the steps."""
    mine = shard(grid, cfg, params)
    B, S = batch["tokens"].shape
    g = grid.replace(seq_shard_kv=True, kv_len=cache_len)
    with torch.no_grad():
        logits, cache = make_prefill_step(cfg, g)(mine, batch,
                                                  cache_len=cache_len)
        _, whole = make_prefill_step(cfg, grid)(mine, batch,
                                                cache_len=cache_len)
        first = host(cache)
        off = 0.0
        for p, x in host(whole).items():
            n = first[p].shape[-3]
            m = grid.model.rank if n != x.shape[-3] else 0
            off = max(off, float(np.abs(x[..., m * n:(m + 1) * n, :, :]
                                        - first[p]).max()))
        decode = make_decode_step(cfg, g)
        steps, tok = [logits.numpy()], logits.argmax(-1)
        for i in range(n_new - 1):
            idx = (torch.arange(B) * rowpos + S + i) if rowpos else S + i
            logits, cache = decode(mine, tok, cache, idx)
            steps.append(logits.numpy())
            tok = logits.argmax(-1)
    return {"steps": np.stack(steps), "cache": first, "prefill_off": off,
            "final": host(cache)}


def account(grid, cfg, shape, seq_shard_kv=False):
    """``launch.dryrun.measure`` of the step ``dryrun.step_and_inputs``
    builds on this rank of a CPU grid (its shard of the backbone and the
    cache): the storage tally, the FLOPs and the collectives."""
    from repro_torch.launch import dryrun
    step, make_args = dryrun.step_and_inputs(
        cfg, shape, device="cpu", grid=grid, seq_shard_kv=seq_shard_kv)
    return dryrun.measure(step, make_args(), grid)
