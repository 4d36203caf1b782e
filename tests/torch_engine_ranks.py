"""Rank-side tasks of the production engine's tests
(``tests/test_torch_train_engine*.py``), run on every rank of a
``ClientPool``.  Each task takes the client-stacked (C, ...) state, runs
the engine on its rank's slice and returns that slice as numpy, so the
test can stack the ranks and hold them against ``FedSim``.  Imports no
JAX.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.launch.train import (TrainSettings, make_fed_pipeline_step,
                                      make_fed_train_step, rank_slice)
from repro_torch.utils import pytree as pt


def host(tree):
    """{path: numpy} of a tree (client axis kept)."""
    return {p: x.detach().cpu().numpy() for p, x in
            pt.tree_leaves_with_path(tree)}


def host_metrics(met):
    return {k: v.detach().cpu().numpy() for k, v in met.items()}


def _on(device):
    """A rank on the card computes f32 matmuls in f32, as the test
    process (TF32 off)."""
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False


def _state(group, opt_init, adapters, opt_state):
    ad = rank_slice(adapters, group.rank)
    return ad, (opt_init(ad) if opt_state is None
                else rank_slice(opt_state, group.rank))


def rounds(group, cfg, settings: dict, base, adapters, opt_state, batches,
           *, faults=(), rng=None, device="cpu"):
    """``len(batches)`` rounds of ``make_fed_train_step``; ``batches``:
    one stacked (C, T·B, S) dict a round; ``faults``: one dict of (C,)
    vectors a round (participation / staleness / update_scale), or
    none; ``opt_state`` None: the engine's ``opt_init``.  Returns
    (adapters, opt_state, [metrics a round])."""
    _on(device)
    st = TrainSettings(**settings)
    step_fn, opt_init = make_fed_train_step(cfg, group, st, device=device)
    ad, ost = _state(group, opt_init, adapters, opt_state)
    step, mets = 0, []
    for r, big in enumerate(batches):
        f = faults[r] if faults else {}
        ad, ost, met = step_fn(base, ad, ost, step,
                               rank_slice(big, group.rank),
                               rng=None if rng is None else rng + r, **f)
        step += st.local_steps
        mets.append(host_metrics(met))
    return host(ad), host(ost), mets


def pipeline(group, cfg, settings: dict, base, adapters, opt_state, iters,
             *, rng=None, device="cpu", telemetry_path=None, stages=False):
    """``len(iters)`` pipeline iterations through ``round_step`` →
    ``global_step`` → ``personal_step``, or ``run_pipeline`` when
    ``telemetry_path`` is given (rank 0's events go there); ``iters``:
    (client batch (C, T·B, S), server batch (TG·B_s, S), personal batch
    (C, TP·B, S)) an iteration.  Returns (adapters, opt_state, the
    server model, [metrics an iteration], whether stage 2 left every
    keep-local leaf as stage 1 did[, with ``stages``: the first
    iteration's rebroadcast and server model after stage 1 ("ad1",
    "agg1") and stage 2 ("ad2", "agg2") and the clients after stage 3
    ("ad3")])."""
    from repro_torch import obs
    _on(device)
    st = TrainSettings(**settings)
    pipe = make_fed_pipeline_step(cfg, group, st, device=device)
    me = group.rank
    ad, ost = _state(group, pipe.opt_init, adapters, opt_state)
    if telemetry_path is not None and me == 0:
        obs.enable(telemetry_path)
    rx = re.compile(pipe.method.keep_local or r"(?!)")
    step, anchor, agg, mets, kept = 0, None, None, [], True
    for i, (cb, sb, pb) in enumerate(iters):
        seeds = (None, None, None) if rng is None else (
            rng + i, rng + 100 + i, rng + 200 + i)
        if telemetry_path is not None:
            ad, ost, agg, anchor, met = pipe.run_pipeline(
                base, ad, ost, step, rank_slice(cb, me), sb,
                rank_slice(pb, me), anchor, *seeds)
        else:
            ad, ost, agg, m1 = pipe.round_step(
                base, ad, ost, step, rank_slice(cb, me), anchor, seeds[0])
            first = {"ad1": host(ad), "agg1": host(agg)}
            anchor = ad if pipe.method.prox else None
            own = {p: x.clone() for p, x in pt.tree_leaves_with_path(ad)
                   if rx.search(p)}
            agg, ad, m2 = pipe.global_step(base, agg, ad, sb, seeds[1])
            first.update(ad2=host(ad), agg2=host(agg))
            kept &= all(torch.equal(pt.tree_get(ad, p), x)
                        for p, x in own.items())
            ad, m3 = pipe.personal_step(base, ad, rank_slice(pb, me),
                                        seeds[2])
            if i == 0 and stages:
                out_stages = dict(first, ad3=host(ad))
            met = {"round": m1, "global": m2, "personal": m3}
        step += st.local_steps
        mets.append({k: host_metrics(v) for k, v in met.items()})
    if telemetry_path is not None and me == 0:
        obs.disable()
    out = (host(ad), host(ost), host(agg), mets, kept)
    return out + (out_stages,) if stages else out


def dropout_rates(group, cfg, settings: dict, base, adapters, batches,
                  rng):
    """``rounds`` with ``layers.adapter_dropout`` recording each draw's
    kept share of nonzero inputs; returns (adapters, [kept shares])."""
    from repro_torch.models import layers
    shares = []
    real = layers.adapter_dropout

    def recording(x, generator, p):
        y = real(x, generator, p)
        live = x != 0
        shares.append(float(((y != 0) & live).sum() / live.sum()))
        return y
    layers.adapter_dropout = recording
    try:
        ad, _, _ = rounds(group, cfg, settings, base, adapters, None,
                          batches, rng=rng)
    finally:
        layers.adapter_dropout = real
    return ad, shares


def collective(group, form, tree, covers, weights, staleness, step):
    """One ``CollectiveAgg`` call on this rank's client of a stacked
    tree; ``weights`` and ``staleness`` are (C,) vectors."""
    me = group.rank
    out = form(pt.tree_map(lambda x: x[me], tree), group=group,
               weight=float(weights[me]),
               cover=pt.tree_map(lambda x: x[me], covers), step=step,
               staleness=float(staleness[me]))
    return host(out)


def fail_on(group, rank):
    if group.rank == rank:
        raise ValueError(f"rank {rank} was told to fail")
    return group.rank


def collective_stats(group):
    return group.stats


def stack(results, key=0):
    """Stack the ranks' {path: (1, ...)} results along the client axis."""
    parts = [r[key] for r in results]
    return {p: np.concatenate([q[p] for q in parts]) for p in parts[0]}
