"""Federated aggregation (paper Eqs. 5-8) and its comm accounting (port
of the ``repro/core/aggregation.py`` functions the paper's pipeline and
the raw-LoRA baseline run).

Client adapter trees carry a leading client axis C on every leaf.  The
decomposed aggregation of Eqs. 5-8 is "mean every leaf over the client
axis" on the decomposed representation, and the raw-LoRA baseline is
the same mean on {lora_A, lora_B}.  The rank-aware, compressed,
trimmed and staleness aggregators are ROADMAP A8; the collective forms
of the production round engine are A11.
"""
from __future__ import annotations

import math
import re
from typing import Any

import torch

from repro_torch.utils import pytree as pt

Params = Any

COMM_CLASSES = ("psum", "all_gather", "q8", "topk")


def fedavg(client_adapters: Params, weights=None) -> Params:
    """FedAvg (McMahan et al.): weighted mean over the client axis."""
    if weights is None:
        return pt.tree_map(lambda x: torch.mean(x, dim=0), client_adapters)
    w = torch.as_tensor(weights, dtype=torch.float32)
    w = w / torch.sum(w)

    def wmean(x):
        wb = w.to(x.device).reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.sum(x * wb, dim=0)

    return pt.tree_map(wmean, client_adapters)


def decomposed_fedavg(client_adapters: Params, weights=None) -> Params:
    """Paper Eqs. 5-8: Ā_D, Ā_M, B̄_M, B̄_D averaged separately, directions
    not re-normalized.  On the decomposed representation this is
    leaf-wise FedAvg, kept as its own entry point for intent."""
    return fedavg(client_adapters, weights)


def broadcast_to_clients(agg: Params, n_clients: int) -> Params:
    """(C, ...) copies of every leaf (copies, not expanded views, so a
    client's leaf can be replaced without touching another's)."""
    return pt.tree_map(
        lambda x: x[None].expand(n_clients, *x.shape).clone(), agg)


def client_rebroadcast(aggregated: Params, own_adapters: Params,
                       keep_rx=None) -> Params:
    """One client's view of the rebroadcast aggregate: leaves matching the
    keep-local regex keep the client's ``own_adapters`` values (personal
    state never leaves the client).  ``keep_rx``: compiled pattern, regex
    string or None.  (The reference's rank re-mask, ``cover``, belongs to
    mixed-rank fleets: ROADMAP A8.)"""
    if keep_rx is None:
        return aggregated
    rx = re.compile(keep_rx) if isinstance(keep_rx, str) else keep_rx
    return pt.tree_map_with_path(
        lambda p, leaf: pt.tree_get(own_adapters, p)
        if rx.search(p) else leaf, aggregated)


def rebroadcast_keep_personal(aggregated: Params, client_adapters: Params,
                              keep_rx=None) -> Params:
    """Broadcast the aggregate to every client of a client-stacked tree;
    leaves matching ``keep_rx`` keep each client's own value."""
    C = pt.tree_leaves(client_adapters)[0].shape[0]
    return client_rebroadcast(broadcast_to_clients(aggregated, C),
                              client_adapters, keep_rx)


def comm_bytes_per_round(adapters_one_client: Params,
                         exclude_rx: str | None = None,
                         comm: str = "psum",
                         n_clients: int | None = None,
                         topk_ratio: float = 0.01) -> int:
    """Per-client bytes for one round's aggregation: adapter leaves only
    (the frozen backbone never moves).  Leaves matching ``exclude_rx``
    stay client-local and are not billed.  (Billing a mixed-rank fleet's
    client at its own rank, the reference's ``rank``, is ROADMAP A8.)
    Per transmitted leaf of n elements of ``itemsize`` bytes, by comm
    class:

      psum        2·n·itemsize (updates up, aggregate down)
      all_gather  (C+1)·n·itemsize (needs ``n_clients``)
      q8          n + 4 up (int8 codes and one f32 scale), n·itemsize down
      topk        k·(itemsize + 4) up, k = max(1, ⌈topk_ratio·n⌉);
                  n·itemsize down
    """
    tree = adapters_one_client
    if exclude_rx is not None:
        rx = re.compile(exclude_rx)
        tree = pt.filter_tree(tree, lambda p: not rx.search(p))
    if comm == "all_gather" and n_clients is None:
        raise ValueError("all_gather comm accounting needs n_clients "
                         "(each client downlinks every client's stack)")
    if comm not in COMM_CLASSES:
        raise ValueError(f"unknown comm class {comm!r} "
                         "(psum | all_gather | q8 | topk)")
    total = 0
    for leaf in pt.tree_leaves(tree):
        n, sz = leaf.numel(), leaf.element_size()
        if comm == "psum":
            total += 2 * n * sz
        elif comm == "all_gather":
            total += (n_clients + 1) * n * sz
        elif comm == "q8":
            total += n + 4 + n * sz
        else:
            k = max(1, int(math.ceil(topk_ratio * n)))
            total += k * (sz + 4) + n * sz
    return total


def comm_class(method) -> str:
    """The comm class a method's aggregation moves on the wire.  A method
    with an explicit collective form bills at its class; every
    aggregator the port has is a mean, an all-reduce: "psum"."""
    collective = getattr(method, "collective", None)
    return getattr(collective, "comm", None) or "psum"
