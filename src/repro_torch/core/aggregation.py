"""Federated aggregation (paper Eqs. 5-8), the baselines' aggregators and
their comm accounting (port of ``repro/core/aggregation.py``).

Client adapter trees carry a leading client axis C on every leaf.  The
decomposed aggregation of Eqs. 5-8 is "mean every leaf over the client
axis" on the decomposed representation, and the raw-LoRA baseline is
the same mean on {lora_A, lora_B}.  Beside the mean: the trimmed mean,
FedALT's mean with the personal pair zeroed, the FedBuff staleness
discount, the compressed uplinks (stochastic int8, top-k) and the
rank-aware family of mixed-rank fleets (zero-pad, replication, exact).

Every aggregator takes the client-stacked tree (plus optional weights,
plus ``ranks`` for the rank-aware family) and returns the aggregate
without the client axis.  ``CollectiveAgg`` is the same aggregation as
a collective over one client's tree a rank (``launch/train.py``: one
client per ``torch.distributed`` rank), and ``collective_form`` resolves
a method's.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import re
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import peft
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


def trimmed_fedavg(client_adapters: Params, weights=None, *,
                   trim_ratio: float = 0.25) -> Params:
    """Coordinate-wise trimmed mean over the client axis (cf. Koo et
    al.): per coordinate, drop the k lowest and k highest client values,
    k = ⌊trim_ratio · C⌋, and average the rest; the plain mean when
    that would leave nothing (2k ≥ C) or trim nothing.  ``weights`` are
    ignored: order statistics do not compose with client weighting."""
    def tmean(x):
        C = x.shape[0]
        k = int(trim_ratio * C)
        if k == 0 or 2 * k >= C:
            return torch.mean(x, dim=0)
        return torch.mean(torch.sort(x, dim=0).values[k:C - k], dim=0)

    return pt.tree_map(tmean, client_adapters)


def fedavg_excluding(client_adapters: Params, weights=None, *,
                     exclude_rx: str) -> Params:
    """FedAvg with the leaves matching ``exclude_rx`` zeroed: they are
    client-personal and stay out of the server's model (the engine's
    keep-local rebroadcast restores each client's own values)."""
    rx = re.compile(exclude_rx)
    return pt.tree_map_with_path(
        lambda p, x: torch.zeros_like(x) if rx.search(p) else x,
        fedavg(client_adapters, weights))


def keep_components(tree: Params, component_rx: str) -> Params:
    """Zero every leaf that does NOT match ``component_rx``."""
    rx = re.compile(component_rx)
    return pt.tree_map_with_path(
        lambda p, x: x if rx.search(p) else torch.zeros_like(x), tree)


def aggregate_zero_rx(method) -> str | None:
    """Regex of the leaves a method's aggregate zeroes in the global
    model (FedALT's personal pair), or None: its ``server_zero_rx``.
    The reference also reads the ``exclude_rx`` of a
    ``fedavg_excluding`` partial when that field is unset; every
    registered method that excludes leaves sets it."""
    return getattr(method, "server_zero_rx", None)


# ---------------------------------------------------------------------------
# rank-aware aggregation (mixed-rank fleets)
# ---------------------------------------------------------------------------
#
# Mixed-rank client adapters live zero-padded at r_max (see
# peft.client_rank_masks).  Three policies over that layout:
#
#   zeropad_fedavg      the plain weighted mean, which IS zero-pad
#                       averaging on padded trees (it dilutes high-rank
#                       rows, Koo et al.);
#   replication_fedavg  rank row j averages only the clients that own it;
#   exact_fedavg        Σ wᵢ·AᵢBᵢ exactly, from the weighted pairs stacked
#                       along the rank axis, re-factored to the server
#                       rank by truncated SVD (Nguyen et al.).


def zeropad_fedavg(client_adapters: Params, weights=None, *,
                   ranks=None) -> Params:
    """The naive mixed-rank baseline.  ``ranks`` is accepted for the
    family's signature and unused: the zero padding above each client's
    rank does the zero-pad averaging by construction."""
    del ranks
    return fedavg(client_adapters, weights)


def _client_weights(x0, weights):
    """Normalized (C,) f32 client weights on ``x0``'s device (uniform
    for None)."""
    C = x0.shape[0]
    if weights is None:
        return torch.full((C,), 1.0 / C, device=x0.device)
    w = torch.as_tensor(weights, dtype=torch.float32).to(x0.device)
    return w / torch.sum(w)


def replication_fedavg(client_adapters: Params, weights=None, *,
                       ranks) -> Params:
    """Coverage-weighted mean over the client axis: rank row j of a
    rank-axis leaf averages only the clients with rank > j, so low-rank
    clients never dilute the rows they do not own; a row no client owns
    is 0.  Leaves without a rank axis get the plain weighted mean, and
    on a uniform fleet this is ``fedavg``."""
    leaves = pt.tree_leaves(client_adapters)
    w = _client_weights(leaves[0], weights)
    covers = peft.client_rank_masks(
        pt.tree_map(lambda x: x[0], client_adapters), ranks)

    def one(path, x):
        cover = pt.tree_get(covers, path)
        wb = w.reshape((-1,) + (1,) * (x.dim() - 1))
        num = torch.sum(x * cover * wb, dim=0)
        den = torch.sum(cover * wb, dim=0)
        return torch.where(den > 0, num / torch.clamp(den, min=1e-12),
                           torch.zeros((), dtype=num.dtype,
                                       device=num.device))

    return pt.tree_map_with_path(one, client_adapters)


def _refactor_pair(a_cat, b_cat, r_out: int):
    """Best rank-``r_out`` factorization of ``a_cat @ b_cat`` through a
    QR-reduced SVD.  a_cat (..., d_in, K), b_cat (..., K, d_out) with
    K = Σ rᵢ; exact whenever rank(a_cat @ b_cat) ≤ r_out.  The singular
    values split as √s into each factor; the result is zero-padded back
    to ``r_out`` columns / rows when the core has fewer."""
    qa, ra = torch.linalg.qr(a_cat)                    # (.., d_in, k)(k, K)
    qb, rb = torch.linalg.qr(b_cat.transpose(-1, -2))  # (.., d_out, k')
    m = ra @ rb.transpose(-1, -2)                      # (.., k, k')
    # on the card, cuSOLVER's QR-iteration SVD (gesvd): its default, the
    # Jacobi gesvdj, leaves the products ~1e-5 off an f64 SVD in f32,
    # gesvd ~1e-6 as LAPACK on the CPU (scripts/exact_fedavg_accuracy.py)
    u, s, vt = torch.linalg.svd(m, full_matrices=False,
                                driver="gesvd" if m.is_cuda else None)
    take = min(r_out, s.shape[-1])
    root = torch.sqrt(s[..., :take])
    a_new = (qa @ u[..., :, :take]) * root[..., None, :]
    b_new = root[..., :, None] * (vt[..., :take, :] @ qb.transpose(-1, -2))
    if take < r_out:                                   # pad back to r_out
        a_new = F.pad(a_new, (0, r_out - take))
        b_new = F.pad(b_new, (0, 0, 0, r_out - take))
    return a_new, b_new


def exact_fedavg(client_adapters: Params, weights=None, *, ranks=None,
                 r_out: int | None = None) -> Params:
    """Exact product aggregation for raw-LoRA pairs.

    Σ wᵢ·AᵢBᵢ is the product of the client-concatenated factors
    [w₁A₁ | w₂A₂ | ...] @ [B₁; B₂; ...], client-major along the rank
    axis; that stacked pair (rank Σ rᵢ) is re-factored to ``r_out``
    (default: the allocated rank) by truncated SVD, so the aggregate
    keeps the fleet's leaf shapes.  It is the best rank-``r_out``
    approximation of the exact mean, and the exact mean whenever
    rank(Σ wᵢ·AᵢBᵢ) ≤ r_out.  The factors are fixed only up to one sign
    per rank column.  QR and SVD run on the adapters' own device in
    (at least) f32.  ``ranks`` is accepted for the family's signature:
    the padded columns are zero and only add zero singular values."""
    del ranks
    leaves = pt.tree_leaves(client_adapters)
    w = _client_weights(leaves[0], weights)
    paths = set(pt.tree_paths(client_adapters))
    a_paths = sorted(p for p in paths if p.endswith("lora_A"))
    if not a_paths or any(p.rsplit("/", 1)[0] + "/lora_B" not in paths
                          for p in a_paths):
        raise ValueError("exact_fedavg needs raw-LoRA {lora_A, lora_B} "
                         "pairs (decomposed/dual trees have no exact "
                         "product aggregation)")

    out = fedavg(client_adapters, w)              # non-pair leaves: mean
    for pa in a_paths:
        prefix = pa.rsplit("/", 1)[0]
        A = pt.tree_get(client_adapters, pa)       # (C, *lead, d_in, r)
        B = pt.tree_get(client_adapters, f"{prefix}/lora_B")
        C = A.shape[0]
        dt = torch.promote_types(A.dtype, torch.float32)
        Aw = A.to(dt) * w.to(dt).reshape((C,) + (1,) * (A.dim() - 1))
        # client-major concat along the rank axis
        a_cat = torch.movedim(Aw, 0, -2).reshape(
            *A.shape[1:-1], C * A.shape[-1])       # (*lead, d_in, C·r)
        b_cat = torch.movedim(B.to(dt), 0, -3).reshape(
            *B.shape[1:-2], C * B.shape[-2], B.shape[-1])
        a_new, b_new = _refactor_pair(a_cat, b_cat, r_out or A.shape[-1])
        pt.set_leaf(out, pa, a_new.to(A.dtype))
        pt.set_leaf(out, f"{prefix}/lora_B", b_new.to(B.dtype))
    return out


# ---------------------------------------------------------------------------
# staleness-weighted (FedBuff-style) aggregation
# ---------------------------------------------------------------------------

def staleness_scale(staleness, alpha: float = 0.5):
    """FedBuff's polynomial discount s(τ) = (1 + τ)^(−α): 1 for a fresh
    update, so a synchronous fleet is exactly weighted FedAvg."""
    return torch.pow(1.0 + torch.as_tensor(staleness, dtype=torch.float32),
                     -alpha)


@dataclasses.dataclass(frozen=True)
class StalenessFedAvg:
    """Weighted mean with client i's weight discounted by its staleness,
    wᵢ·(1+τᵢ)^(−α).  ``needs_staleness`` (a class attribute) tells
    ``FedSim.aggregate`` to pass the (C,) staleness vector."""
    alpha: float = 0.5

    needs_staleness = True        # no annotation: a class attribute

    def __call__(self, client_adapters: Params, weights=None, *,
                 staleness=None) -> Params:
        C = pt.tree_leaves(client_adapters)[0].shape[0]
        w = (torch.ones((C,), dtype=torch.float32) if weights is None
             else torch.as_tensor(weights, dtype=torch.float32))
        if staleness is not None:
            w = w * staleness_scale(staleness, self.alpha)
        return fedavg(client_adapters, w)


# ---------------------------------------------------------------------------
# compressed uplinks (q8, top-k)
# ---------------------------------------------------------------------------

def _sr_int8_roundtrip(x, generator):
    """Stochastically rounded symmetric int8 encode → decode of one leaf,
    one f32 scale a leaf: q = ⌊y⌋ + Bernoulli(y − ⌊y⌋) is unbiased per
    coordinate, and an all-zero leaf comes back exactly zero."""
    scale = torch.clamp(torch.max(torch.abs(x.float())), min=1e-8) / 127.0
    y = torch.clamp(x.float() / scale, -127.0, 127.0)
    lo = torch.floor(y)
    u = torch.rand(x.shape, generator=generator, device=x.device)
    return ((lo + (u < y - lo)) * scale).to(x.dtype)


def _topk_roundtrip(x, ratio: float):
    """Keep the ⌈ratio·n⌉ largest-magnitude coordinates of the leaf and
    zero the rest; deterministic."""
    k = max(1, int(math.ceil(ratio * x.numel())))
    if k >= x.numel():
        return x
    flat = x.reshape(-1)
    idx = torch.topk(torch.abs(flat).float(), k).indices
    out = torch.zeros_like(flat)
    out[idx] = flat[idx]
    return out.reshape(x.shape)


def _q8_generator(device, seed: int, step: int, client_idx: int,
                  leaf: int) -> torch.Generator:
    """The stochastic-rounding stream of one leaf of one client's uplink
    in one round.  The reference keys it by fold_in(seed, step, client,
    leaf), which torch cannot reproduce: this seeds a torch.Generator
    from the same four integers (numpy's SeedSequence mixes them), so
    the draws are deterministic within the port and agree with the
    reference only in distribution."""
    s = np.random.SeedSequence([seed, int(step), client_idx, leaf])
    return torch.Generator(device=device).manual_seed(
        int(s.generate_state(1, np.uint64)[0]) & ((1 << 63) - 1))


def compress_update(adapters: Params, *, mode: str, step=0, client_idx=0,
                    topk_ratio: float = 0.01, seed: int = 0) -> Params:
    """Encode → decode one client's adapters through the compressed
    uplink: "q8" stochastic int8 (``_q8_generator``'s stream for each
    leaf, in ``tree_leaves`` order), "topk" magnitude top-k."""
    if mode == "topk":
        return pt.tree_map(lambda x: _topk_roundtrip(x, topk_ratio), adapters)
    if mode != "q8":
        raise ValueError(f"unknown compression mode {mode!r} (q8 | topk)")
    leaves = iter(range(len(pt.tree_leaves(adapters))))

    def enc(x):
        return _sr_int8_roundtrip(x, _q8_generator(x.device, seed, step,
                                                   client_idx, next(leaves)))
    return pt.tree_map(enc, adapters)


@dataclasses.dataclass(frozen=True)
class CompressedFedAvg:
    """Every client's adapters ride the compressed uplink
    (``compress_update``) before the weighted mean.  ``needs_step`` (a
    class attribute) tells ``FedSim.aggregate`` to pass its round
    counter, which keys the q8 streams."""
    mode: str                     # "q8" | "topk"
    topk_ratio: float = 0.01
    seed: int = 0

    needs_step = True             # no annotation: a class attribute

    def __call__(self, client_adapters: Params, weights=None, *,
                 step=0) -> Params:
        C = pt.tree_leaves(client_adapters)[0].shape[0]
        enc = [compress_update(pt.tree_map(lambda x: x[c], client_adapters),
                               mode=self.mode, step=step, client_idx=c,
                               topk_ratio=self.topk_ratio, seed=self.seed)
               for c in range(C)]
        return fedavg(pt.tree_map_with_path(
            lambda p, _: torch.stack([pt.tree_get(e, p) for e in enc]),
            enc[0]), weights)


def broadcast_to_clients(agg: Params, n_clients: int) -> Params:
    """(C, ...) copies of every leaf (copies, not expanded views, so a
    client's leaf can be replaced without touching another's)."""
    return pt.tree_map(
        lambda x: x[None].expand(n_clients, *x.shape).clone(), agg)


def client_rebroadcast(aggregated: Params, own_adapters: Params,
                       keep_rx=None, cover: Params | None = None) -> Params:
    """One client's view of the rebroadcast aggregate: leaves matching the
    keep-local regex keep the client's ``own_adapters`` values (personal
    state never leaves the client), and on a mixed-rank fleet the result
    is re-masked by the client's rank ``cover``: a rank-r client
    receives the first r rank rows of the server model.  ``keep_rx``:
    compiled pattern, regex string or None."""
    out = aggregated
    if keep_rx is not None:
        rx = re.compile(keep_rx) if isinstance(keep_rx, str) else keep_rx
        out = pt.tree_map_with_path(
            lambda p, leaf: pt.tree_get(own_adapters, p)
            if rx.search(p) else leaf, out)
    if cover is not None:
        out = peft.apply_rank_masks(out, cover)
    return out


def aggregate_with_personal_exclusion(client_adapters: Params,
                                      exclude_rx: str = r"dB_mag$"
                                      ) -> Params:
    """Paper pipeline: the mean over clients of every leaf, broadcast back
    to each client, except the personalized magnitude deltas, which stay
    client-local (the client-stacked leaves themselves)."""
    rx = re.compile(exclude_rx)
    agg = pt.tree_map(lambda x: torch.mean(x, dim=0), client_adapters)
    n = pt.tree_leaves(client_adapters)[0].shape[0]
    return pt.tree_map_with_path(
        lambda p, new_leaf: client_adapters_leaf(p, new_leaf,
                                                 client_adapters, rx),
        broadcast_to_clients(agg, n))


def client_adapters_leaf(path: str, new_leaf, client_adapters: Params, rx):
    """``client_adapters``' leaf at ``path`` where ``rx`` matches it, else
    ``new_leaf``."""
    if rx.search(path):
        return pt.tree_get(client_adapters, path)
    return new_leaf


def rebroadcast_keep_personal(aggregated: Params, client_adapters: Params,
                              keep_rx=None,
                              rank_masks: Params | None = None) -> Params:
    """Broadcast the aggregate to every client of a client-stacked tree;
    leaves matching ``keep_rx`` keep each client's own value, and with
    ``rank_masks`` (``peft.client_rank_masks``) each client is re-masked
    to its own rank."""
    C = pt.tree_leaves(client_adapters)[0].shape[0]
    return client_rebroadcast(broadcast_to_clients(aggregated, C),
                              client_adapters, keep_rx, rank_masks)


def comm_bytes_per_round(adapters_one_client: Params,
                         exclude_rx: str | None = None,
                         rank: int | None = None,
                         comm: str = "psum",
                         n_clients: int | None = None,
                         topk_ratio: float = 0.01) -> int:
    """Per-client bytes for one round's aggregation: adapter leaves only
    (the frozen backbone never moves).  Leaves matching ``exclude_rx``
    stay client-local and are not billed.  ``rank``: the client's own
    rank in a mixed-rank fleet; a rank-axis leaf is billed at
    min(rank, allocated rank), since the padding rows are zero and never
    leave the client.  Per transmitted leaf of n elements of
    ``itemsize`` bytes, by comm class:

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
    for path, leaf in pt.tree_leaves_with_path(tree):
        shape = list(leaf.shape)
        ax = peft.rank_axis(path) if rank is not None else None
        if ax is not None:
            shape[ax] = min(rank, shape[ax])
        n, sz = math.prod(shape), leaf.element_size()
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


# ---------------------------------------------------------------------------
# collective forms (the production round engine, launch/train.py)
# ---------------------------------------------------------------------------
#
# Every aggregator above takes the client-stacked tree ``FedSim`` holds.
# The production engine never holds that stack: each client is one rank
# of a ``torch.distributed`` group with its own adapters, and aggregation
# is a collective over the group.  ``group`` is a ``launch.mesh
# .ClientGroup``: ``rank``, ``size``, and ``all_reduce`` / ``all_gather``
# over a list of tensors (sum; stacked in rank order).  Comm classes:
#
#   psum        Σ wᵢxᵢ / Σ wᵢ by two all-reduces: the mean family (fedavg,
#               decomposed, zero-pad, excluding) and, with per-row
#               coverage masks, replication_fedavg.
#   all_gather  every rank stacks all clients' trees and runs the host
#               aggregator ``FedSim`` uses (exact_fedavg's QR and SVD,
#               trimmed_fedavg's order statistics).
#   q8 / topk   the rank encodes its update (compress_update, keyed by
#               its rank as FedSim keys by the client index) before the
#               weighted sum of the decoded values.
#
# The gather class gives the host aggregate of the same bits; the psum
# class agrees with it up to rounding (FedSim's mean normalises w first).


def client_index(group) -> int:
    """This rank's client index: its rank in the client group, the order
    ``all_gather`` stacks in and ``FedSim`` stacks its clients."""
    return group.rank


@dataclasses.dataclass(frozen=True)
class CollectiveAgg:
    """A method's aggregation as a collective over the client group.

    Called on every rank with the rank's adapter tree (no client axis),
    the group, the client's scalar weight and its per-leaf rank-coverage
    masks (only the "coverage" kind reads them); returns the aggregate,
    the same on every rank."""
    kind: str            # "wmean" | "coverage" | "staleness" |
                         # "gather_exact" | "gather_trimmed" | "q8" | "topk"
    comm: str            # comm class (COMM_CLASSES), for the billing
    trim_ratio: float = 0.0
    topk_ratio: float = 0.01
    seed: int = 0
    alpha: float = 0.5   # staleness discount exponent ("staleness" kind)

    def __call__(self, adapters: Params, *, group, weight, cover=None,
                 step=0, staleness=0.0):
        paths = pt.tree_paths(adapters)
        xs = pt.tree_leaves(adapters)
        w = torch.as_tensor(weight, dtype=torch.float32,
                            device=xs[0].device)

        def rebuild(leaves):
            out: dict = {}
            for p, x in zip(paths, leaves):
                pt.set_leaf(out, p, x)
            return out

        if self.kind in ("q8", "topk"):
            # the rank's uplink, encoded before it reaches the wire; the
            # weighted sum of decoded trees is then WMEAN's algebra
            xs = pt.tree_leaves(compress_update(
                adapters, mode=self.kind, step=step,
                client_idx=client_index(group), topk_ratio=self.topk_ratio,
                seed=self.seed))
        if self.kind == "staleness":
            w = w * staleness_scale(staleness, self.alpha).to(w.device)
        if self.kind in ("wmean", "staleness", "q8", "topk"):
            den, *num = group.all_reduce([w] + [x * w for x in xs])
            return rebuild([n / den for n in num])
        if self.kind == "coverage":
            cs = [pt.tree_get(cover, p) for p in paths]
            sums = group.all_reduce([x * c * w for x, c in zip(xs, cs)]
                                    + [c * w for c in cs])
            num, den = sums[:len(xs)], sums[len(xs):]
            return rebuild([
                torch.where(d > 0, n / torch.clamp(d, min=1e-12),
                            torch.zeros((), dtype=n.dtype, device=n.device))
                for n, d in zip(num, den)])
        gathered = rebuild(group.all_gather(xs))
        if self.kind == "gather_trimmed":
            return trimmed_fedavg(gathered, trim_ratio=self.trim_ratio)
        if self.kind == "gather_exact":
            (w_all,) = group.all_gather([w])
            return exact_fedavg(gathered, w_all)
        raise ValueError(f"unknown collective kind {self.kind!r}")


WMEAN = CollectiveAgg(kind="wmean", comm="psum")
COVERAGE = CollectiveAgg(kind="coverage", comm="psum")
GATHER_EXACT = CollectiveAgg(kind="gather_exact", comm="all_gather")
COMPRESSED_Q8 = CollectiveAgg(kind="q8", comm="q8")
STALENESS = CollectiveAgg(kind="staleness", comm="psum")


def gather_trimmed(trim_ratio: float) -> CollectiveAgg:
    return CollectiveAgg(kind="gather_trimmed", comm="all_gather",
                         trim_ratio=trim_ratio)


def compressed_topk(topk_ratio: float) -> CollectiveAgg:
    return CollectiveAgg(kind="topk", comm="topk", topk_ratio=topk_ratio)


def collective_form(method) -> CollectiveAgg:
    """A method's collective form: its ``collective`` when set, else the
    one its host aggregate maps to.  Raises for an aggregate with no
    collective form, so the production engine never trains with other
    math than ``FedSim``."""
    if getattr(method, "collective", None) is not None:
        return method.collective
    a = method.aggregate
    if isinstance(a, CompressedFedAvg):
        # the codec's parameters carry over, so the engines cannot
        # disagree on mode, ratio or seed
        return CollectiveAgg(kind=a.mode, comm=a.mode,
                             topk_ratio=a.topk_ratio, seed=a.seed)
    if isinstance(a, StalenessFedAvg):
        return CollectiveAgg(kind="staleness", comm="psum", alpha=a.alpha)
    if a in (fedavg, decomposed_fedavg, zeropad_fedavg):
        return WMEAN
    if a is replication_fedavg:
        return COVERAGE
    if a is exact_fedavg:
        return GATHER_EXACT
    if isinstance(a, functools.partial) and not a.args:
        # a partial maps to a collective only when the collective honours
        # every keyword baked into it
        kw = set(a.keywords)
        if a.func is fedavg_excluding and kw == {"exclude_rx"}:
            # sound only when the excluded leaves are the keep-local set:
            # the engine's keep-local restore then overwrites the WMEAN
            # of those leaves with each client's own values
            if a.keywords["exclude_rx"] == method.keep_local:
                return WMEAN
        if a.func is trimmed_fedavg and kw <= {"trim_ratio"}:
            return gather_trimmed(a.keywords.get("trim_ratio", 0.25))
        if not kw:
            if a.func in (fedavg, decomposed_fedavg, zeropad_fedavg):
                return WMEAN
            if a.func is replication_fedavg:
                return COVERAGE
            if a.func is exact_fedavg:
                return GATHER_EXACT
    raise ValueError(
        f"method {method.name!r} has no shard_map collective form; set "
        "FedMethod.collective (a core.aggregation.CollectiveAgg) to run "
        "it on the production train step")


def comm_class(method) -> str:
    """The comm class a method's aggregation moves on the wire, for the
    billing: its collective form's ``comm``; "psum" for an aggregate
    with no collective form."""
    try:
        return collective_form(method).comm
    except ValueError:
        return "psum"


def topk_ratio(method) -> float:
    """The top-k density a method bills its uplink at (0.01, the
    accounting's default, when it has no top-k collective)."""
    try:
        return collective_form(method).topk_ratio
    except ValueError:
        return 0.01
