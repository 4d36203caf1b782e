"""Federated PEFT engine (port of ``repro/fed/simulate.py``).

Clients are a leading axis C on every leaf of the adapter overlay; the
frozen backbone is shared.  The engine is method-agnostic: every method
is a ``FedMethod`` strategy from ``core/methods.py`` (adapter factory,
stage masks, aggregate function, loss extras, keep-local regex), and this
module holds no per-method branch.

A training step runs the clients one after another: each gets its own
value-and-grad through torch autograd (``stage_loss`` and
``value_and_grad``, which the production engine, ``launch/train.py``,
shares), then the clip and the masked AdamW update.
That is what the reference's ``vmap`` computes client by client; the
client state (adapters and optimizer moments) stays stacked as (C, ...)
leaves.  Rounds loop over their steps in Python (the reference's
``lax.scan``), so there is no separate per-step reference loop.

Randomness: adapter dropout draws from the ``torch.Generator`` a stage
is given (on the engine's device), in order: client by client, layer by
layer, q then k then v.  The JAX key chain cannot be reproduced, so
parity with the reference holds at ``lora_dropout = 0``.

FedProx: a ``prox`` method's stage-1 loss adds ½µ‖θ − θ_ref‖² over every
adapter leaf, θ_ref the round reference: the client adapters as the
first round found them, then the rebroadcast after each ``aggregate``.
Stages 2 and 3 have no prox term.

Mixed-rank fleets (``FedHyper.client_ranks``): adapters are allocated
at ``server_rank`` or the fleet's largest rank, the client stack is
masked to each client's rank, and each stage-1 / stage-3 update is
masked after the clip and the masked AdamW, before it is applied.  The
stage-2 server model trains at the full allocated rank, unmasked; each
rebroadcast re-masks it to every client's rank.  Rank-aware aggregators
get the fleet's ranks, and each client is billed at its own rank.

``save`` / ``load`` write and read the reference's checkpoint files
(``checkpoint/ckpt.py``): the port resumes a reference run and the
reference a port run.

Cohort rounds: ``aggregate`` takes per-round ``weights``,
``participation`` and ``staleness``, and ``run_cohort_round`` applies a
round's faults (dropouts, corrupted updates), the layer under
``fed/cohort.py``.

Telemetry (``repro_torch.obs``), as the reference's: the spans
``fed/round_scan``, ``fed/aggregate``, ``fed/rebroadcast``,
``fed/round``, ``fed/stage2_global`` and ``fed/stage3_personalize``
(each waits for the card first, only while telemetry is enabled),
``fed/rounds``, ``fed/comm_bytes`` (by method and comm class),
``fed/loss_spread``, ``fed/client_ce``, each client's drift from the
aggregate, and the ``fed_round`` and ``fed_stage`` events.
"""
from __future__ import annotations

import contextlib
import dataclasses
import re
import time
from typing import Any

import numpy as np
import torch

from repro_torch import obs, optim
from repro_torch.checkpoint.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.core import aggregation as agg
from repro_torch.core import peft
from repro_torch.core.methods import get_method
from repro_torch.device import check_on, resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.utils import pytree as pt
from repro_torch.utils.collectives import model_group, scale_grad

Params = Any


@dataclasses.dataclass(frozen=True)
class FedHyper:
    method: str = "fedlora_opt"   # any name in core.methods.available_methods()
    n_clients: int = 4
    rounds: int = 10
    local_steps: int = 5
    batch: int = 8
    seq_len: int = 64
    lr: float = 1e-3
    server_lr: float = 5e-4
    global_steps: int = 5          # stage-2 ΔA_D steps per round (pipeline)
    personal_steps: int = 20       # stage-3 ΔB_M steps
    lam: float = 1e-3              # Eq. 11 Frobenius regularizer
    prox_mu: float = 0.0           # FedProx proximal coefficient
    pipeline: bool = True          # global→local staging (Fig. 3 ablation)
    clip: float = 1.0
    seed: int = 0
    # mixed-rank fleet: one LoRA rank per client (len == n_clients);
    # None → every client at cfg.lora_rank
    client_ranks: tuple = None
    # a mixed-rank fleet's allocated rank (0 → the fleet's max); at
    # r_server ≥ Σ rᵢ exact_fedavg keeps Σ wᵢ·AᵢBᵢ exactly.  Ignored on
    # uniform fleets
    server_rank: int = 0
    # per-client aggregation weights (len == n_clients); None → uniform
    client_weights: tuple = None

    def __post_init__(self):
        if self.client_ranks is not None:
            ranks = tuple(int(r) for r in self.client_ranks)
            object.__setattr__(self, "client_ranks", ranks)
            peft.fleet_alloc_rank(ranks, self.n_clients, self.server_rank)
        if self.client_weights is not None:
            weights = tuple(float(w) for w in self.client_weights)
            object.__setattr__(self, "client_weights", weights)
            peft.validate_client_weights(weights, self.n_clients)


def prox_term(adapters: Params, ref: Params):
    """‖θ − θ_ref‖² over every adapter leaf, summed in f32."""
    return sum(torch.sum(torch.square(x.float() - pt.tree_get(ref, p).float()))
               for p, x in pt.tree_leaves_with_path(adapters))


def stage_loss(base, adapters, batch, cfg, *, gen=None, lam=0.0,
               reg_mask=None, prox_mu=0.0, prox_ref=None, remat=False,
               mesh=None):
    """The training loss of one adapter tree on one (B, S) batch: masked
    CE, plus the Eq. 11 ½λ‖·‖²_F over ``reg_mask``'s leaves when ``lam``,
    plus FedProx's ½µ‖θ − θ_ref‖² when ``prox_ref`` is given.  ``gen``:
    the adapter-dropout generator; ``remat``: as ``model.forward``'s;
    ``mesh``: the production engine's grid, on which every rank of a
    model row adds the two terms whole and takes their gradient at
    1/n_model, a partial sum like the layers'.  Returns (loss,
    metrics)."""
    loss, met = M.loss_and_metrics(pt.merge_trees(base, adapters), batch,
                                   cfg, rng=gen, remat=remat, mesh=mesh)
    tp = model_group(mesh)
    own = adapters if tp is None else pt.tree_map(
        lambda x: scale_grad(x, 1.0 / tp.size), adapters)
    if lam:
        reg = sum(torch.sum(torch.square(x))
                  for p, x in pt.tree_leaves_with_path(own)
                  if pt.tree_get(reg_mask, p))
        loss = loss + 0.5 * lam * reg
    if prox_ref is not None:
        loss = loss + 0.5 * prox_mu * prox_term(own, prox_ref)
    return loss, met


def value_and_grad(loss_fn, adapters):
    """(loss, metrics, grads) of ``loss_fn(adapters) → (loss, metrics)``
    through autograd: a gradient for every adapter leaf, trainable or
    not (zeros where the loss does not reach it), so the clip norm and
    ``grad_norm`` count the frozen ones as the reference's do."""
    leaves = pt.tree_map(lambda x: x.detach().requires_grad_(True),
                         adapters)
    with torch.enable_grad():
        loss, met = loss_fn(leaves)
        grads = iter(torch.autograd.grad(loss, pt.tree_leaves(leaves),
                                         allow_unused=True))

    def take(x):                    # same leaf order as tree_leaves
        gi = next(grads)
        return torch.zeros_like(x) if gi is None else gi
    g = pt.tree_map(take, leaves)
    return loss.detach(), {k: v.detach() for k, v in met.items()}, g


def _host(v) -> np.ndarray:
    """A (C,) fault vector (numpy, list or tensor) as a host array."""
    return (v.detach().cpu().numpy() if torch.is_tensor(v)
            else np.asarray(v))


def client(tree: Params, c: int) -> Params:
    """Client ``c``'s slice (views) of a client-stacked tree."""
    return pt.tree_map(lambda x: x[c], tree)


def stack_clients(trees: list) -> Params:
    """(C, ...) leaves from C trees of one structure."""
    return pt.tree_map_with_path(
        lambda p, _: torch.stack([pt.tree_get(t, p) for t in trees]),
        trees[0])


class FedSim:
    """Federated simulation over one ArchConfig + per-client datasets."""

    def __init__(self, cfg: ArchConfig, hp: FedHyper, base=None, *,
                 device="cuda"):
        if cfg.use_fused_dora:
            raise ValueError(
                "use_fused_dora is forward/serving-only (the kernel defines "
                "no backward); training through FedSim requires the plain "
                "adapter path: construct with use_fused_dora=False")
        self.cfg, self.hp = cfg, hp
        self.device = resolve_device(device)
        self.method = get_method(hp.method)

        def generator(seed):
            return torch.Generator(device=self.device).manual_seed(seed)
        if base is None:
            base = M.init_params(generator(hp.seed), cfg, device=self.device)
        check_on(pt.tree_leaves(base)[0], self.device, "base")
        self.base = base
        gen_ad = generator(hp.seed + 1)
        if hp.client_ranks is not None:
            if not self.method.het_ranks:
                raise ValueError(
                    f"method {self.method.name!r} has no rank dimension "
                    "(het_ranks=False); client_ranks requires a "
                    "LoRA-family method")
            self.alloc_rank = peft.fleet_alloc_rank(
                hp.client_ranks, hp.n_clients, hp.server_rank)
            ad = self.method.make_adapter(base, cfg, gen_ad,
                                          rank=self.alloc_rank)
        else:
            self.alloc_rank = cfg.lora_rank
            ad = self.method.make_adapter(base, cfg, gen_ad)
        # the template stays unmasked; the client stack is masked
        self.adapter_template = ad
        self.rank_mask = (peft.client_rank_masks(ad, hp.client_ranks)
                          if hp.client_ranks is not None else None)
        self.train_mask = self.method.train_mask(ad)
        self.global_mask = self.method.stage_global_mask(ad)
        self.local_mask = self.method.stage_local_mask(ad)
        self.reg_mask = (self.method.personal_reg(ad)
                         if self.method.personal_reg else None)
        self._keep_rx = (re.compile(self.method.keep_local)
                         if self.method.keep_local else None)
        self._comm_class = agg.comm_class(self.method)
        self._topk_ratio = agg.topk_ratio(self.method)
        self._prox_mu = hp.prox_mu if self.method.prox else 0.0
        self._base_weights = (torch.tensor(hp.client_weights)
                              if hp.client_weights is not None else None)

        self.opt = optim.chain_clip(
            optim.masked(optim.adamw(hp.lr), self.train_mask), hp.clip)
        self.opt_global = optim.chain_clip(
            optim.masked(optim.adamw(hp.server_lr), self.global_mask),
            hp.clip)
        self.opt_local = optim.chain_clip(
            optim.masked(optim.adamw(hp.lr), self.local_mask), hp.clip)
        self.client_adapters = agg.broadcast_to_clients(ad, hp.n_clients)
        if self.rank_mask is not None:
            self.client_adapters = peft.apply_rank_masks(
                self.client_adapters, self.rank_mask)
        # stage 1's optimizer state and step counter carry across rounds
        self.opt_state = self._init_clients(self.opt)
        self._step = 0
        self.comm_bytes = 0
        # FedProx round reference; None until the first round starts
        self._round_ref = None
        # the scaled, not yet reverted client state of the last faulted
        # round (what a straggler computed): see run_cohort_round
        self.last_trained: dict | None = None
        self._obs_wall: dict = {}       # the last round's telemetry split

    # ------------------------------------------------------------------
    def _init_clients(self, opt) -> Params:
        return stack_clients([opt.init(client(self.client_adapters, c))
                              for c in range(self.hp.n_clients)])

    def loss_and_grad(self, adapters: Params, batch: dict, gen=None,
                      lam: float = 0.0, prox_ref=None):
        """(loss, metrics, grads) of one adapter tree (no client axis) on
        one (B, S) batch; ``grads`` has a leaf for every adapter leaf.
        ``prox_ref``: the FedProx reference of this client (a prox
        method's stage 1), held constant."""
        if prox_ref is not None:
            prox_ref = pt.tree_map(torch.Tensor.detach, prox_ref)
        return value_and_grad(lambda ad: stage_loss(
            self.base, ad, batch, self.cfg, gen=gen, lam=lam,
            reg_mask=self.reg_mask, prox_mu=self._prox_mu,
            prox_ref=prox_ref), adapters)

    def _step_one(self, adapters, opt_state, batch, gen, step, opt, lam,
                  prox_ref=None, rmask=None):
        """One step of one client; ``rmask``: its rank mask, applied to
        the update (after the clip and AdamW, before it is applied)."""
        _, met, g = self.loss_and_grad(adapters, batch, gen, lam, prox_ref)
        upd, opt_state = opt.update(g, opt_state, adapters, step)
        if rmask is not None:
            upd = peft.apply_rank_masks(upd, rmask)
        met["grad_norm"] = pt.global_norm(g)
        return optim.apply_updates(adapters, upd), opt_state, met

    def _clients_step(self, adapters, opt_state, batch, gen, step, opt, lam,
                      prox_ref=None):
        """One step of every client, one after another, on a stacked
        (C, B, S) batch → stacked adapters, state and (C,) metrics;
        ``prox_ref``: the stacked FedProx reference, or None.  A
        mixed-rank fleet masks each client's update to its rank."""
        rm = self.rank_mask
        outs = [self._step_one(client(adapters, c), client(opt_state, c),
                               client(batch, c), gen, step, opt, lam,
                               None if prox_ref is None
                               else client(prox_ref, c),
                               None if rm is None else client(rm, c))
                for c in range(self.hp.n_clients)]
        return tuple(stack_clients([o[i] for o in outs]) for i in range(3))

    # ------------------------------------------------------------------
    @contextlib.contextmanager
    def _timed(self, span: str, wall_key: str):
        """While telemetry is enabled, time the region into
        ``span_seconds`` and the round's wall split, waiting for the card
        first so that the span covers its work; bare otherwise (no clock
        read, no sync)."""
        if not obs.enabled():
            yield
            return
        t0 = time.perf_counter()
        yield
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        obs.observe("span_seconds", dt, span=span, method=self.hp.method)
        self._obs_wall[wall_key] = dt

    def local_round(self, batches: list[dict], rng=None) -> dict:
        """One round of stage-1 local training.  batches: one stacked
        (C, B, S) dict per local step; rng: the round's torch.Generator
        (adapter dropout).  Returns the last step's (C,) metrics."""
        if self.method.prox and self._round_ref is None:
            self._round_ref = self.client_adapters
        ref = self._round_ref if self._prox_mu else None
        mets = {}
        with self._timed("fed/round_scan", "scan"), \
                obs.named_scope("fed/round_scan"):
            for b in batches:
                self.client_adapters, self.opt_state, mets = \
                    self._clients_step(self.client_adapters, self.opt_state,
                                       b, rng, self._step, self.opt, 0.0,
                                       ref)
                self._step += 1
        return {k: v.cpu().numpy() for k, v in mets.items()}

    def _client_drift(self, clients, aggregated) -> np.ndarray:
        """Per-client drift ‖clientᵢ − aggregate‖ over the shared leaves
        (keep-local leaves are personal and skipped; a mixed-rank fleet
        masks each difference to the client's rank rows), summed in f32;
        (C,) float64 on the host.  Telemetry only."""
        rm = self.rank_mask
        tot = torch.zeros((self.hp.n_clients,), device=self.device)
        for p, x in pt.tree_leaves_with_path(clients):
            if self._keep_rx is not None and self._keep_rx.search(p):
                continue
            d = x.float() - pt.tree_get(aggregated, p).float()[None]
            if rm is not None:
                d = d * pt.tree_get(rm, p)
            tot = tot + torch.sum(torch.square(d),
                                  dim=tuple(range(1, x.dim())))
        return torch.sqrt(tot).cpu().numpy().astype(np.float64)

    def aggregate(self, *, weights=None, staleness=None,
                  participation=None) -> Params:
        """Method aggregation (Eqs. 5-8 for ours, the baselines' own
        otherwise) and comm accounting; broadcasts the aggregate back with
        the keep-local leaves (dB_mag, FedALT's pair) kept per client.
        Returns the aggregate (no client axis).  A ``needs_step``
        aggregate gets the round counter.

        Cohort and fault arguments, all optional (None: the synchronous
        full-participation round):

          weights        a per-call (C,) override of ``hp.client_weights``
          staleness      (C,) rounds since each client's last sync, for
                         ``needs_staleness`` aggregates (FedBuff); zeros
                         when None
          participation  (C,) 0/1 flags: a non-participant gets weight 0
                         and is not billed (it uploads nothing)
        """
        C = self.hp.n_clients
        w = weights if weights is not None else self._base_weights
        if participation is not None:
            base_w = (torch.as_tensor(w, dtype=torch.float32)
                      if w is not None else torch.ones((C,)))
            w = base_w * torch.as_tensor(participation, dtype=torch.float32)
        kwargs = {}
        if w is not None:
            kwargs["weights"] = torch.as_tensor(w, dtype=torch.float32)
        if getattr(self.method.aggregate, "needs_step", False):
            kwargs["step"] = self._step
        if getattr(self.method.aggregate, "needs_staleness", False):
            kwargs["staleness"] = (
                torch.zeros((C,), dtype=torch.float32) if staleness is None
                else torch.as_tensor(staleness, dtype=torch.float32))
        if self.method.rank_aware:
            # a uniform fleet is the all-alloc_rank case
            kwargs["ranks"] = self.hp.client_ranks or (self.alloc_rank,) * C
        with self._timed("fed/aggregate", "aggregate"):
            aggregated = self.method.aggregate(self.client_adapters,
                                               **kwargs)
        # a dropped or straggling client uploads nothing this round
        # (a straggler is billed when its update arrives: fed/cohort.py),
        # and each live client moves only its own rank rows
        live = (_host(participation) > 0 if participation is not None
                else np.ones((C,), bool))
        billed = sum(self.client_comm_bytes(c) for c in range(C) if live[c])
        self.comm_bytes += billed
        if obs.enabled():
            obs.inc("fed/comm_bytes", billed, method=self.hp.method,
                    comm=self._comm_class)
            self._obs_wall["comm_bytes"] = billed
            # measured before the rebroadcast: the client models as they
            # finished the round, against the server aggregate
            self._obs_wall["drift"] = self._client_drift(self.client_adapters,
                                                         aggregated)
        with self._timed("fed/rebroadcast", "rebroadcast"):
            self.client_adapters = self._rebroadcast(aggregated)
        if self.method.prox:
            self._round_ref = self.client_adapters
        return aggregated

    def _rebroadcast(self, aggregated):
        """The aggregate to every client, keep-local leaves kept per
        client, each client re-masked to its rank on a mixed-rank fleet
        (a rank-r client receives the first r rank rows)."""
        return agg.rebroadcast_keep_personal(aggregated, self.client_adapters,
                                             self._keep_rx, self.rank_mask)

    def run_round(self, batches: list[dict], rng=None) -> dict:
        """Stage-1 local training, then the method's aggregation.  With
        telemetry enabled: the ``fed/round`` span, ``fed/rounds``,
        ``fed/loss_spread``, ``fed/client_ce`` and the ``fed_round``
        event."""
        if not obs.enabled():
            mets = self.local_round(batches, rng)
            self.aggregate()
            return mets
        self._obs_wall = {}
        t0 = time.perf_counter()
        mets = self.local_round(batches, rng)
        self.aggregate()
        total = time.perf_counter() - t0
        self._round_event(mets, total)
        return mets

    def _round_event(self, mets: dict, total: float) -> None:
        method = self.hp.method
        obs.observe("span_seconds", total, span="fed/round", method=method)
        obs.inc("fed/rounds", method=method)
        w = self._obs_wall
        ce = np.asarray(mets["ce"], np.float64).reshape(-1)
        gn = np.asarray(mets.get("grad_norm", np.zeros_like(ce)),
                        np.float64).reshape(-1)
        drift = np.asarray(w.get("drift", np.zeros_like(ce))).reshape(-1)
        spread = float(ce.max() - ce.min()) if ce.size else 0.0
        obs.set_gauge("fed/loss_spread", spread, method=method)
        for c in range(ce.size):
            obs.observe("fed/client_ce", float(ce[c]), method=method,
                        client=c)
        obs.event(
            "fed_round", method=method, step=int(self._step),
            clients=int(ce.size),
            ce=[round(float(v), 6) for v in ce],
            grad_norm=[round(float(v), 6) for v in gn],
            drift=[round(float(v), 6) for v in drift],
            loss_spread=round(spread, 6),
            comm_bytes=int(w.get("comm_bytes", 0)),
            comm_class=self._comm_class,
            wall={"scan": round(w.get("scan", 0.0), 6),
                  "aggregate": round(w.get("aggregate", 0.0), 6),
                  "rebroadcast": round(w.get("rebroadcast", 0.0), 6),
                  "total": round(total, 6)})

    def client_comm_bytes(self, client: int | None = None) -> int:
        """One client's wire bytes for one round of this method's
        collective (the unit ``aggregate`` bills a live client), at the
        client's own rank on a mixed-rank fleet; cohort drivers bill a
        straggler's delivery with it."""
        rank = (int(self.hp.client_ranks[client])
                if self.hp.client_ranks is not None and client is not None
                else None)
        return agg.comm_bytes_per_round(
            self.adapter_template, exclude_rx=self.method.keep_local,
            rank=rank, comm=self._comm_class, n_clients=self.hp.n_clients,
            topk_ratio=self._topk_ratio)

    def run_cohort_round(self, batches: list[dict], rng=None, *,
                         participation=None, staleness=None,
                         update_scale=None, weights=None) -> dict:
        """One federated round under cohort faults.  Every fault input is
        a (C,) array:

          participation  0/1 flags; a 0-client's adapters AND optimizer
                         state revert to their round-start values (its
                         work is lost), it has weight 0 in the aggregate
                         and is not billed
          update_scale   multiplies each client's round update (a
                         corrupted client inflates its own); 1 is honest
          staleness      rounds since the last sync, for
                         ``needs_staleness`` aggregates (FedBuff)
          weights        a per-round override of ``hp.client_weights``

        The fault transforms, ``old + s·(new − old)`` then
        ``where(p > 0, new, old)``, apply to every client when either
        ``participation`` or ``update_scale`` is given, and not at all
        otherwise: with neither, the round is ``run_round`` bit for bit
        (``old + 1·(new − old)`` is not always ``new`` in floating
        point).  The round-start snapshot is a copy (``clone``), so a
        step that updated a leaf in place could not alter it.

        After a faulted round ``last_trained`` holds the scaled client
        state before the revert (what a straggler computed), for
        delayed delivery (``fed/cohort.CohortSim``).  When every client
        dropped, nothing aggregates and nothing is billed."""
        use_faults = participation is not None or update_scale is not None
        C = self.hp.n_clients
        # dropped before the round (the reference drops it after), so the
        # last round's copy is not held through this round's training
        self.last_trained = None
        if use_faults:
            snap_ad = pt.tree_map(torch.clone, self.client_adapters)
            snap_ost = pt.tree_map(torch.clone, self.opt_state)
        mets = self.local_round(batches, rng)
        if use_faults:
            s = (torch.ones((C,)) if update_scale is None
                 else torch.as_tensor(update_scale, dtype=torch.float32))
            p = (torch.ones((C,)) if participation is None
                 else torch.as_tensor(participation, dtype=torch.float32))
            s, p = s.to(self.device), p.to(self.device)

            def per_client(v, x):
                return v.reshape((C,) + (1,) * (x.dim() - 1))

            self.client_adapters = pt.tree_map2(
                lambda new, old: old + per_client(s, new) * (new - old),
                self.client_adapters, snap_ad)
            self.last_trained = {"adapters": self.client_adapters,
                                 "opt_state": self.opt_state}

            def revert(new, old):
                return torch.where(per_client(p, new) > 0, new, old)
            self.client_adapters = pt.tree_map2(revert, self.client_adapters,
                                                snap_ad)
            self.opt_state = pt.tree_map2(revert, self.opt_state, snap_ost)
        if participation is not None and not np.any(
                _host(participation) > 0):
            # every cohort client dropped: the round is a no-op (the
            # reverted adapters are the round-start anchor)
            if self.method.prox:
                self._round_ref = self.client_adapters
            return mets
        self.aggregate(weights=weights, staleness=staleness,
                       participation=participation)
        return mets

    def global_stage(self, aggregated: Params, server_batches: list[dict],
                     rng=None) -> Params:
        """Stage 2: train the global-stage leaves (ΔA_D for the paper,
        Eq. 9) on the server task mixture, from a fresh optimizer at step
        0, at the full allocated rank (no rank mask); rebroadcast the
        result (keep-local leaves stay, each client re-masked to its
        rank) and return it."""
        opt_state = self.opt_global.init(aggregated)
        with self._timed("fed/stage2_global", "global"), \
                obs.named_scope("fed/stage2_global"):
            for step, b in enumerate(server_batches):
                aggregated, opt_state, _ = self._step_one(
                    aggregated, opt_state, b, rng, step, self.opt_global, 0.0)
            self.client_adapters = self._rebroadcast(aggregated)
        self._stage_event("global", len(server_batches))
        return aggregated

    def personalize(self, batches: list[dict], rng=None) -> None:
        """Stage 3: per-client fine-tune of the local-stage leaves (ΔB_M
        with the Eq. 11 regularizer for the paper), from a fresh
        optimizer at step 0."""
        lam = self.hp.lam if self.method.personal_reg is not None else 0.0
        ad, opt_state = self.client_adapters, self._init_clients(
            self.opt_local)
        with self._timed("fed/stage3_personalize", "personalize"), \
                obs.named_scope("fed/stage3_personalize"):
            for step, b in enumerate(batches):
                ad, opt_state, _ = self._clients_step(
                    ad, opt_state, b, rng, step, self.opt_local, lam)
        self.client_adapters = ad
        self._stage_event("personalize", len(batches))

    def _stage_event(self, stage: str, steps: int) -> None:
        if obs.enabled():
            obs.event("fed_stage", stage=stage, method=self.hp.method,
                      steps=steps, wall=round(self._obs_wall[stage], 6))

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def state_tree(self) -> dict:
        """Round-resumable state, leaf for leaf the reference's:
        ``client_adapters``, ``opt_state`` (masked AdamW's frozen leaves
        as (C, 0) placeholders), ``step`` (0-d int32), ``comm_bytes``
        (0-d int64), ``client_ranks`` ((C,) int32, recorded for uniform
        fleets too, so a checkpoint never loads into another fleet) and,
        for a prox method, ``round_ref``: mid-cycle (after a round,
        before its aggregate) the anchor is not the current adapters."""
        C = self.hp.n_clients
        tree = {"client_adapters": self.client_adapters,
                "opt_state": self.opt_state,
                "step": torch.tensor(self._step, dtype=torch.int32),
                "comm_bytes": np.asarray(self.comm_bytes, np.int64),
                "client_ranks": torch.tensor(
                    self.hp.client_ranks or (self.alloc_rank,) * C,
                    dtype=torch.int32)}
        if self.method.prox:
            # before the first round the anchor is the adapters as that
            # round will find them
            tree["round_ref"] = (self._round_ref if self._round_ref
                                 is not None else self.client_adapters)
        return tree

    def save(self, path: str, round_idx: int = 0) -> None:
        save_checkpoint(path, self.state_tree(), step=round_idx)

    def load(self, path: str) -> int:
        """Restore state saved by ``save`` (either package's) into this
        sim (same cfg and hp) on its device; returns the round index.
        Raises ValueError when the checkpoint's per-client ranks are not
        this fleet's: rank layout is state, not a detail."""
        like = self.state_tree()
        tree, round_idx = restore_checkpoint(path, like, device=self.device)
        want = like["client_ranks"].tolist()
        got = tree["client_ranks"].tolist()
        if want != got:
            raise ValueError(f"checkpoint fleet ranks {got} do not match "
                             f"this sim's {want}")
        self.client_adapters = tree["client_adapters"]
        self.opt_state = tree["opt_state"]
        self._step = int(tree["step"])
        self.comm_bytes = int(tree["comm_bytes"])
        if self.method.prox:
            self._round_ref = tree["round_ref"]
        return round_idx

    # ------------------------------------------------------------------
    def _metrics(self, adapters, batch) -> dict:
        with torch.no_grad():
            _, met = M.loss_and_metrics(pt.merge_trees(self.base, adapters),
                                        batch, self.cfg)
        return met

    def eval_global(self, aggregated: Params, batches: list[dict]) -> dict:
        mets = [self._metrics(aggregated, b) for b in batches]
        return {"acc": float(np.mean([float(m["acc"]) for m in mets])),
                "ce": float(np.mean([float(m["ce"]) for m in mets]))}

    def eval_personalized(self, batches_stacked: list[dict]) -> dict:
        """batches_stacked: list of (C, B, S) dicts, each client evaluated
        on its own task distribution."""
        accs = [np.stack([self._metrics(client(self.client_adapters, c),
                                        client(b, c))["acc"].cpu().numpy()
                          for c in range(self.hp.n_clients)])
                for b in batches_stacked]
        per_client = np.mean(np.stack(accs), axis=0)
        return {"acc": float(np.mean(per_client)),
                "per_client": per_client.tolist()}
