"""Production federated round engine and the paper's three-stage
pipeline (port of ``repro/launch/train.py``).

The reference maps one client to one data shard inside a ``shard_map``
that is manual over the data axes.  Here one client is one rank of a
``torch.distributed`` client group (``launch/mesh.py``); every rank runs
the same program on its own client's trees:

  * local SGD: the rank's own gradient and update steps, through
    autograd as ``FedSim``'s (the reference trains through no Pallas
    kernel);
  * aggregation: the method's collective form
    (``core.aggregation.CollectiveAgg``) over the group: a weighted
    all-reduce for the mean family, a coverage all-reduce for
    replication averaging, an all-gather and the host aggregator for
    exact and trimmed aggregation, an encoded uplink for q8 and top-k.
    It is the only traffic between clients, adapter-sized;
  * per-client state (the paper's ΔB_M, FedALT's individual pair) never
    leaves its rank: keep-local leaves are restored from the rank's own
    values after the collective (``aggregation.client_rebroadcast``);
  * mixed-rank fleets: each rank's rank-coverage mask zeroes the update
    rows above its client's rank and re-masks the rebroadcast;
  * FedProx's anchor is the rank's round-start adapters.

``make_fed_train_step`` returns one federated round (stage 1 and the
collective); ``make_fed_pipeline_step`` the paper's pipeline as three
stage programs (``FedPipeline``):

  stage 1  the round; also returns the aggregate (no client axis, the
           same on every rank);
  stage 2  the global optimizer: the ``stage_global_mask`` leaves (ΔA_D,
           Eq. 9) of the aggregate train on the server batch from a
           fresh optimizer.  When the server batch divides over the
           ranks (and no dropout seed is given) each rank takes its
           slice of every micro-batch and a token-weighted all-reduce
           recovers the full-batch gradient; otherwise every rank runs
           the same replicated math.  Rebroadcast as stage 1's;
  stage 3  personalization: the ``stage_local_mask`` leaves (ΔB_M, Eq.
           10) train on each rank with the Eq. 11 ½λ‖·‖²_F regularizer,
           no collective.

``FedPipeline.run_pipeline`` sequences the stages as ``FedSim.run_round
→ global_stage → personalize``.

State layout.  Each rank's adapters, optimizer state and batches carry
a leading client axis of length 1, its slice of ``FedSim``'s (C, ...)
stack, so the rank masks, ``client_rebroadcast`` and the optimizer are
reused as they are; ``rank_slice`` and ``stack_ranks`` move state
between the two layouts.  Fleet vectors (weights, participation,
staleness, update scales) are (C,) on every rank, which reads its own
entry.

Gradient accumulation: each local step's rows split into
``micro_batches`` micro-batches whose gradients accumulate in f32 (f64
for f64 adapters).  ``remat`` checkpoints each superblock
(``models/model.py``).

Dropout: a seed (``rng``, an int) gives each local step a
``torch.Generator`` seeded from (seed, fold + step, rank): fold 0 in
stage 1 and 31 in stage 3; stage 2 draws from (seed, step) on every
rank, and a stage-2 seed forces its replicated path.  ``FedSim`` draws
its masks client after client from one generator, so the two engines
agree mask for mask only at ``lora_dropout = 0`` (ROADMAP C).

The grid.  ``mesh`` is a client group (``make_client_mesh``: one rank a
client, each with the whole backbone) or a ``Grid`` (``make_debug_mesh``
/ ``make_production_mesh``): the clients on its data axis, each client's
backbone split over its model axis.  On a grid ``base`` is this rank's
shard (``launch/specs.shard_tree(base, param_specs(cfg, grid, base),
grid)``), and the adapters, optimizer state and batches are the client's
whole trees on every rank of its model row:

  * the forward and backward pass run tensor-parallel over the model row
    (``models/layers.py``; the Mamba-2 mixer over the rank's heads,
    ``models/ssm.py``; an encoder-decoder's encoder too), with a
    vocab-parallel CE: every family;
  * after each step's backward every adapter gradient is all-reduced
    (summed) over the model row: each rank's is a partial sum, as the
    layers lay them out (those computed whole on every rank, the Houlsby
    adapter, the prompt, the Eq. 11 regularizer and FedProx's term, take
    their gradient at 1/n_model a rank: ``utils/collectives.scale_grad``).
    The clip and AdamW then run identically on every rank of the row;
  * the method's collective, the sharded stage 2 and the metrics' means
    run over the data column only;
  * dropout generators are seeded by the data rank, so that the model
    ranks of one client draw the same masks;
  * MoE runs ``layers.moe_ffn_manual``: the base's expert slots split
    over the data axis (``base_manual_specs``, part of ``param_specs``),
    tokens exchanged by all-to-all at the capacity of the rank's own
    micro-batch.

On a client group, MoE runs ``layers.moe_ffn_local`` on each rank's own
micro-batch (and its slice in the sharded stage 2), every slot resident
on every rank: what the reference's ``moe_ffn_manual`` computes with its
per-shard grouping and all-to-all.  There is no jit: ``round_step_raw``
is ``round_step``.
"""
from __future__ import annotations

import dataclasses
import re
import time
from functools import partial
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import aggregation as fedagg
from repro_torch.core import peft
from repro_torch.core.methods import get_method
from repro_torch.device import check_on, resolve_device
from repro_torch.fed.simulate import stage_loss, value_and_grad
from repro_torch.launch.mesh import Grid, data_axes, dp_size
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.optim import adamw, masked
from repro_torch.optim.optimizers import apply_updates, clip_by_global_norm
from repro_torch.utils import pytree as pt
from repro_torch.utils.collectives import model_group

Params = Any


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    lr: float = 1e-4
    micro_batches: int = 1
    clip: float = 1.0
    remat: object = True          # True (full) | "dots" | False
    # stage: which components train (paper pipeline stages)
    stage: str = "local_pretrain"   # | "global" | "local"
    # federated method (core.methods registry): the adapter factory, the
    # per-stage trainable masks, the keep-local leaves and the collective
    method: str = "fedlora_opt"
    # local optimizer steps per round (per train_step call); the batch
    # carries local_steps × per-step rows per client, step-major
    local_steps: int = 1
    # FedProx proximal coefficient (only read for prox methods)
    prox_mu: float = 0.0
    # mixed-rank fleet: one LoRA rank per client (len == dp_size(mesh));
    # None → uniform at cfg.lora_rank.  Mirrors FedHyper.client_ranks.
    client_ranks: Optional[tuple] = None
    # server-side allocation rank for a mixed-rank fleet (0 → fleet max)
    server_rank: int = 0
    # per-client aggregation weights (len == dp_size(mesh)); None →
    # uniform.  Mirrors FedHyper.client_weights.
    client_weights: Optional[tuple] = None
    # ---- pipeline stages 2/3 (mirror FedHyper) -----------------------
    server_lr: float = 5e-4       # stage-2 global-optimizer lr
    global_steps: int = 5         # stage-2 steps per global_step call
    personal_steps: int = 20      # stage-3 steps per personal_step call
    lam: float = 1e-3             # Eq. 11 Frobenius regularizer (stage 3)
    # telemetry: the round also all-gathers per-client {ce, grad_norm,
    # drift} into its metrics, and run_pipeline emits fed_round /
    # fed_stage events; False computes exactly what it computed without
    telemetry: bool = False

    def __post_init__(self):
        """Normalize the fleet vectors (lists, arrays → plain tuples;
        mirrors FedHyper).  Length checks need the group and stay in
        ``make_fed_pipeline_step``."""
        if self.client_ranks is not None:
            object.__setattr__(self, "client_ranks",
                               tuple(int(r) for r in self.client_ranks))
        if self.client_weights is not None:
            object.__setattr__(self, "client_weights",
                               tuple(float(w) for w in self.client_weights))


def pick_micro_batches(cfg: ArchConfig, per_client_batch: int,
                       seq_len: int, budget_bytes: float = 1.0e9) -> int:
    """Choose the accumulation depth so the superblock-boundary
    activations (n_superblocks × mb × S × D × 2 B) stay under budget."""
    n_sb, tail, pattern = cfg.blocks_layout()
    per_mb = (n_sb + 1) * seq_len * cfg.d_model * 2 * len(pattern)
    mb_max = max(1, int(budget_bytes // max(per_mb, 1)))
    micro = max(1, -(-per_client_batch // mb_max))
    while per_client_batch % micro:
        micro += 1
    return min(micro, per_client_batch)


def rank_slice(tree, rank: int):
    """Rank ``rank``'s slice of a client-stacked (C, ...) tree, with a
    client axis of length 1 (views)."""
    return pt.tree_map(lambda x: x[rank:rank + 1], tree)


def stack_ranks(trees: list):
    """The (C, ...) stack of the ranks' length-1 slices, in rank order."""
    return pt.tree_map_with_path(
        lambda p, _: torch.cat([pt.tree_get(t, p) for t in trees]), trees[0])


def _first(tree):
    return pt.tree_map(lambda x: x[0], tree)


def _step_generator(device, seed, fold: int, step: int, rank=None):
    """A step's dropout stream: seeded from (seed, fold + step[, rank])
    through numpy's SeedSequence."""
    key = [int(seed), fold + int(step)] + ([] if rank is None else [rank])
    s = np.random.SeedSequence(key).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(
        int(s) & ((1 << 63) - 1))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@dataclasses.dataclass(frozen=True)
class FedPipeline:
    """The three stage programs and the sequencing driver, per rank (C =
    dp_size(mesh); trees as in ``make_fed_train_step``):

      round_step(base, adapters, opt_state, step, batch, anchor=None,
                 rng=None, weights=None, participation=None,
                 staleness=None, update_scale=None)
          → (adapters, opt_state, aggregated, metrics)
      global_step(base, aggregated, adapters, server_batch, rng=None)
          → (aggregated, adapters, metrics)
      personal_step(base, adapters, batch, rng=None) → (adapters, metrics)
      local_step(base, adapters, opt_state, step, batch, anchor=None,
                 rng=None) → (adapters, opt_state, metrics)

    ``aggregated`` is the server model (no client axis), the tree
    ``FedSim.aggregate`` returns, the same on every rank.
    ``server_batch`` is a {tokens, loss_mask} dict of ``global_steps · B``
    rows, step-major, the same on every rank; ``batch`` trees carry the
    rank's client axis of 1.  ``anchor`` is the FedProx reference (the
    call's input adapters by default; the pipeline driver threads the
    post-round rebroadcast through, as ``FedSim._round_ref``).  ``rng``
    is a dropout seed (module docstring).  ``local_step`` is stage 1's
    local steps alone, before the collective and the fault layer.
    Metrics are means over the ranks (0-d tensors)."""
    round_step: Callable
    global_step: Callable
    personal_step: Callable
    opt_init: Callable
    method: Any
    # the round itself (the reference's unjitted body; no jit here)
    round_step_raw: Callable = None
    # telemetry (TrainSettings.telemetry): run_pipeline emits fed_round /
    # fed_stage events from the per-client metrics the round gathers;
    # comm_bytes_round is the analytic wire cost of one round's
    # collective (FedSim's billing)
    telemetry: bool = False
    comm_bytes_round: int = 0
    comm_class: str = "psum"
    local_step: Callable = None
    device: Any = None

    def run_pipeline(self, base, adapters, opt_state, step, batch,
                     server_batch, personal_batch, prox_anchor=None,
                     rng=None, global_rng=None, personal_rng=None):
        """One paper-pipeline iteration: stage-1 round → stage-2 global
        optimizer → stage-3 personalization, sequenced as ``FedSim
        .run_round`` → ``global_stage`` → ``personalize``.  Returns
        (adapters, opt_state, aggregated, prox_anchor, metrics); pass the
        returned ``prox_anchor`` (and ``step + local_steps``) to the next
        iteration.  A rank whose telemetry sink is enabled emits the
        events (enable it on one rank for one record a round)."""
        enabled = self.telemetry and obs.enabled()
        t0 = time.perf_counter() if enabled else 0.0
        adapters, opt_state, agg, met1 = self.round_step(
            base, adapters, opt_state, step, batch, prox_anchor, rng)
        if enabled:
            _sync(self.device)
            t1 = time.perf_counter()
        anchor = adapters if self.method.prox else None
        agg, adapters, met2 = self.global_step(base, agg, adapters,
                                               server_batch, global_rng)
        if enabled:
            _sync(self.device)
            t2 = time.perf_counter()
        adapters, met3 = self.personal_step(base, adapters, personal_batch,
                                            personal_rng)
        if enabled:
            _sync(self.device)
            t3 = time.perf_counter()
            self._emit_round_event(step, met1, met2, met3,
                                   (t1 - t0, t2 - t1, t3 - t2, t3 - t0))
        return adapters, opt_state, agg, anchor, {
            "round": met1, "global": met2, "personal": met3}

    def _emit_round_event(self, step, met1, met2, met3, wall):
        """Feed the round's gathered per-client metrics into the sink."""
        def host(v):
            return np.asarray(v.detach().cpu() if torch.is_tensor(v) else v,
                              np.float64).reshape(-1)
        name = self.method.name
        dt_round, dt_global, dt_personal, total = wall
        ce = host(met1.get("client_ce", []))
        gn = host(met1.get("client_grad_norm", []))
        drift = host(met1.get("client_drift", []))
        spread = float(ce.max() - ce.min()) if ce.size else 0.0
        obs.inc("fed/rounds", method=name, engine="pipeline")
        obs.inc("fed/comm_bytes", self.comm_bytes_round, method=name,
                comm=self.comm_class)
        obs.set_gauge("fed/loss_spread", spread, method=name)
        for span, dt in (("fed/round", dt_round),
                         ("fed/stage2_global", dt_global),
                         ("fed/stage3_personalize", dt_personal)):
            obs.observe("span_seconds", dt, span=span, method=name)
        for c in range(ce.size):
            obs.observe("fed/client_ce", float(ce[c]), method=name, client=c)
        obs.event(
            "fed_round", engine="pipeline", method=name, step=int(step),
            clients=int(ce.size),
            ce=[round(float(v), 6) for v in ce],
            grad_norm=[round(float(v), 6) for v in gn],
            drift=[round(float(v), 6) for v in drift],
            loss_spread=round(spread, 6),
            comm_bytes=int(self.comm_bytes_round),
            comm_class=self.comm_class,
            wall={"round": round(dt_round, 6),
                  "global": round(dt_global, 6),
                  "personal": round(dt_personal, 6),
                  "total": round(total, 6)})
        for stage, met, dt in (("global", met2, dt_global),
                               ("personal", met3, dt_personal)):
            obs.event("fed_stage", engine="pipeline", stage=stage,
                      method=name, ce=round(float(met["ce"]), 6),
                      wall=round(dt, 6))


def make_fed_pipeline_step(cfg: ArchConfig, mesh, settings: TrainSettings,
                           *, device="cuda") -> FedPipeline:
    """Build this rank's pipeline engine (see FedPipeline).

    base: the backbone on ``device``, the same on every rank (read only;
    on the card the ranks may map one copy by CUDA IPC).
    adapters: this rank's client, leading axis 1 (for a mixed-rank fleet
    allocated at the server rank and already rank-masked, as ``FedSim``
    lays them out).
    batch: {"tokens": (1, local_steps·B_c, S), ...}, step-major: local
    step t takes rows [t·B_c, (t+1)·B_c).
    step: the global local-step counter; a round advances it by
    ``settings.local_steps``, so the caller passes step + local_steps to
    the next round (AdamW's bias correction follows FedSim's counter;
    stages 2/3 restart at 0 with a fresh optimizer each call, as
    ``FedSim.global_stage`` / ``personalize``)."""
    if cfg.use_fused_dora:
        raise ValueError(
            "use_fused_dora is forward/serving-only (the Pallas kernel "
            "defines no VJP); the train step requires the jnp adapter path")
    dev = resolve_device(device)
    group = data_axes(mesh)
    dp = dp_size(mesh)
    rank = fedagg.client_index(group)
    grid = mesh if isinstance(mesh, Grid) else None
    tp = model_group(grid)
    manual = grid.replace(manual=True) if grid is not None else None
    micro = settings.micro_batches
    method = get_method(settings.method)
    keep_rx = re.compile(method.keep_local) if method.keep_local else None
    # resolved now, not at step time: an aggregate with no collective
    # form fails here instead of training with other math than FedSim's
    collective = fedagg.collective_form(method)
    # leaves the host aggregate zeroes in the server model (FedALT's
    # personal pair): the collective meaned them, the server must not
    zrx = fedagg.aggregate_zero_rx(method)
    zero_rx = re.compile(zrx) if zrx else None
    prox_mu = settings.prox_mu if method.prox else 0.0
    lam = settings.lam if method.personal_reg is not None else 0.0

    # ---- fleet layout: ranks, coverage masks, aggregation weights ------
    het = settings.client_ranks is not None
    if het:
        if not method.het_ranks:
            raise ValueError(
                f"method {method.name!r} has no rank dimension "
                "(het_ranks=False); client_ranks requires a LoRA-family "
                "method")
        alloc_rank = peft.fleet_alloc_rank(settings.client_ranks, dp,
                                           settings.server_rank)
        ranks = settings.client_ranks
    else:
        alloc_rank = cfg.lora_rank
        ranks = (alloc_rank,) * dp
    if settings.client_weights is not None:
        peft.validate_client_weights(settings.client_weights, dp)
        weight_c = torch.tensor(settings.client_weights, dtype=torch.float32,
                                device=dev)
    else:
        weight_c = torch.ones((dp,), dtype=torch.float32, device=dev)

    # the adapter template on "meta" (shapes and dtypes: the stage masks
    # and the billing), allocated at the server rank on a mixed fleet
    mk = (partial(method.make_adapter, rank=alloc_rank) if het
          else method.make_adapter)
    abs_ad = mk(abstract_base(cfg), cfg, torch.Generator())
    opt = masked(adamw(settings.lr), method.stage_mask(abs_ad, settings.stage))
    opt_g = masked(adamw(settings.server_lr), method.stage_global_mask(abs_ad))
    opt_l = masked(adamw(settings.lr), method.stage_local_mask(abs_ad))
    reg_mask = method.personal_reg(abs_ad) if method.personal_reg else None
    # this rank's coverage masks over the rank axis of every leaf
    # (all-ones on a uniform fleet, where only "coverage" reads them)
    shaped = pt.tree_map(
        lambda x: torch.empty(x.shape, dtype=x.dtype, device=dev), abs_ad)
    cover = _first(rank_slice(peft.client_rank_masks(shaped, ranks), rank))

    def loss_and_grad(base, ad, mb, gen, stage_lam, stage_prox, anchor):
        """FedSim.loss_and_grad, with remat: (metrics, grads)."""
        prox_ref = (pt.tree_map(torch.Tensor.detach, anchor) if stage_prox
                    else None)
        _, met, g = value_and_grad(lambda leaves: stage_loss(
            base, leaves, mb, cfg, gen=gen, lam=stage_lam, reg_mask=reg_mask,
            prox_mu=stage_prox, prox_ref=prox_ref, remat=settings.remat,
            mesh=manual), ad)
        return met, g

    def pmean(met):
        keys = sorted(met)
        vals = group.all_reduce([met[k] for k in keys])
        return {k: v / dp for k, v in zip(keys, vals)}

    # ---- the shared training loop --------------------------------------
    # T optimizer steps, each over ``micro`` micro-batches whose
    # gradients accumulate in f32, then the pre-clip grad_norm, the clip,
    # the masked AdamW and (mixed fleets) the rank-cover mask.
    def train_scan(base, ad, ost, step0, batch, *, T, stage_opt, cover,
                   stage_lam, stage_prox, anchor, stage, rng=None, fold=0,
                   split=True, sharded=False):
        B_c = batch["tokens"].shape[0]
        shards = dp if sharded else 1
        if B_c % (T * micro * shards):
            raise ValueError(
                f"{stage} batch of {B_c} rows is not divisible by steps "
                f"({T}) x micro_batches ({micro})"
                + (f" x shards ({shards})" if shards > 1 else ""))
        mb_sz = B_c // (T * micro * shards)
        if sharded:
            # each rank takes its slice of every micro-batch; the
            # token-weighted all-reduce below recovers the full-batch
            # gradient
            sbatch = {k: v.reshape((T, micro, shards, mb_sz) + v.shape[1:])
                      [:, :, rank] for k, v in batch.items()}
        else:
            sbatch = {k: v.reshape((T, micro, mb_sz) + v.shape[1:])
                      for k, v in batch.items()}
        met = {}
        for t in range(T):
            step = step0 + t
            gen = (None if rng is None else _step_generator(
                dev, rng, fold, step, rank if split else None))
            g_acc, n_acc, mets = None, 0.0, []
            for m in range(micro):
                mb = {k: v[t, m] for k, v in sbatch.items()}
                met_m, g = loss_and_grad(base, ad, mb, gen, stage_lam,
                                         stage_prox, anchor)
                # grad weight: the CE denominator (n_tok) when sharded,
                # so uneven loss masks still give the full-batch
                # gradient; 1 on the per-client and replicated paths
                n = met_m["n_tok"] if sharded else 1.0
                acc = pt.tree_map(lambda x: x.to(torch.promote_types(
                    x.dtype, torch.float32)) * n, g)
                g_acc = acc if g_acc is None else pt.tree_map2(torch.add,
                                                               g_acc, acc)
                n_acc = n_acc + n
                mets.append(met_m)
            if tp is not None:      # the row's partial sums
                gs = iter(tp.all_reduce(pt.tree_leaves(g_acc)))
                g_acc = pt.tree_map(lambda _: next(gs), g_acc)
            if sharded:
                n_tot, *gs = group.all_reduce(
                    [n_acc] + pt.tree_leaves(g_acc))
                gs = iter(gs)
                g_acc = pt.tree_map(lambda _: next(gs) / n_tot, g_acc)
            else:
                g_acc = pt.tree_map(lambda x: x / micro, g_acc)
            # the pre-clip norm rides the metrics unconditionally; it is
            # FedSim's per-client grad_norm at micro_batches=1
            gnorm = pt.global_norm(g_acc)
            upd, ost = stage_opt.update(
                clip_by_global_norm(g_acc, settings.clip), ost, ad, step)
            if cover is not None:
                # mixed fleet: no update above this client's rank
                upd = peft.apply_rank_masks(upd, cover)
            ad = apply_updates(ad, upd)
            met = {k: sum(mm[k] for mm in mets) / micro for k in mets[0]}
            met["grad_norm"] = gnorm
        return ad, ost, met

    # ---- stage 1: the federated round ----------------------------------
    def local_step(base, adapters, opt_state, step, batch, anchor=None,
                   rng=None):
        check_on(pt.tree_leaves(base)[0], dev, "base")
        if anchor is None:
            # the proximal reference is the call's input adapters (a
            # round ends in rebroadcast, so that IS the last rebroadcast)
            anchor = adapters
        ad, ost, met = train_scan(
            base, _first(adapters), _first(opt_state), int(step),
            _first(batch), T=settings.local_steps, stage_opt=opt,
            cover=cover if het else None, stage_lam=0.0, stage_prox=prox_mu,
            anchor=_first(anchor), stage="round", rng=rng)
        return (pt.tree_map(lambda x: x[None], ad),
                pt.tree_map(lambda x: x[None], ost), met)

    def round_step(base, adapters, opt_state, step, batch, anchor=None,
                   rng=None, weights=None, participation=None,
                   staleness=None, update_scale=None):
        # the fault layer runs only when participation or update_scale is
        # given (old + 1·(new − old) is not always new in floating
        # point), and then as FedSim.run_cohort_round applies it: a
        # corrupted client's round update scaled, a 0-participation
        # client reverted (adapters and optimizer state) with weight 0
        use_faults = participation is not None or update_scale is not None

        def mine(v, default):
            if v is None:
                return torch.tensor(default, dtype=torch.float32, device=dev)
            return torch.as_tensor(v, dtype=torch.float32).reshape(-1)[
                rank].to(dev)
        w = (weight_c[rank] if weights is None else mine(weights, 1.0))
        if use_faults:
            ad0 = pt.tree_map(torch.clone, _first(adapters))
            ost0 = pt.tree_map(torch.clone, _first(opt_state))
        adapters, opt_state, mets = local_step(base, adapters, opt_state,
                                               step, batch, anchor, rng)
        ad, ost = _first(adapters), _first(opt_state)
        if use_faults:
            p, s = mine(participation, 1.0), mine(update_scale, 1.0)
            ad = pt.tree_map2(lambda new, old: old + s * (new - old), ad, ad0)
            ad = pt.tree_map2(lambda new, old: torch.where(p > 0, new, old),
                              ad, ad0)
            ost = pt.tree_map2(lambda new, old: torch.where(p > 0, new, old),
                               ost, ost0)
            w = w * p
        # the only traffic between clients; ``step`` keys the q8 codec
        # (FedSim's counter at aggregate time), ``staleness`` FedBuff
        agg = collective(ad, group=group, weight=w, cover=cover,
                         step=int(step) + settings.local_steps,
                         staleness=mine(staleness, 0.0))
        if settings.telemetry:
            # the client's drift from the aggregate over the shared
            # leaves, before the rebroadcast (FedSim._client_drift)
            sq = torch.zeros((), dtype=torch.float32, device=dev)
            for p_, x in pt.tree_leaves_with_path(ad):
                if keep_rx is not None and keep_rx.search(p_):
                    continue
                d = x.float() - pt.tree_get(agg, p_).float()
                if het:
                    d = d * pt.tree_get(cover, p_)
                sq = sq + torch.sum(torch.square(d))
            drift = torch.sqrt(sq)
        if zero_rx is not None:
            agg = pt.tree_map_with_path(
                lambda p_, x: torch.zeros_like(x) if zero_rx.search(p_)
                else x, agg)
        out = fedagg.client_rebroadcast(agg, ad, keep_rx,
                                        cover if het else None)
        met_last = pmean(mets)
        if settings.telemetry:
            ce, gn, dr = group.all_gather(
                [mets["ce"].float(), mets["grad_norm"].float(), drift])
            met_last.update(client_ce=ce, client_grad_norm=gn,
                            client_drift=dr)
        return (pt.tree_map(lambda x: x[None], out),
                pt.tree_map(lambda x: x[None], ost), agg, met_last)

    # ---- stage 2: the global optimizer (the server model) ---------------
    def global_step(base, aggregated, adapters, server_batch, rng=None):
        # the server model trains at the full allocated rank, unmasked,
        # from a fresh optimizer (FedSim.global_stage).  A dropout seed
        # forces the replicated path: sliced rows would draw other masks
        # than the full batch
        check_on(pt.tree_leaves(base)[0], dev, "base")
        B_s = server_batch["tokens"].shape[0]
        sharded = (dp > 1 and rng is None
                   and B_s % (settings.global_steps * micro * dp) == 0)
        agg, _, mets = train_scan(
            base, aggregated, opt_g.init(aggregated), 0, server_batch,
            T=settings.global_steps, stage_opt=opt_g, cover=None,
            stage_lam=0.0, stage_prox=0.0, anchor=None, stage="global",
            rng=rng, split=False, sharded=sharded)
        if sharded:
            # each rank's metrics cover its own rows: mean them
            mets = pmean(mets)
        out = fedagg.client_rebroadcast(agg, _first(adapters), keep_rx,
                                        cover if het else None)
        return agg, pt.tree_map(lambda x: x[None], out), mets

    # ---- stage 3: per-client personalization (no collective) -----------
    def personal_step(base, adapters, batch, rng=None):
        check_on(pt.tree_leaves(base)[0], dev, "base")
        ad = _first(adapters)
        ad, _, mets = train_scan(
            base, ad, opt_l.init(ad), 0, _first(batch),
            T=settings.personal_steps, stage_opt=opt_l,
            cover=cover if het else None, stage_lam=lam, stage_prox=0.0,
            anchor=None, stage="personal", rng=rng, fold=31)
        return pt.tree_map(lambda x: x[None], ad), pmean(mets)

    def opt_init(adapters_c):
        """Stage-1 optimizer state of a client-stacked tree (any leading
        length: 1 on a rank)."""
        n = pt.tree_leaves(adapters_c)[0].shape[0]
        return stack_ranks([pt.tree_map(lambda x: x[None], opt.init(
            pt.tree_map(lambda x: x[c], adapters_c))) for c in range(n)])

    # the analytic wire cost of one round's collective: FedSim.aggregate's
    # billing on the template (a mixed fleet bills each client at its rank)
    comm_cls = collective.comm
    if het:
        comm_bytes = sum(
            fedagg.comm_bytes_per_round(
                abs_ad, exclude_rx=method.keep_local, rank=int(r),
                comm=comm_cls, n_clients=dp, topk_ratio=collective.topk_ratio)
            for r in settings.client_ranks)
    else:
        comm_bytes = dp * fedagg.comm_bytes_per_round(
            abs_ad, exclude_rx=method.keep_local, comm=comm_cls,
            n_clients=dp, topk_ratio=collective.topk_ratio)

    return FedPipeline(round_step=round_step, global_step=global_step,
                       personal_step=personal_step, opt_init=opt_init,
                       method=method, round_step_raw=round_step,
                       telemetry=settings.telemetry,
                       comm_bytes_round=int(comm_bytes),
                       comm_class=comm_cls, local_step=local_step,
                       device=dev)


def make_fed_train_step(cfg: ArchConfig, mesh, settings: TrainSettings, *,
                        device="cuda"):
    """Returns (train_step, opt_init).  train_step signature:

        train_step(base, adapters, opt_state, step, batch, rng=None,
                   weights=None, participation=None, staleness=None,
                   update_scale=None) → (adapters, opt_state, metrics)

    One call is one federated round: ``settings.local_steps`` optimizer
    steps on each rank's client, then one aggregation; the stage-1
    program of ``make_fed_pipeline_step`` with the aggregate dropped.
    Every registry method trains with ``FedSim``'s math."""
    pipe = make_fed_pipeline_step(cfg, mesh, settings, device=device)

    def train_step(base, adapters, opt_state, step, batch, rng=None,
                   weights=None, participation=None, staleness=None,
                   update_scale=None):
        adapters, opt_state, _, met = pipe.round_step_raw(
            base, adapters, opt_state, step, batch, rng=rng,
            weights=weights, participation=participation,
            staleness=staleness, update_scale=update_scale)
        return adapters, opt_state, met

    return train_step, pipe.opt_init


def base_manual_specs(base, cfg: ArchConfig):
    """The base's specs over the data axis alone (the reference's): MoE
    expert slots split over 'data', everything else whole.  The port's
    ``launch/specs.param_specs`` carries these entries together with the
    rule table's 'model' ones, and an engine on a grid takes the base cut
    by it."""
    def fn(path, x):
        if cfg.n_experts and re.search(r"moe/experts/", path):
            return (None,) * (len(x.shape) - 3) + ("data", None, None)
        return (None,) * len(x.shape)
    return pt.tree_map_with_path(fn, base)


def abstract_base(cfg: ArchConfig):
    """The backbone's shapes and dtypes, on the "meta" device."""
    return M.init_params(torch.Generator(), cfg, device="meta")
