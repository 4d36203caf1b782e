"""Cross-device-scale federation: bank → cohort → round → bank (port of
``repro/fed/cohort.py``).

``FedSim`` runs a fixed number C of client slots.  Cross-device
federation has N ≫ C *registered* clients, of which each round samples
a cohort.  This module keeps the round untouched and adds the three
host-side pieces around it:

  ClientBank      host-resident state for all N registered clients, as
                  CPU tensors with a leading (N,) axis: adapters,
                  optimizer state, and the round each client last
                  synced.  ``gather`` stacks a cohort onto the sim's
                  device in its (C, ...) layout; ``scatter`` writes the
                  survivors back.  Nothing N-sized touches the card.
  CohortSampler   the per-round cohort draw (distinct indices, seeded by
                  (seed, round), so any round replays on its own).
  FaultPlan       the per-round fault draw: dropouts (the client is lost
                  mid-round), stragglers (miss the round, deliver their
                  update d rounds late), corrupted updates (the round
                  update inflated), all expressed through the (C,)
                  participation / update_scale vectors
                  ``FedSim.run_cohort_round`` takes.
  CohortSim       the driver: deliver matured straggler buffers, sample
                  a cohort, gather, run the faulted round, buffer new
                  stragglers, scatter the participants, and record
                  participation, staleness and faults through
                  ``repro_torch.obs``.

The sampler and the fault plan draw with numpy exactly as the
reference's do, so the same seeds give the same cohorts, faults and
delays in both packages; the bank's checkpoints are the reference's
files, byte for byte.

Staleness is bank state: a client's τ at round r is ``r − last_sync``,
and FedBuff-family aggregates (``needs_staleness``) discount its
contribution by ``(1+τ)^(−α)``.

Comm billing follows participation: a dropped client uploads nothing; a
straggler is billed when its buffered update *arrives*
(``CohortSim._deliver_due``), not in the round it missed.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import obs
from repro_torch.checkpoint.ckpt import (load_checkpoint_flat,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.utils import pytree as pt

# Bucket bounds for the fed/staleness_rounds histogram: staleness is a
# small integer (rounds since the last sync), so the latency-shaped
# defaults would pile everything below 1.0; passed through
# obs.observe(..., bounds=...) (first creation wins)
STALENESS_BOUNDS = (0.0, 1.0, 2.0, 4.0, 8.0, 16.0, 32.0, 64.0)


def _host(x) -> torch.Tensor:
    """A checkpoint leaf (numpy, or a CPU tensor for bfloat16) as a CPU
    tensor."""
    return x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))


def _stack(trees: list):
    """(P, ...) CPU tensors from P trees of one structure."""
    return pt.tree_map_with_path(
        lambda p, _: torch.stack([pt.tree_get(t, p) for t in trees]),
        trees[0])


class ClientBank:
    """Host-resident state for ``n_total`` registered clients.

    Leaves are CPU tensors with a leading (N,) axis: the bank is host
    memory, sized by the fleet, never by the card.  Cohort indices must
    be distinct (``CohortSampler`` draws without replacement); a scatter
    with duplicate indices would be last-write-wins.  ``device``: where
    ``gather`` puts a cohort (default: the adapters' device).
    """

    def __init__(self, adapters, opt_state, n_total: int, *, device=None):
        self.n_total = int(n_total)
        if self.n_total < 1:
            raise ValueError(f"n_total must be >= 1, got {n_total}")
        self.device = torch.device(
            device if device is not None
            else pt.tree_leaves(adapters)[0].device)

        def bank(leaf):
            t = leaf.detach().cpu()
            return t.unsqueeze(0).expand(self.n_total, *t.shape).clone()

        self.adapters = pt.tree_map(bank, adapters)
        self.opt_state = pt.tree_map(bank, opt_state)
        # round of each client's last server sync; staleness at round r
        # is r - last_sync (0 for a fresh fleet at round 0)
        self.last_sync = np.zeros((self.n_total,), np.int64)

    @classmethod
    def from_sim(cls, sim, n_total: int) -> "ClientBank":
        """A bank whose every client starts at ``sim``'s initial state
        (the adapter template and its optimizer init, as the sim's own C
        slots start), gathering onto the sim's device."""
        if sim.hp.client_ranks is not None:
            raise ValueError(
                "ClientBank requires a uniform-rank fleet: per-client "
                "rank masks are bound to the sim's C slots, not to bank "
                "clients, so a mixed-rank bank would silently re-mask "
                "clients to whichever slot they land in")
        return cls(sim.adapter_template, sim.opt.init(sim.adapter_template),
                   n_total, device=sim.device)

    # -- cohort movement ---------------------------------------------------

    def gather(self, idx):
        """Cohort ``idx`` as (C, ...) trees on the bank's device."""
        sel = torch.as_tensor(np.asarray(idx), dtype=torch.int64)

        def g(leaf):
            return leaf[sel].to(self.device)

        return pt.tree_map(g, self.adapters), pt.tree_map(g, self.opt_state)

    def scatter(self, idx, adapters, opt_state, round_idx: int,
                mask=None) -> None:
        """Write cohort slots back into the bank.  ``mask`` (C,) bool
        selects the slots that synced this round (participants); the
        others keep their bank state (a dropped client never heard from
        the server)."""
        idx = np.asarray(idx)
        mask = (np.ones(idx.shape, bool) if mask is None
                else np.asarray(mask, bool))
        sel = idx[mask]
        if sel.size == 0:
            return
        rows = torch.as_tensor(sel, dtype=torch.int64)
        keep = torch.as_tensor(mask)

        def put(bank_tree, new_tree):
            for p, leaf in pt.tree_leaves_with_path(bank_tree):
                new = pt.tree_get(new_tree, p).detach()
                leaf[rows] = new[keep.to(new.device)].cpu()

        put(self.adapters, adapters)
        put(self.opt_state, opt_state)
        self.last_sync[sel] = int(round_idx)

    def deposit(self, client: int, adapters, opt_state,
                sync_round: int) -> None:
        """Write ONE client's (unstacked, host) state: the delayed
        straggler delivery."""
        for bank_tree, new_tree in ((self.adapters, adapters),
                                    (self.opt_state, opt_state)):
            for p, leaf in pt.tree_leaves_with_path(bank_tree):
                leaf[client] = pt.tree_get(new_tree, p)
        self.last_sync[client] = int(sync_round)

    def staleness(self, idx, round_idx: int) -> np.ndarray:
        """Rounds since each cohort member last synced, as (C,) f32: the
        τ vector FedBuff-family aggregates discount by."""
        return (int(round_idx)
                - self.last_sync[np.asarray(idx)]).astype(np.float32)

    # -- checkpointing -----------------------------------------------------

    def state_tree(self) -> dict:
        return {"adapters": self.adapters, "opt_state": self.opt_state,
                "last_sync": self.last_sync}

    def save(self, path: str, round_idx: int = 0) -> None:
        save_checkpoint(path, self.state_tree(), step=round_idx)

    def _adopt(self, tree: dict) -> None:
        self.adapters = pt.tree_map(_host, tree["adapters"])
        self.opt_state = pt.tree_map(_host, tree["opt_state"])
        self.last_sync = np.asarray(tree["last_sync"], np.int64)

    def load(self, path: str) -> int:
        """Restore a bank saved by ``save`` (either package's), on the
        host: N clients' bytes never touch the card."""
        tree, round_idx = restore_checkpoint(path, self.state_tree(),
                                             to_host=True)
        self._adopt(tree)
        return round_idx


class CohortSampler:
    """Per-round cohort draw: C distinct client indices from N, seeded by
    (seed, round), so round r's cohort needs no replay of rounds
    0..r-1."""

    def __init__(self, n_total: int, cohort: int, seed: int = 0):
        if not 1 <= cohort <= n_total:
            raise ValueError(
                f"cohort size {cohort} must be in [1, n_total={n_total}]")
        self.n_total, self.cohort, self.seed = int(n_total), int(cohort), seed

    def sample(self, round_idx: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, int(round_idx)))
        return np.sort(rng.choice(self.n_total, size=self.cohort,
                                  replace=False))


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Per-round fault distribution over the cohort.

    Each cohort slot draws one fate: dropout (probability
    ``dropout_rate``: the client vanishes mid-round, its work is lost,
    it uploads nothing and is not billed), straggler (``straggler_rate``:
    it misses the round but its trained update arrives
    ``straggler_delay`` ∈ [lo, hi] rounds later), else it participates;
    a participant is also corrupted with ``corrupt_rate`` (its round
    update inflated ×``corrupt_scale``).  Draws are seeded by (seed,
    round).  Delays: "uniform" over [lo, hi], or the heavy-tailed
    "lognormal" (lo·LogNormal(0, σ=straggler_tail)) and "pareto"
    (lo·(1 + Pareto(α=straggler_tail))) of arXiv 2410.22815, clipped
    into [lo, hi] so the in-flight buffers stay bounded.
    """
    dropout_rate: float = 0.0
    straggler_rate: float = 0.0
    straggler_delay: tuple = (1, 3)
    straggler_dist: str = "uniform"
    straggler_tail: float = 1.0
    corrupt_rate: float = 0.0
    corrupt_scale: float = 10.0
    seed: int = 0

    def __post_init__(self):
        if not 0.0 <= self.dropout_rate + self.straggler_rate <= 1.0:
            raise ValueError(
                "dropout_rate + straggler_rate must lie in [0, 1], got "
                f"{self.dropout_rate} + {self.straggler_rate}")
        lo, hi = self.straggler_delay
        if not 1 <= int(lo) <= int(hi):
            raise ValueError(
                f"straggler_delay range {self.straggler_delay} must "
                "satisfy 1 <= lo <= hi (a 0-round delay is just "
                "participation)")
        if self.straggler_dist not in ("uniform", "lognormal", "pareto"):
            raise ValueError(
                f"straggler_dist {self.straggler_dist!r} must be "
                "uniform | lognormal | pareto")
        if self.straggler_tail <= 0.0:
            raise ValueError(
                f"straggler_tail must be > 0 (σ for lognormal, α for "
                f"pareto), got {self.straggler_tail}")

    @property
    def any(self) -> bool:
        return (self.dropout_rate > 0 or self.straggler_rate > 0
                or self.corrupt_rate > 0)

    def draw(self, round_idx: int, n: int) -> dict:
        rng = np.random.default_rng((self.seed, int(round_idx), 727))
        u = rng.random(n)
        dropout = u < self.dropout_rate
        straggler = (~dropout) & (u < self.dropout_rate
                                  + self.straggler_rate)
        corrupt = ((~dropout) & (~straggler)
                   & (rng.random(n) < self.corrupt_rate))
        delays = self._draw_delays(rng, n)
        participation = (~(dropout | straggler)).astype(np.float32)
        update_scale = np.where(corrupt, self.corrupt_scale,
                                1.0).astype(np.float32)
        return {"participation": participation,
                "update_scale": update_scale, "dropout": dropout,
                "straggler": straggler, "corrupt": corrupt,
                "delays": delays}

    def _draw_delays(self, rng: np.random.Generator, n: int) -> np.ndarray:
        """Integer delays in [lo, hi]; ``hi`` caps the heavy tails (a
        "declared dead after" horizon)."""
        lo, hi = int(self.straggler_delay[0]), int(self.straggler_delay[1])
        if self.straggler_dist == "uniform":
            return rng.integers(lo, hi + 1, size=n)
        if self.straggler_dist == "lognormal":
            mult = rng.lognormal(mean=0.0, sigma=self.straggler_tail,
                                 size=n)
        else:                                  # pareto, α = straggler_tail
            mult = 1.0 + rng.pareto(self.straggler_tail, size=n)
        return np.clip(np.floor(lo * mult).astype(np.int64), lo, hi)


class CohortSim:
    """Drives a ``FedSim`` of C slots over a ``ClientBank`` fleet.

    Each round: matured straggler buffers deliver to the bank (billed at
    arrival), a cohort is sampled and gathered into the sim's C slots,
    the faulted round runs (``FedSim.run_cohort_round``), new
    stragglers' trained state is buffered on the host for delayed
    delivery, and the participants scatter back with ``last_sync =
    round``.

    Checkpoints hold the bank, the round counter, the comm bill and the
    in-flight straggler buffers, stacked on a lead (P, ...) axis, so a
    restart mid-delay still delivers (and bills) each buffered update at
    its original round.  P varies between checkpoints, so ``load`` reads
    the buffers through the flat (template-free) path; a checkpoint
    without them restores with none in flight.
    """

    def __init__(self, sim, n_total: int, faults: FaultPlan | None = None,
                 seed: int = 0):
        self.sim = sim
        self.bank = ClientBank.from_sim(sim, n_total)
        self.sampler = CohortSampler(n_total, sim.hp.n_clients, seed)
        self.faults = faults if faults is not None else FaultPlan()
        self.round = 0
        self._pending: list[dict] = []   # in-flight straggler deliveries

    # -- straggler buffer --------------------------------------------------

    def _deliver_due(self) -> tuple[int, int]:
        """Deliver matured straggler buffers; returns (deposited, billed):
        every matured upload is billed, but one that lost the race to a
        fresher sync is discarded rather than deposited."""
        due = [d for d in self._pending if d["deliver_at"] <= self.round]
        self._pending = [d for d in self._pending
                         if d["deliver_at"] > self.round]
        n, billed = 0, len(due)
        for d in due:
            # the upload happened either way: bill the wire
            self.sim.comm_bytes += self.sim.client_comm_bytes()
            if self.bank.last_sync[d["client"]] > d["trained_round"]:
                # a fresher sync landed while this update was in flight;
                # the server keeps the newer state
                if obs.enabled():
                    obs.inc("fed/stale_deliveries_discarded",
                            method=self.sim.hp.method)
                continue
            self.bank.deposit(d["client"], d["adapters"], d["opt_state"],
                              d["trained_round"])
            n += 1
        if n and obs.enabled():
            obs.inc("fed/straggler_deliveries", n,
                    method=self.sim.hp.method)
        return n, billed

    def _buffer_stragglers(self, idx, fault) -> None:
        """Each straggler's trained state (``last_trained``: scaled, not
        reverted), as host copies of its slot, never views of the
        stacked leaves."""
        strag = np.nonzero(fault["straggler"])[0]
        if strag.size == 0 or self.sim.last_trained is None:
            return
        trained = self.sim.last_trained
        for slot in strag:
            def take(leaf, s=int(slot)):
                return leaf[s].detach().to("cpu", copy=True)
            self._pending.append({
                "client": int(idx[slot]),
                "deliver_at": self.round + int(fault["delays"][slot]),
                "trained_round": self.round,
                "adapters": pt.tree_map(take, trained["adapters"]),
                "opt_state": pt.tree_map(take, trained["opt_state"])})

    # -- the round ---------------------------------------------------------

    def run_round(self, batches: list[dict], rng=None) -> dict:
        """One cohort round.  ``batches``: one stacked (C, B, S) dict a
        local step, as ``FedSim.local_round`` takes (the data pipeline
        feeds cohort slots, not bank ids); ``rng``: the round's
        ``torch.Generator``."""
        sim, r = self.sim, self.round
        delivered, billed = self._deliver_due()
        idx = self.sampler.sample(r)
        C = sim.hp.n_clients
        sim.client_adapters, sim.opt_state = self.bank.gather(idx)
        if sim.method.prox:
            sim._round_ref = sim.client_adapters
        stale = self.bank.staleness(idx, r)
        fault = self.faults.draw(r, C)
        use_faults = self.faults.any
        mets = sim.run_cohort_round(
            batches, rng,
            participation=fault["participation"] if use_faults else None,
            staleness=stale,
            update_scale=fault["update_scale"] if use_faults else None)
        live = (fault["participation"] > 0 if use_faults
                else np.ones((C,), bool))
        if use_faults:
            self._buffer_stragglers(idx, fault)
        self.bank.scatter(idx, sim.client_adapters, sim.opt_state, r,
                          mask=live)
        if obs.enabled():
            self._cohort_telemetry(r, idx, live, stale, fault, delivered)
        self.round = r + 1
        return {"metrics": mets, "cohort": idx, "participation": live,
                "staleness": stale, "delivered": delivered,
                "delivered_billed": billed, "pending": len(self._pending)}

    def _cohort_telemetry(self, r, idx, live, stale, fault,
                          delivered) -> None:
        method = self.sim.hp.method
        obs.set_gauge("fed/participation_rate", float(live.mean()),
                      method=method)
        for v in stale[live]:
            obs.observe("fed/staleness_rounds", float(v),
                        bounds=STALENESS_BOUNDS, method=method)
        obs.inc("fed/dropouts", float(fault["dropout"].sum()), method=method)
        obs.inc("fed/stragglers", float(fault["straggler"].sum()),
                method=method)
        obs.inc("fed/corrupt_updates", float(fault["corrupt"].sum()),
                method=method)
        obs.event(
            "fed_cohort", method=method, round=r,
            cohort=[int(i) for i in idx],
            participation=[int(v) for v in live],
            staleness=[float(v) for v in stale],
            dropouts=int(fault["dropout"].sum()),
            stragglers=int(fault["straggler"].sum()),
            corrupt=int(fault["corrupt"].sum()),
            delivered=delivered, pending=len(self._pending),
            comm_bytes=int(self.sim.comm_bytes))

    # -- checkpointing -----------------------------------------------------

    def state_tree(self) -> dict:
        return {"bank": self.bank.state_tree(),
                "round": np.asarray(self.round, np.int64),
                "comm_bytes": np.asarray(self.sim.comm_bytes, np.int64)}

    def save(self, path: str) -> None:
        tree = self.state_tree()
        if self._pending:
            pend = self._pending
            tree["pending"] = {
                "client": np.array([d["client"] for d in pend], np.int64),
                "deliver_at": np.array([d["deliver_at"] for d in pend],
                                       np.int64),
                "trained_round": np.array([d["trained_round"] for d in pend],
                                          np.int64),
                "adapters": _stack([d["adapters"] for d in pend]),
                "opt_state": _stack([d["opt_state"] for d in pend]),
            }
        save_checkpoint(path, tree, step=self.round)

    def load(self, path: str) -> int:
        """Restore a checkpoint written by ``save`` (either package's):
        the bank on the host, the round, the comm bill and the in-flight
        straggler buffers; returns the round."""
        tree, _ = restore_checkpoint(path, self.state_tree(), to_host=True)
        self.bank._adopt(tree["bank"])
        self.round = int(tree["round"])
        self.sim.comm_bytes = int(tree["comm_bytes"])
        self._pending = self._load_pending(load_checkpoint_flat(path)[0])
        return self.round

    def _load_pending(self, flat: dict) -> list[dict]:
        """The in-flight straggler list from a checkpoint's flat leaves
        (empty when it has none), its structure templated by the bank's
        own trees."""
        if "pending/client" not in flat:
            return []
        clients = np.asarray(flat["pending/client"], np.int64)
        deliver = np.asarray(flat["pending/deliver_at"], np.int64)
        trained = np.asarray(flat["pending/trained_round"], np.int64)

        def unstack(template, head):
            return pt.tree_map_with_path(lambda p, _: _host(flat[head + p]),
                                         template)

        stacked_ad = unstack(self.bank.adapters, "pending/adapters/")
        stacked_ost = unstack(self.bank.opt_state, "pending/opt_state/")
        return [{"client": int(clients[i]),
                 "deliver_at": int(deliver[i]),
                 "trained_round": int(trained[i]),
                 "adapters": pt.tree_map(lambda x, i=i: x[i].clone(),
                                         stacked_ad),
                 "opt_state": pt.tree_map(lambda x, i=i: x[i].clone(),
                                          stacked_ost)}
                for i in range(clients.shape[0])]
