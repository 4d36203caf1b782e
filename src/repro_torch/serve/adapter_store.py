"""AdapterStore: slot-pooled per-tenant adapters for mixed-batch serving.

Port of the flat ``AdapterStore`` of ``repro/serve/adapter_store.py``.
The store owns, per target projection, stacked pools with an ``L =
n_slots + 1`` slot axis the BGMV kernels gather over (slot ``n_slots``
is the permanent all-zero, rank-0 null adapter — rows without a tenant
adapter point there).  Targets under the stacked ``blocks`` keep their
leading superblock axis ahead of the slot axis — ``(n_sb, L, ...)`` —
so each layer's view is a clean ``(L, ...)`` pool.  Two pool layouts:

  kind="pairs"     pool_A (L, d_in, r) + pool_B (L, r, d_out): one
                   effective LoRA pair per tenant.  Raw-LoRA adapters
                   pack as-is; decomposed-DoRA adapters collapse to
                   their effective pair (A_mag·(A_dir+dA_dir),
                   (B_mag+dB_mag)·B_dir).

  kind="dora_mag"  the paper's deployment shape: every tenant shares the
                   direction/magnitude factors and differs only in its
                   RAW per-rank magnitude delta ΔB_M — pool_dB_mag
                   (L, r); the effective magnitude B_mag+ΔB_M forms
                   inside the BGMV kernel.

A tenant may register any rank ≤ the pool rank: its leaves are
zero-padded into the slot and its true rank goes into the slot-rank
table, exposed as a ``pool_ranks`` leaf for both kinds, so the kernels
always take their ranked variant and mask each row at its slot's rank
(for dora_mag that covers the shared B_mag rows too, and the rank-0
null slot serves the bare backbone).  Register/evict is LRU over slots.
Pools live on the store's device and are updated in place.

``save`` / ``load`` round-trip the pools and the tenant table through
``checkpoint/ckpt.py`` in the reference's file format (tenant ids as
fixed-width uint8 rows, so every leaf is a plain numeric array); a file
either package writes loads into the other's store.

``TieredAdapterStore`` grows the same pool into a three-tier cache for
fleets far larger than the device pool:

    T0  the fixed-shape device pool above (n_slots hot tenants)
    T1  host cache: packed CPU tensors keyed by tenant id, capacity-
        bounded with its own LRU (a dirty entry spills to T2 on evict)
    T2  per-tenant checkpoint shards on disk (``ckpt.save_shard``)

Registration packs on the host and never touches the device; a T0 miss
promotes T2→T1→T0, and ``install_batch`` installs every tenant the next
admission needs with one ``index_copy_`` a pool leaf.  A background
prefetcher reads queued tenants' shards into host memory while a
decode chunk runs.

Telemetry (``repro_torch.obs``), at the reference's sites with its
names: the ``pool/*`` counters (lookups, registers, evictions, tier
hits and misses, promotions, spills, prefetches) and occupancy gauges,
and the ``pool_register`` / ``pool_evict`` / ``pool_promote`` /
``pool_prefetch`` / ``ckpt_migrate`` events, emitted on the serving
thread only: ``pool_prefetch``, and the ``ckpt_restore`` of a prefetched
shard, when ``drain_prefetch`` folds the load in, not on the prefetch
thread (the event log is not thread-safe).
"""
from __future__ import annotations

import os
import threading
import warnings
from collections import OrderedDict, deque
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.checkpoint.ckpt import (checkpoint_leaf_paths,
                                         held_restores, list_shards,
                                         load_checkpoint_flat,
                                         load_shard_flat, record_restores,
                                         restore_checkpoint, save_checkpoint,
                                         save_shard)
from repro_torch.core.peft import _target_kernels
from repro_torch.device import resolve_device
from repro_torch.models.config import ArchConfig
from repro_torch.utils import pytree as pt

Params = Any

_ID_BYTES = 64

_DECOMPOSED = ("A_dir", "A_mag", "B_dir", "B_mag")

# pool leaves carrying a slot axis (cleared on evict); the bgmv_* leaves
# are shared across tenants and never change per slot
_SLOT_KEYS = ("pool_A", "pool_B", "pool_dB_mag")


def _encode_id(tenant: str) -> np.ndarray:
    raw = tenant.encode("utf-8")
    if not raw or len(raw) > _ID_BYTES:
        raise ValueError(f"tenant id must be 1..{_ID_BYTES} utf-8 bytes, "
                         f"got {tenant!r}")
    return np.frombuffer(raw.ljust(_ID_BYTES, b"\0"), np.uint8).copy()


def _decode_id(row: np.ndarray) -> str:
    return bytes(np.asarray(row, np.uint8)).rstrip(b"\0").decode("utf-8")


class AdapterStore:
    """Pools per-tenant adapters behind integer slots for BGMV serving."""

    def __init__(self, base: Params, cfg: ArchConfig, *, n_slots: int = 8,
                 kind: str = "pairs", rank: int = 0,
                 shared: Optional[Params] = None, device="cuda"):
        if kind not in ("pairs", "dora_mag"):
            raise ValueError(f"unknown AdapterStore kind {kind!r}")
        if kind == "dora_mag" and shared is None:
            raise ValueError("kind='dora_mag' needs the shared decomposed "
                             "adapter tree (direction factors)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.kind = kind
        if not rank and kind == "dora_mag":
            # the pool allocation follows the shared model's own rank
            rank = int(pt.tree_leaves(pt.filter_tree(
                shared, lambda p: p.endswith("A_dir")))[0].shape[-1])
        self.rank = rank or cfg.lora_rank
        self.n_slots = n_slots
        self.null_slot = n_slots                      # all-zero identity slot
        # target prefix (".../q_proj") → (lead_dims, d_in, d_out)
        self.targets: dict[str, tuple[tuple, int, int]] = {}
        for path, kern in _target_kernels(base, cfg.lora_targets):
            *lead, d_in, d_out = kern.shape
            if len(lead) > 1:
                raise ValueError(f"unsupported kernel layout at {path}: "
                                 f"{tuple(kern.shape)}")
            self.targets[path.rsplit("/", 1)[0]] = (tuple(lead), d_in, d_out)
        if not self.targets:
            raise ValueError(f"no lora_targets {cfg.lora_targets} in base")

        L, r = n_slots + 1, self.rank

        def zeros(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        self._pools: dict[str, dict[str, torch.Tensor]] = {}
        for prefix, (lead, d_in, d_out) in self.targets.items():
            if kind == "pairs":
                self._pools[prefix] = {"pool_A": zeros(*lead, L, d_in, r),
                                       "pool_B": zeros(*lead, L, r, d_out)}
                continue
            sh = {k: pt.tree_get(shared, f"{prefix}/{k}") for k in _DECOMPOSED}
            if any(v is None for v in sh.values()):
                raise ValueError(f"shared tree missing decomposed leaves "
                                 f"under {prefix}")
            if tuple(sh["A_dir"].shape) != (*lead, d_in, r):
                raise ValueError(
                    f"shared rank mismatch at {prefix}: "
                    f"{tuple(sh['A_dir'].shape)} vs {(*lead, d_in, r)}")
            da = pt.tree_get(shared, f"{prefix}/dA_dir")
            a_dir = sh["A_dir"] + da if da is not None else sh["A_dir"]
            self._pools[prefix] = {
                "bgmv_A_dir": self._f32(a_dir),
                "bgmv_A_mag": self._f32(sh["A_mag"]),
                "bgmv_B_dir": self._f32(sh["B_dir"]),
                "bgmv_B_mag": self._f32(sh["B_mag"]),
                # RAW ΔB_M per slot — the kernel adds the shared B_mag
                # and rank-masks the product
                "pool_dB_mag": zeros(*lead, L, r),
            }

        self._slot_of: dict[str, int] = {}            # tenant → slot
        self._tenant_of: dict[int, str] = {}          # slot → tenant
        self._last_used = np.zeros((n_slots,), np.int64)
        self._counter = 0
        # per-slot adapter ranks (null slot stays 0)
        self._slot_ranks = np.zeros((n_slots + 1,), np.int32)
        # bumped on every pool/rank-table mutation — ServeEngine keys its
        # merged-params cache on this
        self.version = 0

    def _f32(self, t, device=None) -> torch.Tensor:
        return torch.as_tensor(t).to(device or self.device,
                                     torch.float32).contiguous()

    # ------------------------------------------------------------------
    # slot management
    # ------------------------------------------------------------------

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._slot_of

    @property
    def tenants(self) -> list[str]:
        return sorted(self._slot_of)

    def slot_of(self, tenant: str) -> int:
        """Slot for a registered tenant; bumps LRU recency."""
        slot = self._slot_of[tenant]
        self._touch(slot)
        obs.inc("pool/lookups", kind=self.kind)
        return slot

    def rank_of(self, tenant: str) -> int:
        """The tenant's own adapter rank (≤ the pool's r_max)."""
        return int(self._slot_ranks[self._slot_of[tenant]])

    def _touch(self, slot: int) -> None:
        self._counter += 1
        self._last_used[slot] = self._counter

    def _alloc(self, tenant: str) -> int:
        if tenant in self._slot_of:
            return self._slot_of[tenant]
        for slot in range(self.n_slots):
            if slot not in self._tenant_of:
                return slot
        lru = min(self._tenant_of, key=lambda s: self._last_used[s])
        self.evict(self._tenant_of[lru])
        return lru

    def _set_slot(self, prefix: str, key: str, slot: int, val):
        """In-place write of one slot of one pool leaf."""
        lead, _, _ = self.targets[prefix]
        pool = self._pools[prefix][key]
        if lead:
            pool[:, slot] = val
        else:
            pool[slot] = val
        self.version += 1

    def evict(self, tenant: str) -> None:
        slot = self._slot_of.pop(tenant)
        del self._tenant_of[slot]
        self._last_used[slot] = 0
        self._slot_ranks[slot] = 0
        for prefix, pool in self._pools.items():
            for key in _SLOT_KEYS:
                if key in pool:
                    self._set_slot(prefix, key, slot, 0.0)
        if obs.enabled():
            obs.inc("pool/evictions", kind=self.kind)
            obs.set_gauge("pool/occupancy",
                          len(self._tenant_of) / self.n_slots, kind=self.kind)
            obs.event("pool_evict", tenant=tenant, slot=slot, pool=self.kind)

    # ------------------------------------------------------------------
    # register
    # ------------------------------------------------------------------

    def register(self, tenant: str, adapter: Params, rank: int = 0) -> int:
        """Pack one tenant's adapter tree into a pool slot (LRU evict when
        full).  Accepts raw-LoRA {lora_A, lora_B} or decomposed-DoRA
        leaves for kind='pairs'; a dB_mag overlay (or full decomposed
        tree) for kind='dora_mag'.  ``rank``: the tenant's TRUE rank when
        it is below the leaves' allocation.  Raises ValueError on
        rank/target mismatch."""
        packed, r_t = self._pack_adapter(tenant, adapter, rank)
        slot = self._alloc(tenant)
        for prefix, leaves in packed.items():
            for key, val in leaves.items():
                self._set_slot(prefix, key, slot, val)
        self._slot_of[tenant] = slot
        self._tenant_of[slot] = tenant
        self._slot_ranks[slot] = r_t
        self._touch(slot)
        if obs.enabled():
            obs.inc("pool/registers", kind=self.kind)
            obs.set_gauge("pool/occupancy",
                          len(self._tenant_of) / self.n_slots, kind=self.kind)
            obs.event("pool_register", tenant=tenant, slot=slot,
                      rank=int(self._slot_ranks[slot]), pool=self.kind)
        return slot

    def install_batch(self, tenants, *, pinned=(),
                      queued=()) -> dict[str, int]:
        """Make every tenant resident and return ``{tenant: slot}``.  The
        flat store has one tier, so this is a recency-bumping lookup (a
        never-registered tenant raises KeyError); ``pinned`` / ``queued``
        are the tiered store's victim hints and are ignored here."""
        return {t: self.slot_of(t) for t in tenants}

    def prefetch(self, tenants) -> None:
        """Hint that ``tenants`` are queued: a no-op for the flat store
        (the tiered store reads their shards in the background)."""

    def drain_prefetch(self) -> None:
        """No-op for the flat store."""

    def _pack_adapter(self, tenant: str, adapter: Params, rank: int = 0,
                      device=None) -> tuple[dict, int]:
        """Validate + pack one tenant's adapter into f32 leaves on
        ``device`` (default: the store's), keyed ``{target_prefix:
        {pool_key: tensor}}``; returns (packed, true_rank)."""
        _encode_id(tenant)                            # validate early
        packed, t_ranks = {}, set()
        for p in self.targets:
            packed[p], r_t = self._pack_one(p, adapter, device)
            t_ranks.add(r_t)
        if len(t_ranks) != 1:
            raise ValueError(f"adapter rank mismatch across targets: "
                             f"{sorted(t_ranks)}")
        if rank:
            if not 1 <= rank <= min(t_ranks):
                raise ValueError(
                    f"explicit rank {rank} mismatch: outside [1, "
                    f"{min(t_ranks)}] (the adapter leaves' own rank)")
            t_ranks = {rank}
        extra = [p for p in pt.tree_paths(adapter)
                 if not any(p.startswith(t + "/") for t in self.targets)]
        if extra:
            raise ValueError(f"adapter has leaves outside the store's "
                             f"targets: {extra[:3]}")
        return packed, t_ranks.pop()

    def _pad_rank(self, x: torch.Tensor, axis: int) -> torch.Tensor:
        """Zero-pad a rank-``r_t`` leaf up to the pool's r_max along
        ``axis`` (-1 or -2)."""
        r_t = x.shape[axis]
        if not 1 <= r_t <= self.rank:
            raise ValueError(f"rank mismatch: adapter rank {r_t} outside "
                             f"[1, r_max={self.rank}]")
        pad = [0, 0] * (-axis)
        pad[-1] = self.rank - r_t           # F.pad lists the last axis first
        return F.pad(x, pad)

    def _pack_one(self, prefix: str, adapter: Params,
                  device=None) -> tuple[dict, int]:
        """Pack one target's leaves for a slot on ``device``; returns
        (leaves, rank)."""
        lead, d_in, d_out = self.targets[prefix]
        r = self.rank

        def f32(t):
            return self._f32(t, device)
        sub = pt.tree_get(adapter, prefix)
        if sub is None:
            raise ValueError(f"adapter missing target {prefix} "
                             f"(store targets: {list(self.targets)})")
        if self.kind == "dora_mag":
            db = sub.get("dB_mag")
            if db is None:
                raise ValueError(f"{prefix}: kind='dora_mag' needs a dB_mag "
                                 f"leaf per target")
            r_t = db.shape[-1]
            if tuple(db.shape) != (*lead, r_t) or r_t > r:
                raise ValueError(f"{prefix}: dB_mag rank mismatch "
                                 f"{tuple(db.shape)} vs {(*lead, f'<={r}')}")
            return {"pool_dB_mag": self._pad_rank(f32(db), -1)}, r_t
        if "lora_A" in sub:
            A, B = f32(sub["lora_A"]), f32(sub["lora_B"])
        elif "A_dir" in sub:
            a_dir = f32(sub["A_dir"])
            if "dA_dir" in sub:
                a_dir = a_dir + f32(sub["dA_dir"])
            b_mag = f32(sub["B_mag"])
            if "dB_mag" in sub:
                b_mag = b_mag + f32(sub["dB_mag"])
            A = f32(sub["A_mag"])[..., None] * a_dir
            B = b_mag[..., None] * f32(sub["B_dir"])
        else:
            raise ValueError(f"{prefix}: no lora_A/A_dir leaves in adapter")
        r_t = A.shape[-1]
        if (r_t > r or tuple(A.shape) != (*lead, d_in, r_t)
                or tuple(B.shape) != (*lead, r_t, d_out)):
            raise ValueError(f"{prefix}: shape mismatch A{tuple(A.shape)} "
                             f"B{tuple(B.shape)} vs {(*lead, d_in, f'<={r}')}"
                             f" / {(*lead, f'<={r}', d_out)}")
        return {"pool_A": self._pad_rank(A, -1),
                "pool_B": self._pad_rank(B, -2)}, r_t

    # ------------------------------------------------------------------
    # serving views
    # ------------------------------------------------------------------

    def overlay(self) -> Params:
        """Pooled overlay tree to merge into the backbone params —
        ``layers.linear`` consults these leaves when adapter_idx is set.
        Both kinds carry the per-slot rank table as a ``pool_ranks`` leaf
        (int32, broadcast over the stacked-block lead axis)."""
        slot_ranks = torch.as_tensor(self._slot_ranks, device=self.device)
        out: dict = {}
        for prefix, pool in self._pools.items():
            cur = out
            for k in prefix.split("/"):
                cur = cur.setdefault(k, {})
            cur.update(pool)
            lead, _, _ = self.targets[prefix]
            cur["pool_ranks"] = slot_ranks.expand(
                *lead, self.n_slots + 1).contiguous()
        return out

    def bytes_per_tenant(self, tenant: str | None = None) -> int:
        """Marginal pool bytes one registered tenant occupies (at the
        tenant's own rank when given; at the pool's r_max otherwise)."""
        r = self.rank if tenant is None else self.rank_of(tenant)
        total = 0
        for lead, d_in, d_out in self.targets.values():
            n = int(np.prod(lead)) if lead else 1
            total += 4 * r * n * (1 if self.kind == "dora_mag"
                                  else d_in + d_out)
        return total

    # ------------------------------------------------------------------
    # checkpointing
    # ------------------------------------------------------------------

    def _meta_arrays(self) -> dict:
        ids = np.zeros((self.n_slots, _ID_BYTES), np.uint8)
        for slot, tenant in self._tenant_of.items():
            ids[slot] = _encode_id(tenant)
        return {"tenant_ids": ids,
                "last_used": self._last_used.copy(),
                "counter": np.asarray(self._counter, np.int64),
                "slot_ranks": self._slot_ranks.copy()}

    def state_tree(self) -> dict:
        """Pools keyed by target prefix ("/" → "."), and the tenant table."""
        return {"pools": {p.replace("/", "."): dict(v)
                          for p, v in self._pools.items()},
                "meta": self._meta_arrays()}

    def save(self, path: str, step: int = 0) -> None:
        save_checkpoint(path, self.state_tree(), step=step)

    def _like(self) -> dict:
        """``state_tree`` as a restore template: a checkpoint written
        before the slot-rank table existed restores at the full rank."""
        like = self.state_tree()
        like["meta"]["slot_ranks"] = np.full((self.n_slots + 1,), self.rank,
                                             np.int32)
        return like

    def load(self, path: str) -> int:
        """Restore pools + tenant table saved by ``save`` (either
        package's) into this store, which must have the same base, cfg,
        n_slots, kind and pool rank; returns the step.  A checkpoint with
        no ``meta/slot_ranks`` restores every occupied slot at the pool's
        full rank.  A kind='dora_mag' checkpoint of the pre-raw-delta
        layout (a ``pool_B_mag`` pool of merged magnitudes) is migrated
        by ``_load_legacy_b_mag``."""
        if self.kind == "dora_mag":
            try:
                old_paths = checkpoint_leaf_paths(path)
            except (OSError, ValueError):
                old_paths = []              # the restore below says why
            if any(p.endswith("/pool_B_mag") for p in old_paths):
                return self._load_legacy_b_mag(path)
        tree, step = restore_checkpoint(path, self._like(),
                                        allow_missing=r"^meta/slot_ranks$")
        for p in self._pools:
            self._pools[p] = tree["pools"][p.replace("/", ".")]
        self._restore_meta(tree["meta"])
        self.version += 1
        return step

    def _restore_meta(self, meta: dict) -> None:
        ids = np.asarray(meta["tenant_ids"], np.uint8)
        self._last_used = np.asarray(meta["last_used"], np.int64).copy()
        self._counter = int(meta["counter"])
        self._slot_ranks = np.asarray(meta["slot_ranks"], np.int32).copy()
        self._slot_of, self._tenant_of = {}, {}
        for slot in range(self.n_slots):
            tenant = _decode_id(ids[slot])
            if tenant:
                self._slot_of[tenant] = slot
                self._tenant_of[slot] = tenant
        for slot in range(self.n_slots + 1):      # empty and null slots: 0
            if slot not in self._tenant_of:
                self._slot_ranks[slot] = 0

    def _load_legacy_b_mag(self, path: str) -> int:
        """Restore a pre-raw-delta kind='dora_mag' checkpoint, whose slots
        held merged magnitudes ``pool_B_mag[slot] = B_mag + ΔB_M`` (zero
        above the tenant's rank), as today's raw ``pool_dB_mag``:
        ``ΔB_M = pool_B_mag[slot] − B_mag`` on every occupied slot's rank
        rows, zero elsewhere.  That inverts the merge only against the
        shared magnitude the checkpoint was written with, so a ValueError
        is raised when the checkpoint's ``bgmv_B_mag`` differs from this
        store's or its pool shapes differ from this allocation
        (re-register the tenants instead)."""
        warnings.warn(
            f"{path}: legacy pre-raw-delta AdapterStore checkpoint "
            "(merged pool_B_mag layout) — converting to raw pool_dB_mag "
            "by subtracting the shared B_mag per occupied slot",
            stacklevel=3)
        like = self._like()
        for p, pool in self._pools.items():
            legacy = {k: v for k, v in pool.items() if k != "pool_dB_mag"}
            legacy["pool_B_mag"] = torch.zeros_like(pool["pool_dB_mag"])
            like["pools"][p.replace("/", ".")] = legacy
        try:
            # old checkpoints may predate the shared bgmv_* leaves: the
            # store's own shared tree is then the only candidate
            tree, step = restore_checkpoint(
                path, like, allow_missing=r"^meta/slot_ranks$|/bgmv_")
        except AssertionError as e:
            raise ValueError(
                f"legacy pool_B_mag checkpoint {path} is not convertible "
                f"into this store: pool shape mismatch {e.args[0]!r} — the "
                "merge is non-invertible here; re-register the tenants"
            ) from e
        self._restore_meta(tree["meta"])
        occupied = np.zeros((self.n_slots + 1, 1), bool)
        for slot in self._tenant_of:
            occupied[slot] = True
        rows = np.arange(self.rank) < self._slot_ranks[:, None]
        for p, pool in self._pools.items():
            ck = tree["pools"][p.replace("/", ".")]
            b_mag = pool["bgmv_B_mag"].cpu().numpy()         # (lead, r)
            ck_b_mag = ck["bgmv_B_mag"].cpu().numpy()
            if not np.allclose(ck_b_mag, b_mag, rtol=1e-6, atol=1e-7):
                raise ValueError(
                    f"legacy pool_B_mag checkpoint {path} was written "
                    f"against a different shared B_mag at {p!r} — the merge "
                    "is non-invertible with this store's shared tree; "
                    "re-register the tenants")
            db = ck["pool_B_mag"].cpu().numpy() - ck_b_mag[..., None, :]
            self._pools[p] = {k: v for k, v in ck.items()
                              if k != "pool_B_mag"}
            self._pools[p]["pool_dB_mag"] = self._f32(
                db * (occupied & rows))
        self.version += 1
        if obs.enabled():
            obs.event("ckpt_migrate", path=str(path),
                      layout="pool_B_mag->pool_dB_mag",
                      tenants=len(self._tenant_of))
        return step


# ---------------------------------------------------------------------------
# tiered store: device pool (T0) + host cache (T1) + disk shards (T2)
# ---------------------------------------------------------------------------


class _Prefetcher:
    """Background T2 → host loader for the tiered store.

    A worker thread, started on demand and gone when its queue is empty,
    reads each submitted tenant's shard into packed CPU tensors (no CUDA
    call) and puts the result in the back buffer.  ``drain``, called on
    the serving thread between decode chunks, swaps the buffer out under
    the lock; the thread never touches T0 or T1.  Each item carries the
    tenant's registration generation at submit time, so the store can
    drop a load that a re-registration made stale.  A load that fails
    (missing or corrupt shard) is dropped and kept in ``last_error``: the
    synchronous path raises it when the tenant is installed.  The
    thread emits no telemetry: its shard reads' ``ckpt_restore`` records
    wait in ``records`` for the serving thread."""

    def __init__(self, load_fn):
        self._load = load_fn                  # tenant → (packed, rank)
        self._cv = threading.Condition()
        self._work: deque = deque()
        self._inflight: set[str] = set()
        self._back: dict[str, tuple] = {}     # tenant → (packed, rank, gen)
        self._records: list = []              # held ckpt_restore records
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def submit(self, tenant: str, gen: int) -> None:
        with self._cv:
            if tenant in self._inflight or tenant in self._back:
                return
            self._inflight.add(tenant)
            self._work.append((tenant, gen))
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._run, name="adapter-prefetch", daemon=True)
                self._thread.start()

    def _run(self) -> None:
        while True:
            with self._cv:
                if not self._work:
                    self._thread = None
                    return
                tenant, gen = self._work.popleft()
            result = None
            with held_restores() as records:
                try:
                    packed, rank = self._load(tenant)
                    result = (packed, rank, gen)
                except Exception as e:  # noqa: BLE001
                    # the boundary of the thread: the load is dropped, and
                    # the synchronous read raises the error at install time
                    self.last_error = e
            with self._cv:
                self._inflight.discard(tenant)
                self._records.extend(records)
                if result is not None:
                    self._back[tenant] = result
                self._cv.notify_all()

    def drain(self) -> dict[str, tuple]:
        """Swap out the completed loads."""
        with self._cv:
            front, self._back = self._back, {}
        return front

    def drain_records(self) -> list:
        """Swap out the held ``ckpt_restore`` records of the reads."""
        with self._cv:
            front, self._records = self._records, []
        return front

    def wait(self, timeout: float = 5.0) -> bool:
        """Block until no load is in flight (True) or ``timeout`` seconds
        pass (False)."""
        with self._cv:
            return self._cv.wait_for(lambda: not self._inflight, timeout)


class TieredAdapterStore(AdapterStore):
    """Three-tier adapter store: device pool (T0) ⊆ host cache (T1), and
    per-tenant disk shards (T2).  Port of the reference's
    ``TieredAdapterStore``.

    T1 is an inclusive host cache of packed CPU tensors: promotion into
    T0 keeps the T1 copy, so demotion out of T0 is bookkeeping only (the
    victim row is overwritten by the incoming rows) and every registered
    tenant lives in T1 or a T2 shard.  T1 has its own LRU and capacity;
    evicting a dirty entry (packed since its last shard write) spills it
    to ``shard_dir`` first.

    ``register`` packs on the host into T1 only: registering a fleet
    makes no device allocation.  Residency comes from ``install_batch``
    (or ``slot_of``): the missing tenants are promoted T2→T1→T0 and
    written with one ``index_copy_`` a pool leaf along its slot axis;
    the pool tensors keep their identity and ``version`` goes up once.
    Victims: ``pinned`` tenants (active batch rows) are never evicted (a
    pool with every slot pinned raises RuntimeError), ``queued`` tenants
    only when no other victim is left, LRU recency orders the rest.
    Give the pool at least as many slots as the engine has rows.

    ``prefetch`` / ``drain_prefetch`` bracket a decode chunk: queued
    tenants' shards load in the background and fold into T1 on the
    serving thread.  A promoted adapter's bytes are the same whether
    they came from the prefetcher or a synchronous shard read, so the
    tokens never depend on thread timing.

    ``save`` flushes dirty T1 entries to their shards and writes the T0
    state with the tier directory (``tier/ids``, ``tier/ranks``); ``load``
    takes tiered and flat-store checkpoints and adopts the shards already
    in ``shard_dir``."""

    def __init__(self, base: Params, cfg: ArchConfig, *, shard_dir: str,
                 host_capacity: int = 1024, n_slots: int = 8,
                 kind: str = "pairs", rank: int = 0,
                 shared: Optional[Params] = None, device="cuda"):
        super().__init__(base, cfg, n_slots=n_slots, kind=kind, rank=rank,
                         shared=shared, device=device)
        if not shard_dir:
            raise ValueError("TieredAdapterStore needs a shard_dir (the T2 "
                             "spill/restore target)")
        if host_capacity < 1:
            raise ValueError(f"host_capacity must be >= 1, got "
                             f"{host_capacity}")
        self.shard_dir = str(shard_dir)
        os.makedirs(self.shard_dir, exist_ok=True)
        self.host_capacity = int(host_capacity)
        self._host = torch.device("cpu")
        # T1: tenant → (packed leaves, rank, dirty), insertion = LRU order
        self._t1: OrderedDict[str, tuple] = OrderedDict()
        # every tenant in any tier → rank (-1: a shard not read yet)
        self._dir: dict[str, int] = {}
        self._gen: dict[str, int] = {}        # re-registration generations
        self._prefetcher = _Prefetcher(self._read_shard)
        for t in list_shards(self.shard_dir):
            self._dir[t] = -1

    # -- membership is directory-wide ----------------------------------

    def __contains__(self, tenant: str) -> bool:
        return tenant in self._dir

    @property
    def tenants(self) -> list[str]:
        return sorted(self._dir)

    @property
    def resident_tenants(self) -> list[str]:
        """Tenants holding a T0 slot."""
        return sorted(self._slot_of)

    def rank_of(self, tenant: str) -> int:
        r = self._dir[tenant]
        if r < 0:                             # shard-only: read it once
            _packed, r = self._read_shard(tenant)
            self._dir[tenant] = int(r)
        return int(r)

    # -- registration goes to T1 ---------------------------------------

    def register(self, tenant: str, adapter: Params, rank: int = 0) -> int:
        """Pack one tenant's adapter on the host into T1 (dirty).  Claims
        no device slot: returns the tenant's T0 slot when it is resident
        (its row is rewritten in place), else -1."""
        packed, r_t = self._pack_adapter(tenant, adapter, rank,
                                         device=self._host)
        self._gen[tenant] = self._gen.get(tenant, 0) + 1
        self._dir[tenant] = r_t
        self._t1_put(tenant, packed, r_t, dirty=True)
        slot = self._slot_of.get(tenant, -1)
        if slot >= 0:
            self._install_rows([(slot, tenant, packed, r_t)])
        if obs.enabled():
            obs.inc("pool/registers", kind=self.kind)
            obs.set_gauge("pool/t1_occupancy",
                          len(self._t1) / self.host_capacity)
            obs.event("pool_register", tenant=tenant, slot=slot,
                      rank=int(r_t), pool=self.kind, tier="t1")
        return slot

    # -- promotion ------------------------------------------------------

    def slot_of(self, tenant: str) -> int:
        """Slot for a known tenant, promoting T2→T1→T0 on a miss."""
        if tenant in self._slot_of:
            return super().slot_of(tenant)
        return self.install_batch([tenant])[tenant]

    def install_batch(self, tenants, *, pinned=(),
                      queued=()) -> dict[str, int]:
        """Make every tenant T0-resident and return ``{tenant: slot}``,
        promoting the missing ones (T2→T1→T0) in one install.  Tenants of
        ``tenants`` already resident are pinned for this call."""
        order = list(dict.fromkeys(tenants))
        out: dict[str, int] = {}
        missing: list[str] = []
        for t in order:
            slot = self._slot_of.get(t)
            if slot is not None:
                self._touch(slot)
                out[t] = slot
                obs.inc("pool/tier_hits", tier="t0")
            else:
                missing.append(t)
        if order:
            obs.inc("pool/lookups", len(order), kind=self.kind)
        if not missing:
            return out
        self.drain_prefetch()
        incoming = []
        for t in missing:
            if t not in self._dir:
                raise KeyError(f"unknown tenant {t!r}: register it first")
            entry = self._t1.get(t)
            if entry is not None:
                self._t1.move_to_end(t)
                packed, r_t, _dirty = entry
                src = "t1"
                obs.inc("pool/tier_hits", tier="t1")
            else:
                obs.inc("pool/tier_misses", tier="t1")
                packed, r_t = self._read_shard(t)
                self._t1_put(t, packed, r_t, dirty=False)
                src = "t2"
            obs.inc("pool/promotions", src=src)
            incoming.append((t, packed, r_t, src))
        slots = self._alloc_slots(len(incoming), pinned=set(pinned) | set(out),
                                  queued=set(queued))
        self._install_rows([(s, t, p, r)
                            for s, (t, p, r, _src) in zip(slots, incoming)])
        for (t, _p, r_t, src), s in zip(incoming, slots):
            out[t] = s
            if obs.enabled():
                obs.event("pool_promote", tenant=t, slot=s, src=src,
                          rank=int(r_t), pool=self.kind)
        if obs.enabled():
            obs.set_gauge("pool/occupancy",
                          len(self._tenant_of) / self.n_slots, kind=self.kind)
            obs.set_gauge("pool/t1_occupancy",
                          len(self._t1) / self.host_capacity)
        return out

    def _alloc_slots(self, k: int, *, pinned: set, queued: set) -> list[int]:
        """``k`` free or evictable slots: free slots first, then LRU over
        unpinned unqueued residents, then LRU over unpinned queued ones.
        Raises RuntimeError when fewer than ``k`` are evictable."""
        slots = [s for s in range(self.n_slots)
                 if s not in self._tenant_of][:k]
        need = k - len(slots)
        if need > 0:
            ranked = sorted(
                (self._tenant_of[s] in queued, int(self._last_used[s]), s)
                for s in self._tenant_of
                if self._tenant_of[s] not in pinned)
            if len(ranked) < need:
                raise RuntimeError(
                    f"adapter pool exhausted: need {need} more slots but "
                    f"only {len(ranked)} of {self.n_slots} residents are "
                    f"evictable (rest pinned by active rows) — raise "
                    f"n_slots or shrink the admitted batch")
            for was_queued, _lu, s in ranked[:need]:
                self._demote(s, bool(was_queued))
                slots.append(s)
        return slots

    def _demote(self, slot: int, was_queued: bool) -> None:
        """Bookkeeping-only T0 eviction: the bytes stay in T1 (or a
        shard) and the row is overwritten by the incoming install."""
        tenant = self._tenant_of.pop(slot)
        del self._slot_of[tenant]
        self._last_used[slot] = 0
        self._slot_ranks[slot] = 0
        if obs.enabled():
            obs.inc("pool/evictions", kind=self.kind)
            obs.event("pool_evict", tenant=tenant, slot=slot, pool=self.kind,
                      tier="t0", queued=was_queued)

    def _install_rows(self, rows) -> None:
        """Write packed host rows ``(slot, tenant, packed, rank)`` into
        T0: one host-to-device copy and one ``index_copy_`` a pool leaf
        for all rows."""
        idx = torch.tensor([s for s, *_ in rows], dtype=torch.int64,
                           device=self.device)
        for prefix, (lead, _d_in, _d_out) in self.targets.items():
            pool = self._pools[prefix]
            axis = 1 if lead else 0
            for key in _SLOT_KEYS:
                if key in pool:
                    vals = torch.stack([p[prefix][key] for _s, _t, p, _r
                                        in rows], dim=axis)
                    pool[key].index_copy_(axis, idx, vals.to(self.device))
        for slot, tenant, _packed, r_t in rows:
            self._slot_of[tenant] = slot
            self._tenant_of[slot] = tenant
            self._slot_ranks[slot] = int(r_t)
            self._touch(slot)
        self.version += 1

    # -- T1 and its T2 spill --------------------------------------------

    def _t1_put(self, tenant: str, packed: dict, rank: int,
                *, dirty: bool) -> None:
        self._t1[tenant] = (packed, int(rank), bool(dirty))
        self._t1.move_to_end(tenant)
        while len(self._t1) > self.host_capacity:
            victim, (vp, vr, vdirty) = self._t1.popitem(last=False)
            if vdirty:
                save_shard(self.shard_dir, victim, self._shard_tree(vp, vr))
                obs.inc("pool/t1_spills")
            obs.inc("pool/t1_evictions")

    def _shard_tree(self, packed: dict, rank: int) -> dict:
        return {"leaves": {p.replace("/", "."): dict(v)
                           for p, v in packed.items()},
                "rank": np.asarray(rank, np.int32)}

    def _read_shard(self, tenant: str) -> tuple[dict, int]:
        """One tenant's shard as packed CPU tensors and its rank (runs on
        the prefetch thread too: host work only)."""
        flat, _step = load_shard_flat(self.shard_dir, tenant)
        rank = int(flat.pop("rank"))
        packed: dict = {}
        for p in self.targets:
            head = "leaves/" + p.replace("/", ".") + "/"
            leaves = {path[len(head):]: torch.from_numpy(
                np.asarray(arr, np.float32))
                for path, arr in flat.items() if path.startswith(head)}
            if not leaves:
                raise KeyError(f"shard for tenant {tenant!r} is missing "
                               f"target {p}")
            packed[p] = leaves
        return packed, rank

    # -- async prefetch -------------------------------------------------

    def prefetch(self, tenants) -> None:
        """Queue background shard reads for tenants in neither T0 nor T1
        (called before a decode chunk)."""
        for t in tenants:
            if t in self._slot_of or t in self._t1 or t not in self._dir:
                continue
            self._prefetcher.submit(t, self._gen.get(t, 0))
            obs.inc("pool/prefetch_submits")

    def drain_prefetch(self) -> None:
        """Fold completed prefetches into T1; a load a re-registration
        superseded while in flight is dropped.  The reads' ``ckpt_restore``
        records are emitted here, on the serving thread."""
        loads = self._prefetcher.drain()
        record_restores(self._prefetcher.drain_records())
        for tenant, (packed, rank, gen) in loads.items():
            if gen != self._gen.get(tenant, 0) or tenant in self._t1:
                continue
            self._t1_put(tenant, packed, rank, dirty=False)
            if obs.enabled():
                obs.inc("pool/prefetched")
                obs.event("pool_prefetch", tenant=tenant, rank=int(rank))

    def wait_prefetch(self, timeout: float = 5.0) -> bool:
        """Block until the prefetcher is idle (True) or ``timeout``
        seconds pass (False).  A barrier for tests and measurements;
        serving never needs it."""
        return self._prefetcher.wait(timeout)

    # -- checkpointing --------------------------------------------------

    def flush(self) -> None:
        """Write every dirty T1 entry to its shard."""
        for t, (packed, r, dirty) in list(self._t1.items()):
            if dirty:
                save_shard(self.shard_dir, t, self._shard_tree(packed, r))
                self._t1[t] = (packed, r, False)
                obs.inc("pool/t1_spills")

    def save(self, path: str, step: int = 0) -> None:
        """Flush dirty T1 entries, then write the T0 state and the tier
        directory (ids and ranks, read back without a template)."""
        self.flush()
        tree = self.state_tree()
        names = sorted(self._dir)
        ids = np.zeros((len(names), _ID_BYTES), np.uint8)
        ranks = np.zeros((len(names),), np.int32)
        for i, t in enumerate(names):
            ids[i] = _encode_id(t)
            ranks[i] = self._dir[t]
        tree["tier"] = {"ids": ids, "ranks": ranks}
        save_checkpoint(path, tree, step=step)

    def load(self, path: str) -> int:
        """Restore the T0 state (a flat-store checkpoint loads as is, its
        residents becoming the directory) and the tier directory when
        present; the resident rows become dirty T1 entries, so a later
        demotion loses nothing, and the rest reload from their shards."""
        step = super().load(path)
        self._t1.clear()
        self._gen.clear()
        self._dir = {}
        flat, _ = load_checkpoint_flat(path)
        if "tier/ids" in flat:
            for row, r in zip(flat["tier/ids"], flat["tier/ranks"]):
                t = _decode_id(row)
                if t:
                    self._dir[t] = int(r)
        for slot, t in self._tenant_of.items():
            self._dir.setdefault(t, int(self._slot_ranks[slot]))
        for t in list_shards(self.shard_dir):
            self._dir.setdefault(t, -1)
        for slot, t in sorted(self._tenant_of.items()):
            self._t1_put(t, self._extract_slot(slot),
                         int(self._slot_ranks[slot]), dirty=True)
        return step

    def _extract_slot(self, slot: int) -> dict:
        """A copy of one resident row as packed host tensors."""
        packed: dict = {}
        for prefix, (lead, _d_in, _d_out) in self.targets.items():
            pool = self._pools[prefix]
            packed[prefix] = {
                k: (pool[k][:, slot] if lead else pool[k][slot]).to(
                    self._host).clone(memory_format=torch.contiguous_format)
                for k in _SLOT_KEYS if k in pool}
        return packed
