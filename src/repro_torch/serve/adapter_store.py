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

Not ported yet: checkpoint save/load (ROADMAP A10) and the tiered store
(ROADMAP A10).
"""
from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

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


def _check_id(tenant: str) -> None:
    raw = tenant.encode("utf-8")
    if not raw or len(raw) > _ID_BYTES:
        raise ValueError(f"tenant id must be 1..{_ID_BYTES} utf-8 bytes, "
                         f"got {tenant!r}")


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

    def _f32(self, t) -> torch.Tensor:
        return torch.as_tensor(t).to(self.device, torch.float32).contiguous()

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
        return slot

    def install_batch(self, tenants) -> dict[str, int]:
        """Make every tenant resident and return ``{tenant: slot}``.  The
        flat store has one tier, so this is a recency-bumping lookup (a
        never-registered tenant raises KeyError)."""
        return {t: self.slot_of(t) for t in tenants}

    def prefetch(self, tenants) -> None:
        """Hint that ``tenants`` are queued: a no-op for the flat store
        (the tiered store, ROADMAP A10, loads their shards)."""

    def drain_prefetch(self) -> None:
        """No-op for the flat store."""

    def _pack_adapter(self, tenant: str, adapter: Params,
                      rank: int = 0) -> tuple[dict, int]:
        """Validate + pack one tenant's adapter into f32 leaves on the
        store's device, keyed ``{target_prefix: {pool_key: tensor}}``;
        returns (packed, true_rank)."""
        _check_id(tenant)
        packed, t_ranks = {}, set()
        for p in self.targets:
            packed[p], r_t = self._pack_one(p, adapter)
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

    def _pack_one(self, prefix: str, adapter: Params) -> tuple[dict, int]:
        """Pack one target's leaves for a slot; returns (leaves, rank)."""
        lead, d_in, d_out = self.targets[prefix]
        r = self.rank
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
            return {"pool_dB_mag": self._pad_rank(self._f32(db), -1)}, r_t
        if "lora_A" in sub:
            A, B = self._f32(sub["lora_A"]), self._f32(sub["lora_B"])
        elif "A_dir" in sub:
            a_dir = self._f32(sub["A_dir"])
            if "dA_dir" in sub:
                a_dir = a_dir + self._f32(sub["dA_dir"])
            b_mag = self._f32(sub["B_mag"])
            if "dB_mag" in sub:
                b_mag = b_mag + self._f32(sub["dB_mag"])
            A = self._f32(sub["A_mag"])[..., None] * a_dir
            B = b_mag[..., None] * self._f32(sub["B_dir"])
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

    def save(self, path: str, step: int = 0) -> None:
        raise NotImplementedError("AdapterStore checkpoints are not ported "
                                  "yet (ROADMAP A10)")

    def load(self, path: str) -> int:
        raise NotImplementedError("AdapterStore checkpoints are not ported "
                                  "yet (ROADMAP A10)")
