"""Multi-tenant serving engine: one mixed batch, never-merged adapters.

Port of ``repro/serve/engine.py``.  The engine keeps a persistent batch
of ``max_rows`` rows over one frozen backbone merged (dict-merge, no
tensor copies) with the AdapterStore's pooled overlay.  Each row carries
its own adapter slot (``adapter_idx``) and its own sequence position, so
tenants mix freely in a single forward pass — the BGMV kernels in
``layers.linear`` gather each row's adapter from the pool instead of
folding it into the weights.  With ``cfg.backbone_quant`` the backbone
is quantized once, at construction (``quantize_backbone``), and every
projection then runs the dequant-fused ``quant_matmul`` kernel.

Two steps cover the serving loop, both at fixed shapes:

  prefill   full-width (R, W) forward over newly admitted rows (idle
            rows compute throwaway work; only the admitted rows' cache
            rows are copied into the persistent cache) → first greedy
            token per row, from hidden[row, len-1]
  decode    a loop of ``decode_chunk`` single-token steps with per-row
            cache positions; retired rows freeze (their writes are
            idempotent) until re-admission overwrites them

Between chunks the host retires finished rows and lets the batcher
admit queued requests into the free rows — continuous batching at
chunk granularity, with one host sync per prefill and per chunk.

Telemetry (``repro_torch.obs``), at the reference's sites with its
names: the ``serve/requests`` and ``serve/completed`` counters per
tenant, the queue-depth, slot-occupancy and null-slot gauges (sampled
at admit and retire), the admission-wait, prefill, decode-chunk and
tokens/s histograms and ``span_seconds`` of ``serve/prefill`` and
``serve/decode_chunk`` (timed from the host syncs the loop makes
anyway), the ``serve_admit``, ``compile`` (the first call of each step
in this engine, which on the card includes the lazy kernel build) and
``serve_run`` events, and the ``REPRO_PROM_PATH`` Prometheus textfile,
written atomically after each run.  All of it only while ``obs`` is
enabled; the two steps are named in profiler traces by ``obs.annotate``.
"""
from __future__ import annotations

import os
import time
from typing import Any

import numpy as np
import torch

from repro_torch import obs
from repro_torch.device import check_on, resolve_device
from repro_torch.models import model as M
from repro_torch.models.config import ArchConfig
from repro_torch.serve.adapter_store import AdapterStore
from repro_torch.serve.batcher import ContinuousBatcher
from repro_torch.utils import pytree as pt

Params = Any


def _merge_cache_rows(old, new, rows):
    """Copy cache rows ``rows`` ((n,) int64) of ``new`` into ``old`` in
    place.  Batch sits at axis 1 under the stacked ``blocks`` (leading
    superblock axis) and axis 0 in the unstacked ``tail``."""
    for path in pt.tree_paths(old["blocks"]):
        o, n = pt.tree_get(old["blocks"], path), pt.tree_get(new["blocks"], path)
        o[:, rows] = n[:, rows]
    for path in pt.tree_paths(old["tail"]):
        o, n = pt.tree_get(old["tail"], path), pt.tree_get(new["tail"], path)
        o[rows] = n[rows]
    return old


class ServeEngine:
    def __init__(self, base: Params, cfg: ArchConfig, store: AdapterStore, *,
                 max_rows: int = 8, max_prompt_len: int = 32,
                 max_len: int = 64, decode_chunk: int = 8, device="cuda"):
        if cfg.family not in ("dense", "moe") or cfg.n_enc_layers:
            raise ValueError(f"ServeEngine supports attention-cache "
                             f"families, got {cfg.family!r}")
        if cfg.sliding_window or cfg.local_global:
            raise ValueError("sliding-window (local) attention is not "
                             "supported by ServeEngine yet")
        self.device = resolve_device(device)
        check_on(base["embed"]["embedding"], self.device, "base params")
        if store.device != self.device:
            raise ValueError(f"store is on {store.device}, engine on "
                             f"{self.device}")
        if cfg.backbone_quant:
            # the frozen backbone is quantized once, here, and only the
            # quantized tree is kept; the per-tenant pool deltas stay full
            # precision on top, so one pass serves every tenant
            from repro_torch.kernels import quantize_backbone
            base = quantize_backbone(base, cfg.backbone_quant,
                                     group_size=cfg.backbone_quant_group)
        self.base, self.cfg, self.store = base, cfg, store
        self.max_rows = max_rows
        self.max_len = max_len
        self.decode_chunk = decode_chunk
        self.batcher = ContinuousBatcher(max_rows, max_prompt_len, max_len)
        self._tenant_of_rid: dict[int, str] = {}
        self._params_cache: tuple[int, Params] | None = None
        self._compiled: set[str] = set()   # compile-event bookkeeping
        # counts and host-clock seconds of the latest run(); each timed
        # step ends in the host sync the loop makes anyway
        self.last_run: dict = {}

    def _merged_params(self) -> Params:
        """Backbone ∪ pool overlay, rebuilt only when the store's pools
        changed (keyed on ``store.version``)."""
        if (self._params_cache is None
                or self._params_cache[0] != self.store.version):
            self._params_cache = (self.store.version,
                                  pt.merge_trees(self.base,
                                                 self.store.overlay()))
        return self._params_cache[1]

    def _tensor(self, a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    @obs.annotate("serve/prefill")
    def _prefill(self, params, cache, tokens, lens, slots, rows):
        """Full-width prefill; copies the admitted ``rows`` of the fresh
        cache into ``cache`` and returns the first greedy token per row."""
        batch = {"tokens": self._tensor(tokens, torch.int64),
                 "adapter_idx": self._tensor(slots, torch.int32)}
        hidden, fresh, _ = M.forward(params, batch, self.cfg,
                                     return_cache=True, cache_len=self.max_len)
        ar = torch.arange(hidden.shape[0], device=self.device)
        last = hidden[ar, self._tensor(lens, torch.int64) - 1]
        logits = (last @ M._head_kernel(params, self.cfg).to(last.dtype)
                  ).float()
        _merge_cache_rows(cache, fresh, self._tensor(rows, torch.int64))
        return M.argmax_first(logits)

    @obs.annotate("serve/decode_chunk")
    def _decode_chunk(self, params, cache, tok, pos, slots, active):
        """``decode_chunk`` greedy steps; retired rows keep their token and
        position.  Returns (tok, pos, toks (chunk, R))."""
        step = active.to(torch.int32)
        toks = []
        for _ in range(self.decode_chunk):
            logits, cache = M.decode_step(params, tok, cache, pos, self.cfg,
                                          adapter_idx=slots)
            tok = torch.where(active, M.argmax_first(logits), tok)
            pos = pos + step
            toks.append(tok)
        return tok, pos, torch.stack(toks)

    # ------------------------------------------------------------------

    def submit(self, tenant: str, tokens, n_new: int) -> int:
        """Queue one request.  The tenant must be registered in the store
        (or be the empty-adapter pseudo-tenant None)."""
        if tenant is not None and tenant not in self.store:
            raise KeyError(f"tenant {tenant!r} not registered in the store")
        rid = self.batcher.submit(tenant or "", tokens, n_new)
        self._tenant_of_rid[rid] = tenant
        if obs.enabled():
            obs.inc("serve/requests", tenant=tenant or "<none>")
            obs.set_gauge("serve/queue_depth", self.batcher.pending)
        return rid

    def run(self) -> dict[int, np.ndarray]:
        """Drain the queue, returning {rid: generated tokens (n_new,)}.
        Adapter slots are snapshotted per admission — register/evict
        between ``run`` calls, not during one."""
        cfg, R, dev = self.cfg, self.max_rows, self.device
        null = self.store.null_slot
        params = self._merged_params()
        cache = M.init_cache(cfg, R, self.max_len, device=dev)
        stats = {"prefills": 0, "decode_steps": 0, "tokens": 0,
                 "prefill_seconds": [], "chunk_seconds": []}
        t_run = time.perf_counter()
        # telemetry is sampled once a run; every obs call below is behind
        # ``if enabled`` and reuses the loop's own clock reads
        enabled = obs.enabled()

        active = np.zeros((R,), bool)
        pos = torch.zeros((R,), dtype=torch.int32, device=dev)
        tok = torch.zeros((R,), dtype=torch.int64, device=dev)
        row_slots = np.full((R,), null, np.int32)
        remaining = np.zeros((R,), np.int64)
        rid_of_row = np.full((R,), -1, np.int64)
        outputs: dict[int, list[int]] = {}
        results: dict[int, np.ndarray] = {}

        def gauges():
            # batch composition changes only at admit and retire
            obs.set_gauge("serve/queue_depth", self.batcher.pending)
            obs.set_gauge("serve/slot_occupancy", float(active.mean()))
            obs.set_gauge("serve/null_slot_fraction",
                          float((row_slots == null).mean()))

        def retire(row):
            rid = int(rid_of_row[row])
            results[rid] = np.asarray(outputs.pop(rid), np.int32)
            tenant = self._tenant_of_rid.pop(rid, None)
            active[row] = False
            row_slots[row] = null
            if enabled:
                obs.inc("serve/completed", tenant=tenant or "<none>")
                gauges()

        while self.batcher.pending or active.any():
            free = [r for r in range(R) if not active[r]]
            admitted = self.batcher.admit(free)
            if admitted:
                if enabled:
                    now = time.perf_counter()
                    for row, req in admitted:
                        wait = now - req.submit_ts
                        obs.observe("serve/admission_wait_seconds", wait,
                                    bounds=obs.LATENCY_BOUNDS,
                                    tenant=req.tenant or "<none>")
                        obs.event("serve_admit", rid=req.rid,
                                  tenant=req.tenant or None, row=row,
                                  wait=round(wait, 6),
                                  queue_depth=self.batcher.pending)
                tenant = {req.rid: self._tenant_of_rid[req.rid]
                          for _, req in admitted}
                # one install for every admitted tenant: the active rows'
                # tenants are pinned (their slots are serving) and the
                # front of the queue steers the victim choice
                still_active = {self._tenant_of_rid[int(rid_of_row[r])]
                                for r in range(R) if active[r]} - {None}
                installed = self.store.install_batch(
                    [t for t in tenant.values() if t is not None],
                    pinned=still_active,
                    queued=self.batcher.queued_tenants(limit=2 * R))
                slot_of_rid = {rid: null if t is None else installed[t]
                               for rid, t in tenant.items()}
                params = self._merged_params()
                tokens, lens, row_slots = self.batcher.pack_prompts(
                    admitted, slot_of_rid, null, row_slots)
                rows = [row for row, _ in admitted]
                t0 = time.perf_counter()
                tok0 = self._prefill(params, cache, tokens, lens, row_slots,
                                     rows)
                tok0_h = tok0.cpu().numpy()
                dt = time.perf_counter() - t0
                stats["prefill_seconds"].append(dt)
                stats["prefills"] += 1
                if enabled:
                    self._compile_event("prefill", dt)
                    obs.observe("serve/prefill_seconds", dt,
                                bounds=obs.LATENCY_BOUNDS)
                    obs.observe("span_seconds", dt, span="serve/prefill")
                    gauges()
                admit_mask = np.zeros((R,), bool)
                admit_mask[rows] = True
                tok = torch.where(self._tensor(admit_mask, torch.bool),
                                  tok0, tok)
                new_pos = pos.cpu().numpy().copy()
                for row, req in admitted:
                    active[row] = True
                    new_pos[row] = req.tokens.size
                    remaining[row] = req.n_new - 1
                    rid_of_row[row] = req.rid
                    outputs[req.rid] = [int(tok0_h[row])]
                    if remaining[row] == 0:
                        retire(row)
                pos = self._tensor(new_pos, torch.int32)

            if active.any():
                n_active = int(active.sum())
                # queued tenants' adapters may load while the chunk runs
                # (flat store: no-op)
                self.store.prefetch(self.batcher.queued_tenants(limit=2 * R))
                t0 = time.perf_counter()
                tok, pos, toks = self._decode_chunk(
                    params, cache, tok, pos,
                    self._tensor(row_slots, torch.int32),
                    self._tensor(active, torch.bool))
                toks_h = toks.cpu().numpy()                 # (chunk, R)
                self.store.drain_prefetch()
                dt = time.perf_counter() - t0
                stats["chunk_seconds"].append(dt)
                stats["decode_steps"] += self.decode_chunk
                if enabled:
                    self._compile_event("decode_chunk", dt)
                    obs.observe("serve/decode_chunk_seconds", dt,
                                bounds=obs.LATENCY_BOUNDS)
                    obs.observe("span_seconds", dt, span="serve/decode_chunk")
                    obs.observe("serve/chunk_tokens_per_s",
                                n_active * self.decode_chunk / max(dt, 1e-9))
                for row in range(R):
                    if not active[row]:
                        continue
                    take = int(min(self.decode_chunk, remaining[row]))
                    outputs[int(rid_of_row[row])].extend(
                        toks_h[:take, row].tolist())
                    remaining[row] -= take
                    if remaining[row] == 0:
                        retire(row)
        stats["wall_seconds"] = time.perf_counter() - t_run
        stats["tokens"] = int(sum(v.size for v in results.values()))
        self.last_run = stats
        if enabled:
            self._run_epilogue(stats, len(results), gauges)
        return results

    def _compile_event(self, program: str, dt: float) -> None:
        """The ``compile`` event of a step's first call in this engine."""
        if program not in self._compiled:
            self._compiled.add(program)
            obs.event("compile", program=f"serve/{program}",
                      wall=round(dt, 6))

    def _run_epilogue(self, stats: dict, n_requests: int, gauges) -> None:
        """The ``serve_run`` event, and the Prometheus textfile when
        ``REPRO_PROM_PATH`` names one (written to a temporary file and
        renamed, so a scrape never reads a torn file)."""
        wall, toks = stats["wall_seconds"], stats["tokens"]
        gauges()
        obs.event("serve_run", requests=n_requests, tokens=toks,
                  wall=round(wall, 6),
                  tokens_per_s=round(toks / max(wall, 1e-9), 2),
                  chunks=len(stats["chunk_seconds"]),
                  prefills=stats["prefills"], rows=self.max_rows,
                  decode_chunk=self.decode_chunk)
        prom_path = os.environ.get("REPRO_PROM_PATH")
        if prom_path:
            text = obs.to_prometheus(obs.active().metrics.snapshot())
            tmp = prom_path + ".tmp"
            with open(tmp, "w") as f:
                f.write(text)
            os.replace(tmp, prom_path)

    def generate(self, requests, n_new: int = 16) -> list[np.ndarray]:
        """Convenience: ``requests`` is a list of (tenant, prompt_tokens);
        returns generated tokens per request, in order — one mixed batch
        across all tenants."""
        rids = [self.submit(tenant, toks, n_new) for tenant, toks in requests]
        results = self.run()
        return [results[rid] for rid in rids]
