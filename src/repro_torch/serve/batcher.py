"""Continuous batcher: tenant-tagged requests → rows of a mixed batch.

The port's copy of ``repro/serve/batcher.py`` (pure numpy).  Requests
queue FIFO; whenever engine rows free up (retired sequences), the
batcher admits waiting requests into them.  Admission is what makes the
batch *mixed*: rows of different tenants, admitted at different times
and so at different sequence positions, decode together in one forward
pass with per-row ``adapter_idx`` and per-row cache positions.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np


@dataclasses.dataclass
class Request:
    rid: int
    tenant: str
    tokens: np.ndarray            # (prompt_len,) int32
    n_new: int
    # host clock at submit (perf_counter seconds), for the admission-wait
    # histogram; one clock read a request, stamped unconditionally
    submit_ts: float = 0.0


class ContinuousBatcher:
    def __init__(self, max_rows: int, max_prompt_len: int, max_len: int):
        self.max_rows = max_rows
        self.max_prompt_len = max_prompt_len
        self.max_len = max_len
        self._queue: deque[Request] = deque()
        self._next_rid = 0

    def submit(self, tenant: str, tokens, n_new: int) -> int:
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if not 0 < tokens.size <= self.max_prompt_len:
            raise ValueError(f"prompt length {tokens.size} outside "
                             f"(0, {self.max_prompt_len}]")
        if n_new < 1 or tokens.size + n_new > self.max_len:
            raise ValueError(f"prompt {tokens.size} + n_new {n_new} exceeds "
                             f"max_len {self.max_len}")
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append(Request(rid, tenant, tokens, n_new,
                                   submit_ts=time.perf_counter()))
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue)

    def queued_tenants(self, limit: Optional[int] = None) -> list[str]:
        """Distinct tenants with queued requests, in FIFO order (the
        empty-string pseudo-tenant is excluded).  ``limit`` caps the
        number of REQUESTS scanned, not tenants."""
        seen: list[str] = []
        for i, req in enumerate(self._queue):
            if limit is not None and i >= limit:
                break
            if req.tenant and req.tenant not in seen:
                seen.append(req.tenant)
        return seen

    def admit(self, free_rows: list[int]) -> list[tuple[int, Request]]:
        """Pop up to len(free_rows) queued requests, FIFO, pairing each
        with a free row index."""
        admitted = []
        for row in free_rows:
            if not self._queue:
                break
            admitted.append((row, self._queue.popleft()))
        return admitted

    def pack_prompts(self, admitted: list[tuple[int, Request]],
                     slots: dict[int, int], null_slot: int,
                     active_slots: Optional[np.ndarray] = None):
        """Build the fixed-shape (max_rows, max_prompt_len) prefill inputs:
        token matrix (pads at the *end* — causality keeps them invisible
        to real tokens), per-row prompt lengths, and per-row adapter
        slots (active rows keep theirs; idle rows point at the null
        slot)."""
        R, W = self.max_rows, self.max_prompt_len
        tokens = np.zeros((R, W), np.int32)
        lens = np.ones((R,), np.int32)
        out_slots = (np.full((R,), null_slot, np.int32)
                     if active_slots is None else
                     np.asarray(active_slots, np.int32).copy())
        for row, req in admitted:
            n = req.tokens.size
            tokens[row, :n] = req.tokens
            lens[row] = n
            out_slots[row] = slots[req.rid]
        return tokens, lens, out_slots
