"""Structured JSONL event sink with size-based rotation (port of
``repro/obs/events.py``: the same lines, but for ``ts``, for the same
calls).

One event per line: ``{"ts": <unix seconds>, "kind": "...", ...fields}``.
Kinds emitted by the instrumented engines (the reference's catalog in
docs/observability.md):

    fed_round          per-round summary from FedSim
    fed_stage          stage-2 / stage-3 summaries
    fed_cohort         per-round cohort summary from CohortSim
    serve_run          end-of-run serving summary
    serve_admit        request admitted to a batch row
    pool_register / pool_evict / pool_promote / pool_prefetch
                       AdapterStore slot churn and tier movement
    ckpt_save / ckpt_restore / ckpt_migrate   checkpoint traffic
    compile            first execution of a program in an engine
    metrics_snapshot   full MetricsRegistry dump (run epilogue)

Values must be JSON-serializable; ``_coerce`` turns numpy scalars and
arrays, 0-d tensors and CPU tensors that slip through into Python values
(a tensor with more than one element on the card is refused: a call site
pulls it to the host on purpose, never by accident).  The sink is not
thread-safe: engines emit from their serving thread only.

Rotation: when the live file would exceed ``max_bytes`` the sink
renames ``path -> path.1`` (shifting ``path.1 -> path.2`` ... up to
``keep``) and starts fresh, so long serve runs cannot fill a disk.
``read_events`` re-joins rotated segments oldest-first.
"""
from __future__ import annotations

import json
import os
import time

import torch


class EventLog:
    def __init__(self, path: str, *, max_bytes: int = 8 * 1024 * 1024,
                 keep: int = 3):
        self.path = str(path)
        self.max_bytes = int(max_bytes)
        self.keep = int(keep)
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = self._fh.tell()

    def emit(self, kind: str, **fields) -> None:
        rec = {"ts": round(time.time(), 3), "kind": kind}
        rec.update(fields)
        line = json.dumps(rec, sort_keys=False, default=_coerce) + "\n"
        if self._size + len(line) > self.max_bytes and self._size > 0:
            self._rotate()
        # no flush here: the file object's block buffering batches the
        # write syscalls (per-event flush is measurable on the serve hot
        # loop); close()/rotation/``flush()`` drain the buffer, and
        # ``emit_snapshot`` flushes as the run epilogue
        self._fh.write(line)
        self._size += len(line)

    def flush(self) -> None:
        self._fh.flush()

    def _rotate(self) -> None:
        self._fh.close()
        for i in range(self.keep - 1, 0, -1):
            src, dst = f"{self.path}.{i}", f"{self.path}.{i + 1}"
            if os.path.exists(src):
                os.replace(src, dst)
        if self.keep > 0:
            os.replace(self.path, f"{self.path}.1")
        else:
            os.remove(self.path)
        self._fh = open(self.path, "a", encoding="utf-8")
        self._size = 0

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()


class NullEventLog:
    """Disabled-telemetry sink: ``emit`` is a no-op."""

    path = None

    def emit(self, kind: str, **fields) -> None:
        pass

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def _coerce(obj):
    """JSON fallback for numpy scalars / arrays and tensors that slip
    through: a 0-d tensor gives its Python value, a CPU tensor its
    (nested) list."""
    if torch.is_tensor(obj):
        if obj.dim() == 0:
            return obj.item()
        if obj.device.type != "cpu":
            raise TypeError(f"not JSON-serializable: a {tuple(obj.shape)} "
                            f"tensor on {obj.device} (pull it to the host "
                            f"first)")
        return obj.tolist()
    if hasattr(obj, "tolist"):
        return obj.tolist()
    if hasattr(obj, "item"):
        return obj.item()
    raise TypeError(f"not JSON-serializable: {type(obj)!r}")


def read_events(path: str, *, kind: str | None = None) -> list[dict]:
    """All events at ``path`` (rotated segments first), oldest-first."""
    segments = []
    i = 1
    while os.path.exists(f"{path}.{i}"):
        segments.append(f"{path}.{i}")
        i += 1
    segments.reverse()  # path.N is oldest
    if os.path.exists(path):
        segments.append(path)
    out = []
    for seg in segments:
        with open(seg, encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                rec = json.loads(line)
                if kind is None or rec.get("kind") == kind:
                    out.append(rec)
    return out
