"""repro_torch.obs — fleet telemetry: metrics, tracing, structured events
(port of ``repro/obs``; the port keeps its own copy and imports nothing
of the reference).

Global-sink design: exactly one ``Telemetry`` is active per process.
By default it is the **null** telemetry — a ``NullRegistry`` plus a
``NullEventLog`` whose every method is a no-op — so instrumented call
sites cost one attribute lookup when observability is off, read no
clock, enter no ``torch.profiler.record_function`` and add no device
sync (held by ``tests/test_torch_obs.py``).  ``enable()`` swaps in a
live registry / event log; ``disable()`` swaps the null one back.

    from repro_torch import obs
    tel = obs.enable(event_path="run/telemetry.jsonl")
    ... run engines ...
    obs.emit_snapshot()           # dump metrics into the JSONL epilogue
    obs.disable()

Engines read the sink through ``obs.active()`` (or the module-level
helpers ``inc`` / ``set_gauge`` / ``observe`` / ``event``) at call time,
never caching it across rounds, so enabling mid-process works.
"""
from __future__ import annotations

from repro_torch.obs.events import EventLog, NullEventLog, read_events
from repro_torch.obs.metrics import (DEFAULT_BOUNDS, LATENCY_BOUNDS,
                               MetricsRegistry, NullRegistry, to_prometheus)
from repro_torch.obs.tracing import annotate, named_scope, span

__all__ = [
    "Telemetry", "enable", "disable", "enabled", "active",
    "inc", "set_gauge", "observe", "event", "emit_snapshot",
    "MetricsRegistry", "NullRegistry", "EventLog", "NullEventLog",
    "read_events", "span", "annotate", "named_scope",
    "DEFAULT_BOUNDS", "LATENCY_BOUNDS", "to_prometheus",
]


class Telemetry:
    """A metrics registry paired with an event sink."""

    def __init__(self, metrics, events, *, live: bool):
        self.metrics = metrics
        self.events = events
        self.live = live

    def close(self) -> None:
        self.events.close()


_NULL = Telemetry(NullRegistry(), NullEventLog(), live=False)
_active = _NULL


def enable(event_path: str | None = None, *,
           max_bytes: int = 8 * 1024 * 1024, keep: int = 3) -> Telemetry:
    """Install a live telemetry sink (idempotent: replaces the current
    one, closing its event log).  ``event_path=None`` keeps metrics but
    drops events (useful in tests that only assert on the registry)."""
    global _active
    if _active.live:
        _active.close()
    events = (EventLog(event_path, max_bytes=max_bytes, keep=keep)
              if event_path is not None else NullEventLog())
    _active = Telemetry(MetricsRegistry(), events, live=True)
    return _active


def disable() -> None:
    """Swap the null sink back in (closing the live event log)."""
    global _active
    if _active.live:
        _active.close()
    _active = _NULL


def enabled() -> bool:
    return _active.live


def active() -> Telemetry:
    return _active


# -- call-site helpers -------------------------------------------------------

def inc(name: str, value: float = 1.0, **labels) -> None:
    _active.metrics.counter(name).inc(value, **labels)


def set_gauge(name: str, value: float, **labels) -> None:
    _active.metrics.gauge(name).set(value, **labels)


def observe(name: str, value: float, bounds: tuple | None = None,
            **labels) -> None:
    """Record one histogram observation.  ``bounds`` sets the bucket
    upper bounds on the histogram's *first* creation (latency-class call
    sites pass ``obs.LATENCY_BOUNDS`` for sub-ms resolution); later
    calls — with or without bounds — share the existing instrument, per
    the registry's first-creation-wins contract."""
    h = (_active.metrics.histogram(name, bounds) if bounds is not None
         else _active.metrics.histogram(name))
    h.observe(value, **labels)


def event(kind: str, **fields) -> None:
    _active.events.emit(kind, **fields)


def emit_snapshot() -> dict:
    """Dump the full metrics snapshot as a ``metrics_snapshot`` event
    (the run epilogue that ``telemetry_section`` renders) and return it."""
    snap = _active.metrics.snapshot()
    _active.events.emit("metrics_snapshot", snapshot=snap)
    _active.events.flush()
    return snap
