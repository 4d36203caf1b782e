"""Host-side metrics registry: counters / gauges / histograms (port of
``repro/obs/metrics.py``, kept line for line: the same bounds, snapshot
schema and Prometheus text for the same calls).

Every instrument carries *labeled series*: a single ``Counter`` named
``fed/comm_bytes`` holds one monotonically-increasing value per label
set (``method=lora, comm=psum`` vs ``method=lora_trimmed,
comm=all_gather``), so engines never pre-bake label combinations.
Labels are plain ``str -> str|int`` kwargs; a series key is the sorted
tuple of items, making label order irrelevant.

The registry is **pure host state**: no tensors, no device transfers.
Engines feed it host values (a tensor statistic is pulled to the host
only when telemetry is enabled).  ``snapshot()`` returns a plain-dict
schema, the same as the reference's, so the reference's report
(``launch/report.telemetry_section``) renders the port's files:

    {"counters":   {name: [{"labels": {...}, "value": float}, ...]},
     "gauges":     {name: [{"labels": {...}, "value": float}, ...]},
     "histograms": {name: [{"labels": {...}, "count": int, "sum": ...,
                            "min": ..., "max": ..., "buckets": {...}},
                           ...]}}

``NullRegistry`` implements the same surface as cheap no-ops; it is the
globally-installed sink when telemetry is disabled (see
``repro_torch.obs``), so instrumented call sites never branch beyond one
attribute lookup.
"""
from __future__ import annotations

import bisect
import threading

# Default histogram bucket upper bounds (inclusive), log-spaced so one
# set covers microsecond spans and multi-second rounds alike.  Values
# above the last bound land in the +Inf bucket.  The sub-ms decades
# matter: decode chunks and admission waits on a warm serve engine sit
# well under 1 ms, and a histogram whose first bound is 1 ms collapses
# them all into one bucket (p50 == p99 == "under a millisecond").
DEFAULT_BOUNDS = (
    0.00005, 0.0001, 0.00025, 0.0005,
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0,
)

# Serve-path latency bounds: denser sub-ms resolution, capped at 10 s —
# the ServeEngine/batcher hot spans (admission wait, prefill, decode
# chunk) thread these through ``obs.observe(..., bounds=...)`` so a 80 µs
# and a 600 µs chunk land in distinct buckets.
LATENCY_BOUNDS = (
    0.00001, 0.000025, 0.00005, 0.0001, 0.00025, 0.0005,
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


def _key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _labels(key: tuple) -> dict:
    return dict(key)


class Counter:
    """Monotonic per-series accumulator (``inc`` only)."""

    def __init__(self, name: str):
        self.name = name
        self._series: dict[tuple, float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        k = _key(labels)
        self._series[k] = self._series.get(k, 0.0) + float(value)

    def value(self, **labels) -> float:
        return self._series.get(_key(labels), 0.0)

    def snapshot(self) -> list[dict]:
        return [{"labels": _labels(k), "value": v}
                for k, v in sorted(self._series.items())]


class Gauge:
    """Last-write-wins per-series value (``set``)."""

    def __init__(self, name: str):
        self.name = name
        self._series: dict[tuple, float] = {}

    def set(self, value: float, **labels) -> None:
        self._series[_key(labels)] = float(value)

    def value(self, **labels) -> float:
        return self._series.get(_key(labels), 0.0)

    def snapshot(self) -> list[dict]:
        return [{"labels": _labels(k), "value": v}
                for k, v in sorted(self._series.items())]


class _HistSeries:
    __slots__ = ("count", "sum", "min", "max", "bucket_counts")

    def __init__(self, n_buckets: int):
        self.count = 0
        self.sum = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.bucket_counts = [0] * (n_buckets + 1)  # +1 for +Inf


class Histogram:
    """Per-series distribution: count/sum/min/max + bucket counts."""

    def __init__(self, name: str, bounds: tuple[float, ...] = DEFAULT_BOUNDS):
        self.name = name
        self.bounds = tuple(bounds)
        self._series: dict[tuple, _HistSeries] = {}

    def observe(self, value: float, **labels) -> None:
        k = _key(labels)
        s = self._series.get(k)
        if s is None:
            s = self._series[k] = _HistSeries(len(self.bounds))
        value = float(value)
        s.count += 1
        s.sum += value
        if value < s.min:
            s.min = value
        if value > s.max:
            s.max = value
        s.bucket_counts[bisect.bisect_left(self.bounds, value)] += 1

    def series(self, **labels) -> _HistSeries | None:
        return self._series.get(_key(labels))

    def snapshot(self) -> list[dict]:
        out = []
        for k, s in sorted(self._series.items()):
            buckets = {}
            for bound, c in zip(self.bounds, s.bucket_counts):
                if c:
                    buckets[f"le_{bound:g}"] = c
            if s.bucket_counts[-1]:
                buckets["le_inf"] = s.bucket_counts[-1]
            out.append({"labels": _labels(k), "count": s.count,
                        "sum": s.sum, "min": s.min, "max": s.max,
                        "mean": s.sum / max(s.count, 1),
                        "buckets": buckets})
        return out


class MetricsRegistry:
    """Get-or-create registry of named instruments.

    Thread-safe at the instrument-creation level (the serve engine and a
    background personalization loop may both first-touch a metric); the
    per-observation path is a plain dict update, which is atomic enough
    under the GIL for the host-side counters this registry holds.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name, Counter(name))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name))
        return g

    def histogram(self, name: str,
                  bounds: tuple[float, ...] = DEFAULT_BOUNDS) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(name, Histogram(name, bounds))
        return h

    def snapshot(self) -> dict:
        return {
            "counters": {n: c.snapshot()
                         for n, c in sorted(self._counters.items())},
            "gauges": {n: g.snapshot()
                       for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.snapshot()
                           for n, h in sorted(self._histograms.items())},
        }

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


class _NullInstrument:
    """Absorbs any instrument method call at one attribute lookup."""

    __slots__ = ()

    def inc(self, value=1.0, **labels):
        pass

    def set(self, value, **labels):
        pass

    def observe(self, value, **labels):
        pass

    def value(self, **labels):
        return 0.0

    def series(self, **labels):
        return None

    def snapshot(self):
        return []


_NULL_INSTRUMENT = _NullInstrument()


class NullRegistry:
    """Disabled-telemetry sink: every instrument is the shared no-op."""

    def counter(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def gauge(self, name: str) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def histogram(self, name: str, bounds=DEFAULT_BOUNDS) -> _NullInstrument:
        return _NULL_INSTRUMENT

    def snapshot(self) -> dict:
        return {"counters": {}, "gauges": {}, "histograms": {}}

    def reset(self) -> None:
        pass


# ---------------------------------------------------------------------------
# Prometheus text exposition
# ---------------------------------------------------------------------------

def _prom_name(name: str) -> str:
    """Metric names here are slash-namespaced (``fed/comm_bytes``);
    Prometheus names admit only ``[a-zA-Z_:][a-zA-Z0-9_:]*``."""
    out = "".join(c if (c.isalnum() or c in "_:") else "_" for c in name)
    if out and out[0].isdigit():
        out = "_" + out
    return "repro_" + out


def _prom_labels(labels: dict, extra: tuple = ()) -> str:
    items = sorted(labels.items()) + list(extra)
    if not items:
        return ""
    body = ",".join(
        '{}="{}"'.format(k, str(v).replace("\\", r"\\").replace('"', r'\"'))
        for k, v in items)
    return "{" + body + "}"


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


def to_prometheus(snapshot: dict) -> str:
    """Render a ``MetricsRegistry.snapshot()`` as Prometheus text
    exposition format (version 0.0.4) — counters/gauges verbatim,
    histograms as cumulative ``_bucket{le=...}`` series plus ``_sum`` /
    ``_count``.  Pure function of the snapshot dict, so the serve loop's
    ``REPRO_PROM_PATH`` hook and offline converters share one encoder."""
    lines: list[str] = []
    for name, series in snapshot.get("counters", {}).items():
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} counter")
        for s in series:
            lines.append(f"{pn}{_prom_labels(s['labels'])} "
                         f"{_fmt(s['value'])}")
    for name, series in snapshot.get("gauges", {}).items():
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        for s in series:
            lines.append(f"{pn}{_prom_labels(s['labels'])} "
                         f"{_fmt(s['value'])}")
    for name, series in snapshot.get("histograms", {}).items():
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} histogram")
        for s in series:
            # snapshot buckets are sparse per-bucket counts keyed
            # "le_{bound:g}" / "le_inf"; prometheus wants cumulative
            finite = sorted(
                (float(k[3:]), c) for k, c in s["buckets"].items()
                if k != "le_inf")
            cum = 0
            for bound, c in finite:
                cum += c
                lines.append(
                    f"{pn}_bucket{_prom_labels(s['labels'], (('le', f'{bound:g}'),))} "
                    f"{cum}")
            lines.append(
                f"{pn}_bucket{_prom_labels(s['labels'], (('le', '+Inf'),))} "
                f"{s['count']}")
            lines.append(f"{pn}_sum{_prom_labels(s['labels'])} "
                         f"{_fmt(s['sum'])}")
            lines.append(f"{pn}_count{_prom_labels(s['labels'])} "
                         f"{s['count']}")
    return "\n".join(lines) + ("\n" if lines else "")
