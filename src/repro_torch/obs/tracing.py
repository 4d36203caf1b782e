"""Span timers and torch-profiler naming wrappers (port of
``repro/obs/tracing.py``).

Three layers, all safe to leave in production call sites:

* ``span(name, **labels)`` — host wall-clock context manager.  When
  telemetry is enabled it records the elapsed seconds into the
  ``span_seconds`` histogram (label ``span=<name>`` plus any extras)
  and opens a ``torch.profiler.record_function`` so the region shows up
  named in a captured trace.  When disabled it degrades to a bare
  ``yield``: no clock read, no profiler call.

  ``span`` does NOT wait for the device: callers that want the span to
  cover device work synchronize inside it (the instrumented engines do
  so only when telemetry is enabled, so the disabled path adds no sync).

* ``named_scope(name)`` — names the kernels launched inside it in a
  profiler trace (the reference's ``jax.named_scope`` around BGMV and
  the quantized matmul).  In JAX that scope is metadata of a compiled
  program and costs nothing at run time; in eager PyTorch a
  ``record_function`` costs a dispatcher call (several µs) on every
  launch, and decode launches ``bgmv_mag`` 64 times a step.  So the
  scope enters ``record_function`` only when telemetry is enabled or a
  torch profiler is recording, and is a shared no-op context otherwise.

* ``annotate(name)`` — decorator wrapping a function in the same gated
  ``record_function`` (the reference names its jitted programs this
  way).
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch

import repro_torch.obs as _obs   # late-bound: obs imports this module

_NO_SCOPE = contextlib.nullcontext()


def _profiling() -> bool:
    """True while a torch profiler (autograd or kineto) is recording."""
    return torch._C._autograd._profiler_enabled()


def named_scope(name: str):
    """A ``record_function(name)`` context when telemetry is enabled or
    a profiler records, else a no-op context."""
    if _obs._active.live or _profiling():
        return torch.profiler.record_function(name)
    return _NO_SCOPE


def annotate(name: str):
    """Decorator: run ``fn`` inside ``named_scope(name)``."""
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*args, **kwargs):
            with named_scope(name):
                return fn(*args, **kwargs)
        return wrapped
    return deco


@contextlib.contextmanager
def span(name: str, **labels):
    """Time a host-side region into the ``span_seconds`` histogram."""
    tel = _obs._active
    if not tel.live:
        yield
        return
    with torch.profiler.record_function(name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            tel.metrics.histogram("span_seconds").observe(dt, span=name,
                                                          **labels)
