"""Runtime sanitizer — the dynamic half of repro_torch.lint (port of
``repro/lint/sanitize.py``).

``nan_guard`` walks a tree on the host and raises on the first
non-finite leaf, naming every offending path (a NaN that surfaces five
ops downstream of where it was born is the classic week-long hunt).
It reads each floating tensor's values, a host sync, so it is a tool
for tests and debugging sessions, never for engine hot paths.  A meta
tensor holds no values and is passed over.

The reference's ``tracked`` PRNG-key reuse detector has no counterpart:
the port draws from ``torch.Generator`` streams, not threefry keys.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from repro_torch.utils import pytree as pt


class NonFiniteError(ValueError):
    """A guarded tree contained NaN/Inf leaves."""

    def __init__(self, name: str, bad: list[str]):
        self.name = name
        self.bad_paths = bad
        super().__init__(
            f"nan_guard({name!r}): non-finite values in {len(bad)} "
            f"leaf/leaves: " + ", ".join(bad[:8])
            + (" …" if len(bad) > 8 else ""))


def _finite(leaf) -> bool:
    """False if ``leaf`` is a floating or complex array holding NaN/Inf;
    True for anything else (a non-array leaf, a meta tensor)."""
    if torch.is_tensor(leaf):
        if leaf.device.type == "meta" or not (
                leaf.is_floating_point() or leaf.is_complex()):
            return True
        return bool(torch.isfinite(leaf.detach()).all())
    try:
        arr = np.asarray(leaf)
    except TypeError:
        return True                            # non-array leaf (config &c)
    return not (arr.dtype.kind in "fc" and not np.isfinite(arr).all())


def nan_guard(tree: Any, name: str = "tree") -> Any:
    """Raise ``NonFiniteError`` if any array leaf of ``tree`` holds
    NaN/Inf; returns ``tree`` unchanged otherwise (so it chains:
    ``params = nan_guard(step(params), "params")``)."""
    bad = sorted(p for p, leaf in pt.tree_leaves_with_path(tree)
                 if not _finite(leaf))
    if bad:
        raise NonFiniteError(name, bad)
    return tree


def guard(name: str = "result") -> Callable:
    """Decorator form: ``@guard("grads")`` nan-guards the return value."""
    def deco(fn: Callable) -> Callable:
        def wrapped(*args, **kwargs):
            return nan_guard(fn(*args, **kwargs), name)
        wrapped.__name__ = getattr(fn, "__name__", "wrapped")
        return wrapped
    return deco
