"""msgpack tree checkpoints (port of ``repro/checkpoint/ckpt.py``).

A checkpoint is one msgpack map ``{"step": int, "leaves": {path:
record}}``; each leaf record is ``{"d": dtype, "s": shape, "b": raw
bytes}``, ``dtype`` being ``numpy.dtype.str`` (``"<f4"``, ``"|b1"``,
...) or ``"__bf16__"`` for bfloat16, written as its uint16 bits.  The
files are byte-identical to the JAX package's for the same tree: leaves
go in the order ``jax.tree_util.tree_leaves_with_path`` gives, which
sorts the keys of every dict level (``{"z", "a": {"y", "b"}}`` writes
``a/b, a/y, z``), and ``checkpoint/msgpack_codec.py`` writes msgpack's
smallest forms as the ``msgpack`` package does.  Either package restores
the other's files bit for bit.

Trees are nested dicts whose leaves are tensors (on any device), numpy
arrays or Python numbers; a ``None`` leaf is an empty subtree.  Saving
streams: each leaf is copied to the host and written on its own, so the
host holds one leaf at a time.  Loading reads the file once and decodes
it over slices of that buffer.

Where the port differs from the reference:
- ``restore_checkpoint`` takes ``device=`` where the reference takes
  ``shardings``: the port runs on one card, so there is nothing to
  shard.
- int64 leaves restore as int64 tensors: torch keeps int64 (the
  reference keeps them as host numpy arrays because JAX without x64
  would narrow them).
- Host reads (``load_checkpoint_flat``, ``to_host=True``) return numpy
  arrays, except bfloat16 leaves, which numpy cannot hold without the
  ``ml_dtypes`` extension: they come back as CPU ``torch.bfloat16``
  tensors, bit for bit.

Telemetry, as the reference's: each save emits ``ckpt_save`` (path,
step, leaves, bytes: the leaves' payload bytes) and counts
``ckpt/saves``; each restore emits ``ckpt_restore`` (path, step, leaves)
and counts ``ckpt/restores``, only while ``obs`` is enabled.  A worker
thread's reads (the tiered store's prefetcher) run under
``held_restores``, which holds their records for ``record_restores`` on
the thread that owns the event log (the log is not thread-safe; the
reference emits them from the worker).

Per-key shards are the tiered adapter store's T2 layout: one small
checkpoint per key (tenant id), named by the hex of the key's utf-8
bytes.
"""
from __future__ import annotations

import contextlib
import operator
import os
import re
import threading
from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.checkpoint import msgpack_codec as codec
from repro_torch import obs
from repro_torch.device import resolve_device
from repro_torch.utils import pytree as pt

_BF16 = "__bf16__"
_SHARD_EXT = ".msgpack"


def _sorted_leaves(tree: Any, prefix: str = ""):
    """(path, leaf) pairs with every dict level's keys sorted, as JAX
    flattens a dict (``utils/pytree.py`` keeps dict order instead)."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _sorted_leaves(tree[k],
                                      f"{prefix}/{k}" if prefix else str(k))
    elif tree is not None:
        yield prefix, tree


def _host_array(x) -> tuple[str, np.ndarray]:
    """(dtype tag, C-contiguous host array of the leaf's bytes)."""
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return _BF16, t.view(torch.int16).numpy()
        arr = t.numpy()
        return arr.dtype.str, arr
    arr = np.asarray(x)
    if not arr.flags["C_CONTIGUOUS"]:
        arr = arr.copy(order="C")
    if arr.dtype.name == "bfloat16":
        return _BF16, arr.view(np.uint16)
    return arr.dtype.str, arr


def _pack_leaf(x) -> dict:
    tag, arr = _host_array(x)
    return {"d": tag, "s": list(arr.shape),
            "b": memoryview(arr.reshape(-1).view(np.uint8))}


def _unpack_leaf(rec: dict):
    """A leaf record as a fresh numpy array (a CPU bfloat16 tensor for
    ``"__bf16__"``), not a view of the file's buffer."""
    shape = tuple(rec["s"])
    if rec["d"] == _BF16:
        bits = np.frombuffer(rec["b"], np.int16).reshape(shape)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return np.frombuffer(rec["b"], np.dtype(rec["d"])).reshape(shape).copy()


def _read_payload(path: str) -> dict:
    with open(path, "rb") as f:
        buf = f.read()
    return codec.unpackb(buf)


def save_checkpoint(path: str, tree: Any, step: int = 0) -> None:
    """Write ``tree`` to ``path`` (through ``path + ".tmp"`` and an atomic
    rename)."""
    leaves = list(_sorted_leaves(tree))
    step = operator.index(step)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    nbytes = 0
    with open(tmp, "wb") as f:
        f.write(codec.pack_map_header(2))
        codec.pack_to(f, "step")
        codec.pack_to(f, step)
        codec.pack_to(f, "leaves")
        f.write(codec.pack_map_header(len(leaves)))
        for p, x in leaves:
            rec = _pack_leaf(x)
            nbytes += rec["b"].nbytes
            codec.pack_to(f, p)
            codec.pack_to(f, rec)
    os.replace(tmp, path)
    if obs.enabled():
        obs.event("ckpt_save", path=str(path), step=int(step),
                  leaves=len(leaves), bytes=nbytes)
        obs.inc("ckpt/saves")


_held = threading.local()


def _restored(path: str, step, n_leaves: int) -> None:
    """The ``ckpt_restore`` event and counter of one read, or its record
    kept for later under ``held_restores``."""
    if not obs.enabled():
        return
    held = getattr(_held, "records", None)
    if held is not None:
        held.append((str(path), int(step), n_leaves))
        return
    obs.event("ckpt_restore", path=str(path), step=int(step),
              leaves=n_leaves)
    obs.inc("ckpt/restores")


@contextlib.contextmanager
def held_restores():
    """Collect this thread's restore records in the yielded list instead
    of emitting them."""
    _held.records = records = []
    try:
        yield records
    finally:
        _held.records = None


def record_restores(records) -> None:
    """Emit restore records a ``held_restores`` block collected."""
    for rec in records:
        _restored(*rec)


def checkpoint_leaf_paths(path: str) -> list[str]:
    """Leaf paths stored in a checkpoint (sorted), unpacking no array:
    the schema probe migration code uses to recognize old layouts."""
    return sorted(_read_payload(path)["leaves"])


def load_checkpoint_flat(path: str) -> tuple[dict, int]:
    """A checkpoint as a flat ``{leaf_path: array}`` dict plus its step,
    with no ``like`` template: the read path for state whose shapes vary
    between save and load (tier-2 shards, the tier directory)."""
    payload = _read_payload(path)
    flat = {p: _unpack_leaf(rec) for p, rec in payload["leaves"].items()}
    _restored(path, payload["step"], len(flat))
    return flat, payload["step"]


# ---------------------------------------------------------------------------
# per-key shards (the tiered AdapterStore's T2)
# ---------------------------------------------------------------------------

def shard_path(shard_dir: str, key: str) -> str:
    """Filesystem path of ``key``'s shard under ``shard_dir``."""
    return os.path.join(shard_dir, key.encode("utf-8").hex() + _SHARD_EXT)


def save_shard(shard_dir: str, key: str, tree: Any, step: int = 0) -> None:
    """Write one key's tree as its shard (atomic, as ``save_checkpoint``)."""
    save_checkpoint(shard_path(shard_dir, key), tree, step=step)


def load_shard_flat(shard_dir: str, key: str) -> tuple[dict, int]:
    """One key's shard as a flat ``{path: array}`` dict plus its step."""
    return load_checkpoint_flat(shard_path(shard_dir, key))


def has_shard(shard_dir: str, key: str) -> bool:
    return os.path.exists(shard_path(shard_dir, key))


def list_shards(shard_dir: str) -> list[str]:
    """The keys of every shard under ``shard_dir`` (sorted); other files
    are ignored."""
    if not os.path.isdir(shard_dir):
        return []
    keys = []
    for name in os.listdir(shard_dir):
        if not name.endswith(_SHARD_EXT):
            continue
        try:
            keys.append(bytes.fromhex(name[:-len(_SHARD_EXT)]).decode("utf-8"))
        except ValueError:
            continue
    return sorted(keys)


# ---------------------------------------------------------------------------
# restore into a template
# ---------------------------------------------------------------------------

def _to_host(a):
    if torch.is_tensor(a):
        a = a.detach().cpu()
        return a.clone() if a.dtype == torch.bfloat16 else a.numpy().copy()
    return np.array(a)


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    t = a if torch.is_tensor(a) else torch.from_numpy(np.asarray(a))
    return t.to(device)


def restore_checkpoint(path: str, like: Any, *, device=None,
                       strict: bool = True,
                       allow_missing: str | None = None,
                       to_host: bool = False):
    """Restore ``path`` into the structure of ``like``; returns (tree,
    step).

    Each leaf keeps the checkpoint's dtype and must have ``like``'s
    shape (``AssertionError`` naming the path otherwise).  A leaf of
    ``like`` absent from the checkpoint raises ``KeyError``, unless its
    path matches the ``allow_missing`` regex or ``strict=False``: it
    then keeps ``like``'s value.

    Placement: ``to_host=True`` returns writable numpy arrays (bfloat16
    as CPU tensors).  Otherwise ``device`` (resolved when the function
    is called: ``"cuda"`` without a card raises at once) puts every leaf
    on that device as a tensor; ``device=None`` puts each leaf on the
    device of ``like``'s leaf, and a leaf whose ``like`` is a numpy
    array or a number is host state and stays a numpy array.  The port's
    counterpart of the reference's ``shardings``, on one card."""
    dev = resolve_device(device) if device is not None else None
    payload = _read_payload(path)
    recs = payload["leaves"]
    miss_rx = re.compile(allow_missing) if allow_missing else None

    def fn(p, x):
        if x is None:
            return None
        if p in recs:
            arr = _unpack_leaf(recs[p])
            want = tuple(np.shape(x))
            if tuple(arr.shape) != want:
                raise AssertionError((p, tuple(arr.shape), want))
        elif strict and not (miss_rx and miss_rx.search(p)):
            raise KeyError(
                f"checkpoint {path} has no leaf {p!r} (present: "
                f"{len(recs)} leaves); pass strict=False or a matching "
                f"allow_missing regex to keep the caller's default")
        else:
            arr = x
        if to_host:
            return _to_host(arr)
        if dev is not None:
            return _to_tensor(arr, dev)
        if torch.is_tensor(x):
            return _to_tensor(arr, x.device)
        return _to_host(arr)

    tree = pt.tree_map_with_path(fn, like)
    _restored(path, payload["step"], len(recs))
    return tree, payload["step"]
