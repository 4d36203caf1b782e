"""Sharding rules: map param paths → partition specs by ordered regex
rules (the port's own copy of ``repro/utils/sharding.py``; no JAX).

A spec is a plain tuple with one entry per array dimension: None (the
dimension is whole on every rank), a grid-axis name (the dimension is
split over that axis), or a tuple of axis names (split over their
product, the first the slowest).  ``()`` is replicated.

Rules are (regex, spec template) pairs.  A template's entries are
written for the unstacked rank; axis names that the grid does not have
are dropped, so the same table serves a ("data", "model") grid and a
("pod", "data", "model") one.

The functions take a grid object: anything with ``axis_names`` (a tuple)
and ``shape`` (a mapping axis → size), such as ``launch/mesh.Grid`` or
``launch/mesh.AbstractGrid``.  ``launch/specs.shard_tree`` cuts a tree
to one rank's shard by these specs.
"""
from __future__ import annotations

import re
from typing import Any, Sequence

from repro_torch.utils import pytree as pt

Rules = Sequence[tuple[str, tuple]]


def _filter_axes(entry, mesh_axes: set[str]):
    if entry is None:
        return None
    if isinstance(entry, str):
        return entry if entry in mesh_axes else None
    kept = tuple(a for a in entry if a in mesh_axes)
    if not kept:
        return None
    return kept if len(kept) > 1 else kept[0]


def spec_for(path: str, ndim: int, rules: Rules, mesh) -> tuple:
    """The spec of the leaf at ``path`` with ``ndim`` dimensions: the
    first rule whose regex matches (``re.search``), its template padded
    with leading Nones (scan-stacking prepends dims) or trimmed from the
    front to ``ndim``; ``()`` when no rule matches."""
    mesh_axes = set(mesh.axis_names)
    for rx, template in rules:
        if re.search(rx, path):
            entries = [_filter_axes(e, mesh_axes) for e in template]
            if len(entries) < ndim:
                entries = [None] * (ndim - len(entries)) + entries
            elif len(entries) > ndim:
                entries = entries[len(entries) - ndim:]
            return tuple(entries)
    return ()


def tree_specs(tree, rules: Rules, mesh):
    """The spec tree of a tree of tensors (or anything with ``shape``)."""
    return pt.tree_map_with_path(
        lambda p, x: spec_for(p, len(x.shape), rules, mesh), tree)


def data_axis_names(mesh) -> tuple[str, ...]:
    """The grid axes that enumerate data / clients, in collective order."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def client_axis(mesh):
    """The spec entry that splits a leading client / batch axis over
    every data-like grid axis."""
    axes = data_axis_names(mesh)
    if not axes:
        return None
    return axes if len(axes) > 1 else axes[0]


def client_specs(tree, mesh):
    """One client per data shard: every leaf split on its leading
    client axis (adapters, optimizer state, per-client vectors)."""
    ax = client_axis(mesh)
    return pt.tree_map(lambda _: (ax,), tree)


def client_vector_spec(mesh) -> tuple:
    """The spec of a per-client (C,) vector (weights, participation,
    staleness, update scales)."""
    return (client_axis(mesh),)


def replicated_specs(tree):
    """Every leaf replicated (the pipeline's stage-2 server model)."""
    return pt.tree_map(lambda _: (), tree)


def batch_spec(mesh, ndim: int, batch_axis: int = 0) -> tuple:
    """Split the batch dim over every data-like axis of the grid."""
    entries: list[Any] = [None] * ndim
    entries[batch_axis] = client_axis(mesh)
    return tuple(entries)


# ---------------------------------------------------------------------------
# The rule table of the model zoo.  Paths look like:
#   embed/embedding                         (vocab, d)
#   blocks/<i>/attn/{q,k,v,o}_proj/kernel   (d, heads*dh) stacked → (L, d, H*dh)
#   blocks/<i>/mlp/{up,gate}_proj/kernel    (d, ff)
#   blocks/<i>/mlp/down_proj/kernel         (ff, d)
#   blocks/<i>/moe/experts/{up,gate}        (E, d, ff)
#   blocks/<i>/moe/experts/down             (E, ff, d)
#   blocks/<i>/moe/router/kernel            (d, E)
#   blocks/<i>/ssm/...                      Mamba-2 mixer params
#   lm_head/kernel                          (d, vocab)
#   .../lora_A, A_dir, ...                  adapters: replicated
# ---------------------------------------------------------------------------

DEFAULT_PARAM_RULES: Rules = (
    # adapters: tiny, replicated (a leading per-client axis is split by
    # the federated engine, not by these rules)
    (r"lora_|prompt_|adapter_|_mag$|_dir$", ()),
    # MoE experts: expert-parallel over data, d_ff tensor-parallel
    (r"moe/experts/(up|gate)", ("data", None, "model")),
    (r"moe/experts/down", ("data", "model", None)),
    (r"moe/router", (None, None)),
    # attention projections: heads tensor-parallel
    (r"attn/(q_proj|k_proj|v_proj)/kernel", (None, "model")),
    (r"attn/o_proj/kernel", ("model", None)),
    # dense mlp
    (r"mlp/(up_proj|gate_proj)/kernel", (None, "model")),
    (r"mlp/down_proj/kernel", ("model", None)),
    # Mamba mixer: inner dim tensor-parallel
    (r"ssm/in_proj/kernel", (None, "model")),
    (r"ssm/out_proj/kernel", ("model", None)),
    (r"ssm/(conv_w|A_log|D|dt_bias|norm_w)", ("model",)),
    # embeddings / unembedding: vocab tensor-parallel
    (r"embed/embedding", ("model", None)),
    (r"lm_head/kernel", (None, "model")),
    # norms etc.: replicated
    (r".*", ()),
)

# The FSDP overlay: the frozen big tensors also split over the data axis
# (ZeRO-3 style).  The reference defines it and never uses it; it is
# carried here as data.
FSDP_PARAM_RULES: Rules = (
    (r"lora_|prompt_|adapter_|_mag$|_dir$", ()),
    (r"moe/experts/(up|gate)", ("data", None, "model")),
    (r"moe/experts/down", ("data", "model", None)),
    (r"moe/router", (None, None)),
    (r"attn/(q_proj|k_proj|v_proj)/kernel", ("data", "model")),
    (r"attn/o_proj/kernel", (("data", "model"), None)),
    (r"mlp/(up_proj|gate_proj)/kernel", ("data", "model")),
    (r"mlp/down_proj/kernel", (("data", "model"), None)),
    (r"ssm/in_proj/kernel", ("data", "model")),
    (r"ssm/out_proj/kernel", (("data", "model"), None)),
    (r"ssm/(conv_w|A_log|D|dt_bias|norm_w)", ("model",)),
    (r"embed/embedding", (("data", "model"), None)),
    (r"lm_head/kernel", ("data", "model")),
    (r".*", ()),
)
