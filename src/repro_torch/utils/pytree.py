"""Nested-dict tree helpers (port of ``repro/utils/pytree.py``).

Parameters, adapters and caches are nested dicts of tensors.  Paths are
"/"-joined key strings, e.g. ``"blocks/sub0/attn/q_proj/lora_A"`` — the
same paths the JAX package uses, so trees carry across leaf by leaf.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Mapping, Sequence

import torch

Tree = Any


def _leaves_with_path(tree: Tree, prefix: str = ""):
    if isinstance(tree, Mapping):
        for k in tree:          # dict order, as the reference keeps it
            yield from _leaves_with_path(
                tree[k], f"{prefix}/{k}" if prefix else str(k))
    elif tree is not None:
        yield prefix, tree


def path_str(keys: Sequence) -> str:
    """A sequence of keys (dict keys or sequence indices) as a "/"-joined
    path: ``("blocks", "sub0", 0)`` → ``"blocks/sub0/0"``."""
    return "/".join(str(k) for k in keys)


def _map_with_path(fn, node, prefix):
    if isinstance(node, Mapping):
        return {k: _map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in node.items()}
    return fn(prefix, node)


def tree_map_with_path(fn: Callable[[str, Any], Any], tree: Tree) -> Tree:
    """Map ``fn(path, leaf)`` over a nested dict.  The recursion is a
    module-level function: a nested recursive closure is a reference
    cycle, and it would keep ``fn`` (and every tensor ``fn`` closes over)
    alive until Python's cyclic collector runs."""
    return _map_with_path(fn, tree, "")


def tree_map(fn: Callable[[Any], Any], tree: Tree) -> Tree:
    return tree_map_with_path(lambda _, x: fn(x), tree)


def tree_map2(fn: Callable[[Any, Any], Any], a: Tree, b: Tree) -> Tree:
    """Map ``fn(x, y)`` over two trees of one structure (``a``'s)."""
    return tree_map_with_path(lambda p, x: fn(x, tree_get(b, p)), a)


def path_mask(tree: Tree, predicate: Callable[[str], bool]) -> Tree:
    """Boolean mask tree: True where ``predicate(path)``."""
    return tree_map_with_path(lambda p, _: bool(predicate(p)), tree)


def regex_mask(tree: Tree, pattern: str) -> Tree:
    """Boolean mask tree: True where the path matches ``pattern``
    (``re.search``)."""
    rx = re.compile(pattern)
    return path_mask(tree, lambda p: rx.search(p) is not None)


def tree_select(tree: Tree, mask: Tree, other: Tree) -> Tree:
    """Per-leaf select over ``mask``'s structure: mask ? tree : other."""
    return tree_map_with_path(
        lambda p, m: tree_get(tree, p) if m else tree_get(other, p), mask)


def tree_zeros_like(tree: Tree) -> Tree:
    return tree_map(torch.zeros_like, tree)


def tree_add(a: Tree, b: Tree) -> Tree:
    return tree_map2(torch.add, a, b)


def tree_sub(a: Tree, b: Tree) -> Tree:
    return tree_map2(torch.sub, a, b)


def tree_scale(a: Tree, s) -> Tree:
    return tree_map(lambda x: x * s, a)


def tree_dot(a: Tree, b: Tree):
    """Σ over leaves of the flattened dot product, a 0-d tensor."""
    return sum(torch.vdot(x.reshape(-1), tree_get(b, p).reshape(-1))
               for p, x in _leaves_with_path(a))


def global_norm(tree: Tree):
    """sqrt(Σ x²) over every leaf, a 0-d tensor (no host sync)."""
    return torch.sqrt(sum(torch.sum(torch.square(x))
                          for x in tree_leaves(tree)))


def tree_count_params(tree: Tree) -> int:
    """Elements over every leaf (a ``device="meta"`` tree counts too)."""
    return int(sum(x.numel() for x in tree_leaves(tree)))


def tree_bytes(tree: Tree) -> int:
    """Bytes over every leaf at its dtype (a meta tree counts too)."""
    return int(sum(x.numel() * x.element_size() for x in tree_leaves(tree)))


def tree_cast(tree: Tree, dtype) -> Tree:
    """Floating leaves cast to ``dtype``; other leaves as they are."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    tree)


def tree_all_finite(tree: Tree):
    """0-d bool tensor: every floating leaf finite (no host sync; True
    without floating leaves)."""
    oks = [torch.all(torch.isfinite(x)) for x in tree_leaves(tree)
           if x.is_floating_point()]
    if not oks:
        return torch.tensor(True)
    return torch.all(torch.stack(oks))


def tree_leaves_with_path(tree: Tree) -> list[tuple[str, Any]]:
    """(path, leaf) pairs in dict order."""
    return list(_leaves_with_path(tree))


def tree_paths(tree: Tree) -> list[str]:
    return [p for p, _ in _leaves_with_path(tree)]


def tree_leaves(tree: Tree) -> list:
    return [x for _, x in _leaves_with_path(tree)]


def tree_get(tree: Mapping, path: str, default=None):
    """Fetch the node at a "/"-joined path, or ``default`` on a miss."""
    node = tree
    for k in path.split("/"):
        if not isinstance(node, Mapping) or k not in node:
            return default
        node = node[k]
    return node


def set_leaf(tree: dict, path: str, leaf) -> None:
    """Set the leaf at a "/"-joined path, creating intermediate dicts."""
    keys = path.split("/")
    cur = tree
    for k in keys[:-1]:
        cur = cur.setdefault(k, {})
    cur[keys[-1]] = leaf


def filter_tree(tree: Mapping, predicate: Callable[[str], bool]) -> dict:
    """Subtree of the leaves whose path satisfies ``predicate``; empty
    dicts are pruned."""
    out: dict = {}
    for p, leaf in _leaves_with_path(tree):
        if predicate(p):
            set_leaf(out, p, leaf)
    return out


def merge_trees(base: Mapping, overlay: Mapping) -> dict:
    """Deep merge: overlay leaves replace base leaves (no tensor copies)."""
    out = dict(base)
    for k, v in overlay.items():
        if k in out and isinstance(out[k], Mapping) and isinstance(v, Mapping):
            out[k] = merge_trees(out[k], v)
        else:
            out[k] = v
    return out
