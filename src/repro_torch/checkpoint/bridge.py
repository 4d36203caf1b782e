"""Weights carried across from the JAX package.

``params_from_numpy`` takes a parameter or adapter tree whose leaves are
numpy arrays (the JAX side converts with ``jax.tree.map(np.asarray,
tree)``) and returns the port's tree: same paths, same shapes, torch
tensors on ``device``.

JAX's bf16 arrays arrive as numpy arrays of the ``ml_dtypes`` bfloat16
dtype, which ``torch.from_numpy`` rejects; they are detected by dtype
name and reinterpreted bit for bit through ``uint16``.

``shard_from_numpy`` carries such a tree into one rank's shard on a grid
(``launch/specs.shard_tree`` by the given specs), so that both packages
can be fed the same weights with each rank holding only its own.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.device import resolve_device


def _leaf(arr, device, dtype=None) -> torch.Tensor:
    arr = np.asarray(arr)
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(np.array(arr.view(np.uint16))).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))     # writable copy
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device="cuda", dtype=None):
    """Nested dict of numpy leaves → nested dict of tensors on ``device``
    (floating leaves cast to ``dtype`` when given)."""
    dev = resolve_device(device)

    def go(node):
        if isinstance(node, Mapping):
            return {k: go(v) for k, v in node.items()}
        return _leaf(node, dev, dtype)
    return go(tree)


def shard_from_numpy(tree, specs, grid, device="cuda", dtype=None):
    """This rank's shard (``grid.coords``) of a numpy tree by ``specs``
    (``launch/specs.param_specs`` and friends), as tensors on ``device``
    (floating leaves cast to ``dtype`` when given), cut on the host
    before they are copied to the device."""
    from repro_torch.launch.specs import shard_tree
    from repro_torch.utils import pytree as pt
    dev = resolve_device(device)
    cut = shard_tree(params_from_numpy(tree, "cpu", dtype), specs, grid)
    return pt.tree_map(lambda t: t.to(dev), cut)
