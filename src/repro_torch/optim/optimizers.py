"""Optimizers as pure functions on adapter trees (port of
``repro/optim/optimizers.py``).

An ``Optimizer`` is a pair of functions:

  init(params) -> opt_state
  update(grads, opt_state, params, step) -> (updates, new_opt_state)

``updates`` are deltas to add to params; ``step`` is the 0-indexed step
(an int).  The state is a nested dict of tensors, so it stacks and
slices per client like the adapters.  ``masked`` wraps an optimizer so
that leaves where the bool-mask tree is False get zero updates and carry
no optimizer state (a zero-size placeholder): frozen leaves allocate no
AdamW moments.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.utils import pytree as pt

Tree = Any


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable[[Tree], Tree]
    update: Callable[..., tuple[Tree, Tree]]


def _as_schedule(lr):
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.0) -> Optimizer:
    """AdamW with f32 moments and bias correction at ``step + 1``.  A
    zero gradient gives a zero update (0 / (0 + eps)), never NaN."""
    sched = _as_schedule(lr)

    def init(params):
        def zeros(x):
            return torch.zeros_like(x, dtype=torch.float32)
        return {"mu": pt.tree_map(zeros, params),
                "nu": pt.tree_map(zeros, params)}

    def update(grads, state, params, step):
        t = torch.tensor(float(step + 1), dtype=torch.float32)
        bc1 = 1 - torch.tensor(b1, dtype=torch.float32) ** t
        bc2 = 1 - torch.tensor(b2, dtype=torch.float32) ** t
        lr_t = sched(step + 1)
        mu = pt.tree_map2(lambda m, g: b1 * m + (1 - b1) * g.float(),
                          state["mu"], grads)
        nu = pt.tree_map2(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                          state["nu"], grads)

        def upd(path, p):
            m, v = pt.tree_get(mu, path), pt.tree_get(nu, path)
            u = -lr_t * ((m / bc1) / (torch.sqrt(v / bc2) + eps)
                         + weight_decay * p.float())
            return u.to(p.dtype)
        return pt.tree_map_with_path(upd, params), {"mu": mu, "nu": nu}

    return Optimizer(init=init, update=update)


def sgd(lr, momentum: float = 0.0, weight_decay: float = 0.0) -> Optimizer:
    """SGD with optional heavy-ball momentum (an f32 buffer) and L2 weight
    decay added to the gradient.  The learning rate is read at ``step``
    itself (AdamW's at ``step + 1``), as the reference's."""
    sched = _as_schedule(lr)

    def init(params):
        if momentum == 0.0:
            return {"mom": {}}
        return {"mom": pt.tree_map(
            lambda x: torch.zeros_like(x, dtype=torch.float32), params)}

    def update(grads, state, params, step):
        lr_t = sched(step)
        g = grads
        if weight_decay:
            g = pt.tree_map2(lambda gi, p: gi + weight_decay * p, g, params)
        if momentum == 0.0:
            return pt.tree_map2(lambda gi, p: (-lr_t * gi).to(p.dtype),
                                g, params), state
        mom = pt.tree_map2(lambda m, gi: momentum * m + gi.float(),
                           state["mom"], g)
        updates = pt.tree_map2(lambda m, p: (-lr_t * m).to(p.dtype),
                               mom, params)
        return updates, {"mom": mom}

    return Optimizer(init=init, update=update)


def _sentinel(x):
    return torch.zeros((0,), dtype=torch.float32, device=x.device)


def masked(inner: Optimizer, mask: Tree) -> Optimizer:
    """Apply ``inner`` only where the bool-mask tree is True; elsewhere
    the update is zero and the state a zero-size placeholder."""
    def select(tree):
        return pt.tree_map2(lambda m, x: x if m else _sentinel(x), mask, tree)

    def init(params):
        return inner.init(select(params))

    def update(grads, state, params, step):
        upd, new_state = inner.update(select(grads), state, select(params),
                                      step)
        full = pt.tree_map_with_path(
            lambda p, m: (pt.tree_get(upd, p) if m
                          else torch.zeros_like(pt.tree_get(params, p))),
            mask)
        return full, new_state

    return Optimizer(init=init, update=update)


def clip_by_global_norm(grads: Tree, max_norm: float) -> Tree:
    """Scale every leaf by min(1, max_norm / (‖grads‖ + 1e-9)); the norm
    covers every leaf given, trainable or not."""
    scale = torch.clamp(max_norm / (pt.global_norm(grads) + 1e-9), max=1.0)
    return pt.tree_map(lambda g: g * scale, grads)


def chain_clip(inner: Optimizer, max_norm: float) -> Optimizer:
    def update(grads, state, params, step):
        return inner.update(clip_by_global_norm(grads, max_norm), state,
                            params, step)

    return Optimizer(init=inner.init, update=update)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return pt.tree_map2(torch.add, params, updates)
