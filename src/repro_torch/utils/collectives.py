"""Collectives that carry gradients, for the tensor-parallel layers.

Each takes a group with the collectives of ``launch/mesh.ClientGroup``
(``all_reduce``, ``all_gather``, ``exchange``), or None (and a group of
one), where it is the identity.  The forward and
backward pairs are Megatron's conjugates, written for a loss that every
rank of the group computes whole and back-propagates from its own copy:

  copy_to(x, g)        identity forward, all-reduce backward: the input
                       of a column-parallel region, whose ranks each
                       send back a partial gradient
  reduce_from(x, g)    all-reduce forward, identity backward: the output
                       of a row-parallel region (partial sums), whose
                       gradient is whole on every rank
  gather_from(x, g, d) all-gather along dim d forward, this rank's slice
                       of the gradient backward: the gathered tensor is
                       used whole on every rank
  all_to_all(x, g)     dim 0's chunks exchanged (chunk j to rank j)
                       forward, the gradient exchanged back backward
  mean_over(x, g)      the mean over the ranks forward, the mean of the
                       ranks' gradients backward: a quantity each rank
                       adds whole to a loss of its own rows, where the
                       ranks' gradients are meaned (a grid's data axis)
  sum_over(x, g)       all-reduce forward and backward: each rank's
                       partial sum of a quantity every rank then uses
                       whole for its own slice (the gated norm's sum of
                       squares over a split inner dimension), so each
                       rank's gradient of it is partial too
  scale_grad(x, s)     identity forward, the gradient times s backward

``model_group(mesh)`` reads the group that splits one backbone off a
``launch/mesh.Grid`` (its ``model`` row), and gives None where there is
none or it has one rank.
"""
from __future__ import annotations

import torch


def model_group(mesh):
    g = getattr(mesh, "model", None)
    return g if g is not None and g.size > 1 else None


def _trivial(group) -> bool:
    return group is None or group.size == 1


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce([g])[0], None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce([x])[0]

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.n = group, dim, x.shape[dim]
        parts = group.all_gather([x])[0]            # (size, *x.shape)
        return torch.cat(list(parts.unbind(0)), dim=dim)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.group.rank, ctx.n
        return g.narrow(ctx.dim, r * n, n).contiguous(), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.exchange(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.exchange(g), None


class _MeanOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce([x])[0] / group.size

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce([g])[0] / ctx.group.size, None


class _ScaleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, s):
        ctx.s = s
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.s, None


def copy_to(x, group):
    return x if _trivial(group) else _CopyTo.apply(x, group)


def reduce_from(x, group):
    return x if _trivial(group) else _ReduceFrom.apply(x, group)


def gather_from(x, group, dim: int = -1):
    if _trivial(group):
        return x
    return _GatherFrom.apply(x, group, dim % x.dim())


def all_to_all(x, group):
    return x if _trivial(group) else _AllToAll.apply(x, group)


def mean_over(x, group):
    return x if _trivial(group) else _MeanOver.apply(x, group)


def sum_over(x, group):
    return reduce_from(copy_to(x, group), group)


def scale_grad(x, s: float):
    return x if s == 1 else _ScaleGrad.apply(x, s)
