"""Megatron-style tensor parallelism over the mesh's ``model`` axis.

A block's up-projections are split by output rows (column parallel: each
rank computes its heads or hidden columns) and its down-projections by
input columns (row parallel: each rank's partial product), so a sublayer
needs one all-reduce of its output in the forward pass, and one of its
input's gradient in the backward pass:

  * ``enter``  -- identity forward, all-reduce of the gradient backward
    (before a column-parallel layer);
  * ``reduce`` -- all-reduce forward, identity backward (after a
    row-parallel layer);
  * ``gather`` -- all-gather of a column-parallel output on its last axis
    forward, this rank's slice of the gradient backward (the LM head's
    logits, which every rank needs whole for the loss and for sampling).

Every rank of a ``model`` group computes the same loss from the same
gathered logits, so the gradients of the leaves it holds whole (norms,
embeddings) agree across the group without a reduction of their own.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class _Enter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size, rank):
        ctx.rank, ctx.width = rank, x.shape[-1]
        parts = [torch.empty_like(x.contiguous()) for _ in range(size)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.rank * ctx.width
        return g[..., lo:lo + ctx.width].contiguous(), None, None, None


class ModelParallel:
    """This rank's place on the ``model`` axis: its process group, the
    axis size and its index on it."""

    def __init__(self, group, size: int, rank: int):
        self.group, self.size, self.rank = group, int(size), int(rank)

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        return _Enter.apply(x, self.group) if x.requires_grad else x

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _Reduce.apply(x, self.group)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(x, self.group, self.size, self.rank)


def enter(tp, x):
    return x if tp is None else tp.enter(x)


def reduce(tp, x):
    return x if tp is None else tp.reduce(x)


def gather(tp, x):
    return x if tp is None else tp.gather(x)
