"""Collectives over a `torch.distributed` process group that autograd
differentiates: the data-parallel step's global-batch BatchNorm
statistics and its globally averaged loss (`parallel.shard_dp`)."""

import torch
import torch.distributed as dist


class _AllReduceSum(torch.autograd.Function):
    """y = the sum of x over the group, on every rank. Every rank's loss
    reads y, so the cotangent of x is the sum of y's cotangents over the
    group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x, group=None):
    """The sum of x over `group` (default: the world), differentiable."""
    return _AllReduceSum.apply(x, group)


def all_reduce_mean(x, group=None):
    """The mean of x over `group`, differentiable."""
    return all_reduce_sum(x, group) / dist.get_world_size(group)
