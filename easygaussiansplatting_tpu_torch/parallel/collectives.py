"""The collectives the multi-device layer calls, and the bytes they move.

JAX's GSPMD and ``shard_map`` insert the all-gathers and all-reduces of the
sharded programs; PyTorch has no partitioner, so parallel/train.py calls
them here, on a :class:`~easygaussiansplatting_tpu_torch.parallel.mesh.Mesh`
axis: "data", "gs" or "all". A mesh without process groups (one rank)
makes each an identity and counts nothing.

:data:`BYTES` counts what each call moved, by (operation, axis, tag): an
all-gather its gathered output, an all-reduce its tensor. The tests hold
the per-step counts to the table and gradient sizes, as JAX's
``test_parallel.py`` reads the byte counts of its compiled collectives.
"""

import collections

import torch
import torch.distributed as dist

BYTES = collections.Counter()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _nbytes(t):
    return t.numel() * t.element_size()


def all_gather(x, mesh, axis, tag):
    """Every rank's ``x`` along ``axis``, in the axis's rank order."""
    group = mesh.groups.get(axis)
    if group is None:
        return [x]
    n = mesh.axis_size(axis)
    x = x.contiguous()
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x, group=group)
    BYTES["all_gather", axis, tag] += n * _nbytes(x)
    return out


def gather_rows(x, mesh, axis, tag):
    """The rows of every rank's ``x`` along ``axis``, concatenated."""
    parts = all_gather(x, mesh, axis, tag)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def all_reduce_(x, mesh, axis, tag, op="sum"):
    """Reduce ``x`` in place over ``axis`` ("sum" or "max"); returns it."""
    group = mesh.groups.get(axis)
    if group is None:
        return x
    dist.all_reduce(x, op=_OPS[op], group=group)
    BYTES["all_reduce", axis, tag] += _nbytes(x)
    return x


class GatherRows(torch.autograd.Function):
    """``gather_rows`` under autograd. The backward keeps this rank's rows of
    the cotangent; with ``reduce_axis`` it first sums the cotangent over
    that axis (the ranks computed different shares of the loss from the
    gathered rows)."""

    @staticmethod
    def forward(ctx, x, mesh, axis, tag, reduce_axis):
        ctx.mesh, ctx.axis, ctx.tag, ctx.reduce_axis = mesh, axis, tag, reduce_axis
        ctx.rows = x.shape[0]
        return gather_rows(x, mesh, axis, tag)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        if ctx.reduce_axis is not None:
            g = all_reduce_(g.clone(), ctx.mesh, ctx.reduce_axis, ctx.tag + "_grad")
        i = ctx.mesh.index(ctx.axis)
        return g[i * ctx.rows:(i + 1) * ctx.rows], None, None, None, None
