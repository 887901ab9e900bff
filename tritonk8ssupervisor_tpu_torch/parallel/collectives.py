"""Collectives with autograd rules, per rank, over a process group.

The reference differentiates through collectives inside one SPMD
program; here each rank runs its own autograd graph, so every collective
on a gradient path is a `torch.autograd.Function` whose backward is the
collective's transpose. Two conventions meet, and each function states
its own:

- a group that splits the data (the batch axes; the sequence axis under
  ring attention): each rank's objective is its part of the global one,
  and a rank's gradient is the sum of what every rank's part says of its
  inputs. `all_reduce` (backward: all_reduce), `ppermute` (backward: the
  inverse permutation) and `all_to_all` (backward: all_to_all) follow it.
- a group over which the computation is replicated (the "model" axis
  under tensor parallelism): every rank holds the same objective, as the
  reference's shard_map bodies do, and a collective whose result is the
  same on every rank passes its gradient back unreduced. `copy_to_group`
  (identity forward, all_reduce backward), `reduce_from_group`
  (all_reduce forward, identity backward), `scatter_to_group` (this
  rank's slice forward, all_gather backward) and `gather_from_group`
  (all_gather forward, this rank's slice of the gradient backward, or
  its reduced slice when the group splits the data) follow it.

gloo takes every collective here on CPU tensors; of these, the PyTorch
docs list only its all_reduce as taking CUDA tensors, which is all the
data-parallel path uses. NCCL takes them all. A point-to-point send a
rank would make to itself is a copy.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def sum_values(x: torch.Tensor, group) -> torch.Tensor:
    """all_reduce (sum) into a new tensor, outside autograd."""
    x = x.contiguous().clone()
    dist.all_reduce(x, group=group)
    return x


def gather_values(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """all_gather concatenated along `dim`, outside autograd."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _my_slice(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    n = dist.get_world_size(group)
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return sum_values(x, group)

    @staticmethod
    def backward(ctx, g):
        return sum_values(g, ctx.group), None


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group; the gradient is summed too (data-splitting)."""
    return _AllReduce.apply(x, group)


class _CopyToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return sum_values(g, ctx.group), None


def copy_to_group(x: torch.Tensor, group) -> torch.Tensor:
    """Identity; the gradient is summed over the group (a replicated
    input consumed by sharded work, e.g. the features under a
    class-sharded classifier)."""
    return _CopyToGroup.apply(x, group)


class _ReduceFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return sum_values(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def reduce_from_group(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over the group into a replicated result; the gradient passes
    back as it is (the reference's psum inside a shard_map body)."""
    return _ReduceFromGroup.apply(x, group)


class _ScatterToGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _my_slice(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return gather_values(g, ctx.group, ctx.dim), None, None


def scatter_to_group(x: torch.Tensor, group, dim: int) -> torch.Tensor:
    """This rank's slice of a replicated tensor along `dim`; the gradient
    is gathered, so every rank's copy gets the whole of it."""
    return _ScatterToGroup.apply(x, group, dim)


class _GatherFromGroup(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, reduce_grad):
        ctx.group, ctx.dim, ctx.reduce_grad = group, dim, reduce_grad
        return gather_values(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.reduce_grad:
            g = sum_values(g, ctx.group)
        return _my_slice(g, ctx.group, ctx.dim), None, None, None


def gather_from_group(x: torch.Tensor, group, dim: int, reduce_grad: bool) -> torch.Tensor:
    """The whole tensor from every rank's slice along `dim`. The gradient
    is this rank's slice of the whole one's, summed over the group first
    when `reduce_grad` (the group splits the data, so each rank's whole
    gradient is a part)."""
    return _GatherFromGroup.apply(x, group, dim, reduce_grad)


def _ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    me = dist.get_rank(group)
    dst = next((d for s, d in perm if s == me), None)
    src = next((s for s, d in perm if d == me), None)
    # a rank no pair sends to receives zeros
    out = torch.zeros_like(x, memory_format=torch.contiguous_format)
    if dst == me and src == me:
        return out.copy_(x)
    ops = []
    if dst is not None:
        ops.append(dist.P2POp(dist.isend, x.contiguous(), dist.get_global_rank(group, dst), group))
    if src is not None:
        ops.append(dist.P2POp(dist.irecv, out, dist.get_global_rank(group, src), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _ppermute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return _ppermute(g, ctx.group, [(d, s) for s, d in ctx.perm]), None, None


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """`jax.lax.ppermute`: `perm` is a list of (source, destination)
    ranks within the group; a rank no pair names as destination gets
    zeros. The gradient travels the inverse permutation."""
    return _PPermute.apply(x, group, tuple(perm))


def _all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    x = x.contiguous()  # the call reads and writes dim-0 blocks of dense memory
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.group), None


def all_to_all(x: torch.Tensor, group) -> torch.Tensor:
    """Block j of dim 0 goes to rank j, which keeps it as block i (from
    rank i). Its own transpose, so the gradient takes the same trip."""
    return _AllToAll.apply(x, group)
