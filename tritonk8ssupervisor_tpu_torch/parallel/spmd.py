"""A model on a mesh of ranks: what the reference's `jit` over sharded
arrays does for it, written out per rank.

- `distribute` cuts every parameter to this rank's shard by
  `mesh.param_shardings`, so a rank holds what the reference's device at
  its place holds. A parameter sharded over "model" is gathered whole
  for its module's forward (`_GatheredParam`); one sharded over
  "expert" stays a shard, which the MoE layer's all_to_all serves. It
  also points every BatchNorm at the batch axes' group (statistics over
  the global batch) and every MoE layer at the mesh.
- `reduce_gradients` sums each parameter's gradient over the axes that
  split the data and do not shard the parameter: one bucketed
  all_reduce per group, made even on a group of one rank.
- `ClassShardedLinear` is the classifier under tensor parallelism: this
  rank's block of classes, its logits local (for
  `ops/cross_entropy.vocab_parallel_cross_entropy`), the gradient of its
  input summed over "model".
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors

from tritonk8ssupervisor_tpu_torch.models.moe import MoEMLP
from tritonk8ssupervisor_tpu_torch.models.resnet import BatchNorm
from tritonk8ssupervisor_tpu_torch.parallel import collectives as coll
from tritonk8ssupervisor_tpu_torch.parallel.mesh import (
    MODEL_AXIS,
    batch_axes,
    batch_degree,
    local_shard,
    mesh_group,
    param_shardings,
)


class _GatheredParam:
    """Keeps a model-sharded parameter's shard registered on its module
    (so the optimizer, the state dict and checkpoints see the shard) and
    puts the whole tensor, gathered over "model", in its place for the
    module's forward; a recompute under `torch.utils.checkpoint` gathers
    again. The gradient is this rank's slice of the whole one, summed
    over "model" first when that axis splits the data (`reduce_grad`,
    set by a step with a sequence axis)."""

    def __init__(self, module: nn.Module, leaf: str, group, dim: int):
        self.leaf, self.group, self.dim = leaf, group, dim
        self.reduce_grad = False
        self.shard = None
        module.register_forward_pre_hook(self._gather)
        module.register_forward_hook(self._restore)

    def _gather(self, module, _args):
        self.shard = module._parameters[self.leaf]
        module._parameters[self.leaf] = coll.gather_from_group(
            self.shard, self.group, self.dim, self.reduce_grad)

    def _restore(self, module, _args, _output):
        module._parameters[self.leaf] = self.shard


def distribute(model: nn.Module, mesh) -> tuple[dict[str, tuple], list[_GatheredParam]]:
    """Shard `model` (its parameters already on this rank's device) onto
    `mesh` in place; returns (every parameter's spec, the gathers)."""
    specs = param_shardings(model, mesh)
    modules = dict(model.named_modules())
    gathers = []
    model_group = mesh_group(mesh, MODEL_AXIS)
    with torch.no_grad():
        for name, p in model.named_parameters():
            spec = specs[name]
            if not any(spec):
                continue
            p.data = local_shard(p.data, mesh, spec).clone()
            if MODEL_AXIS in spec:
                owner, _, leaf = name.rpartition(".")
                gathers.append(_GatheredParam(modules[owner], leaf, model_group,
                                              spec.index(MODEL_AXIS)))
    group = mesh_group(mesh, batch_axes(mesh))
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.group = group if batch_degree(mesh) > 1 else None
        elif isinstance(m, MoEMLP):
            m.mesh = mesh
    return specs, gathers


def reduce_gradients(model: nn.Module, mesh, specs: dict[str, tuple],
                     split_axes: tuple[str, ...]) -> None:
    """Sum every parameter's gradient over the axes of `split_axes` (those
    that split the data) that do not shard it: an axis that shards a
    parameter already summed in its collective's backward. One flat
    all_reduce per group, in the same order on every rank; a missing
    gradient counts as zeros."""
    buckets: dict[tuple[str, ...], list[torch.Tensor]] = {}
    for name, p in model.named_parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
        axes = tuple(a for a in split_axes if a not in specs[name])
        buckets.setdefault(axes, []).append(p.grad)
    for axes, grads in buckets.items():
        if not axes:
            continue
        flat = _flatten_dense_tensors(grads)
        dist.all_reduce(flat, group=mesh_group(mesh, axes))
        for g, reduced in zip(grads, _unflatten_dense_tensors(flat, grads)):
            g.copy_(reduced)


class ClassShardedLinear(nn.Module):
    """The classifier under tensor parallelism over `group` ("model"):
    logits for this rank's block of classes only. Holds the classifier's
    own parameters (the same objects, so the optimizer and the state dict
    keep them): the weight is this rank's block where `param_shardings`
    sharded it, else the whole, which the forward slices; the bias is
    whole (1-d parameters are replicated) and sliced. The input's
    gradient is summed over the group, the slices' gradients gathered."""

    def __init__(self, linear: nn.Module, group, num_classes: int):
        super().__init__()
        self.weight, self.bias = linear.weight, linear.bias
        self.group = group
        self.dtype = getattr(linear, "dtype", linear.weight.dtype)
        self.weight_sharded = linear.weight.shape[0] != num_classes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = coll.copy_to_group(x, self.group)
        w = self.weight if self.weight_sharded else coll.scatter_to_group(self.weight, self.group, 0)
        b = coll.scatter_to_group(self.bias, self.group, 0)
        return F.linear(x.to(self.dtype), w.to(self.dtype), b.to(self.dtype))


def split_axes(mesh, seq_axis: str | None) -> tuple[str, ...]:
    """The axes that split the data: the batch axes, and the sequence
    axis when there is one."""
    return batch_axes(mesh) + ((seq_axis,) if seq_axis else ())
