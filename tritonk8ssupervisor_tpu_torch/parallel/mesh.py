"""The device mesh and the sharding rules: the port of
`tritonk8ssupervisor_tpu/parallel/mesh.py` on a
`torch.distributed.device_mesh.DeviceMesh`.

The axes are the reference's, in its order:

- "data": batch parallelism; gradients are summed over it;
- "expert": expert parallelism for the mixture-of-experts blocks
  (models/moe.py): expert parameters shard their leading expert dim here
  and the dispatched tokens travel by all_to_all. For every other layer
  it is more batch parallelism: the batch shards over (data, expert);
- "pipe": pipeline stages (parallel/pipeline.py): the pipelined LM's
  stage parameters shard their leading stage dim here, activations hop
  between neighbours. It splits no data and gathers no parameter: for
  every other parameter and for the batch it is replicated;
- "model": tensor parallelism (the classifier's classes, wide kernels)
  and the ring-attention sequence axis; innermost.

The reference is one SPMD program over global arrays, and XLA places
the collectives. The port runs per rank: each process holds its shard of
the batch and of every sharded parameter, and the train steps
(parallel/train.py) call the collectives themselves. A rank's place on
the mesh is its coordinate in the (data, expert, pipe, model) grid of
ranks, laid out row-major as `jax.devices()` are in the reference, so a
rank holds the slice of each array that the reference's device at the
same place holds.
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from tritonk8ssupervisor_tpu_torch import resolve_device
from tritonk8ssupervisor_tpu_torch.parallel.distributed import cluster_env

DATA_AXIS = "data"
EXPERT_AXIS = "expert"
PIPE_AXIS = "pipe"
MODEL_AXIS = "model"
AXES = (DATA_AXIS, EXPERT_AXIS, PIPE_AXIS, MODEL_AXIS)

# a sharding spec: one entry per tensor dim, the mesh axis (or axes) that
# dim is split over, None where it is whole (the reference's PartitionSpec)
Spec = tuple


def world_ranks() -> list[int]:
    """Every rank of the default process group; [0] without one."""
    return list(range(dist.get_world_size())) if dist.is_initialized() else [0]


def mesh_grid(ranks: Sequence[int], model_parallelism: int = 1, expert_parallelism: int = 1,
              pipeline_parallelism: int = 1) -> np.ndarray:
    """The (data, expert, pipe, model) grid of `ranks`, row-major; the
    reference's ValueError when the degrees do not divide their count."""
    n = len(ranks)
    denom = model_parallelism * expert_parallelism * pipeline_parallelism
    if (model_parallelism < 1 or expert_parallelism < 1 or pipeline_parallelism < 1
            or n % denom):
        raise ValueError(
            f"parallelism degrees model={model_parallelism} "
            f"expert={expert_parallelism} pipe={pipeline_parallelism} "
            f"do not divide device count {n}"
        )
    return np.asarray(ranks).reshape(
        n // denom, expert_parallelism, pipeline_parallelism, model_parallelism
    )


def make_mesh(ranks: Sequence[int] | None = None, model_parallelism: int = 1,
              expert_parallelism: int = 1, pipeline_parallelism: int = 1,
              device_type: str | None = None) -> DeviceMesh:
    """A (data, expert, pipe, model) mesh over `ranks` (default: every
    rank of the process group). The named degrees must divide the rank
    count; the rest is data. `device_type` is "cuda" unless the caller
    asks for "cpu" (the card, as every entry point of the port)."""
    grid = mesh_grid(world_ranks() if ranks is None else list(ranks), model_parallelism,
                     expert_parallelism, pipeline_parallelism)
    device_type = resolve_device(device_type).type
    return DeviceMesh(device_type, torch.as_tensor(grid), mesh_dim_names=AXES)


def _hardware_multislice(devices: Sequence[Any]) -> bool:
    """True when every item carries a `slice_index` and they differ. Ranks
    carry none, so a process group is one slice unless the cluster
    environment says otherwise (`make_workload_mesh`)."""
    tags = {getattr(d, "slice_index", None) for d in devices}
    return None not in tags and len(tags) > 1


def slice_groups(devices: Sequence[Any] | None = None,
                 num_slices: int | None = None) -> list[list[Any]]:
    """`devices` (default: every rank) grouped by slice, slice-major: by
    their `slice_index` where they carry one, else `num_slices` equal
    contiguous groups (ranks are slice-major by the cluster env's
    `global_process_id`)."""
    devices = list(devices) if devices is not None else world_ranks()
    if _hardware_multislice(devices):
        groups: dict[int, list[Any]] = {}
        for d in devices:
            groups.setdefault(d.slice_index, []).append(d)
        if num_slices is not None and len(groups) != num_slices:
            raise ValueError(
                f"hardware reports {len(groups)} slices, caller asked for {num_slices}"
            )
        return [groups[s] for s in sorted(groups)]
    if num_slices is None or num_slices < 1:
        raise ValueError("devices carry no multislice grouping; pass num_slices explicitly")
    n = len(devices)
    if n % num_slices:
        raise ValueError(f"{n} devices do not split into {num_slices} equal slices")
    per = n // num_slices
    return [devices[i * per:(i + 1) * per] for i in range(num_slices)]


def make_cross_slice_mesh(num_slices: int | None = None, ranks: Sequence[int] | None = None,
                          model_parallelism: int = 1, expert_parallelism: int = 1,
                          pipeline_parallelism: int = 1,
                          device_type: str | None = None) -> DeviceMesh:
    """One mesh over every slice: slices laid slice-major into the data
    axis, so expert, pipe and model index within a slice and only the
    data axis crosses slices. model x expert x pipe must divide the
    per-slice rank count."""
    groups = slice_groups(ranks, num_slices)
    per_slice = len(groups[0])
    denom = model_parallelism * expert_parallelism * pipeline_parallelism
    if per_slice % denom:
        raise ValueError(
            f"model x expert x pipe = {denom} must divide the per-slice "
            f"device count {per_slice}: tensor/expert/pipeline axes may "
            "not straddle a slice boundary (only the data axis crosses slices)"
        )
    return make_mesh([r for g in groups for r in g], model_parallelism,
                     expert_parallelism, pipeline_parallelism, device_type)


def make_workload_mesh(model_parallelism: int = 1, expert_parallelism: int = 1,
                       pipeline_parallelism: int = 1, device_type: str | None = None,
                       num_slices: int | None = None) -> DeviceMesh:
    """The mesh a workload builds: the cross-slice mesh when the cluster
    environment (`parallel/distributed.cluster_env`) names more than one
    slice, else `make_mesh`. `num_slices` replaces the environment's count:
    after a membership change the process environment still describes the
    old world, and the elastic trainer passes the rejoin's count."""
    if num_slices is None:
        env = cluster_env()
        num_slices = env.num_slices if env is not None else 1
    env_slices = num_slices
    degrees = (model_parallelism, expert_parallelism, pipeline_parallelism)
    if env_slices > 1 or _hardware_multislice(world_ranks()):
        return make_cross_slice_mesh(env_slices if env_slices > 1 else None, None, *degrees,
                                     device_type=device_type)
    return make_mesh(None, *degrees, device_type=device_type)


def axis_sizes(mesh) -> dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh) -> tuple[str, ...]:
    """The axes the batch shards over: ("data", "expert") where the mesh
    has them (non-MoE layers treat expert parallelism as more batch
    parallelism)."""
    return tuple(a for a in (DATA_AXIS, EXPERT_AXIS) if a in mesh.mesh_dim_names)


def batch_degree(mesh) -> int:
    """The number of batch shards: the product of the batch axes' sizes."""
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in batch_axes(mesh))


def axis_index(mesh: DeviceMesh, axes: str | Sequence[str]) -> int:
    """This rank's index along `axes`, several axes counted row-major (as
    a PartitionSpec entry that names several axes splits its dim)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = axis_sizes(mesh)
    index = 0
    for a in axes:
        index = index * sizes[a] + mesh.get_local_rank(a)
    return index


def axes_size(mesh, axes: str | Sequence[str]) -> int:
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


def mesh_group(mesh: DeviceMesh, axes: str | Sequence[str]):
    """The process group of this rank's peers along `axes` (one axis: the
    mesh's own group; several: a group made once per mesh and kept on
    it). Every rank must ask for the same groups in the same order, as
    for any `new_group`."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    cache = mesh.__dict__.setdefault("_tk8s_groups", {})
    if axes not in cache:
        names = list(mesh.mesh_dim_names)
        grid = mesh.mesh.numpy()
        order = [names.index(a) for a in names if a not in axes] + [names.index(a) for a in axes]
        rows = grid.transpose(order).reshape(-1, axes_size(mesh, axes))
        me = dist.get_rank()
        mine = None
        for row in rows:  # every rank makes every group, in one order
            group = dist.new_group([int(r) for r in row])
            if me in row:
                mine = group
        cache[axes] = mine
    return cache[axes]


def local_shard(x: torch.Tensor, mesh: DeviceMesh, spec: Spec) -> torch.Tensor:
    """This rank's slice of the global array `x` under `spec`: what the
    reference's device at this rank's place on the mesh holds."""
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        n = axes_size(mesh, axes)
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over {axes} ({n})")
        x = x.chunk(n, dim=dim)[axis_index(mesh, axes)]
    return x


def _is_expert_param(name: str) -> bool:
    """The reference's rule: a parameter under any module or parameter
    name containing "expert" carries a leading expert dim."""
    return any("expert" in part.lower() for part in name.split("."))


def _reference_last_dim(module: nn.Module, leaf: str, param: torch.Tensor) -> int:
    """The torch dim holding the reference's LAST axis (a kernel's output
    features). A Dense or Linear weight is (out, in) where flax's kernel
    is (in, out), and a convolution's is OIHW where flax's is HWIO: for
    both it is dim 0. Everything else keeps the reference's layout
    (embeddings, `pos_embed`, the MoE expert tensors): the last dim."""
    if leaf == "weight" and param.ndim in (2, 4) and not isinstance(module, nn.Embedding):
        return 0
    return param.ndim - 1


def param_shardings(model: nn.Module, mesh, min_shard_size: int = 2**16) -> dict[str, Spec]:
    """The spec of every parameter of `model`, in torch's dim order, by
    the reference's rules:

    - an expert parameter whose leading dim the expert axis divides
      shards dim 0 over "expert", and also its last axis over "model"
      when that divides, it has at least 3 dims and 2^16 elements;
    - any other parameter of at least 2 dims and 2^16 elements shards the
      reference's last axis over "model" when that divides;
    - the rest is replicated (all None).

    The "last axis" is the reference's: dim 0 of a torch Linear or
    convolution weight (`_reference_last_dim`), so each spec names the
    same logical axis as the reference's PartitionSpec for that
    parameter."""
    sizes = axis_sizes(mesh)
    model_size = sizes.get(MODEL_AXIS, 1)
    expert_size = sizes.get(EXPERT_AXIS, 1)
    modules = dict(model.named_modules())
    specs: dict[str, Spec] = {}
    for name, p in model.named_parameters():
        owner, _, leaf = name.rpartition(".")
        last = _reference_last_dim(modules[owner], leaf, p)
        spec: list = [None] * p.ndim
        if expert_size > 1 and p.ndim >= 2 and _is_expert_param(name) \
                and p.shape[0] % expert_size == 0:
            spec[0] = EXPERT_AXIS
            if (model_size > 1 and p.ndim >= 3 and p.shape[last] % model_size == 0
                    and p.numel() >= min_shard_size):
                spec[last] = MODEL_AXIS
        elif (model_size > 1 and p.ndim >= 2 and p.shape[last] % model_size == 0
              and p.numel() >= min_shard_size):
            spec[last] = MODEL_AXIS
        specs[name] = tuple(spec)
    return specs


def dtensor_placements(mesh, spec: Spec) -> list:
    """`spec` as DTensor placements, one per mesh axis (checkpoints)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, a in enumerate(spec)
                if a == axis or (isinstance(a, tuple) and axis in a)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out
