"""Input pipeline: the port of `tritonk8ssupervisor_tpu/utils/data.py`.

The benchmarks make their data on the device; these two serve a user
training on real data on a mesh of ranks:

- `prefetch_to_mesh(it, mesh, size)` takes an iterator of GLOBAL batches
  (dicts, lists or tuples of arrays or tensors, the batch dim first) and
  yields this rank's shard of each, copied to the mesh's device `size`
  batches ahead of the consumer (non-blocking host-to-device copies from
  pinned memory on the card, so the copy overlaps the step);
- `global_batch_from_local(mesh, local_batch)` takes the batch a rank's
  own loader produced (its shard: global batch / batch degree) and puts
  it on the mesh's device.

A rank's shard is the slice of the batch dim that the reference's
`batch_sharding` over the batch axes gives the device at the rank's
place on the mesh: shards in (data, expert) row-major order.
"""

from __future__ import annotations

import collections
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from tritonk8ssupervisor_tpu_torch.parallel import mesh as mesh_lib


def _tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _to_device(x: Any, device: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.tensor(np.asarray(x))
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def mesh_device(mesh) -> torch.device:
    """The device this rank's tensors live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_shard(mesh, x: Any) -> Any:
    """This rank's rows of a global batch leaf (batch dim first)."""
    axes = mesh_lib.batch_axes(mesh)
    n = mesh_lib.axes_size(mesh, axes)
    if x.shape[0] % n:
        raise ValueError(f"global batch {x.shape[0]} does not split into {n} shards")
    per = x.shape[0] // n
    start = mesh_lib.axis_index(mesh, axes) * per
    return x[start:start + per]


def prefetch_to_mesh(iterator: Iterable[Any], mesh, size: int = 2) -> Iterator[Any]:
    """Yield this rank's shard of every global batch of `iterator`, on the
    mesh's device, keeping up to `size` copies in flight ahead."""
    if size < 1:
        raise ValueError(f"prefetch size must be >= 1, got {size}")
    device = mesh_device(mesh)
    queue: collections.deque = collections.deque()
    for batch in iterator:
        queue.append(_tree_map(lambda x: _to_device(batch_shard(mesh, x), device), batch))
        if len(queue) > size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


def global_batch_from_local(mesh, local_batch: Any) -> Any:
    """This rank's own shard of the global batch (what its loader made:
    leading dim global batch / batch degree) on the mesh's device. Every
    rank passes the same leading size."""
    device = mesh_device(mesh)
    return _tree_map(lambda x: _to_device(x, device), local_batch)
