"""Weight carrier: the reference model's flax variables -> the port's
`state_dict`.

Takes the variables as a nested dict of numpy arrays (what
`jax.device_get(variables)` gives), so it never needs JAX. Module names
are the same on both sides (`models/resnet.py`, `models/transformer.py`,
`models/vit.py`, `models/moe.py`); only the leaf names and layouts
differ:

    params      .../kernel (kh, kw, in, out)  -> .../weight (out, in, kh, kw)
    params      .../kernel (in, out)          -> .../weight (out, in)
    params      .../bias                      -> .../bias
    params      .../scale                     -> .../weight
    params      .../embedding                 -> .../weight
    params      <name> (a module's own param) -> <name>
    batch_stats .../mean                      -> .../running_mean
    batch_stats .../var                       -> .../running_var

The pipelined LM's parameters (`parallel/pipeline.py`) carry the same
way: the reference's {"outer": ..., "stages": ...} tree maps onto a
`PipelinedLM`'s `outer.*` and `stages.*`, and under `stages` every leaf
leads with the (P, L/P) stack dims, which the layout change leaves in
front (a stacked Dense kernel (P, L/P, in, out) -> (P, L/P, out, in)).

The last params row is a parameter that a module declares itself rather
than through a submodule: the LM's and the ViT's `pos_embed`, the ViT's
`cls_token` (1, 1, D), and the five leaves of a `moe_mlp`
(`router_kernel` (d, E), `expert_up_kernel` (E, d, f), `expert_up_bias`,
`expert_down_kernel` (E, f, d), `expert_down_bias`), which the port
declares with the reference's names and layouts: its path is kept as it
is. The ViT's `patch_embed` is a 4-d conv kernel (HWIO -> OIHW) and its
`classifier` a Dense. The head-major attention projections keep the
Dense (in, out) kernels, so they map as any Dense does.

Any leaf it cannot map, and any entry of the port's state dict left
unfilled, raises: a silently half-loaded model would make every parity
test meaningless.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

_LEAVES = {
    "params": {"kernel": "weight", "bias": "bias", "scale": "weight",
               "embedding": "weight"},
    "batch_stats": {"mean": "running_mean", "var": "running_var"},
}


def _walk(tree: Mapping[str, Any], prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _to_torch_layout(leaf: str, value: np.ndarray, stack_dims: int = 0) -> np.ndarray:
    """`value` in the port's layout; its first `stack_dims` dims (the
    pipeline's stage stack) stay in front."""
    k = value.ndim - stack_dims
    if leaf == "kernel" and k == 4:
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and k == 2:
        return np.swapaxes(value, -1, -2)  # (in, out) -> (out, in)
    return value


def state_dict_from_flax(
    variables: Mapping[str, Any], model: nn.Module
) -> dict[str, torch.Tensor]:
    """The state dict for `model` carried from flax `variables`
    ({"params": ..., "batch_stats": ...}, leaves numpy arrays)."""
    expected = model.state_dict()
    out: dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        names = _LEAVES.get(collection)
        if names is None:
            raise ValueError(f"unmapped variable collection {collection!r}")
        for path, value in _walk(tree):
            *modules, leaf = path
            if leaf in names:
                key = ".".join(modules + [names[leaf]])
            elif collection == "params" and ".".join(path) in expected:
                key = ".".join(path)  # a module's own parameter, e.g. pos_embed
            else:
                raise ValueError(f"unmapped leaf {collection}/{'/'.join(path)}")
            if key not in expected:
                raise ValueError(
                    f"{collection}/{'/'.join(path)} maps to {key!r}, which "
                    "the port's model does not have"
                )
            stack_dims = 2 if collection == "params" and path[0] == "stages" else 0
            array = _to_torch_layout(leaf, np.asarray(value, dtype=np.float32), stack_dims)
            if tuple(array.shape) != tuple(expected[key].shape):
                raise ValueError(
                    f"{key}: flax shape {tuple(array.shape)} after layout "
                    f"change, port shape {tuple(expected[key].shape)}"
                )
            out[key] = torch.from_numpy(np.array(array, order="C"))
    missing = sorted(set(expected) - set(out))
    if missing:
        raise ValueError(f"port parameters left unfilled: {missing}")
    return out
