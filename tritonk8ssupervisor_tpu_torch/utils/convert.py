"""Weight carrier: the reference model's flax variables -> the port's
`state_dict`.

Takes the variables as a nested dict of numpy arrays (what
`jax.device_get(variables)` gives), so it never needs JAX. Module names
are the same on both sides (`models/resnet.py`, `models/transformer.py`);
only the leaf names and layouts differ:

    params      .../kernel (kh, kw, in, out)  -> .../weight (out, in, kh, kw)
    params      .../kernel (in, out)          -> .../weight (out, in)
    params      .../bias                      -> .../bias
    params      .../scale                     -> .../weight
    params      .../embedding                 -> .../weight
    params      <name> (a module's own param) -> <name>
    batch_stats .../mean                      -> .../running_mean
    batch_stats .../var                       -> .../running_var

The last params row is a parameter that a module declares itself rather
than through a submodule, such as the LM's top-level `pos_embed`: its
name is kept as it is. The head-major attention projections keep the
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


def _to_torch_layout(leaf: str, value: np.ndarray) -> np.ndarray:
    if leaf == "kernel" and value.ndim == 4:
        return value.transpose(3, 2, 0, 1)  # HWIO -> OIHW
    if leaf == "kernel" and value.ndim == 2:
        return value.T  # (in, out) -> (out, in)
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
            elif collection == "params" and not modules:
                key = leaf  # the model's own parameter, e.g. pos_embed
            else:
                raise ValueError(f"unmapped leaf {collection}/{'/'.join(path)}")
            if key not in expected:
                raise ValueError(
                    f"{collection}/{'/'.join(path)} maps to {key!r}, which "
                    "the port's model does not have"
                )
            array = _to_torch_layout(leaf, np.asarray(value, dtype=np.float32))
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
