"""The training steps of the port on one device or a mesh of ranks, the
mesh, its collectives, checkpoints, cluster formation from the env
contract, the elastic trainer and a local launcher of ranks.

The names below load on first use, so that the kernels' modules can
import `parallel.collectives` and `parallel.mesh` without importing the
train steps (which import the models, which import those modules).
"""

import importlib

_EXPORTS = {
    "TrainState": "train",
    "create_train_state": "train",
    "default_optimizer": "train",
    "lm_optimizer": "train",
    "make_lm_eval_step": "train",
    "make_lm_train_step": "train",
    "make_train_step": "train",
    "batch_axes": "mesh",
    "batch_degree": "mesh",
    "make_cross_slice_mesh": "mesh",
    "make_mesh": "mesh",
    "make_workload_mesh": "mesh",
    "param_shardings": "mesh",
    "cluster_env": "distributed",
    "initialize_from_env": "distributed",
    "ElasticCheckpoint": "elastic",
    "ElasticPolicy": "elastic",
    "ElasticTrainer": "elastic",
    "FileHealthSource": "elastic",
    "JobAck": "elastic",
    "ScriptedHealthSource": "elastic",
    "TrainSession": "elastic",
    "run_ranks": "ranks",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name]}")
    return getattr(module, name)
