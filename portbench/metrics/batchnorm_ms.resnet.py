"""batchnorm_ms.resnet (ms, layer "model: models/resnet.py"): device ms a
traced step of BatchNorm's forward and backward ops."""

from portbench.readers import ms_per_step


def _batch_norm(name):
    lowered = name.lower()
    return "batch_norm" in lowered or "batchnorm" in lowered


def read(run):
    return ms_per_step(run, _batch_norm)
