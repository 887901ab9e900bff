"""optimizer_ms.<family> (ms, layer "step: parallel/train.py"): device ms a
traced step under torch's `Optimizer.step#SGD.step` range: the
SGD-Nesterov update."""

from portbench.readers import is_optimizer, ms_per_step


def read(run):
    return ms_per_step(run, is_optimizer)
