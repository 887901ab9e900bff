"""forward_ms.<family> (ms, layer "step: parallel/train.py"): device ms a
traced step of the kernels launched by ops that start inside the step's
`train.forward` spans (`spans.launched_ms`)."""

from portbench.spans import launched_ms


def read(run):
    return launched_ms(run.trace, "train.forward")
