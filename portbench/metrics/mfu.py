"""mfu.<family> (%, layer "step: parallel/train.py"): the step's model
FLOPs, counted from the configuration's shapes (the family's
`model_flops_per_step`), times the steps of the window, over the window
time x 989 TFLOP/s. One reader for every family; the name's suffix says
which end-to-end metric it moves."""

from portbench.readers import mfu_percent


def read(run):
    return mfu_percent(run)
