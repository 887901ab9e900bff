"""k4_roofline.resnet (%, layer "kernels: ops/conv_backward.py"): K4's
share of its roofline, the bound of every call (`frozen.k4_backward_cost` at
the step's 1x1 shapes) over the device time of `tk8s::conv1x1_bwd`."""

from portbench.readers import roofline_percent


def read(run):
    return roofline_percent(run, "k4", ("tk8s::conv1x1_bwd",))
