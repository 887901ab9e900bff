"""k2_roofline.lm (%, layer "kernels: ops/flash_attention.py"): K2's share
of its roofline, the bound of every call (`frozen.k2_forward_cost`,
`k2_backward_cost` at the cell's shapes) over the device time of
`tk8s::flash_attn_fwd` and `tk8s::flash_attn_bwd`."""

from portbench.readers import roofline_percent


def read(run):
    return roofline_percent(run, "k2", ("tk8s::flash_attn_fwd", "tk8s::flash_attn_bwd"))
