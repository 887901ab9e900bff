"""elementwise_ms.lm (ms, layer "model: models/transformer.py"): device ms a
traced step outside the matrix products, the port's own `tk8s::*` kernels
and the optimizer: LayerNorm's pieces, GELU, casts, adds, reductions."""

from portbench.readers import is_optimizer, is_port_kernel, is_product


def read(run):
    others = sum(run.trace.op_seconds(match)[0] for match in (is_product, is_port_kernel, is_optimizer))
    return (run.trace.busy_s - others) * 1e3 / run.trace.steps
