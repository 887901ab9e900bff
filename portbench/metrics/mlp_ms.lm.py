"""mlp_ms.lm (ms, layer "model: models/transformer.py"): device ms a traced
step of the ops inside `model.mlp` spans (each block's two products, GELU
and residual add), and of the backward nodes those ops made
(`spans.sublayer_ms`)."""

from portbench.spans import sublayer_ms


def read(run):
    return sublayer_ms(run.trace, "model.mlp")
