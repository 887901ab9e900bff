"""Kernels of the port and their plain torch versions. The attention
entry is `ops.flash_attention.flash_attention` (not re-exported here,
where it would hide its module)."""

from tritonk8ssupervisor_tpu_torch.ops.conv_backward import (
    conv1x1,
    conv1x1_backward,
    conv1x1_backward_kernel,
    conv1x1_backward_plain,
)
from tritonk8ssupervisor_tpu_torch.ops.cross_entropy import (
    cross_entropy_backward,
    cross_entropy_backward_plain,
    cross_entropy_forward,
    cross_entropy_forward_plain,
    cross_entropy_loss,
    cross_entropy_loss_and_correct,
    cross_entropy_loss_and_correct_reference,
    cross_entropy_loss_reference,
)
from tritonk8ssupervisor_tpu_torch.ops.decode_attention import (
    decode_attention_int8,
    decode_attention_int8_plain,
    decode_attention_kernel,
)
from tritonk8ssupervisor_tpu_torch.ops.pool_backward import max_pool_3x3_s2
from tritonk8ssupervisor_tpu_torch.ops.ring_attention import (
    attention_reference,
    attention_reference_layout,
)

__all__ = [
    "attention_reference",
    "attention_reference_layout",
    "conv1x1",
    "conv1x1_backward",
    "conv1x1_backward_kernel",
    "conv1x1_backward_plain",
    "cross_entropy_backward",
    "cross_entropy_backward_plain",
    "cross_entropy_forward",
    "cross_entropy_forward_plain",
    "cross_entropy_loss",
    "cross_entropy_loss_and_correct",
    "cross_entropy_loss_and_correct_reference",
    "cross_entropy_loss_reference",
    "decode_attention_int8",
    "decode_attention_int8_plain",
    "decode_attention_kernel",
    "max_pool_3x3_s2",
]
