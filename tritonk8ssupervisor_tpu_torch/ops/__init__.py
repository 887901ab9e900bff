"""Kernels of the port and their plain torch versions. The attention
entry is `ops.flash_attention.flash_attention` (not re-exported here,
where it would hide its module)."""

from tritonk8ssupervisor_tpu_torch.ops.cross_entropy import (
    cross_entropy_forward,
    cross_entropy_forward_plain,
    cross_entropy_loss,
    cross_entropy_loss_and_correct,
    cross_entropy_loss_and_correct_reference,
    cross_entropy_loss_reference,
)
from tritonk8ssupervisor_tpu_torch.ops.ring_attention import (
    attention_reference,
    attention_reference_layout,
)

__all__ = [
    "attention_reference",
    "attention_reference_layout",
    "cross_entropy_forward",
    "cross_entropy_forward_plain",
    "cross_entropy_loss",
    "cross_entropy_loss_and_correct",
    "cross_entropy_loss_and_correct_reference",
    "cross_entropy_loss_reference",
]
