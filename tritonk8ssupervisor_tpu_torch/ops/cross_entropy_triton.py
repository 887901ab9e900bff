"""K1 on Hopper: fused softmax cross-entropy + argmax-correct, in Triton.

Replaces the TPU kernel `tritonk8ssupervisor_tpu/ops/cross_entropy.py::
_ce_kernel` (launched by `_forward`, :56-146). Same function per row:
upcast to f32, row max, `lse = log sum exp(x - max)`, `picked` = the
label's shifted logit (-inf for a label in [C, C rounded up to 128), the
TPU kernel's padding lanes; 0 for any other label outside [0, C)), and
returns `loss = lse - picked` and `correct = (picked >= 0) and
0 <= label < C`.

What bounds it on an H100: memory. It reads the (B, C) logits once and
the labels, and writes one f32 loss and one bool per row:
B*C*4 + B*(4 + 4 + 1) bytes for f32 logits and int32 labels. At the
ResNet shape (256, 1000) that is 1.03 MB, 0.31 us at 3.35 TB/s, so there
the launch, not the card, sets its time. At an LM shape (4096, 32000) it
is 524 MB, 157 us.

Design, and how it differs from the TPU kernel: one program per row,
looping over column tiles of BLOCK_C (a power of two) with a running max
and a rescaled running sum (online logsumexp), so a row at a 32k LM
vocabulary never sits in registers at once, where the TPU kernel held a
whole row block in VMEM. Masked loads replace the TPU kernel's 128-lane
class padding and its batch padding. The label's logit is picked in the
tile that holds it. The logits are read exactly once.

This module imports triton at the top, so only the launcher in
`cross_entropy.py` imports it, inside the call that launches on a CUDA
tensor: hosts without triton can still import `cross_entropy.py`.
"""

from __future__ import annotations

import torch
import triton
import triton.language as tl

# Column tile ceiling: 4096 f32 per program is 16 KB in flight per tile,
# 32 registers a thread at 8 warps.
_MAX_BLOCK_C = 4096


@triton.jit
def _ce_fwd_kernel(
    logits_ptr,
    labels_ptr,
    loss_ptr,
    correct_ptr,
    num_classes,
    row_stride,
    BLOCK_C: tl.constexpr,
):
    row = tl.program_id(0).to(tl.int64)
    row_ptr = logits_ptr + row * row_stride
    label = tl.load(labels_ptr + row).to(tl.int64)
    cols = tl.arange(0, BLOCK_C)
    row_max = float("-inf")
    sum_exp = 0.0
    label_logit = 0.0
    for start in range(0, num_classes, BLOCK_C):
        offs = start + cols
        in_row = offs < num_classes
        x = tl.load(row_ptr + offs, mask=in_row, other=float("-inf"))
        x = x.to(tl.float32)
        new_max = tl.maximum(row_max, tl.max(x, axis=0))
        sum_exp = sum_exp * tl.exp(row_max - new_max) + tl.sum(
            tl.exp(x - new_max), axis=0
        )
        label_logit += tl.sum(tl.where((offs == label) & in_row, x, 0.0), axis=0)
        row_max = new_max
    label_valid = (label >= 0) & (label < num_classes)
    # a label in [C, C rounded up to 128) picks one of the TPU kernel's
    # padding lanes, whose shifted logit is -inf
    pad_lane = (label >= num_classes) & (label < (num_classes + 127) // 128 * 128)
    # the same f32 subtraction as the TPU kernel's `shifted`, so the
    # row max reads exactly 0 and `correct` is argmax == label up to ties
    picked = tl.where(label_valid, label_logit - row_max,
                      tl.where(pad_lane, float("-inf"), 0.0))
    tl.store(loss_ptr + row, tl.log(sum_exp) - picked)
    tl.store(correct_ptr + row, ((picked >= 0.0) & label_valid).to(tl.uint8))


def launch(
    logits: torch.Tensor,
    labels: torch.Tensor,
    losses: torch.Tensor,
    correct: torch.Tensor,
) -> None:
    """Launch K1 on the current stream into the caller's `losses` (B,)
    f32 and `correct` (B,) bool. The caller has checked device, dtype,
    rank and contiguity; this allocates nothing and does not synchronise."""
    batch, num_classes = logits.shape
    block_c = min(triton.next_power_of_2(num_classes), _MAX_BLOCK_C)
    _ce_fwd_kernel[(batch,)](
        logits,
        labels,
        losses,
        correct.view(torch.uint8),
        num_classes,
        logits.stride(0),
        BLOCK_C=block_c,
        num_warps=4 if block_c <= 2048 else 8,
    )
