"""Fused softmax cross-entropy + argmax-correct: the port of
`tritonk8ssupervisor_tpu/ops/cross_entropy.py`.

Forward: kernel K1 (`cross_entropy_triton.py`) on a CUDA tensor; on a
CPU tensor, `cross_entropy_forward_plain`, which repeats the kernel's
arithmetic in plain torch. A CUDA tensor goes through the kernel or
raises: there is no fallback.

Backward: plain torch, `(softmax(logits) - onehot) * g`, as in the
reference (`_dlogits`, :237-241): one fused elementwise expression over
the logits, which a hand kernel would not improve on.

`vocab_parallel_cross_entropy` (:189-234) is the loss over class-sharded
logits under tensor parallelism: plain torch and collectives over the
"model" group, as the reference's is plain XLA.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tritonk8ssupervisor_tpu_torch.parallel import collectives as coll

_LOGIT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)
_LABEL_DTYPES = (torch.int32, torch.int64)
# the TPU kernel pads the classes to whole 128-lane vregs
_LANE = 128


def padded_classes(num_classes: int) -> int:
    """C rounded up to the TPU kernel's 128-lane multiple."""
    return -(-num_classes // _LANE) * _LANE


def cross_entropy_loss_reference(
    logits: torch.Tensor, labels: torch.Tensor
) -> torch.Tensor:
    """Per-example loss as `log_softmax` + gather; the ground truth the
    kernel is tested against. Labels must lie in [0, C)."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, labels.long()[:, None])[:, 0]


def cross_entropy_loss_and_correct_reference(
    logits: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """(losses, argmax == label): the metric path off the card."""
    return (
        cross_entropy_loss_reference(logits, labels),
        logits.argmax(dim=-1) == labels,
    )


def cross_entropy_forward_plain(
    logits: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's semantics in plain torch: what the kernel computes, step for
    step as the TPU kernel does (`_ce_kernel`, :56-75). A label outside
    [0, C) reads incorrect. Its loss is what the TPU kernel gives: a label
    in [C, padded_classes(C)) picks one of that kernel's padding lanes,
    whose shifted logit is -inf, so its loss is +inf; any other label
    outside [0, C) picks nothing and its loss is logsumexp(x) - max(x)."""
    x = logits.float()
    num_classes = x.shape[-1]
    shifted = x - x.amax(dim=-1, keepdim=True)
    lse = shifted.exp().sum(dim=-1).log()
    hit = torch.arange(num_classes, device=x.device) == labels[:, None]
    picked = torch.where(hit, shifted, 0.0).sum(dim=-1)
    pad_lane = (labels >= num_classes) & (labels < padded_classes(num_classes))
    picked = torch.where(pad_lane, float("-inf"), picked)
    valid = (labels >= 0) & (labels < num_classes)
    return lse - picked, (picked >= 0.0) & valid


def cross_entropy_forward(
    logits: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's wrapper: (B,) f32 losses and (B,) bool correct.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    Triton kernel (one launch, counted in `cross_entropy_forward.launches`)
    or raises on what the kernel does not take."""
    if logits.dim() != 2 or labels.dim() != 1 or labels.shape[0] != logits.shape[0]:
        raise ValueError(
            f"expected logits (B, C) and labels (B,), got "
            f"{tuple(logits.shape)} and {tuple(labels.shape)}"
        )
    if logits.device.type == "cpu" and labels.device.type == "cpu":
        return cross_entropy_forward_plain(logits, labels)
    if logits.device.type != "cuda" or labels.device != logits.device:
        raise ValueError(
            f"logits on {logits.device} and labels on {labels.device}: "
            "the kernel needs both on one CUDA device"
        )
    if logits.dtype not in _LOGIT_DTYPES or labels.dtype not in _LABEL_DTYPES:
        raise TypeError(
            f"kernel takes logits in {_LOGIT_DTYPES} and labels in "
            f"{_LABEL_DTYPES}, got {logits.dtype} and {labels.dtype}"
        )
    if not (logits.is_contiguous() and labels.is_contiguous()):
        raise ValueError("kernel takes contiguous logits and labels")
    batch = logits.shape[0]
    losses = torch.empty(batch, dtype=torch.float32, device=logits.device)
    correct = torch.empty(batch, dtype=torch.bool, device=logits.device)
    if batch == 0:
        return losses, correct
    from tritonk8ssupervisor_tpu_torch.ops import cross_entropy_triton

    cross_entropy_triton.launch(logits, labels, losses, correct)
    cross_entropy_forward.launches += 1
    return losses, correct


cross_entropy_forward.launches = 0


def _dlogits(logits, labels, g):
    probs = torch.softmax(logits.float(), dim=-1)
    # a mask, not F.one_hot: a label outside [0, C) gives a zero row, as
    # jax.nn.one_hot does, where F.one_hot would raise
    classes = torch.arange(logits.shape[-1], device=logits.device)
    onehot = (classes == labels[:, None]).float()
    return ((probs - onehot) * g[:, None]).to(logits.dtype)


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        losses, correct = cross_entropy_forward(logits, labels)
        ctx.save_for_backward(logits, labels)
        ctx.mark_non_differentiable(correct)
        return losses, correct

    @staticmethod
    def backward(ctx, g, _g_correct):
        logits, labels = ctx.saved_tensors
        return _dlogits(logits, labels, g), None


def cross_entropy_loss_and_correct(
    logits: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-example softmax cross-entropy AND argmax-correctness from one
    pass over the logits (K1), differentiable in the logits.

    Args:
      logits: (batch, classes) float tensor; f32 math inside.
      labels: (batch,) int32 or int64 class ids.

    Returns ((batch,) f32 losses, (batch,) bool correct), correct meaning
    the label's logit equals the row max (argmax == label up to ties).
    """
    return _CrossEntropy.apply(logits, labels)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy through K1: (batch,) f32 losses."""
    return _CrossEntropy.apply(logits, labels)[0]


def vocab_parallel_cross_entropy(
    logits_block: torch.Tensor, labels: torch.Tensor, group
) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-entropy over class-sharded logits (reference :189-234): this
    rank holds the (batch, C / n) block of classes [rank * C / n, ...) of
    the same batch rows as every rank of `group`, and every rank gets the
    same (batch,) f32 losses and correct flags, as if it held all C.

    Three per-example collectives instead of gathering the logits: the
    max of an all_gather of the shard maxima (outside the gradient: it
    cancels in lse - picked), the all-reduced partition sum, and the
    all-reduced logit of the label, which one shard owns. `correct` is
    `picked >= global max`, and False for a label no shard owns (outside
    [0, C)). The sums pass their gradients back unreduced
    (`reduce_from_group`), so the gradient in the local logits is the
    reference's: softmax - onehot of this rank's classes."""
    block = logits_block.float()
    _, c_local = block.shape
    offset = dist.get_rank(group) * c_local
    with torch.no_grad():
        local_max = block.amax(dim=-1)
        global_max = coll.gather_values(local_max[None], group, 0).amax(dim=0)
    z_local = torch.exp(block - global_max[:, None]).sum(dim=-1)
    lse = torch.log(coll.reduce_from_group(z_local, group)) + global_max
    local_label = labels.long() - offset
    mine = (local_label >= 0) & (local_label < c_local)
    picked_here = block.gather(-1, local_label.clamp(0, c_local - 1)[:, None])[:, 0]
    picked = coll.reduce_from_group(torch.where(mine, picked_here, 0.0), group)
    any_mine = coll.sum_values(mine.int(), group) > 0
    correct = (picked.detach() >= global_max) & any_mine
    return lse - picked, correct
