"""Fused softmax cross-entropy + argmax-correct: the port of
`tritonk8ssupervisor_tpu/ops/cross_entropy.py`.

Forward: kernel K1's forward (`csrc/cross_entropy.cu`, launched through
`ops/cross_entropy_cuda.py`) on a CUDA tensor; on a CPU tensor,
`cross_entropy_forward_plain`, which repeats the kernel's arithmetic in
plain torch. Both also give the row's logsumexp, which the autograd
function saves for the backward.

Backward: K1's backward on a CUDA tensor, one fused pass
`(exp(x - lse) - onehot) * g` over the logits, read once and written
once; on a CPU tensor, `cross_entropy_backward_plain`. The reference
leaves this function (`_dlogits`, :237-241) to XLA's fusion.

On the card both directions are the `torch.library` ops
`tk8s::cross_entropy_fwd` and `tk8s::cross_entropy_bwd`; a CUDA tensor
goes through the kernels or raises: there is no fallback to the plain
versions.

`vocab_parallel_cross_entropy` (:189-234) is the loss over class-sharded
logits under tensor parallelism: plain torch and collectives over the
"model" group, as the reference's is plain XLA.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from tritonk8ssupervisor_tpu_torch.ops import cross_entropy_cuda
from tritonk8ssupervisor_tpu_torch.parallel import collectives as coll

# the TPU kernel pads the classes to whole 128-lane vregs
_LANE = 128


# K1's f32 work per logit: max, subtract, exp, add, label compare; its
# backward's: subtract lse, exp, subtract the one-hot, times g
OPS_PER_LOGIT = 5
BACKWARD_OPS_PER_LOGIT = 4


def forward_cost(batch: int, classes: int, logits_bytes: int,
                 labels_bytes: int) -> tuple[int, int]:
    """(bytes, operations) of K1's forward on (batch, classes) logits of
    `logits_bytes` an element and labels of `labels_bytes`: each input
    read once, each output written once (the f32 loss, the 1-byte correct
    and the f32 logsumexp), and OPS_PER_LOGIT f32 operations a logit.
    `chip_smoke.py`'s bound and `utils/roofline.py` both read it."""
    n_bytes = batch * classes * logits_bytes + batch * (labels_bytes + 4 + 1 + 4)
    return n_bytes, batch * classes * OPS_PER_LOGIT


def backward_cost(batch: int, classes: int, logits_bytes: int,
                  labels_bytes: int) -> tuple[int, int]:
    """(bytes, operations) of K1's backward: the logits, labels, f32
    logsumexp and f32 g (one a row) read once, the logits' gradient
    written once, BACKWARD_OPS_PER_LOGIT f32 operations a logit."""
    n_bytes = 2 * batch * classes * logits_bytes + batch * (labels_bytes + 4 + 4)
    return n_bytes, batch * classes * BACKWARD_OPS_PER_LOGIT


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
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's forward in plain torch: what the kernel computes, step for step
    as the TPU kernel does (`_ce_kernel`, :56-75), and the row's logsumexp.
    A label outside [0, C) reads incorrect. Its loss is what the TPU kernel
    gives: a label in [C, padded_classes(C)) picks one of that kernel's
    padding lanes, whose shifted logit is -inf, so its loss is +inf; any
    other label outside [0, C) picks nothing and its loss is logsumexp(x) -
    max(x).

    Returns (B,) f32 losses, (B,) bool correct and (B,) f32 lse =
    max(x) + log(sum(exp(x - max(x)))), which the backward reads."""
    x = logits.float()
    num_classes = x.shape[-1]
    row_max = x.amax(dim=-1, keepdim=True)
    shifted = x - row_max
    log_sum = shifted.exp().sum(dim=-1).log()
    hit = torch.arange(num_classes, device=x.device) == labels[:, None]
    picked = torch.where(hit, shifted, 0.0).sum(dim=-1)
    pad_lane = (labels >= num_classes) & (labels < padded_classes(num_classes))
    picked = torch.where(pad_lane, float("-inf"), picked)
    valid = (labels >= 0) & (labels < num_classes)
    return log_sum - picked, (picked >= 0.0) & valid, row_max[:, 0] + log_sum


def cross_entropy_backward_plain(
    logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """K1's backward in plain torch, step for step as the kernel computes
    it: `(exp(x - lse) - [j == label]) * g` in f32, in the logits' dtype,
    where [j == label] is 0 for a label outside [0, C) (as
    `jax.nn.one_hot` gives) and g is the (B,) cotangent of the losses.
    The reference's `_dlogits` (:237-241) computes the same function as
    `(softmax(x) - onehot) * g`."""
    x = logits.float()
    hit = torch.arange(x.shape[-1], device=x.device) == labels[:, None]
    return ((torch.exp(x - lse[:, None]) - hit.float()) * g[:, None]).to(logits.dtype)


def _check_shapes(logits: torch.Tensor, labels: torch.Tensor) -> None:
    if logits.dim() != 2 or labels.dim() != 1 or labels.shape[0] != logits.shape[0]:
        raise ValueError(
            f"expected logits (B, C) and labels (B,), got "
            f"{tuple(logits.shape)} and {tuple(labels.shape)}"
        )


def _not_on_one_card(logits: torch.Tensor, *others: torch.Tensor) -> ValueError:
    return ValueError(
        f"logits on {logits.device}, labels (and lse, g) on "
        f"{[str(t.device) for t in others]}: the kernel needs all on one CUDA device "
        "(CPU tensors take the plain version)"
    )


def _check_kernel_inputs(logits: torch.Tensor, labels: torch.Tensor, lse=None, g=None) -> None:
    """Raises on what K1 does not take: shapes other than (B, C) and (B,),
    anything off one CUDA device, other dtypes, non-contiguous logits,
    labels or lse, no classes. The backward's lse and g are (B,) f32, g at
    any stride."""
    _check_shapes(logits, labels)
    device = logits.device
    rows = () if lse is None else (lse, g)
    if device.type != "cuda" or labels.device != device or any(t.device != device for t in rows):
        raise _not_on_one_card(logits, labels, *rows)
    if (logits.dtype not in cross_entropy_cuda.DTYPES
            or labels.dtype not in cross_entropy_cuda.LABEL_DTYPES
            or any(t.dtype != torch.float32 for t in rows)):
        raise TypeError(
            f"kernel takes logits in {tuple(cross_entropy_cuda.DTYPES)}, labels in "
            f"{cross_entropy_cuda.LABEL_DTYPES} and f32 lse and g, got {logits.dtype}, "
            f"{labels.dtype}" + "".join(f", {t.dtype}" for t in rows)
        )
    if not (logits.is_contiguous() and labels.is_contiguous()
            and (lse is None or lse.is_contiguous())):
        raise ValueError("kernel takes contiguous logits, labels and lse")
    if any(t.shape != labels.shape for t in rows):
        raise ValueError(f"lse and g must be (B,) = {tuple(labels.shape)}, got "
                         f"{[tuple(t.shape) for t in rows]}")
    if not 0 < logits.shape[1] < 2**31:
        raise ValueError(f"kernel takes 1 to 2^31 - 1 classes, got {logits.shape[1]}")


def cross_entropy_forward_kernel(
    logits: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K1's forward on the card: (B,) f32 losses, (B,) bool correct and
    (B,) f32 lse; anything the kernel does not take raises. One launch,
    counted in `cross_entropy_forward.launches`; an empty batch launches
    nothing."""
    _check_kernel_inputs(logits, labels)
    batch = logits.shape[0]
    losses = torch.empty(batch, dtype=torch.float32, device=logits.device)
    correct = torch.empty(batch, dtype=torch.bool, device=logits.device)
    lse = torch.empty(batch, dtype=torch.float32, device=logits.device)
    if batch:
        cross_entropy_cuda.forward(logits, labels, losses, correct, lse)
        cross_entropy_forward.launches += 1
    return losses, correct, lse


def cross_entropy_backward_kernel(
    logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """K1's backward on the card: the (B, C) logits' gradient in their
    dtype; anything the kernel does not take raises. One launch, counted in
    `cross_entropy_backward.launches`; an empty batch launches nothing."""
    _check_kernel_inputs(logits, labels, lse, g)
    dlogits = torch.empty_like(logits, memory_format=torch.contiguous_format)
    if logits.shape[0]:
        cross_entropy_cuda.backward(logits, labels, lse, g, dlogits)
        cross_entropy_backward.launches += 1
    return dlogits


# K1 runs once a train step, but its binding is the dispatcher's own, as
# K3's is (`ops/decode_attention.py`): `torch.library.Library.define` and
# `impl` call the launcher directly, without `torch.library.custom_op`'s
# Python wrappers around every call
_LIB = torch.library.Library("tk8s", "FRAGMENT")
_LIB.define("cross_entropy_fwd(Tensor logits, Tensor labels) -> (Tensor, Tensor, Tensor)")
_LIB.define("cross_entropy_bwd(Tensor logits, Tensor labels, Tensor lse, Tensor g) -> Tensor")
_LIB.impl("cross_entropy_fwd", cross_entropy_forward_kernel, "CUDA")
_LIB.impl("cross_entropy_bwd", cross_entropy_backward_kernel, "CUDA")


@torch.library.register_fake("tk8s::cross_entropy_fwd", lib=_LIB)
def _(logits, labels):
    batch = logits.shape[0]
    return (logits.new_empty(batch, dtype=torch.float32),
            logits.new_empty(batch, dtype=torch.bool),
            logits.new_empty(batch, dtype=torch.float32))


@torch.library.register_fake("tk8s::cross_entropy_bwd", lib=_LIB)
def _(logits, labels, lse, g):
    return torch.empty_like(logits, memory_format=torch.contiguous_format)


def _forward(logits, labels):
    """(losses, correct, lse): the plain version for CPU tensors, else K1's
    forward op, which raises on what the kernel does not take."""
    if logits.device.type == "cpu" and labels.device.type == "cpu":
        _check_shapes(logits, labels)
        return cross_entropy_forward_plain(logits, labels)
    if logits.device.type != "cuda" or labels.device != logits.device:
        raise _not_on_one_card(logits, labels)  # a meta tensor would reach the fake
    return torch.ops.tk8s.cross_entropy_fwd(logits, labels)


def cross_entropy_forward(
    logits: torch.Tensor, labels: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's forward: (B,) f32 losses and (B,) bool correct.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (one launch, counted in `cross_entropy_forward.launches`) or
    raises on what the kernel does not take."""
    losses, correct, _ = _forward(logits, labels)
    return losses, correct


cross_entropy_forward.launches = 0


def cross_entropy_backward(
    logits: torch.Tensor, labels: torch.Tensor, lse: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """K1's backward: the logits' gradient from the forward's lse and the
    (B,) cotangent g of the losses.

    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    launch, counted in `cross_entropy_backward.launches`) or raise on what
    it does not take."""
    if all(t.device.type == "cpu" for t in (logits, labels, lse, g)):
        _check_shapes(logits, labels)
        return cross_entropy_backward_plain(logits, labels, lse, g)
    if logits.device.type != "cuda" or any(t.device != logits.device for t in (labels, lse, g)):
        raise _not_on_one_card(logits, labels, lse, g)  # a meta tensor would reach the fake
    return torch.ops.tk8s.cross_entropy_bwd(logits, labels, lse, g)


cross_entropy_backward.launches = 0


class _CrossEntropy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        losses, correct, lse = _forward(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        ctx.mark_non_differentiable(correct)
        return losses, correct

    @staticmethod
    def backward(ctx, g, _g_correct):
        logits, labels, lse = ctx.saved_tensors
        return cross_entropy_backward(logits, labels, lse, g), None


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
