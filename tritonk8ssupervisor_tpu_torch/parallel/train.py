"""The training steps: the port of `tritonk8ssupervisor_tpu/parallel/train.py`
for one device.

The reference's steps are jitted SPMD programs over a mesh; here they are
eager PyTorch on one card: forward in train mode, loss and accuracy from
one pass over the logits (kernel K1 on the card), backward, optimizer
step. The BatchNorm running statistics move inside the forward.
`make_train_step` is the image step; `make_lm_train_step` and
`make_lm_eval_step` are the causal-LM steps, whose masked next-token
metrics are `_next_token_metrics`; `lm_optimizer` is the reference's
AdamW recipe. Both train steps add the router losses of a model's
mixture-of-experts blocks to the objective they differentiate
(`_moe_aux_total`, the reference's), and report the data loss without
them, as the reference does; a MoE model's metrics also carry
`router_loss`.

Not ported yet (ROADMAP.md queue 1, item 4b): the mesh, sequence and
tensor parallelism and the vocab-parallel loss, data parallelism across
cards (DDP), and the pipeline's `forward_fn` hook.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable

import torch
from torch import nn

from tritonk8ssupervisor_tpu_torch import resolve_device
from tritonk8ssupervisor_tpu_torch.models.moe import MoEMLP
from tritonk8ssupervisor_tpu_torch.ops.cross_entropy import (
    cross_entropy_loss_and_correct,
    cross_entropy_loss_and_correct_reference,
)

Optimizer = Callable[..., torch.optim.Optimizer]


@dataclasses.dataclass
class TrainState:
    """The reference's TrainState (step, params, batch_stats, opt_state):
    the model holds the parameters and BatchNorm statistics, the
    optimizer its momentum buffers."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def _moe_aux_total(model: nn.Module) -> torch.Tensor | None:
    """Sum of the router losses that the model's MoE layers kept from its
    last forward (the reference's "moe_losses" collection); None for a
    dense model. Read right after the forward: a block that
    `torch.utils.checkpoint` recomputes in the backward overwrites its
    loss only after the objective was built."""
    losses = [m.router_loss for m in model.modules() if isinstance(m, MoEMLP)]
    return sum(losses) if losses else None


def _default_metrics_fn(device: torch.device) -> Callable:
    """(logits, labels) -> (losses, correct): the fused kernel K1 on the
    card, the plain reference elsewhere (reference train.py:73-83)."""
    if device.type == "cuda":
        return cross_entropy_loss_and_correct
    return cross_entropy_loss_and_correct_reference


def default_optimizer(learning_rate: float = 0.1, momentum: float = 0.9) -> Optimizer:
    """SGD with Nesterov momentum, the ResNet-50 benchmark recipe. The
    same update as optax `sgd(lr, momentum, nesterov=True)`, first step
    included: torch seeds the momentum buffer with the first gradient,
    which is optax's 0 * momentum + g."""
    return functools.partial(
        torch.optim.SGD, lr=learning_rate, momentum=momentum,
        nesterov=True, dampening=0.0,
    )


def create_train_state(
    model: nn.Module, tx: Optimizer, device: str | torch.device | None = None
) -> TrainState:
    """Move `model` to the device (the card unless `device` says
    otherwise) and build its optimizer with `tx`."""
    model.to(resolve_device(device))
    return TrainState(model=model, optimizer=tx(model.parameters()))


def make_train_step(
    state: TrainState,
    loss_fn: Callable | None = None,
    steps_per_call: int = 1,
    metrics_fn: Callable | None = None,
) -> Callable[[torch.Tensor, torch.Tensor], dict]:
    """Build the train step: (images NHWC, labels) -> {"loss", "accuracy"},
    updating `state` in place.

    `metrics_fn` ((logits, labels) -> (losses, correct); default K1 on
    the card) gives both metrics from one pass; a plain `loss_fn`
    (losses only) is accepted for custom losses, and then the accuracy
    takes its own argmax. `steps_per_call` > 1 runs that many optimizer
    steps on the same batch per call and returns the last step's
    metrics. The metrics stay on the device: reading them synchronises.
    """
    if loss_fn is not None and metrics_fn is not None:
        raise ValueError("pass loss_fn or metrics_fn, not both")
    if loss_fn is not None:
        def loss_and_correct(logits, labels):
            return loss_fn(logits, labels), logits.argmax(dim=-1) == labels
    else:
        device = next(state.model.parameters()).device
        loss_and_correct = metrics_fn or _default_metrics_fn(device)

    def step(images: torch.Tensor, labels: torch.Tensor) -> dict:
        state.model.train()
        for _ in range(max(1, steps_per_call)):
            logits = state.model(images)
            losses, correct = loss_and_correct(logits, labels)
            loss = losses.mean()
            aux = _moe_aux_total(state.model)
            state.optimizer.zero_grad(set_to_none=True)
            (loss if aux is None else loss + aux).backward()
            state.optimizer.step()
            state.step += 1
        metrics = {"loss": loss.detach(), "accuracy": correct.float().mean()}
        if aux is not None:
            metrics["router_loss"] = aux.detach()
        return metrics

    return step


def warmup_cosine_decay(
    peak: float, warmup_steps: int, decay_steps: int, end: float
) -> Callable[[int], float]:
    """optax `warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps, end)`: linear from 0 to `peak` over `warmup_steps`, then
    a cosine to `end` at `decay_steps`; count 0 (the first update) gives 0."""
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak * count / warmup_steps
        t = min(count - warmup_steps, decay_steps - warmup_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * t / (decay_steps - warmup_steps)))
        return peak * ((1 - alpha) * cosine + alpha)

    return schedule


class ClippedAdamW(torch.optim.AdamW):
    """optax `chain(clip_by_global_norm(max_norm), adamw(schedule, ...))`
    as one torch optimizer. Before each AdamW update it scales every
    gradient by max_norm / norm when the global norm reaches max_norm (no
    epsilon, as optax; `clip_grad_norm_` would add 1e-6), and sets the
    learning rate to schedule(count) with count = updates made so far, so
    the first update uses schedule(0). AdamW's decoupled decay is scaled
    by that learning rate, as optax's `adamw` does."""

    def __init__(self, params, schedule: Callable[[int], float], max_norm: float,
                 **adamw_kwargs):
        super().__init__(params, lr=schedule(0), **adamw_kwargs)
        self.schedule = schedule
        self.max_norm = max_norm
        self.count = 0

    @torch.no_grad()
    def step(self, closure=None):
        grads = [p.grad for group in self.param_groups for p in group["params"]
                 if p.grad is not None]
        if not grads:
            return super().step(closure)
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads])
        )
        # optax: where(norm < max, g, g / norm * max), without a host sync
        clipped = norm >= self.max_norm
        for g in grads:
            g.copy_(torch.where(clipped, g / norm * self.max_norm, g))
        for group in self.param_groups:
            group["lr"] = self.schedule(self.count)
        self.count += 1
        return super().step(closure)


def lm_optimizer(
    learning_rate: float = 3e-4,
    warmup_steps: int = 1000,
    decay_steps: int = 100_000,
    weight_decay: float = 0.1,
    b1: float = 0.9,
    b2: float = 0.95,
    grad_clip_norm: float = 1.0,
) -> Optimizer:
    """AdamW with linear warmup -> cosine decay (to a tenth of the peak)
    and global-norm gradient clipping: the reference's transformer-LM
    recipe (reference train.py:124-148). The benchmark keeps SGD; a real
    training run passes this as `tx`."""
    schedule = warmup_cosine_decay(
        learning_rate, warmup_steps, decay_steps, learning_rate * 0.1
    )
    return functools.partial(
        ClippedAdamW, schedule=schedule, max_norm=grad_clip_norm,
        betas=(b1, b2), eps=1e-8, weight_decay=weight_decay,
    )


def _next_token_metrics(pair_fn: Callable, logits: torch.Tensor,
                        tokens: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked next-token (loss, accuracy): the targets are the token grid
    rolled left by one; the loss kernel runs on all batch*seq rows and the
    wrapped final position is then masked out of both metrics, over
    batch*(seq - 1)."""
    b, s, v = logits.shape
    targets = torch.roll(tokens, -1, dims=1)
    losses, correct = pair_fn(logits.reshape(b * s, v), targets.reshape(-1))
    mask = (torch.arange(s, device=logits.device) < s - 1)[None, :]
    denom = b * (s - 1)
    loss = torch.where(mask, losses.view(b, s), 0.0).sum() / denom
    accuracy = torch.where(mask, correct.view(b, s), False).sum() / denom
    return loss, accuracy


def _lm_pair_fn(state: TrainState, loss_fn: Callable | None,
                metrics_fn: Callable | None) -> Callable:
    if loss_fn is not None and metrics_fn is not None:
        raise ValueError("pass loss_fn or metrics_fn, not both")
    if loss_fn is not None:
        def pair_fn(flat, targets):
            return loss_fn(flat, targets), flat.argmax(dim=-1) == targets

        return pair_fn
    device = next(state.model.parameters()).device
    return metrics_fn or _default_metrics_fn(device)


def _unported_lm_options(mesh, seq_axis, forward_fn) -> None:
    for name, value in (("mesh", mesh), ("seq_axis", seq_axis),
                        ("forward_fn", forward_fn)):
        if value is not None:
            raise NotImplementedError(
                f"{name} (the mesh, ring attention and the pipeline) is not "
                "ported yet: ROADMAP.md queue 1, item 4b"
            )


def make_lm_train_step(
    state: TrainState,
    seq_axis: str | None = None,
    loss_fn: Callable | None = None,
    metrics_fn: Callable | None = None,
    forward_fn: Callable | None = None,
    grad_accum: int = 1,
    mesh=None,
) -> Callable[[torch.Tensor], dict]:
    """Causal-LM train step: tokens (batch, seq) -> {"loss", "accuracy"},
    updating `state` in place.

    `metrics_fn` ((flat_logits, labels) -> (losses, correct); default K1
    on the card) gives loss and accuracy from one pass over the logits; a
    plain `loss_fn` is accepted for custom losses and then pays its own
    argmax. `grad_accum` > 1 splits the batch into that many equal
    microbatches, sums their gradients and divides by `grad_accum` before
    the one optimizer update: exact for the dense LM, whose loss is a
    mean over equal chunks; a MoE LM's router losses are batch statistics,
    so each chunk adds its own and they are averaged, as the reference
    documents. The metrics stay on the device."""
    _unported_lm_options(mesh, seq_axis, forward_fn)
    if grad_accum < 1:
        raise ValueError(f"grad_accum {grad_accum} must be >= 1")
    pair_fn = _lm_pair_fn(state, loss_fn, metrics_fn)
    params = [p for p in state.model.parameters() if p.requires_grad]

    def step(tokens: torch.Tensor) -> dict:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        b = tokens.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} not divisible by grad_accum {grad_accum}")
        loss_sum = acc_sum = 0.0
        aux_sum = None
        for chunk in tokens.reshape(grad_accum, b // grad_accum, -1):
            logits = state.model(chunk)
            loss, accuracy = _next_token_metrics(pair_fn, logits, chunk)
            aux = _moe_aux_total(state.model)
            (loss if aux is None else loss + aux).backward()
            loss_sum = loss_sum + loss.detach()
            acc_sum = acc_sum + accuracy
            if aux is not None:
                aux_sum = aux.detach() + (0.0 if aux_sum is None else aux_sum)
        if grad_accum > 1:
            # the mean of chunk means is the full-batch mean
            for p in params:
                if p.grad is not None:
                    p.grad.div_(grad_accum)
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss_sum / grad_accum, "accuracy": acc_sum / grad_accum}
        if aux_sum is not None:
            metrics["router_loss"] = aux_sum / grad_accum
        return metrics

    return step


def make_lm_eval_step(
    state: TrainState,
    seq_axis: str | None = None,
    metrics_fn: Callable | None = None,
    mesh=None,
) -> Callable[[torch.Tensor], dict]:
    """Gradient-free LM evaluation: tokens -> {"loss", "accuracy"}, by the
    same masked next-token arithmetic and kernel as the train step,
    without the backward or the update, and without the router losses
    (the reference's eval collects none). exp(loss) is the perplexity."""
    _unported_lm_options(mesh, seq_axis, None)
    pair_fn = _lm_pair_fn(state, None, metrics_fn)

    @torch.no_grad()
    def eval_step(tokens: torch.Tensor) -> dict:
        state.model.eval()
        logits = state.model(tokens, train=False)
        loss, accuracy = _next_token_metrics(pair_fn, logits, tokens)
        return {"loss": loss, "accuracy": accuracy}

    return eval_step
