"""The training steps: the port of `tritonk8ssupervisor_tpu/parallel/train.py`.

The reference's steps are jitted SPMD programs over a mesh; here they are
eager PyTorch, on one card or per rank of a mesh (`parallel/mesh.py`):
forward in train mode, loss and accuracy from one pass over the logits
(kernel K1 on the card), backward, optimizer step. The BatchNorm running
statistics move inside the forward. `make_train_step` is the image step;
`make_lm_train_step` and `make_lm_eval_step` are the causal-LM steps,
whose masked next-token metrics are `_next_token_metrics`; `lm_optimizer`
is the reference's AdamW recipe. Both train steps add the router losses
of a model's mixture-of-experts blocks to the objective they
differentiate (`_moe_aux_total`, the reference's), and report the data
loss without them, as the reference does; a MoE model's metrics also
carry `router_loss`.

On a mesh (`create_train_state(..., mesh=)`), each rank holds its shard
of the batch and of the sharded parameters (`parallel/spmd.py`), its
objective is its part of the global one (sums over the global
denominators), and after the backward each gradient is summed over the
axes that split the data (one bucketed all_reduce per group). Under
tensor parallelism the image step's classifier is class-sharded over
"model" and its loss is `vocab_parallel_cross_entropy`; the LM step's
`seq_axis` shards the sequence (ring attention as `attention_fn`, a halo
for the next-token shift), and its mixture-of-experts blocks rank their
slots over the whole sequence (`models/moe.py`). The LM step's
`forward_fn` hook runs the pipelined LM (`parallel/pipeline.py`).
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
    vocab_parallel_cross_entropy,
)
from tritonk8ssupervisor_tpu_torch.parallel import collectives as coll
from tritonk8ssupervisor_tpu_torch.parallel import mesh as mesh_lib
from tritonk8ssupervisor_tpu_torch.parallel import spmd

Optimizer = Callable[..., torch.optim.Optimizer]


@dataclasses.dataclass
class TrainState:
    """The reference's TrainState (step, params, batch_stats, opt_state):
    the model holds the parameters and BatchNorm statistics, the
    optimizer its momentum buffers."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    # on a mesh: the mesh, every parameter's spec (parallel/mesh.py) and
    # the model-sharded parameters' gathers (parallel/spmd.py)
    mesh: object = None
    specs: dict = dataclasses.field(default_factory=dict)
    gathers: list = dataclasses.field(default_factory=list)


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
    model: nn.Module, tx: Optimizer, device: str | torch.device | None = None,
    mesh=None, specs: dict | None = None,
) -> TrainState:
    """Move `model` to the device (the card unless `device`, or the mesh's
    device type, says otherwise) and build its optimizer with `tx`.

    With a `mesh` (every rank calls this with the same model, so the
    same weights) each rank keeps its shard of every parameter that
    `mesh.param_shardings` shards, and the optimizer state follows those
    shards. `specs` (name -> spec) replaces `mesh.param_shardings`'
    rules for a model that lays its parameters out itself (the
    pipeline's stages, `parallel/pipeline.pp_state_shardings`)."""
    if mesh is not None and device is None:
        device = mesh.device_type
    model.to(resolve_device(device))
    specs, gathers = spmd.distribute(model, mesh, specs) if mesh is not None else ({}, [])
    optimizer = tx(model.parameters())
    if mesh is not None and isinstance(optimizer, ClippedAdamW):
        optimizer.norm_groups = {
            p: mesh_lib.mesh_group(mesh, tuple(a for a in specs[n] if a))
            for n, p in model.named_parameters() if any(specs[n])}
    return TrainState(model=model, optimizer=optimizer, mesh=mesh, specs=specs,
                      gathers=gathers)


def _finish_step(state: TrainState, split_axes: tuple[str, ...]) -> None:
    """Sum the gradients over the mesh (where there is one) and update."""
    if state.mesh is not None:
        spmd.reduce_gradients(state.model, state.mesh, state.specs, split_axes)
    state.optimizer.step()
    state.step += 1


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

    On a mesh, images and labels are this rank's shard of the global
    batch (`utils/data.py`) and the metrics are the global batch's. With
    a "model" axis the classifier is class-sharded and the loss is
    `vocab_parallel_cross_entropy` (a class count the axis does not
    divide takes the data-parallel K1 path, as the reference's does); a
    custom `loss_fn` or `metrics_fn` is refused there, as the reference
    refuses it.
    """
    if loss_fn is not None and metrics_fn is not None:
        raise ValueError("pass loss_fn or metrics_fn, not both")
    mesh = state.mesh
    tp_size = mesh_lib.axis_sizes(mesh).get(mesh_lib.MODEL_AXIS, 1) if mesh is not None else 1
    if tp_size > 1 and (loss_fn is not None or metrics_fn is not None):
        raise ValueError(
            "make_train_step: custom loss/metrics functions are "
            "incompatible with model_parallelism > 1: the tp path "
            "computes the loss vocab-parallel over class-sharded logits "
            "(ops/cross_entropy.vocab_parallel_cross_entropy); a custom "
            "loss would need the gathered logits that path exists to avoid"
        )
    if loss_fn is not None:
        def loss_and_correct(logits, labels):
            return loss_fn(logits, labels), logits.argmax(dim=-1) == labels
    else:
        device = next(state.model.parameters()).device
        loss_and_correct = metrics_fn or _default_metrics_fn(device)
    split, degree = (), 1
    if mesh is not None:
        split = spmd.split_axes(mesh, None)
        degree = mesh_lib.batch_degree(mesh)
        group = mesh_lib.mesh_group(mesh, split)
    if tp_size > 1:
        classifier = state.model.classifier
        num_classes = classifier.bias.shape[0]
        if num_classes % tp_size == 0:
            model_group = mesh_lib.mesh_group(mesh, mesh_lib.MODEL_AXIS)
            if not isinstance(classifier, spmd.ClassShardedLinear):
                state.model.classifier = spmd.ClassShardedLinear(
                    classifier, model_group, num_classes)

            def loss_and_correct(logits, labels):
                return vocab_parallel_cross_entropy(logits, labels, model_group)

    def step(images: torch.Tensor, labels: torch.Tensor) -> dict:
        state.model.train()
        for _ in range(max(1, steps_per_call)):
            logits = state.model(images)
            losses, correct = loss_and_correct(logits, labels)
            loss = losses.mean()
            aux = _moe_aux_total(state.model)
            objective = loss if aux is None else loss + aux
            if mesh is not None:
                # this rank's part of the mean over the global batch
                objective = objective / degree
            state.optimizer.zero_grad(set_to_none=True)
            objective.backward()
            _finish_step(state, split)
        if mesh is None:
            metrics = {"loss": loss.detach(), "accuracy": correct.float().mean()}
        else:
            totals = coll.sum_values(torch.stack([loss.detach(), correct.float().sum()]), group)
            metrics = {"loss": totals[0] / degree,
                       "accuracy": totals[1] / (labels.shape[0] * degree)}
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
    by that learning rate, as optax's `adamw` does.

    On a mesh, `norm_groups` maps each sharded parameter to the group of
    ranks holding its other shards (`create_train_state` fills it), and
    the norm is the global arrays': each such shard's squared norm is
    summed over its group."""

    def __init__(self, params, schedule: Callable[[int], float], max_norm: float,
                 **adamw_kwargs):
        super().__init__(params, lr=schedule(0), **adamw_kwargs)
        self.schedule = schedule
        self.max_norm = max_norm
        self.count = 0
        self.norm_groups: dict = {}

    @torch.no_grad()
    def step(self, closure=None):
        params = [p for group in self.param_groups for p in group["params"]
                  if p.grad is not None]
        grads = [p.grad for p in params]
        if not grads:
            return super().step(closure)
        norms = [torch.linalg.vector_norm(g) for g in grads]
        if self.norm_groups:
            norms = [coll.sum_values(n * n, self.norm_groups[p]).sqrt()
                     if p in self.norm_groups else n for p, n in zip(params, norms)]
        norm = torch.linalg.vector_norm(torch.stack(norms))
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


@dataclasses.dataclass
class _TokenLayout:
    """Where this rank's tokens sit in the global (batch, seq) grid: the
    number of batch shards and, under sequence parallelism, the ring's
    group, its size and this rank's shard."""

    batch_shards: int = 1
    seq_group: object = None
    seq_shards: int = 1
    seq_index: int = 0


def _token_layout(mesh, seq_axis: str | None) -> _TokenLayout:
    if mesh is None:
        return _TokenLayout()
    layout = _TokenLayout(batch_shards=mesh_lib.batch_degree(mesh))
    if seq_axis is not None:
        layout.seq_group = mesh_lib.mesh_group(mesh, seq_axis)
        layout.seq_shards = mesh_lib.axes_size(mesh, seq_axis)
        layout.seq_index = mesh_lib.axis_index(mesh, seq_axis)
    return layout


def _next_token_metrics(pair_fn: Callable, logits: torch.Tensor, tokens: torch.Tensor,
                        layout: _TokenLayout | None = None
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked next-token (loss, accuracy): the targets are the token grid
    rolled left by one; the loss kernel runs on all batch*seq rows and the
    wrapped final position is then masked out of both metrics, over
    batch*(seq - 1).

    On a mesh (`layout`) the grid is this rank's shard: the sums are
    divided by the GLOBAL count, so the ranks' results add up to the
    global metrics; under sequence parallelism the rolled-in column is
    the first column of the next sequence shard (a halo from the next
    rank of the ring) and only the last global position is masked."""
    layout = layout or _TokenLayout()
    b, s, v = logits.shape
    if layout.seq_group is None:
        targets = torch.roll(tokens, -1, dims=1)
    else:
        n = layout.seq_shards
        halo = coll.ppermute(tokens[:, :1].contiguous(), layout.seq_group,
                             [(j, (j - 1) % n) for j in range(n)])
        targets = torch.cat([tokens[:, 1:], halo], dim=1)
    losses, correct = pair_fn(logits.reshape(b * s, v), targets.reshape(-1))
    global_s = s * layout.seq_shards
    positions = layout.seq_index * s + torch.arange(s, device=logits.device)
    mask = (positions < global_s - 1)[None, :]
    denom = b * layout.batch_shards * (global_s - 1)
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


def _lm_mesh(state: TrainState, mesh, seq_axis: str | None) -> None:
    """The checks the LM steps share: the reference's `mesh` argument may
    only name the state's mesh (the port shards the state when it is
    made) and a sequence axis needs a mesh. Points the model's gathers
    and MoE layers at the sequence axis (None without one)."""
    if mesh is not None and mesh is not state.mesh:
        raise ValueError("the step runs on the state's mesh: pass the mesh to "
                         "create_train_state(..., mesh=)")
    if seq_axis is not None and state.mesh is None:
        raise ValueError(f"seq_axis={seq_axis!r} needs a state made on a mesh "
                         "(create_train_state(..., mesh=))")
    for gather in state.gathers:  # "model" splits the data when it is the ring
        gather.reduce_grad = seq_axis == mesh_lib.MODEL_AXIS
    for m in state.model.modules():  # slots ranked over the whole sequence
        if isinstance(m, MoEMLP):
            m.seq_axis = seq_axis


def _global_metrics(state: TrainState, split: tuple[str, ...], loss: torch.Tensor,
                    accuracy: torch.Tensor) -> dict:
    """{"loss", "accuracy"}: on a mesh, the ranks' parts summed."""
    if state.mesh is None:
        return {"loss": loss, "accuracy": accuracy}
    totals = coll.sum_values(torch.stack([loss.detach(), accuracy.float()]),
                             mesh_lib.mesh_group(state.mesh, split))
    return {"loss": totals[0], "accuracy": totals[1]}


def _lm_forward(state: TrainState, tokens: torch.Tensor, layout: _TokenLayout,
                train: bool = True) -> torch.Tensor:
    if layout.seq_group is None:
        return state.model(tokens) if train else state.model(tokens, train=False)
    return state.model(tokens, train=train, pos_offset=layout.seq_index * tokens.shape[1])


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
    documents. The metrics stay on the device.

    On a mesh (the state's; `mesh` is the reference's argument and may
    only name that one) tokens are this rank's shard of the global
    (batch, seq) grid, split over the batch axes and, with `seq_axis`,
    the sequence over that axis (the model's `attention_fn` must then be
    the ring over it, as the reference's benchmark builds it); the
    metrics are the global ones.

    `forward_fn` ((model, tokens) -> logits) replaces the model's own
    forward: the hook `parallel/pipeline.make_pp_lm_train_step` runs the
    block stack through the pipeline with. The reference's hook takes
    the parameters and returns the sown router losses beside the
    logits; here the parameters are the model's and the router losses
    its MoE layers' (`_moe_aux_total`)."""
    _lm_mesh(state, mesh, seq_axis)
    if grad_accum < 1:
        raise ValueError(f"grad_accum {grad_accum} must be >= 1")
    pair_fn = _lm_pair_fn(state, loss_fn, metrics_fn)
    params = [p for p in state.model.parameters() if p.requires_grad]
    layout = _token_layout(state.mesh, seq_axis)
    split = spmd.split_axes(state.mesh, seq_axis) if state.mesh is not None else ()

    def step(tokens: torch.Tensor) -> dict:
        state.model.train()
        state.optimizer.zero_grad(set_to_none=True)
        b = tokens.shape[0]
        if b % grad_accum:
            raise ValueError(f"batch {b} not divisible by grad_accum {grad_accum}")
        loss_sum = acc_sum = 0.0
        aux_sum = None
        for chunk in tokens.reshape(grad_accum, b // grad_accum, -1):
            logits = (_lm_forward(state, chunk, layout) if forward_fn is None
                      else forward_fn(state.model, chunk))
            loss, accuracy = _next_token_metrics(pair_fn, logits, chunk, layout)
            aux = _moe_aux_total(state.model)
            if aux is None:
                loss.backward()
            else:  # on a mesh, this rank's part of the global router loss
                (loss + aux / (layout.batch_shards * layout.seq_shards)).backward()
            loss_sum = loss_sum + loss.detach()
            acc_sum = acc_sum + accuracy
            if aux is not None:
                aux_sum = aux.detach() + (0.0 if aux_sum is None else aux_sum)
        if grad_accum > 1:
            # the mean of chunk means is the full-batch mean
            for p in params:
                if p.grad is not None:
                    p.grad.div_(grad_accum)
        _finish_step(state, split)
        metrics = _global_metrics(state, split, loss_sum / grad_accum, acc_sum / grad_accum)
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
    (the reference's eval collects none). exp(loss) is the perplexity.
    On a mesh, as the train step."""
    _lm_mesh(state, mesh, seq_axis)
    pair_fn = _lm_pair_fn(state, None, metrics_fn)
    layout = _token_layout(state.mesh, seq_axis)
    split = spmd.split_axes(state.mesh, seq_axis) if state.mesh is not None else ()

    @torch.no_grad()
    def eval_step(tokens: torch.Tensor) -> dict:
        state.model.eval()
        logits = _lm_forward(state, tokens, layout, train=False)
        loss, accuracy = _next_token_metrics(pair_fn, logits, tokens, layout)
        return _global_metrics(state, split, loss, accuracy)

    return eval_step
