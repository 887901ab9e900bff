"""Pipeline parallelism over the mesh's "pipe" axis: the port of
`tritonk8ssupervisor_tpu/parallel/pipeline.py`.

- The block stack's parameters lead with a stage dim P, sharded over
  "pipe": rank p holds stage p's layers (its spec is ("pipe", None, ...),
  so a checkpoint saves the stack as a DTensor sharded on dim 0 and a
  restore onto another mesh reshards it). Activations hop p -> p+1 by
  `parallel/collectives.ppermute`, whose backward sends the gradients the
  other way.
- The schedule is GPipe's fill and drain: M microbatches through P
  stages in M + P - 1 ticks. Every rank runs its stage on every tick, as
  the reference's scan does, so that every rank builds the same autograd
  graph: the backward issues the point-to-point sends in graph order, and
  a rank that wired another graph would wait on a send no peer makes.
  Stage 0's choice between a fresh microbatch and the received
  activation is therefore a `torch.where` on the stage index, never a
  Python branch.
- The pipeline's result is the last stage's outputs on every rank of the
  pipe group: the other stages' buffers masked to zeros and summed over
  the group (`reduce_from_group`). The objective built on it is the same
  on every rank of the group, as the "model" axis's is under tensor
  parallelism: the result's gradient enters the last stage once, and the
  embedding's gradient, which only stage 0 computes, is summed over the
  group (`copy_to_group`), so every rank's copy of the replicated
  parameters takes the same update. "pipe" splits no data: the gradients
  are summed over the batch axes only.

`pipeline_apply` is the schedule for any stage function; the rest runs
`TransformerLM`'s block stack through it. `create_pp_lm_state` holds the
pipelined LM as a `PipelinedLM` module whose parameters are the
reference's {"outer": ..., "stages": ...} tree, and `make_pp_lm_train_step`
plugs its forward into `parallel/train.make_lm_train_step`, which keeps
the loss masking, the metrics and the update of the dense path.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from tritonk8ssupervisor_tpu_torch.models.transformer import Block, dense, layer_norm
from tritonk8ssupervisor_tpu_torch.parallel import collectives as coll
from tritonk8ssupervisor_tpu_torch.parallel import train as train_lib
from tritonk8ssupervisor_tpu_torch.parallel.mesh import (
    PIPE_AXIS,
    axes_size,
    axis_index,
    mesh_group,
)

def pipeline_apply(
    stage_fn: Callable[[Mapping[str, torch.Tensor], torch.Tensor], torch.Tensor],
    stage_params: Mapping[str, torch.Tensor],
    microbatches: torch.Tensor,
    mesh,
    axis: str = PIPE_AXIS,
) -> torch.Tensor:
    """Run microbatches through the P-stage pipeline over `axis`.

    `stage_fn(params, x) -> y` keeps x's shape and is applied by every
    stage to its own parameters; `stage_params` is this rank's stage,
    each tensor leading with a dim of 1 (its shard of the (P, ...)
    stack); `microbatches` (M, mb, ...) is the same on every rank of the
    pipe group (mb is this rank's shard of the batch axes). Returns
    (M, mb, ...) on every rank of the group: microbatch i through
    stage_{P-1}(... stage_0(microbatches[i])).
    """
    group = mesh_group(mesh, axis)
    num_stages = axes_size(mesh, axis)
    stage = axis_index(mesh, axis)
    num_micro = microbatches.shape[0]
    params = {k: v[0] for k, v in stage_params.items()}
    device = microbatches.device
    is_first = torch.full((), stage == 0, dtype=torch.bool, device=device)
    is_last = torch.full((), stage == num_stages - 1, dtype=torch.bool, device=device)
    hop = [(i, i + 1) for i in range(num_stages - 1)]
    ticks = num_micro + num_stages - 1
    recv = torch.zeros_like(microbatches[0])
    ys = []
    for t in range(ticks):
        x_in = torch.where(is_first, microbatches[min(t, num_micro - 1)], recv)
        ys.append(stage_fn(params, x_in))
        if t < ticks - 1:  # the last tick's hop would reach no later tick
            recv = coll.ppermute(ys[-1], group, hop)
    # the last stage finishes microbatch t - (P - 1) at tick t; the earlier
    # ticks' outputs (fill) reach neither the result nor a gradient
    outputs = torch.stack(ys[num_stages - 1:])
    return coll.reduce_from_group(torch.where(is_last, outputs, 0.0), group)


# ----------------------------------------------------- LM over the pipeline


def _check_pp_model(model) -> None:
    """The reference's refusals: the stage stack holds one block
    structure (a MoE block's differs), and the stage block is seq-major."""
    if getattr(model, "moe_experts", 0):
        raise ValueError(
            "pipeline parallelism supports dense TransformerLM only: "
            f"moe_experts={model.moe_experts} makes MoE layers' parameter "
            "trees differ from dense layers', which the homogeneous stage "
            "stack cannot hold (compose ep with dp/tp instead)"
        )
    if getattr(model, "head_major", False):
        raise ValueError(
            "pipeline parallelism's stage Block is seq-major: "
            "head_major=True would silently run the wrong attention "
            "layout: build the model with head_major=False for pp"
        )


def stack_block_params(params: Mapping[str, torch.Tensor], num_layers: int
                       ) -> dict[str, torch.Tensor]:
    """`Block_i.<name>` of a TransformerLM state dict stacked into one
    `<name>` with a leading (num_layers,) dim. Inverse:
    `unstack_block_params`."""
    names = [k.removeprefix("Block_0.") for k in params if k.startswith("Block_0.")]
    return {n: torch.stack([params[f"Block_{i}.{n}"] for i in range(num_layers)])
            for n in names}


def unstack_block_params(stacked: Mapping[str, torch.Tensor], num_layers: int
                         ) -> dict[str, torch.Tensor]:
    return {f"Block_{i}.{n}": v[i] for i in range(num_layers) for n, v in stacked.items()}


def lm_stage_fn(block_module: nn.Module, remat: bool = False) -> Callable:
    """Stage function for `pipeline_apply`: the stage's layers (params
    leading with L/P) in order through one `Block` by
    `torch.func.functional_call`. `remat` recomputes each layer in the
    backward (`torch.utils.checkpoint`), as the dense model's
    `remat_blocks`."""

    def run(stage_params: Mapping[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        names = list(stage_params)
        # one unbind a stack: its backward stacks the layers' gradients once,
        # where indexing each layer would write a zero-padded stack per layer
        for tensors in zip(*(stage_params[k].unbind(0) for k in names)):
            def layer(h, params=dict(zip(names, tensors))):
                return torch.func.functional_call(block_module, params, (h,))

            x = checkpoint(layer, x, use_reentrant=False) if (
                remat and torch.is_grad_enabled()) else layer(x)
        return x

    return run


def _split(model, params: Mapping[str, torch.Tensor], num_stages: int):
    """(outer, stages): the entries outside the blocks, and the block stack
    reshaped to (P, L/P, ...)."""
    _check_pp_model(model)
    n = model.num_layers
    if n % num_stages:
        raise ValueError(f"num_layers={n} not divisible by pipeline stages {num_stages}")
    outer = {k: v for k, v in params.items() if not k.startswith("Block_")}
    stages = {k: v.reshape((num_stages, n // num_stages) + tuple(v.shape[1:]))
              for k, v in stack_block_params(params, n).items()}
    return outer, stages


def pipelined_lm_params(model, params: Mapping[str, torch.Tensor], mesh,
                        axis: str = PIPE_AXIS):
    """Split a TransformerLM state dict for the pipeline: (outer, stages,
    specs). `outer` holds the embeddings, the final LayerNorm and the head
    (replicated); `stages` the block stack reshaped to (P, L/P, ...), dim
    0 over `axis`; `specs` the spec of each, keyed "outer.<name>" and
    "stages.<name>". Raises when the axis does not divide the layers."""
    outer, stages = _split(model, params, axes_size(mesh, axis))
    specs = {**{f"outer.{k}": (None,) * v.ndim for k, v in outer.items()},
             **{f"stages.{k}": (axis,) + (None,) * (v.ndim - 1) for k, v in stages.items()}}
    return outer, stages, specs


def _stage_block(model) -> Block:
    """The stage's Block on the meta device: `functional_call` gives it
    every parameter, so it holds none of its own."""
    with torch.device("meta"):
        return Block(model.embed_dim, model.num_heads, model.attention_fn, model.mlp_ratio,
                     model.dtype)


class PipelinedLM(nn.Module):
    """The pipelined LM's parameters, the reference's {"outer": ...,
    "stages": ...}: `outer` holds `tok_embed`, `pos_embed`, `LayerNorm_0`
    and `lm_head` as TransformerLM names them, `stages` is a `Block`
    whose every parameter is the stack (P, L/P, ...) of the layers' (on a
    mesh, this rank's (1, L/P, ...)). Built from a TransformerLM's
    weights, whose hyperparameters it keeps for `make_pp_lm_forward`,
    which computes with it; like the reference's tree it has no forward
    of its own."""

    def __init__(self, model, num_stages: int):
        super().__init__()
        with torch.no_grad():
            _, stages = _split(model, dict(model.named_parameters()), num_stages)
        for name in ("vocab_size", "num_layers", "num_heads", "embed_dim", "mlp_ratio",
                     "max_seq_len", "dtype", "logits_dtype", "remat_blocks", "attention_fn",
                     "moe_experts", "head_major"):
            setattr(self, name, getattr(model, name))
        self.outer = nn.Module()
        for name in ("tok_embed", "pos_embed", "LayerNorm_0", "lm_head"):
            setattr(self.outer, name, getattr(model, name))
        self.stages = _stage_block(model)
        for name, value in stages.items():
            owner, _, leaf = name.rpartition(".")
            setattr(self.stages.get_submodule(owner), leaf, nn.Parameter(value))


def make_pp_lm_forward(model, mesh, num_microbatches: int, axis: str = PIPE_AXIS
                       ) -> Callable:
    """(outer, stages, tokens) -> logits: TransformerLM with its block
    stack pipelined over `axis`. `outer` and `stages` map the names of
    `pipelined_lm_params` to this rank's tensors. The embedding, the
    final LayerNorm and the head run outside the pipeline, on every rank
    of the pipe group, by TransformerLM's own functions; the batch must
    divide into the microbatches."""
    _check_pp_model(model)
    stage = lm_stage_fn(_stage_block(model), remat=model.remat_blocks)
    group = mesh_group(mesh, axis)

    def forward(outer: Mapping[str, torch.Tensor], stages: Mapping[str, torch.Tensor],
                tokens: torch.Tensor) -> torch.Tensor:
        b, s = tokens.shape
        m = num_microbatches
        if b % m:
            raise ValueError(f"batch {b} not divisible by microbatches {m}")
        x = torch.nn.functional.embedding(tokens, outer["tok_embed.weight"]).to(model.dtype)
        x = x + outer["pos_embed"][:s].to(model.dtype)
        # only stage 0 reads the embedding: its gradient, summed over the
        # group, reaches every rank's copy
        x = coll.copy_to_group(x, group)
        y = pipeline_apply(stage, stages, x.reshape(m, b // m, s, x.shape[-1]), mesh, axis)
        x = layer_norm(y.reshape(b, s, -1), outer["LayerNorm_0.weight"],
                       outer["LayerNorm_0.bias"], model.dtype)
        return dense(x, outer["lm_head.weight"], outer["lm_head.bias"], model.logits_dtype)

    return forward


def pp_state_shardings(model: nn.Module, mesh, axis: str = PIPE_AXIS) -> dict[str, tuple]:
    """The spec of every parameter of a `PipelinedLM`: a `stages`
    parameter whose leading dim is the pipe axis's size shards it there,
    everything else is replicated (the optimizer state follows)."""
    num_stages = axes_size(mesh, axis)
    return {name: ((axis,) + (None,) * (p.ndim - 1)
                   if name.startswith("stages.") and p.ndim and p.shape[0] == num_stages
                   else (None,) * p.ndim)
            for name, p in model.named_parameters()}


def create_pp_lm_state(model, tx, mesh, device: str | torch.device | None = None,
                       axis: str = PIPE_AXIS) -> train_lib.TrainState:
    """The TrainState of the pipelined LM made from `model` (a dense
    TransformerLM; its weights), on `mesh`: each rank keeps its stage of
    the stack, and the optimizer state follows. The specs are
    `state.specs` (the reference returns them beside the state)."""
    pp_model = PipelinedLM(model, axes_size(mesh, axis))
    return train_lib.create_train_state(pp_model, tx, device, mesh=mesh,
                                        specs=pp_state_shardings(pp_model, mesh, axis))


def make_pp_lm_train_step(state: train_lib.TrainState, num_microbatches: int,
                          axis: str = PIPE_AXIS, metrics_fn: Callable | None = None
                          ) -> Callable[[torch.Tensor], dict]:
    """Causal-LM train step with the block stack pipelined: tokens (this
    rank's batch shard) -> metrics, updating `state` in place. A thin
    `forward_fn` plugged into `parallel/train.make_lm_train_step`."""
    forward = make_pp_lm_forward(state.model, state.mesh, num_microbatches, axis)

    def forward_fn(model: PipelinedLM, tokens: torch.Tensor) -> torch.Tensor:
        # the parameters are read at each call: a restore loads them in place
        return forward(dict(model.outer.named_parameters()),
                       dict(model.stages.named_parameters()), tokens)

    return train_lib.make_lm_train_step(state, metrics_fn=metrics_fn, forward_fn=forward_fn)
