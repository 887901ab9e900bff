"""Mixture-of-experts MLP: the port of
`tritonk8ssupervisor_tpu/models/moe.py`, on one device or over a mesh.

- Routing is static-shaped, as the reference's: every (batch row,
  expert) pair has `capacity` token slots; a choice that finds its
  expert full is dropped (zero combine weight, the residual carries the
  token through).
- Dispatch and combine are products with a (batch, seq, expert,
  capacity) one-hot. On one device the reference runs the layer as plain
  einsums outside any Pallas kernel (its `_constraint_mesh` returns None),
  so the port runs the same products as `torch.einsum` (cuBLAS on the
  card).
- The router runs in f32; dispatch and combine are cast to the compute
  dtype before their products, so bf16 gates are rounded, as in the
  reference; the expert biases are added in the compute dtype.
- `top_k_dispatch` breaks ties by the lower expert index (a stable
  descending sort), as `jax.lax.top_k` does, and builds its slot one-hot
  by comparison with an `arange`: a dropped choice (slot >= capacity)
  gets a zero row, as `jax.nn.one_hot` gives, where
  `torch.nn.functional.one_hot` would raise.
- The reference sows each layer's router loss into the "moe_losses"
  collection. Here `MoEMLP.forward` keeps it as the layer's
  `router_loss`, and the train steps (`parallel/train.py`) sum it over the
  model's MoE layers right after the forward, before the backward: a
  block recomputed by `torch.utils.checkpoint` during the backward only
  overwrites the attribute, after the objective was built from the first
  forward's tensors.

- On a mesh (`mesh`, which `parallel/train.create_train_state` sets on
  every MoE layer) each rank routes its own batch rows, as capacity is
  per row. The router loss is the reference's over the global batch: the
  per-expert sums of the first-choice mask and of the probabilities, the
  token count and the z-loss sum are all-reduced over the batch axes.
  Where the expert axis shards the expert parameters (each rank holds
  E / ep experts, `parallel/mesh.param_shardings`), the dispatched
  (E, b, C, d) slots go to their experts' ranks by all_to_all over
  "expert", the rank runs its experts over the slots of every rank of
  its expert group, and a second all_to_all brings the results back
  before the combine: the reference's two all_to_alls, which XLA places
  there.
"""

from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F
from torch import nn

from tritonk8ssupervisor_tpu_torch.models.resnet import lecun_normal_
from tritonk8ssupervisor_tpu_torch.parallel import collectives as coll
from tritonk8ssupervisor_tpu_torch.parallel.mesh import (
    EXPERT_AXIS,
    axis_sizes,
    batch_axes,
    batch_degree,
    mesh_group,
)

def compute_capacity(seq_len: int, num_experts: int, k: int,
                     capacity_factor: float) -> int:
    """Token slots per (batch row, expert): ceil(cf * k * s / E), >= 1."""
    return max(1, math.ceil(capacity_factor * k * seq_len / num_experts))


def top_k_experts(probs: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the k largest probabilities, ties to the lower
    index (`jax.lax.top_k`'s order)."""
    return torch.sort(probs, dim=-1, descending=True, stable=True).indices[..., :k]


def top_k_dispatch(router_probs: torch.Tensor, k: int, capacity: int
                   ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Static-shaped top-k routing with per-(row, expert) capacity.

    router_probs (b, s, E) f32 -> (dispatch, combine, top1_mask):
    dispatch (b, s, E, C) 0/1, combine (b, s, E, C) the dispatch weighted
    by the gate renormalised over the kept choices, top1_mask (b, s, E)
    the one-hot of each token's first choice. Slots are ranked
    choice-major: every token's first choice before any second choice,
    then by position."""
    b, s, e = router_probs.shape
    idx = top_k_experts(router_probs, k)  # (b, s, k)
    gates = router_probs.gather(-1, idx)
    masks = F.one_hot(idx, e).to(router_probs.dtype)  # (b, s, k, E)

    cm = masks.transpose(1, 2).reshape(b, k * s, e)
    pos_cm = torch.cumsum(cm, dim=1) - cm
    pos = pos_cm.reshape(b, k, s, e).transpose(1, 2)  # (b, s, k, E)
    sel_pos = (pos * masks).sum(-1)  # (b, s, k)
    kept = (sel_pos < capacity).to(masks.dtype) * masks.sum(-1)

    kept_gate = gates * kept
    denom = kept_gate.sum(-1, keepdim=True).clamp(min=1e-9)
    norm_gates = kept_gate / denom

    slots = torch.arange(capacity, device=router_probs.device, dtype=sel_pos.dtype)
    slot_oh = (sel_pos[..., None] == slots).to(masks.dtype)  # (b, s, k, C)
    chosen = masks * kept[..., None]
    dispatch = torch.einsum("bske,bskc->bsec", chosen, slot_oh)
    combine = torch.einsum("bske,bskc->bsec", chosen * norm_gates[..., None], slot_oh)
    return dispatch, combine, masks[:, :, 0]


def load_balance_loss(router_probs: torch.Tensor, top1_mask: torch.Tensor) -> torch.Tensor:
    """E * sum_e(fraction routed to e * mean probability of e): 1 at a
    uniform routing (the Switch/GShard auxiliary)."""
    e = router_probs.shape[-1]
    f = top1_mask.reshape(-1, e).mean(0)
    p = router_probs.reshape(-1, e).mean(0)
    return e * torch.sum(f * p)


def _experts(x: torch.Tensor, up: torch.Tensor, up_bias: torch.Tensor,
             down: torch.Tensor, down_bias: torch.Tensor) -> torch.Tensor:
    """Every expert's FFN on its own tokens: x (E, b, C, d) -> (E, b, C, d),
    the biases added in x's dtype, the tanh GELU between."""
    h = torch.einsum("ebcd,edf->ebcf", x, up.to(x.dtype))
    h = F.gelu(h + up_bias.to(x.dtype)[:, None, None, :], approximate="tanh")
    y = torch.einsum("ebcf,efd->ebcd", h, down.to(x.dtype))
    return y + down_bias.to(x.dtype)[:, None, None, :]


class MoEMLP(nn.Module):
    """Drop-in replacement for a transformer MLP: top-k routed experts.
    The parameters keep the reference's names and layouts: router_kernel
    (d, E), expert_up_kernel (E, d, f), expert_up_bias (E, f),
    expert_down_kernel (E, f, d), expert_down_bias (E, d), all f32."""

    def __init__(self, embed_dim: int, num_experts: int, mlp_ratio: int = 4, k: int = 2,
                 capacity_factor: float = 1.25, aux_weight: float = 1e-2,
                 z_weight: float = 1e-3, dtype: torch.dtype = torch.bfloat16,
                 mesh=None, generator: torch.Generator | None = None):
        super().__init__()
        self.mesh = mesh
        d, e, f = embed_dim, num_experts, mlp_ratio * embed_dim
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        self.num_experts, self.k, self.capacity_factor = e, k, capacity_factor
        self.aux_weight, self.z_weight, self.dtype = aux_weight, z_weight, dtype
        self.router_kernel = nn.Parameter(lecun_normal_(torch.empty(d, e), d, gen))
        self.expert_up_kernel = nn.Parameter(lecun_normal_(torch.empty(e, d, f), d, gen))
        self.expert_up_bias = nn.Parameter(torch.zeros(e, f))
        self.expert_down_kernel = nn.Parameter(lecun_normal_(torch.empty(e, f, d), f, gen))
        self.expert_down_bias = nn.Parameter(torch.zeros(e, d))
        # aux_weight * load balance + z_weight * z-loss of the last forward
        self.router_loss: torch.Tensor | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.shape[1]
        capacity = compute_capacity(s, self.num_experts, self.k, self.capacity_factor)
        logits = torch.einsum("bsd,de->bse", x.float(), self.router_kernel)
        probs = torch.softmax(logits, dim=-1)
        dispatch, combine, top1 = top_k_dispatch(probs, self.k, capacity)
        # computed on every call, so that a checkpointed block's recompute
        # saves the same tensors as its first forward did
        z = torch.logsumexp(logits, dim=-1) ** 2
        if self.mesh is not None and batch_degree(self.mesh) > 1:
            lb, zl = self._global_router_losses(probs, top1, z)
        else:
            lb, zl = load_balance_loss(probs, top1), torch.mean(z)
        self.router_loss = self.aux_weight * lb + self.z_weight * zl

        xe = torch.einsum("bsec,bsd->ebcd", dispatch.to(self.dtype), x.to(self.dtype))
        params = (self.expert_up_kernel, self.expert_up_bias,
                  self.expert_down_kernel, self.expert_down_bias)
        if self.expert_up_kernel.shape[0] == self.num_experts:
            y = _experts(xe, *params)
        else:
            y = self._expert_parallel(xe, params)
        return torch.einsum("bsec,ebcd->bsd", combine.to(self.dtype), y)

    def _global_router_losses(self, probs, top1, z):
        """The load-balance and z losses over the batch of every rank of
        the batch axes: f and p from all-reduced sums (the gradient of p
        summed back), the same value on every rank."""
        e = self.num_experts
        group = mesh_group(self.mesh, batch_axes(self.mesh))
        local = torch.cat([top1.reshape(-1, e).sum(0), probs.reshape(-1, e).sum(0),
                           z.sum()[None]])
        total = coll.all_reduce(local, group)
        tokens = z.numel() * group.size()
        f, p = total[:e] / tokens, total[e:2 * e] / tokens
        return e * torch.sum(f * p), total[2 * e] / tokens

    def _expert_parallel(self, xe, params):
        """The experts of this rank (E / ep of them) over the slots of
        every rank of its expert group: all_to_all there and back."""
        group = mesh_group(self.mesh, EXPERT_AXIS)
        ep = axis_sizes(self.mesh)[EXPERT_AXIS]
        e_local = params[0].shape[0]
        if e_local * ep != self.num_experts:
            raise ValueError(
                f"{e_local} local experts on an expert axis of {ep}: the layer has "
                f"{self.num_experts} (shard it with parallel/train.create_train_state)")
        _, b, c, d = xe.shape
        # block j of dim 0: the slots of rank j's experts
        recv = coll.all_to_all(xe.reshape(ep, e_local, b, c, d), group)
        h = recv.transpose(0, 1).reshape(e_local, ep * b, c, d)
        y = _experts(h, *params).reshape(e_local, ep, b, c, d).transpose(0, 1)
        return coll.all_to_all(y.contiguous(), group).reshape(self.num_experts, b, c, d)


def moe_mlp_reference(params: Mapping[str, torch.Tensor], x: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Per-token reference for tests: MoEMLP's function with unlimited
    capacity (nothing drops), every expert applied to every token and
    picked by gate; f32. `params` holds the five MoEMLP parameters by
    name (a `MoEMLP.state_dict()`)."""
    logits = torch.einsum("bsd,de->bse", x, params["router_kernel"])
    probs = torch.softmax(logits, dim=-1)
    idx = top_k_experts(probs, k)
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
    y = _experts(x.unsqueeze(0).expand(params["router_kernel"].shape[1], *x.shape),
                 params["expert_up_kernel"], params["expert_up_bias"],
                 params["expert_down_kernel"], params["expert_down_bias"])  # (E, b, s, d)
    sel = torch.gather(y.permute(1, 2, 0, 3), 2,
                       idx[..., None].expand(*idx.shape, x.shape[-1]))  # (b, s, k, d)
    return torch.einsum("bskd,bsk->bsd", sel, gates)


def upcycle_dense_to_moe(dense_state: Mapping[str, torch.Tensor], moe_model: nn.Module,
                         generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
    """Sparse upcycling: the state dict of `moe_model` (a TransformerLM or
    ViT with moe_experts > 0) from the state dict of its dense twin (same
    depth and widths). Every expert of a MoE block starts as a copy of the
    dense block's MLP (biases too), the router is drawn fresh
    (lecun-normal, from `generator`), and every other entry carries over
    as it is. With ample capacity the upcycled model computes the dense
    one's function at step 0."""
    e = moe_model.moe_experts
    if not e:
        raise ValueError("moe_model.moe_experts must be > 0 to upcycle")
    gen = torch.Generator().manual_seed(0) if generator is None else generator
    out = dict(dense_state)
    for i in range(moe_model.num_layers):
        if (i + 1) % moe_model.moe_every:
            continue
        block = f"Block_{i}."
        up_w = out.pop(block + "mlp_up.weight")  # (f, d)
        up_b = out.pop(block + "mlp_up.bias")
        down_w = out.pop(block + "mlp_down.weight")  # (d, f)
        down_b = out.pop(block + "mlp_down.bias")
        f, d = up_w.shape
        moe = block + "moe_mlp."
        out[moe + "router_kernel"] = lecun_normal_(torch.empty(d, e), d, gen).to(up_w.device)
        out[moe + "expert_up_kernel"] = up_w.T.expand(e, d, f).clone()
        out[moe + "expert_up_bias"] = up_b.expand(e, f).clone()
        out[moe + "expert_down_kernel"] = down_w.T.expand(e, f, d).clone()
        out[moe + "expert_down_bias"] = down_b.expand(e, d).clone()
    return out
