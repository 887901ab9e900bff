"""Decoder-only Transformer LM: the port of
`tritonk8ssupervisor_tpu/models/transformer.py`.

- Tokens (batch, seq) int -> logits (batch, seq, vocab), in
  `logits_dtype` (bf16 by default, as the reference: the loss kernel K1
  upcasts per row).
- The reference's dtype policy is written out as explicit casts: every
  parameter is f32; `Dense` casts its kernel and bias to `dtype` per call
  (flax `nn.Dense(dtype=bf16, param_dtype=f32)`); `LayerNorm` reduces in
  f32 with flax's defaults (epsilon 1e-6, variance as E[x^2] - E[x]^2)
  and returns `dtype`; GELU is the tanh approximation (flax `nn.gelu`).
- Submodule and parameter names are the flax names (`tok_embed`,
  `pos_embed`, `Block_3`, `LayerNorm_0`, `qkv`, `proj`, `mlp_up`,
  `mlp_down`, `lm_head`), so `utils/convert.py` carries the reference's
  parameters one to one; `_HeadMajorQKV` and `_HeadMajorProj` hold the
  same (out, in) weights as the `Dense` they replace.
- `attention_fn(q, k, v, causal=..., layout=...)` is pluggable:
  `dense_attention` (the default, plain torch),
  `ops/flash_attention.flash_attention` (kernel K2 on the card), or
  under sequence parallelism a closure over
  `ops/ring_attention.ring_attention` (seq-major only), with the
  forward's `pos_offset` the shard's global position.
- Initialisation is the port's own, from an explicit `torch.Generator`
  (lecun-normal kernels, zero biases, N(0, 1/embed) token embedding,
  N(0, 0.02^2) position embedding); it does not reproduce JAX's bits.

- `moe_experts > 0` makes every `moe_every`-th block (the 2nd, 4th, ...)
  a mixture-of-experts block (`models/moe.py`); its router loss is
  kept as the block's `moe_mlp.router_loss`, which the train steps fold
  into the objective.
- While a torch profiler runs, the sublayers are profiler ranges
  (`obs/trace.annotate`), disjoint so that their times add up:
  `model.embed`, `model.norm` (each `LayerNorm`), `model.attention` (qkv
  through the output projection and the residual add), `model.mlp` (the
  MLP or MoE MLP and its residual add) and `model.head`.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tritonk8ssupervisor_tpu_torch.models.moe import MoEMLP
from tritonk8ssupervisor_tpu_torch.models.resnet import lecun_normal_
from tritonk8ssupervisor_tpu_torch.obs.trace import annotate
from tritonk8ssupervisor_tpu_torch.ops.ring_attention import (
    attention_reference_layout,
)

# attention_fn(q, k, v, causal=..., layout="bshd"|"bhsd") -> out
AttentionFn = Callable[..., Any]

_LN_EPSILON = 1e-6  # flax nn.LayerNorm's default


def dense_attention(q, k, v, causal: bool = True, layout: str = "bshd"):
    """Dense attention in plain torch (the reference's default strategy)."""
    return attention_reference_layout(q, k, v, causal, layout)


def dense(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
          dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.Dense(dtype=dtype, param_dtype=f32)` on a (out, in) weight:
    the weight and bias cast to `dtype` per call."""
    return F.linear(x.to(dtype), weight.to(dtype), bias.to(dtype))


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """flax `nn.LayerNorm(dtype=dtype, param_dtype=f32)`: statistics in f32
    as E[x] and E[x^2] - E[x]^2 (clamped at 0), epsilon 1e-6, result in
    `dtype`."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = ((xf * xf).mean(dim=-1, keepdim=True) - mean * mean).clamp(min=0.0)
    mul = torch.rsqrt(var + _LN_EPSILON) * weight
    return ((xf - mean) * mul + bias).to(dtype)


def _default_generator(generator: torch.Generator | None) -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


class Dense(nn.Module):
    """flax `nn.Dense(features, dtype, param_dtype=f32)`: f32 weight
    (out, in) and bias, computed in `dtype`."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features))
        lecun_normal_(self.weight.data, in_features, _default_generator(generator))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return dense(x, self.weight, self.bias, self.dtype)


class LayerNorm(nn.Module):
    """flax `nn.LayerNorm(dtype, param_dtype=f32)`: statistics in f32 as
    E[x] and E[x^2] - E[x]^2 (clamped at 0), epsilon 1e-6, f32 scale
    (`weight`) and bias, result in `dtype`."""

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with annotate("model.norm"):
            return layer_norm(x, self.weight, self.bias, self.dtype)


class _HeadMajorQKV(nn.Module):
    """The qkv projection producing (b, h, s, d) q/k/v directly: the same
    (3e, e) weight and (3e,) bias as `Dense(e, 3e)`, read per head, so the
    head-major layout comes out of the product."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.bias = nn.Parameter(torch.zeros(3 * embed_dim))
        lecun_normal_(self.weight.data, embed_dim, _default_generator(generator))
        self.num_heads = num_heads
        self.dtype = dtype

    def forward(self, y: torch.Tensor):
        e = y.shape[-1]
        h = self.num_heads
        w = self.weight.to(self.dtype).view(3, h, e // h, e)
        out = torch.einsum("bse,khde->kbhsd", y.to(self.dtype), w)
        out = out + self.bias.to(self.dtype).view(3, 1, h, 1, e // h)
        return out[0], out[1], out[2]


class _HeadMajorProj(nn.Module):
    """The attention output projection contracting straight from
    (b, h, s, d): the same (e, e) weight and (e,) bias as `Dense(e, e)`."""

    def __init__(self, embed_dim: int, dtype: torch.dtype,
                 generator: torch.Generator | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(embed_dim, embed_dim))
        self.bias = nn.Parameter(torch.zeros(embed_dim))
        lecun_normal_(self.weight.data, embed_dim, _default_generator(generator))
        self.dtype = dtype

    def forward(self, attn: torch.Tensor) -> torch.Tensor:
        _, h, _, d = attn.shape
        w = self.weight.to(self.dtype).view(h * d, h, d)
        return torch.einsum("bhsd,ehd->bse", attn, w) + self.bias.to(self.dtype)


class Block(nn.Module):
    """Pre-norm transformer block: x + attn(LN(x)), then x + MLP(LN(x))."""

    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        attention_fn: AttentionFn,
        mlp_ratio: int,
        dtype: torch.dtype,
        causal: bool = True,
        head_major: bool = False,
        moe_experts: int = 0,
        moe_k: int = 2,
        moe_capacity_factor: float = 1.25,
        moe_mesh=None,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = _default_generator(generator)
        e = embed_dim
        self.num_heads = num_heads
        self.attention_fn = attention_fn
        self.causal = causal
        self.head_major = head_major
        self.LayerNorm_0 = LayerNorm(e, dtype)
        if head_major:
            self.qkv = _HeadMajorQKV(e, num_heads, dtype, gen)
            self.proj = _HeadMajorProj(e, dtype, gen)
        else:
            self.qkv = Dense(e, 3 * e, dtype, gen)
            self.proj = Dense(e, e, dtype, gen)
        self.LayerNorm_1 = LayerNorm(e, dtype)
        self.moe_experts = moe_experts
        if moe_experts:
            self.moe_mlp = MoEMLP(e, moe_experts, mlp_ratio, moe_k, moe_capacity_factor,
                                  dtype=dtype, mesh=moe_mesh, generator=gen)
        else:
            self.mlp_up = Dense(e, mlp_ratio * e, dtype, gen)
            self.mlp_down = Dense(mlp_ratio * e, e, dtype, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, s, e = x.shape
        y = self.LayerNorm_0(x)
        with annotate("model.attention"):
            if self.head_major:
                q, k, v = self.qkv(y)
                attn = self.attention_fn(q, k, v, causal=self.causal, layout="bhsd")
                x = x + self.proj(attn)
            else:
                # views of the one projection: K2 reads them in place
                q, k, v = (t.view(b, s, self.num_heads, e // self.num_heads)
                           for t in self.qkv(y).split(e, dim=-1))
                attn = self.attention_fn(q, k, v, causal=self.causal)
                x = x + self.proj(attn.reshape(b, s, e))
        y = self.LayerNorm_1(x)
        with annotate("model.mlp"):
            if self.moe_experts:
                return x + self.moe_mlp(y)
            y = F.gelu(self.mlp_up(y), approximate="tanh")
            return x + self.mlp_down(y)


class TransformerLM(nn.Module):
    """Causal LM: tokens (batch, seq) int -> logits (batch, seq, vocab)."""

    def __init__(
        self,
        vocab_size: int = 32000,
        num_layers: int = 4,
        num_heads: int = 8,
        embed_dim: int = 512,
        mlp_ratio: int = 4,
        max_seq_len: int = 2048,
        attention_fn: AttentionFn = dense_attention,
        dtype: torch.dtype = torch.bfloat16,
        logits_dtype: torch.dtype = torch.bfloat16,
        moe_experts: int = 0,
        moe_every: int = 2,
        moe_k: int = 2,
        moe_capacity_factor: float = 1.25,
        moe_mesh=None,
        remat_blocks: bool = False,
        head_major: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        gen = _default_generator(generator)
        # the flax module's hyperparameters, which models/decode.py reads
        self.vocab_size = vocab_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.embed_dim = embed_dim
        self.mlp_ratio = mlp_ratio
        self.max_seq_len = max_seq_len
        self.dtype = dtype
        self.logits_dtype = logits_dtype
        self.remat_blocks = remat_blocks
        self.head_major = head_major
        self.attention_fn = attention_fn
        self.moe_experts = moe_experts
        self.moe_every = moe_every
        self.tok_embed = nn.Embedding(vocab_size, embed_dim)
        self.pos_embed = nn.Parameter(torch.empty(max_seq_len, embed_dim))
        with torch.no_grad():
            self.tok_embed.weight.normal_(0.0, 1.0 / math.sqrt(embed_dim), generator=gen)
            self.pos_embed.normal_(0.0, 0.02, generator=gen)
        for i in range(num_layers):
            moe_here = moe_experts and (i + 1) % moe_every == 0
            self.add_module(f"Block_{i}", Block(
                embed_dim, num_heads, attention_fn, mlp_ratio, dtype,
                head_major=head_major, moe_experts=moe_experts if moe_here else 0,
                moe_k=moe_k, moe_capacity_factor=moe_capacity_factor, moe_mesh=moe_mesh,
                generator=gen,
            ))
        self.LayerNorm_0 = LayerNorm(embed_dim, dtype)
        self.lm_head = Dense(embed_dim, vocab_size, logits_dtype, gen)

    def forward(self, tokens: torch.Tensor, train: bool = True,
                pos_offset: int = 0) -> torch.Tensor:
        """`train` is accepted for the reference's signature; the LM has no
        dropout or batch statistics, so both modes compute the same.

        `pos_offset` is the global position of `tokens`' first column: a
        rank that holds a shard of the sequence (sequence parallelism,
        with a ring `attention_fn`) reads `pos_embed` at its own
        positions, as the reference's global array does."""
        s = tokens.shape[1]
        with annotate("model.embed"):
            pos = self.pos_embed[pos_offset:pos_offset + s]
            x = self.tok_embed(tokens).to(self.dtype) + pos.to(self.dtype)
        remat = self.remat_blocks and self.training and torch.is_grad_enabled()
        for i in range(self.num_layers):
            block = getattr(self, f"Block_{i}")
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        x = self.LayerNorm_0(x)
        with annotate("model.head"):
            return self.lm_head(x)
