"""Vision Transformer classifier: the port of
`tritonk8ssupervisor_tpu/models/vit.py`.

images (B, H, W, C), NHWC as the port's ResNet takes them -> logits
(B, num_classes) f32. A stride-p "VALID" patch convolution in the
compute dtype with f32 parameters, a zero-initialised [CLS] token and
learned positions (cast to the compute dtype before the add), the LM's
pre-norm `Block`s with `causal=False` (and its MoE and remat levers), a
final LayerNorm, and an f32 classifier on the [CLS] position. Names are
the flax names (`patch_embed`, `cls_token`, `pos_embed`, `Block_i`,
`LayerNorm_0`, `classifier`), so `utils/convert.py` carries the
reference's parameters one to one. The default attention is
`dense_attention`, as the reference's; `ops/flash_attention.flash_attention`
(kernel K2 on the card) plugs in through `attention_fn`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tritonk8ssupervisor_tpu_torch.models.resnet import lecun_normal_
from tritonk8ssupervisor_tpu_torch.models.transformer import (
    AttentionFn,
    Block,
    Dense,
    LayerNorm,
    dense_attention,
)


class PatchEmbed(nn.Module):
    """flax `nn.Conv(features, (p, p), strides=(p, p), padding="VALID",
    dtype, param_dtype=f32)` with its bias: OIHW f32 weight, computed in
    `dtype`; NHWC in, (B, patches, features) out in row-major patch order."""

    def __init__(self, in_features: int, features: int, patch: int, dtype: torch.dtype,
                 generator: torch.Generator):
        super().__init__()
        weight = torch.empty(features, in_features, patch, patch)
        self.weight = nn.Parameter(lecun_normal_(weight, in_features * patch * patch, generator))
        self.bias = nn.Parameter(torch.zeros(features))
        self.patch = patch
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2).to(self.dtype), self.weight.to(self.dtype),
                     self.bias.to(self.dtype), stride=self.patch)
        return y.flatten(2).transpose(1, 2)


class ViT(nn.Module):
    """images (B, H, W, C) -> logits (B, num_classes); ViT-S/16 by default."""

    def __init__(
        self,
        num_classes: int = 1000,
        patch_size: int = 16,
        num_layers: int = 12,
        num_heads: int = 6,
        embed_dim: int = 384,
        mlp_ratio: int = 4,
        dtype: torch.dtype = torch.bfloat16,
        attention_fn: AttentionFn = dense_attention,
        moe_experts: int = 0,
        moe_every: int = 2,
        moe_k: int = 2,
        moe_capacity_factor: float = 1.25,
        moe_mesh=None,
        remat_blocks: bool = False,
        image_size: int = 224,
        generator: torch.Generator | None = None,
    ):
        """`image_size` sizes `pos_embed` ((image_size / patch)^2 + 1
        rows), which flax derives from the first input."""
        super().__init__()
        if image_size % patch_size:
            raise ValueError(f"image {image_size}x{image_size} not divisible by patch "
                             f"{patch_size}")
        gen = torch.Generator().manual_seed(0) if generator is None else generator
        self.num_layers = num_layers
        self.embed_dim = embed_dim
        self.patch_size = patch_size
        self.dtype = dtype
        self.moe_experts = moe_experts
        self.moe_every = moe_every
        self.remat_blocks = remat_blocks
        n = (image_size // patch_size) ** 2
        self.patch_embed = PatchEmbed(3, embed_dim, patch_size, dtype, gen)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.empty(n + 1, embed_dim))
        with torch.no_grad():
            self.pos_embed.normal_(0.0, 0.02, generator=gen)
        for i in range(num_layers):
            moe_here = moe_experts and (i + 1) % moe_every == 0
            self.add_module(f"Block_{i}", Block(
                embed_dim, num_heads, attention_fn, mlp_ratio, dtype, causal=False,
                moe_experts=moe_experts if moe_here else 0, moe_k=moe_k,
                moe_capacity_factor=moe_capacity_factor, moe_mesh=moe_mesh, generator=gen,
            ))
        self.LayerNorm_0 = LayerNorm(embed_dim, dtype)
        self.classifier = Dense(embed_dim, num_classes, torch.float32, gen)

    def forward(self, x: torch.Tensor, train: bool = True) -> torch.Tensor:
        """`train` is accepted for the reference's signature; the ViT has
        no dropout or batch statistics, so both modes compute the same."""
        b, h, w, _ = x.shape
        p = self.patch_size
        if h % p or w % p:
            raise ValueError(f"image {h}x{w} not divisible by patch {p}")
        x = self.patch_embed(x)
        cls = self.cls_token.to(self.dtype).expand(b, 1, self.embed_dim)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(self.dtype)
        remat = self.remat_blocks and self.training and torch.is_grad_enabled()
        for i in range(self.num_layers):
            block = getattr(self, f"Block_{i}")
            x = checkpoint(block, x, use_reentrant=False) if remat else block(x)
        return self.classifier(self.LayerNorm_0(x[:, 0]))  # per token: [CLS] alone
