"""ResNet in PyTorch: the port of `tritonk8ssupervisor_tpu/models/resnet.py`.

- Public input is NHWC, as in the reference. Inside, the model runs NCHW
  in `torch.channels_last` memory (the same bytes as NHWC), so cuDNN
  picks its NHWC convolutions and the input permute is free.
- The reference's dtype policy is written out as explicit casts, not
  autocast: parameters and BatchNorm statistics are f32, convolutions
  compute in `dtype` (bf16 by default), BatchNorm statistics are reduced
  in f32 (flax `force_float32_reductions`), the pooled features are
  rounded to `dtype` as `jnp.mean` does, and the classifier runs in f32.
- Submodule names are the flax module names (`stem_conv`,
  `BottleneckBlock_3`, `Conv_1`, `BatchNorm_2`, `shortcut_norm`,
  `classifier`, ...), so `utils/convert.py` maps the reference's
  variables one to one.
- `fused_1x1_bwd` builds every stride-1 1x1 convolution as
  `FusedBwdConv1x1`, whose backward is kernel K4 on the card
  (ops/conv_backward.py); `fast_pool_bwd` takes the stem pool's mask
  backward (ops/pool_backward.py). Neither changes the parameters or
  the forward.
- Initialisation is the port's own (lecun-normal convolutions and
  classifier, zero scale on each block's last BatchNorm) from an
  explicit `torch.Generator`; it does not reproduce JAX's random bits.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from tritonk8ssupervisor_tpu_torch.ops.conv_backward import conv1x1
from tritonk8ssupervisor_tpu_torch.ops.pool_backward import max_pool_3x3_s2
from tritonk8ssupervisor_tpu_torch.parallel import collectives as coll

# flax's lecun_normal is a normal truncated at two standard deviations,
# rescaled by the std of that truncated normal so the variance is 1/fan_in
_TRUNCATED_STD = 0.87962566103423978
# the reference's BatchNorm (flax resnet.py:265-272)
_BN_MOMENTUM = 0.9
_BN_EPSILON = 1e-5


def lecun_normal_(
    tensor: torch.Tensor, fan_in: int, generator: torch.Generator
) -> torch.Tensor:
    std = (1.0 / fan_in) ** 0.5 / _TRUNCATED_STD
    return nn.init.trunc_normal_(
        tensor, 0.0, std, -2.0 * std, 2.0 * std, generator=generator
    )


def same_padding(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding of one spatial dim: (before, after). The
    extra pixel goes AFTER, so a 3x3 stride-2 conv on an even size pads
    (0, 1), where torch's symmetric `padding=1` would pad (1, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


class Conv(nn.Module):
    """flax `nn.Conv(features, kernel_size, strides, use_bias=False)`:
    f32 weight (OIHW, channels_last), computed in `dtype`, "SAME" padding
    unless explicit `padding` ((top, bottom), (left, right)) is given."""

    def __init__(
        self,
        in_features: int,
        features: int,
        kernel_size: tuple[int, int],
        strides: tuple[int, int] = (1, 1),
        padding: tuple[tuple[int, int], tuple[int, int]] | None = None,
        dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        kh, kw = kernel_size
        weight = torch.empty(features, in_features, kh, kw)
        lecun_normal_(weight, in_features * kh * kw, generator)
        self.weight = nn.Parameter(weight.contiguous(memory_format=torch.channels_last))
        self.kernel_size = (kh, kw)
        self.strides = tuple(strides)
        self.padding = padding
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.padding is None:
            pad_h = same_padding(x.shape[2], self.kernel_size[0], self.strides[0])
            pad_w = same_padding(x.shape[3], self.kernel_size[1], self.strides[1])
        else:
            pad_h, pad_w = self.padding
        if pad_h[0] == pad_h[1] and pad_w[0] == pad_w[1]:
            conv_pad = (pad_h[0], pad_w[0])
        else:
            x = F.pad(x, (pad_w[0], pad_w[1], pad_h[0], pad_h[1]))
            conv_pad = (0, 0)
        return F.conv2d(
            x.to(self.dtype), self.weight.to(self.dtype),
            stride=self.strides, padding=conv_pad,
        )


class FusedBwdConv1x1(Conv):
    """Stride-1 1x1 `Conv` whose backward is `ops/conv_backward.conv1x1`'s
    (kernel K4 on the card): the same `weight` (and the same draw from
    the generator), the same forward; dX and an f32 dW from one call."""

    def __init__(self, in_features: int, features: int,
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None):
        super().__init__(in_features, features, (1, 1), dtype=dtype, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv1x1(x, self.weight, self.dtype)


def make_conv(in_features: int, features: int, kernel_size: tuple[int, int],
              strides: tuple[int, int] = (1, 1), *, fused_1x1_bwd: bool = False,
              **kwargs) -> nn.Module:
    """The reference's conv factory (flax resnet.py:238-264): a
    `FusedBwdConv1x1` for a 1x1 stride-1 convolution when `fused_1x1_bwd`
    is set, else the plain `Conv`."""
    if fused_1x1_bwd and tuple(kernel_size) == (1, 1) and tuple(strides) == (1, 1):
        return FusedBwdConv1x1(in_features, features, **kwargs)
    return Conv(in_features, features, kernel_size, strides, **kwargs)


class BatchNorm(nn.Module):
    """flax `nn.BatchNorm(momentum=0.9, epsilon=1e-5)` over the channels
    of an NCHW tensor, with f32 scale (`weight`), bias and statistics.

    Train mode normalises with the batch's biased variance and moves the
    running statistics as `ra = 0.9 * ra + 0.1 * batch`, with the BIASED
    batch variance, as flax does. `F.batch_norm` (which reduces a bf16
    input in f32) folds the UNBIASED variance into the running variance,
    so the running variance is scaled by n/(n-1) before the call and back
    after: 0.9 * ra * k + 0.1 * var * k, divided by k, is exactly the flax
    update, with no second pass over the activations."""

    def __init__(self, features: int, zero_scale: bool = False):
        super().__init__()
        init = torch.zeros if zero_scale else torch.ones
        self.weight = nn.Parameter(init(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        # cleared while a rematerialised block is recomputed in the
        # backward, so the statistics move once per forward
        self.update_stats = True
        # the process group of the batch shards (parallel/spmd.distribute
        # sets it on a mesh): train mode then normalises over the global batch
        self.group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(
                x, self.running_mean, self.running_var, self.weight,
                self.bias, False, 0.0, _BN_EPSILON,
            )
        if self.group is not None:
            return self._global_batch_norm(x)
        n = x.numel() // x.shape[1]
        bessel = n / (n - 1)
        # copies, not the buffers: the op saves the running statistics it
        # was given for its backward, so those must not change after the
        # call (and a rematerialised recompute must save the same tensors)
        running_mean = self.running_mean.clone()
        running_var = self.running_var * bessel
        y = F.batch_norm(
            x, running_mean, running_var, self.weight, self.bias,
            True, 1.0 - _BN_MOMENTUM, _BN_EPSILON,
        )
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.copy_(running_mean)
                torch.div(running_var, bessel, out=self.running_var)
        return y

    def _global_batch_norm(self, x: torch.Tensor) -> torch.Tensor:
        """Train mode over the batch of every rank of `group`, as flax's
        BatchNorm under `jit` takes its statistics over the global batch:
        the f32 per-channel sums of x and x^2 are all-reduced (their
        gradient too), mean = E[x], biased var = E[x^2] - E[x]^2, and
        y = (x - mean) * (scale * rsqrt(var + eps)) + bias in f32, cast
        to x's dtype: flax's own arithmetic. The running statistics move
        as on one device."""
        xf = x.float()
        sums = torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))])
        sums = coll.all_reduce(sums, self.group)
        n = x.numel() // x.shape[1] * self.group.size()
        mean = sums[0] / n
        var = (sums[1] / n - mean * mean).clamp(min=0.0)
        mul = torch.rsqrt(var + _BN_EPSILON) * self.weight
        shape = (1, -1, 1, 1)
        y = ((xf - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)).to(x.dtype)
        if self.update_stats:
            with torch.no_grad():
                self.running_mean.mul_(_BN_MOMENTUM).add_(mean, alpha=1.0 - _BN_MOMENTUM)
                self.running_var.mul_(_BN_MOMENTUM).add_(var, alpha=1.0 - _BN_MOMENTUM)
        return y


class BottleneckBlock(nn.Module):
    """1x1 -> 3x3 -> 1x1 bottleneck with projection shortcut (ResNet-50)."""

    expansion = 4

    def __init__(self, in_features: int, filters: int,
                 strides: tuple[int, int] = (1, 1),
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None,
                 fused_1x1_bwd: bool = False):
        super().__init__()
        conv = functools.partial(make_conv, dtype=dtype, generator=generator,
                                 fused_1x1_bwd=fused_1x1_bwd)
        out = filters * self.expansion
        self.Conv_0 = conv(in_features, filters, (1, 1))
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3), strides)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = conv(filters, out, (1, 1))
        # zero-init the last norm's scale: the residual branch starts as
        # the identity (flax resnet.py:85-87)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True)
        self.shortcut = self.shortcut_norm = None
        if tuple(strides) != (1, 1) or in_features != out:
            self.shortcut = conv(in_features, out, (1, 1), strides)
            self.shortcut_norm = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = F.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = x
        if self.shortcut is not None:
            residual = self.shortcut_norm(self.shortcut(x))
        return F.relu(residual + y)


class BasicBlock(nn.Module):
    """3x3 -> 3x3 block (ResNet-18/34)."""

    expansion = 1

    def __init__(self, in_features: int, filters: int,
                 strides: tuple[int, int] = (1, 1),
                 dtype: torch.dtype = torch.bfloat16,
                 generator: torch.Generator | None = None,
                 fused_1x1_bwd: bool = False):
        super().__init__()
        conv = functools.partial(make_conv, dtype=dtype, generator=generator,
                                 fused_1x1_bwd=fused_1x1_bwd)
        self.Conv_0 = conv(in_features, filters, (3, 3), strides)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = conv(filters, filters, (3, 3))
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)
        self.shortcut = self.shortcut_norm = None
        if tuple(strides) != (1, 1) or in_features != filters:
            self.shortcut = conv(in_features, filters, (1, 1), strides)
            self.shortcut_norm = BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = x
        if self.shortcut is not None:
            residual = self.shortcut_norm(self.shortcut(x))
        return F.relu(residual + y)


@contextlib.contextmanager
def _frozen_stats(block: nn.Module):
    norms = [m for m in block.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def _remat_contexts(block: nn.Module):
    # (forward, recompute): the recompute in the backward must not move
    # the running statistics a second time
    return contextlib.nullcontext(), _frozen_stats(block)


class ResNet(nn.Module):
    """Configurable ResNet; `ResNet50()` is the benchmark flagship.

    Takes (N, H, W, 3) images and returns (N, num_classes) f32 logits.
    Train or eval mode is the module's own (`model.train()`,
    `model.eval()`), where flax passed `train=`.

    `matmul_1x1` and `s2d_stem` are levers of the reference that compute
    the same function as the plain convolution; they are accepted and the
    plain convolution runs. `remat_blocks` recomputes each block in the
    backward (`torch.utils.checkpoint`). `fused_1x1_bwd` takes K4 for the
    backward of every stride-1 1x1 convolution (`FusedBwdConv1x1`), and
    `fast_pool_bwd` the stem pool's tie-splitting mask backward when the
    pool's input has even height and width, as the reference chooses.
    """

    def __init__(
        self,
        stage_sizes: Sequence[int],
        block_cls: type[nn.Module],
        num_classes: int = 1000,
        num_filters: int = 64,
        dtype: torch.dtype = torch.bfloat16,
        matmul_1x1: bool = False,
        s2d_stem: bool = True,
        fused_1x1_bwd: bool = False,
        remat_blocks: bool = False,
        fast_pool_bwd: bool = False,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.remat_blocks = remat_blocks
        self.fast_pool_bwd = fast_pool_bwd
        self.stem_conv = Conv(
            3, num_filters, (7, 7), (2, 2),
            padding=((3, 3), (3, 3)), dtype=dtype, generator=generator,
        )
        self.stem_norm = BatchNorm(num_filters)
        self.block_names = []
        features = num_filters
        for stage, size in enumerate(stage_sizes):
            for block in range(size):
                strides = (2, 2) if stage > 0 and block == 0 else (1, 1)
                filters = num_filters * 2**stage
                name = f"{block_cls.__name__}_{len(self.block_names)}"
                self.add_module(name, block_cls(
                    features, filters, strides, dtype=dtype, generator=generator,
                    fused_1x1_bwd=fused_1x1_bwd,
                ))
                self.block_names.append(name)
                features = filters * block_cls.expansion
        self.classifier = nn.Linear(features, num_classes)
        with torch.no_grad():
            lecun_normal_(self.classifier.weight, features, generator)
            self.classifier.bias.zero_()

    def _block(self, block: nn.Module, x: torch.Tensor) -> torch.Tensor:
        if self.remat_blocks and self.training and torch.is_grad_enabled():
            return checkpoint(
                block, x, use_reentrant=False,
                context_fn=functools.partial(_remat_contexts, block),
            )
        return block(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> an NCHW view whose memory is channels_last
        x = x.permute(0, 3, 1, 2).to(self.dtype)
        x = F.relu(self.stem_norm(self.stem_conv(x)))
        # 3x3/2 max pool padded (1, 1) with -inf, as flax resnet.py:282-291
        if self.fast_pool_bwd and x.shape[2] % 2 == 0 and x.shape[3] % 2 == 0:
            x = max_pool_3x3_s2(x)
        else:
            x = F.max_pool2d(x, 3, 2, padding=1)
        for name in self.block_names:
            x = self._block(getattr(self, name), x)
        # jnp.mean of a bf16 array sums in f32 and rounds the mean to bf16
        x = x.mean(dim=(2, 3), dtype=torch.float32).to(self.dtype)
        # logits in f32: the loss softmax needs the dynamic range
        return self.classifier(x.float())


ResNet18 = functools.partial(ResNet, stage_sizes=(2, 2, 2, 2), block_cls=BasicBlock)
ResNet50 = functools.partial(
    ResNet, stage_sizes=(3, 4, 6, 3), block_cls=BottleneckBlock
)
