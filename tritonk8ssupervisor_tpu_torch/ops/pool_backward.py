"""The ResNet stem's 3x3 / stride-2 / pad-1 max pool with a mask
backward: the port of `tritonk8ssupervisor_tpu/ops/pool_backward.py`.

- Forward: `F.max_pool2d(x, 3, 2, padding=1)`. Its -inf padding equals
  the reference's `finfo.min` padding for every finite input, since each
  window holds at least one real element.
- Backward: the reference's (:87-108). Each window's gradient is split
  uniformly over its tied maxima, in f32, summed onto the input in the
  reference's window order, and cast to x's dtype. `F.max_pool2d`'s own
  backward routes a window's gradient to one element instead; the two
  differ wherever a window's maximum is attained more than once, such as
  every all-zero window of post-ReLU activations.

No Pallas kernel is involved: plain torch on the CPU and on the card.
Tensors are NCHW (the port's layout inside the model) with even H and W.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _windows(xp: torch.Tensor, ho: int, wo: int) -> list[torch.Tensor]:
    """The 9 strided (di, dj) slices of the padded input, each shaped like
    the pool output."""
    return [xp[:, :, di:di + 2 * ho - 1:2, dj:dj + 2 * wo - 1:2]
            for di in range(3) for dj in range(3)]


class _MaxPool3x3S2(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return F.max_pool2d(x, 3, 2, padding=1)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        b, c, h, w = x.shape
        ho, wo = dy.shape[2], dy.shape[3]
        xp = F.pad(x, (1, 1, 1, 1), value=torch.finfo(x.dtype).min)
        wins = _windows(xp, ho, wo)
        y = wins[0]
        for win in wins[1:]:
            y = torch.maximum(y, win)
        masks = [(win == y).float() for win in wins]
        # uniform subgradient over ties; every count is at least 1
        ties = masks[0]
        for m in masks[1:]:
            ties = ties + m
        g = dy.float() / ties
        # NCHW view of channels_last memory, like x
        dxp = torch.zeros((b, h + 2, w + 2, c), dtype=torch.float32,
                          device=x.device).permute(0, 3, 1, 2)
        for k, m in enumerate(masks):
            di, dj = divmod(k, 3)
            dxp[:, :, di:di + 2 * ho - 1:2, dj:dj + 2 * wo - 1:2] += m * g
        return dxp[:, :, 1:h + 1, 1:w + 1].to(x.dtype)


def max_pool_3x3_s2(x: torch.Tensor) -> torch.Tensor:
    """3x3 / stride-2 / pad-1 max pool over NCHW, (B, C, H, W) -> (B, C,
    H//2, W//2) for even H, W, with the tie-splitting mask backward."""
    return _MaxPool3x3S2.apply(x)
