"""Stride-1 1x1 convolution with a fused backward: the port of
`tritonk8ssupervisor_tpu/ops/conv_backward.py::conv1x1` (:149-190).

`conv1x1(x, weight, compute_dtype)` takes the port's NCHW activations
(channels_last memory) and its (N, C, 1, 1) f32 weight. The forward is
the same `F.conv2d` as the plain `models/resnet.Conv`. The backward is
K4's function: with X (M, C) and dY (M, N) the activations as rows and W
(N, C) the weight,

    dX = dY W    (f32 sums of compute-dtype products, rounded to the
                  compute dtype, then to x's dtype)
    dW = dY^T X  (f32, returned as it was summed)

so dW is f32 straight from the accumulator, where the plain `Conv`'s
cuDNN backward gives a bf16 weight gradient that autograd upcasts: the
two models' gradients differ slightly, as the JAX package's do.

On CPU tensors the backward is the plain version
(`conv1x1_backward_plain`). On CUDA tensors it launches kernel K4 for
every M, on the instance `conv_backward_cuda.instance` names from the
compute dtype and widths alone: the wgmma kernels
(`csrc/conv_backward.cu`) for bf16 and fp16 at widths that are multiples
of 8, the TF32 kernels (`csrc/conv_backward_tf32.cu`: TF32 wgmma, every
f32 product split into three, "tf32x3", and one exact product of bf16 or
fp16 values at any other width, "tf32x1"; contractions shorter than 16 as
f32 FMAs).
What K4 does not take (another compute dtype, a mismatched device)
raises, and nothing falls back to the plain version or to the other
instance.

K4 is bound as the `torch.library` custom op `tk8s::conv1x1_bwd`, with a
fake implementation and a FLOP formula of 4 M C N (the two products), so
`utils/perf.flops_per_step` counts the fused backward as it counts
cuDNN's. X and dY are read in place when they are channels_last-dense
and 16-byte aligned; otherwise they are copied, and each copy is counted
in `conv1x1_backward.copies`. dX comes back channels_last-dense.

The reference's tile picker and its XLA-dot fallback (`_pick_tm`) tile
the TPU and are not ported: K4 masks a ragged last row tile.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from tritonk8ssupervisor_tpu_torch.ops import conv_backward_cuda


def backward_cost(m: int, c: int, n: int, elem: int) -> tuple[int, int]:
    """(bytes, operations) of one K4 call on X (M, C), dY (M, N), W (N,
    C) of `elem` bytes an element (4 for an f32 compute dtype): the three
    read once, dX written once in their dtype and dW once in f32; two
    products of 2 * M * C * N. `chip_smoke.py`'s bound and
    `utils/roofline.py` both read it."""
    n_bytes = elem * (m * c + m * n + n * c) + elem * m * c + 4 * n * c
    return n_bytes, 4 * m * c * n


def conv1x1_backward_plain(x2, dy2, w, compute_dtype):
    """K4's semantics in plain torch: X (M, C), dY (M, N), W (N, C) ->
    (dX (M, C) in x2's dtype, dW (N, C) f32). Each operand is rounded to
    the compute dtype and then upcast, so the products are summed in f32
    over compute-dtype values (the reference's preferred_element_type)."""
    x, dy, wc = (t.to(compute_dtype).float() for t in (x2, dy2, w))
    dx = (dy @ wc).to(compute_dtype).to(x2.dtype)
    return dx, dy.t() @ x


def conv1x1_backward_f64(x2, dy2, w2):
    """K4's function in float64 on the values of X (M, C), dY (M, N), W
    (N, C), with the magnitudes its f32 error bound reads: (dX, dW,
    |dY| |W|, |dY|^T |X|), all float64. The yardstick of the f32 route
    in tests/test_torch_kernels.py and `chip_smoke.py`; no path
    of the port calls it."""
    x, dy, w = (t.double() for t in (x2, dy2, w2))
    return dy @ w, dy.t() @ x, dy.abs() @ w.abs(), dy.abs().t() @ x.abs()


def _on_one_cuda_device(*tensors) -> bool:
    return all(t.device.type == "cuda" and t.device == tensors[0].device for t in tensors)


def _check_kernel_inputs(x2, dy2, w2) -> None:
    """Raise unless X (M, C), dY (M, N) and W (N, C) are what K4 takes."""
    tensors = (x2, dy2, w2)
    if any(t.dtype != x2.dtype for t in tensors):
        raise TypeError(f"K4 computes in one dtype for X, dY and W (float32, bf16 or fp16), "
                        f"got {[t.dtype for t in tensors]}")
    if (x2.dim() != 2 or dy2.dim() != 2 or dy2.shape[0] != x2.shape[0]
            or w2.shape != (dy2.shape[1], x2.shape[1])):
        raise ValueError(f"K4 takes X (M, C), dY (M, N), W (N, C), got "
                         f"{[tuple(t.shape) for t in tensors]}")
    route = conv_backward_cuda.instance(x2.dtype, x2.shape[1], dy2.shape[1])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("K4 reads X, dY and W as contiguous rows")
    if route.startswith("wgmma") and not all(t.data_ptr() % 16 == 0 for t in tensors):
        raise ValueError("K4's wgmma instances read X, dY and W as 16-byte aligned rows")
    if not _on_one_cuda_device(*tensors):
        raise ValueError(
            f"X on {x2.device}, dY on {dy2.device}, W on {w2.device}: K4 needs all "
            "three on one CUDA device (CPU tensors take the plain version)"
        )


def conv1x1_backward_kernel(x2, dy2, w2):
    """K4's wrapper: contiguous (M, C), (M, N), (N, C) CUDA tensors in
    one compute dtype (16-byte aligned on the wgmma instances) -> (dX (M,
    C) in that dtype, dW (N, C) f32); anything else raises. One call
    launches dgrad, wgrad and, with more than one split of M, the
    reduction; it is counted once in `conv1x1_backward_kernel.launches`
    (and in its `tf32_launches` on the TF32 instance). An empty M launches
    nothing: dX is empty and dW zero, as the reference returns."""
    _check_kernel_inputs(x2, dy2, w2)
    m, c = x2.shape
    n = dy2.shape[1]
    dx2 = torch.empty((m, c), dtype=x2.dtype, device=x2.device)
    if m == 0:
        return dx2, torch.zeros((n, c), dtype=torch.float32, device=x2.device)
    dw = torch.empty((n, c), dtype=torch.float32, device=x2.device)
    conv_backward_cuda.backward(x2, dy2, w2, dx2, dw)
    conv1x1_backward_kernel.launches += 1
    conv1x1_backward_kernel.tf32_launches += conv_backward_cuda.instance(
        x2.dtype, c, n).startswith("tf32")
    return dx2, dw


conv1x1_backward_kernel.launches = 0
conv1x1_backward_kernel.tf32_launches = 0  # of `launches`, those on the TF32 instance


@torch.library.custom_op(
    "tk8s::conv1x1_bwd", mutates_args=(), device_types="cuda",
    schema="(Tensor x, Tensor dy, Tensor w) -> (Tensor, Tensor)",
)
def _conv1x1_bwd(x, dy, w):
    return conv1x1_backward_kernel(x, dy, w)


@_conv1x1_bwd.register_fake
def _(x, dy, w):
    return x.new_empty(x.shape), w.new_empty(w.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.tk8s.conv1x1_bwd)
def _bwd_flops(x_shape, dy_shape, w_shape, *args, **kwargs) -> int:
    m, c = x_shape
    return 4 * m * c * dy_shape[1]


def _rows(t: torch.Tensor) -> torch.Tensor:
    """An NCHW tensor as its (B*H*W, C) rows: a view when its memory is
    channels_last-dense and 16-byte aligned, else a counted copy (fresh
    memory, so aligned)."""
    rows = t.permute(0, 2, 3, 1)
    if not (rows.is_contiguous() and t.data_ptr() % 16 == 0):
        rows = rows.contiguous()
        conv1x1_backward.copies += 1
    return rows.view(-1, t.shape[1])


def conv1x1_backward(x, weight, dy, compute_dtype):
    """(dx, dweight) of `conv1x1`: x (B, C, H, W), weight (N, C, 1, 1), dy
    (B, N, H, W) -> dx like x (channels_last memory) in x's dtype, dweight
    (N, C, 1, 1) f32. The plain version on CPU tensors, K4 on CUDA ones."""
    b, c, h, w_ = x.shape
    n = weight.shape[0]
    on_cpu = all(t.device.type == "cpu" for t in (x, weight, dy))
    if not (on_cpu or _on_one_cuda_device(x, weight, dy)):
        raise ValueError(
            f"x on {x.device}, weight on {weight.device}, dy on {dy.device}: K4 "
            "needs all three on one CUDA device (CPU tensors take the plain version)"
        )
    x2 = _rows(x.to(compute_dtype))
    dy2 = _rows(dy.to(compute_dtype))
    w2 = weight.to(compute_dtype).reshape(n, c)
    if on_cpu:
        dx2, dw = conv1x1_backward_plain(x2, dy2, w2, compute_dtype)
    else:
        dx2, dw = torch.ops.tk8s.conv1x1_bwd(x2, dy2, w2)
    dx = dx2.view(b, h, w_, c).permute(0, 3, 1, 2).to(x.dtype)
    return dx, dw.view(n, c, 1, 1)


conv1x1_backward.copies = 0


class _Conv1x1(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, compute_dtype):
        # the reference keeps (x, kernel): the input and the f32 weight
        ctx.save_for_backward(x, weight)
        ctx.compute_dtype = compute_dtype
        return F.conv2d(x.to(compute_dtype), weight.to(compute_dtype))

    @staticmethod
    def backward(ctx, dy):
        x, weight = ctx.saved_tensors
        dx, dw = conv1x1_backward(x, weight, dy, ctx.compute_dtype)
        return dx, dw.to(weight.dtype), None


def conv1x1(x, weight, compute_dtype=torch.bfloat16):
    """Stride-1 1x1 convolution whose backward is K4's function.

    Args:
      x: (B, C, H, W) activations (any float dtype; channels_last memory
        lets K4 read them in place).
      weight: (N, C, 1, 1) parameters (the plain `Conv`'s layout and name).
      compute_dtype: the products' input dtype (the model's dtype: bf16 by
        default; float32, bf16 or fp16 on the card).

    Returns (B, N, H, W) in compute_dtype, like the plain `Conv`.
    """
    return _Conv1x1.apply(x, weight, compute_dtype)
