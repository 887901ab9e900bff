"""Fused (flash) attention: the port of
`tritonk8ssupervisor_tpu/ops/flash_attention.py::flash_attention`
(:197-235).

`flash_attention(q, k, v, causal, layout)` takes (batch, seq, heads,
head_dim) inputs, or (batch, heads, seq, head_dim) with layout="bhsd",
and scales the scores by 1/sqrt(head_dim). On CPU tensors it is the
plain version (`ops/ring_attention.attention_reference_layout`). On CUDA
tensors it launches kernel K2, forward and backward, for every sequence
length and every head_dim from 1 to 256, on the instance that
`flash_attention_cuda.instance` names from the dtype and head_dim alone:
bf16 and fp16 run on the wgmma kernels (`csrc/flash_attention.cu`), on the
narrowest of their 64, 128 and 256 tiles that holds the head_dim, with
the columns past it read as zeros; float32 runs on the 3xTF32 kernels
(`csrc/flash_attention_tf32.cu`), every f32 product split into three
TF32 products on the tensor cores. Both mask a ragged last tile, so there
is no dense branch. The bf16/fp16 kernels read q, k, v (and O and dO) in
place where TMA can address them, which the LM's qkv views allow; any
other view is copied first, and a head_dim that is not a multiple of 8
into rows zero-padded to one, whose outputs are sliced back
(`_kernel_view`, counted in `flash_attention_forward.copies`). The 3xTF32
kernels read any strides and any head_dim and copy nothing. What K2 does not take (a head_dim above 256, another dtype,
mixed dtypes) raises; nothing falls back to the plain version on the card
and no failure switches the instance.

K2 is bound as two `torch.library` custom ops, `tk8s::flash_attn_fwd`
and `tk8s::flash_attn_bwd`, with fake (shape) implementations, the
autograd formula (the backward op), and FLOP formulas for
`torch.utils.flop_counter`, so `utils/perf.flops_per_step` counts the
attention FLOPs of a step on the card: 4*B*H*D per (query, key) pair
forward and 8 backward (dV, dP, dQ, dK; the kernel's recompute of P is
not model work), over S*(S+1)/2 pairs when causal and S*S when not.

The reference's block-size overrides from the environment (`_env_block`,
`_bwd_blocks`) tune the TPU kernels and are not ported.
"""

from __future__ import annotations

import math

import torch
from torch.utils.flop_counter import register_flop_formula

from tritonk8ssupervisor_tpu_torch.ops import flash_attention_cuda
from tritonk8ssupervisor_tpu_torch.ops.flash_attention_cuda import dims as _dims
from tritonk8ssupervisor_tpu_torch.ops.ring_attention import (
    attention_reference_layout,
)

LAYOUTS = ("bshd", "bhsd")


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """`x` itself when K2's TMA can read it in place (unit head_dim
    stride, the other strides whole 16-byte chunks, a 16-byte aligned
    start), else a contiguous copy in fresh (aligned) memory; a head_dim
    that is not a multiple of 8 is copied into rows zero-padded to the
    next one (`flash_attention_cuda.padded_width`)."""
    d = x.shape[-1]
    if d % flash_attention_cuda.HEAD_DIM_MULTIPLE:
        padded = x.new_zeros((*x.shape[:-1], flash_attention_cuda.padded_width(d)))
        padded[..., :d] = x
        return padded
    ok = (
        x.stride(-1) == 1
        and all(s % 8 == 0 for s in x.stride()[:-1])
        and x.data_ptr() % 16 == 0
    )
    # `contiguous()` would return a dense view that starts off a line as it is
    return x if ok else x.clone(memory_format=torch.contiguous_format)


def _check_kernel_inputs(q, k, v, layout: str) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(
            f"expected q, k, v of one 4-d shape, got {tuple(q.shape)}, "
            f"{tuple(k.shape)}, {tuple(v.shape)}"
        )
    if any(x.device.type != "cuda" or x.device != q.device for x in (q, k, v)):
        raise ValueError(
            f"q on {q.device}, k on {k.device}, v on {v.device}: K2 needs "
            "all three on one CUDA device (CPU tensors take the plain version)"
        )
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"K2 takes q, k, v of one dtype (float32, bf16 or fp16), got {q.dtype}, "
            f"{k.dtype}, {v.dtype}"
        )
    # raises for another dtype or a head_dim past 256
    flash_attention_cuda.instance(q.dtype, _dims(q.shape, layout)[3])


def flash_attention_forward(q, k, v, causal: bool, layout: str):
    """K2's forward wrapper: (O in q's layout and dtype, (B, H, S) f32
    logsumexp). On the bf16/fp16 instances q, k and v are read in place
    where TMA can address them, else copied (each copy counted in
    `flash_attention_forward.copies`); the 3xTF32 instance reads them in
    place. One launch, counted in `flash_attention_forward.launches` (and
    in its `tf32_launches` on the 3xTF32 instance)."""
    b, h, s, d = _dims(q.shape, layout)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if not q.numel():
        return torch.empty(q.shape, dtype=q.dtype, device=q.device), lse
    tf32 = flash_attention_cuda.instance(q.dtype, d).startswith("tf32x3")
    views = [x if tf32 else _kernel_view(x) for x in (q, k, v)]
    flash_attention_forward.copies += sum(y is not x for x, y in zip((q, k, v), views))
    out = torch.empty(views[0].shape, dtype=q.dtype, device=q.device)
    flash_attention_cuda.forward(*views, out, lse, causal, layout, d ** -0.5)
    flash_attention_forward.launches += 1
    flash_attention_forward.tf32_launches += tf32
    # a padded head_dim's O: its first d columns
    return (out if out.shape == q.shape else out[..., :d].contiguous()), lse


flash_attention_forward.launches = 0
flash_attention_forward.tf32_launches = 0  # of `launches`, those on the 3xTF32 instance
flash_attention_forward.copies = 0


def flash_attention_backward(dout, q, k, v, out, lse, causal: bool, layout: str):
    """K2's backward wrapper: (dq, dk, dv), contiguous in the layout of q.
    One call launches the pre-pass, the dK/dV and the dQ kernels and is
    counted once in `flash_attention_backward.launches` (and in its
    `tf32_launches` on the 3xTF32 instance)."""
    shape, d = q.shape, q.shape[-1]
    tf32 = flash_attention_cuda.instance(q.dtype, d).startswith("tf32x3")
    if not tf32:
        dout, q, k, v, out = (_kernel_view(x) for x in (dout, q, k, v, out))
    grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3)]
    if q.numel():
        rows = torch.empty(flash_attention_cuda.rows_numel(*_dims(q.shape, layout)[:3]),
                           dtype=torch.float32, device=q.device)
        flash_attention_cuda.backward(dout, q, k, v, out, lse, rows, *grads,
                                      causal, layout, d ** -0.5)
        flash_attention_backward.launches += 1
        flash_attention_backward.tf32_launches += tf32
    # a padded head_dim's gradients: their first d columns
    return tuple(g if g.shape == shape else g[..., :d].contiguous() for g in grads)


flash_attention_backward.launches = 0
flash_attention_backward.tf32_launches = 0


@torch.library.custom_op(
    "tk8s::flash_attn_fwd", mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, bool causal, str layout) -> (Tensor, Tensor)",
)
def _flash_attn_fwd(q, k, v, causal, layout):
    return flash_attention_forward(q, k, v, causal, layout)


@_flash_attn_fwd.register_fake
def _(q, k, v, causal, layout):
    b, h, s, _ = _dims(q.shape, layout)
    return q.new_empty(q.shape), q.new_empty((b, h, s), dtype=torch.float32)


@torch.library.custom_op(
    "tk8s::flash_attn_bwd", mutates_args=(), device_types="cuda",
    schema="(Tensor dout, Tensor q, Tensor k, Tensor v, Tensor out, "
    "Tensor lse, bool causal, str layout) -> (Tensor, Tensor, Tensor)",
)
def _flash_attn_bwd(dout, q, k, v, out, lse, causal, layout):
    return flash_attention_backward(dout, q, k, v, out, lse, causal, layout)


@_flash_attn_bwd.register_fake
def _(dout, q, k, v, out, lse, causal, layout):
    return tuple(q.new_empty(q.shape) for _ in range(3))


def _setup_context(ctx, inputs, output):
    q, k, v, causal, layout = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.causal, ctx.layout = causal, layout


def _backward(ctx, grad_out, _grad_lse):
    q, k, v, out, lse = ctx.saved_tensors
    dq, dk, dv = torch.ops.tk8s.flash_attn_bwd(
        grad_out, q, k, v, out, lse, ctx.causal, ctx.layout
    )
    return dq, dk, dv, None, None


_flash_attn_fwd.register_autograd(_backward, setup_context=_setup_context)


def _pairs(seq: int, causal: bool) -> int:
    return seq * (seq + 1) // 2 if causal else seq * seq


def forward_cost(b: int, h: int, s: int, d: int, causal: bool,
                 elem: int) -> tuple[int, int]:
    """(bytes, operations) of K2's forward at (batch, heads, seq,
    head_dim) in a dtype of `elem` bytes (4 for the 3xTF32 instance's f32):
    q, k, v read and O written once, the f32 logsumexp written; two
    products (4 * D a pair) over the (query, key) pairs the mask keeps. d
    is the caller's head_dim, not the tile or padded width the kernel runs
    at: work on the zero columns lowers the kernel's share of this bound,
    it never raises the count. The operations are f32-accurate products
    at 4 bytes, bounded by the 3xTF32 rate (a third of dense TF32), and
    bf16/fp16 products at 2, bounded by the dense bf16 rate
    (`utils/roofline.kernel_peak_flops`).
    `chip_smoke.py`'s bound and `utils/roofline.py` both read it."""
    n = b * s * h * d
    return 4 * n * elem + b * h * s * 4, 4 * b * h * d * _pairs(s, causal)


def backward_cost(b: int, h: int, s: int, d: int, causal: bool,
                  elem: int) -> tuple[int, int]:
    """(bytes, operations) of K2's backward: q, k, v, O, dO
    and the logsumexp read, dq, dk, dv written once; five products a
    pair (the kernel recomputes P), against the model work of four that
    the FLOP counter's formula below counts; the rates as the forward's."""
    n = b * s * h * d
    return 8 * n * elem + b * h * s * 4, 10 * b * h * d * _pairs(s, causal)


@register_flop_formula(torch.ops.tk8s.flash_attn_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, causal, layout, *args, **kwargs) -> int:
    b, h, s, d = _dims(q_shape, layout)
    return 4 * b * h * d * _pairs(s, causal)


@register_flop_formula(torch.ops.tk8s.flash_attn_bwd)
def _bwd_flops(dout_shape, q_shape, k_shape, v_shape, out_shape_, lse_shape,
               causal, layout, *args, **kwargs) -> int:
    b, h, s, d = _dims(q_shape, layout)
    return 8 * b * h * d * _pairs(s, causal)


def attention_f64(q, k, v, causal: bool, layout: str):
    """The attention function in float64 on the values of q, k, v (any
    float dtype, any device; differentiable): the yardstick of the 3xTF32
    instance's error bound in tests/test_torch_kernels.py and
    `chip_smoke.py`. No path of the port calls it."""
    q, k, v = (x.double() for x in (q, k, v))
    if layout == "bhsd":
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    s, d = q.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) / math.sqrt(d)
    if causal:
        pos = torch.arange(s, device=q.device)
        scores = scores.masked_fill(pos[:, None] < pos[None, :], float("-inf"))
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(scores, dim=-1), v)
    return out.transpose(1, 2) if layout == "bhsd" else out


def flash_attention(q, k, v, causal: bool = True, layout: str = "bshd"):
    """Exact softmax attention with scale 1/sqrt(head_dim), causal or
    full, over q, k, v in `layout` ("bshd" or "bhsd"); the output has the
    inputs' layout. CPU tensors: the plain version. CUDA tensors: K2."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout={layout!r}: expected 'bshd' or 'bhsd'")
    if all(x.device.type == "cpu" for x in (q, k, v)):
        return attention_reference_layout(q, k, v, causal, layout)
    _check_kernel_inputs(q, k, v, layout)
    return torch.ops.tk8s.flash_attn_fwd(q, k, v, causal, layout)[0]
