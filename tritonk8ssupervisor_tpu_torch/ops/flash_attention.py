"""Fused (flash) attention: the port of
`tritonk8ssupervisor_tpu/ops/flash_attention.py::flash_attention`
(:197-235).

`flash_attention(q, k, v, causal, layout)` takes (batch, seq, heads,
head_dim) inputs, or (batch, heads, seq, head_dim) with layout="bhsd",
and scales the scores by 1/sqrt(head_dim). On CPU tensors it is the
plain version (`ops/ring_attention.attention_reference_layout`). On CUDA
tensors it launches kernel K2 (`csrc/flash_attention.cu`), forward and
backward, for every sequence length: the kernel masks a ragged last
tile, so there is no dense branch. K2 reads q, k, v (and O and dO) in
place where TMA can address them, which the LM's qkv views allow; any
other view is copied first (`_kernel_view`, counted in
`flash_attention_forward.copies`). What K2 does not take (a head_dim
other than 64 or 128, a dtype other than bf16 or fp16) raises; nothing
falls back to the plain version on the card.

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

import torch
from torch.utils.flop_counter import register_flop_formula

from tritonk8ssupervisor_tpu_torch.ops import flash_attention_cuda
from tritonk8ssupervisor_tpu_torch.ops.flash_attention_cuda import HEAD_DIMS
from tritonk8ssupervisor_tpu_torch.ops.flash_attention_cuda import dims as _dims
from tritonk8ssupervisor_tpu_torch.ops.ring_attention import (
    attention_reference_layout,
)

LAYOUTS = ("bshd", "bhsd")


def _kernel_view(x: torch.Tensor) -> torch.Tensor:
    """`x` itself when K2's TMA can read it in place (unit head_dim
    stride, the other strides whole 16-byte chunks, a 16-byte aligned
    start), else a contiguous copy in fresh (aligned) memory."""
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
    if q.dtype not in flash_attention_cuda.DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"K2 takes bf16 or fp16 q, k, v, got {q.dtype}, {k.dtype}, "
            f"{v.dtype}: other dtypes on the card are a gap (ROADMAP.md "
            "queue 2, K2)"
        )
    d = _dims(q.shape, layout)[3]
    if d not in HEAD_DIMS:
        raise ValueError(
            f"K2 is built for head_dim {HEAD_DIMS}, got {d}: other widths "
            "are a gap (ROADMAP.md queue 2, K2)"
        )


def flash_attention_forward(q, k, v, causal: bool, layout: str):
    """K2's forward wrapper: (O in q's layout and dtype, (B, H, S) f32
    logsumexp). q, k and v are read in place where TMA can address them,
    else copied (each copy counted in `flash_attention_forward.copies`).
    One launch, counted in `flash_attention_forward.launches`."""
    b, h, s, _ = _dims(q.shape, layout)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel():
        views = [_kernel_view(x) for x in (q, k, v)]
        flash_attention_forward.copies += sum(y is not x for x, y in zip((q, k, v), views))
        flash_attention_cuda.forward(*views, out, lse, causal, layout)
        flash_attention_forward.launches += 1
    return out, lse


flash_attention_forward.launches = 0
flash_attention_forward.copies = 0


def flash_attention_backward(dout, q, k, v, out, lse, causal: bool, layout: str):
    """K2's backward wrapper: (dq, dk, dv), contiguous in the layout of q.
    One call launches the pre-pass, the dK/dV and the dQ kernels and is
    counted once in `flash_attention_backward.launches`."""
    dout, q, k, v, out = (_kernel_view(x) for x in (dout, q, k, v, out))
    grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device) for _ in range(3)]
    if q.numel():
        rows = torch.empty(flash_attention_cuda.rows_numel(*_dims(q.shape, layout)[:3]),
                           dtype=torch.float32, device=q.device)
        flash_attention_cuda.backward(dout, q, k, v, out, lse, rows, *grads,
                                      causal, layout)
        flash_attention_backward.launches += 1
    return tuple(grads)


flash_attention_backward.launches = 0


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


@register_flop_formula(torch.ops.tk8s.flash_attn_fwd)
def _fwd_flops(q_shape, k_shape, v_shape, causal, layout, *args, **kwargs) -> int:
    b, h, s, d = _dims(q_shape, layout)
    return 4 * b * h * d * _pairs(s, causal)


@register_flop_formula(torch.ops.tk8s.flash_attn_bwd)
def _bwd_flops(dout_shape, q_shape, k_shape, v_shape, out_shape_, lse_shape,
               causal, layout, *args, **kwargs) -> int:
    b, h, s, d = _dims(q_shape, layout)
    return 8 * b * h * d * _pairs(s, causal)


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
