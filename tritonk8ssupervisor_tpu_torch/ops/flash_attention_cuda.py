"""K2's launcher: the ctypes binding of `csrc/flash_attention.cu`.

The kernel source says what it replaces and how it is built; this module
turns tensors into its arguments: data pointers, (batch, seq, head)
strides for either layout, and PyTorch's current stream. The caller
(`ops/flash_attention.py`) has checked device, dtype and head_dim and
allocated the outputs. Both directions read and write every tile
through TMA tensor maps, which take only what `check_tma_operand` lets
through; a launch that the runtime refuses raises here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tritonk8ssupervisor_tpu_torch.ops import cuda_build

SOURCE = "flash_attention.cu"
# what the kernel is instantiated for: dtype -> its code in the C
# interface, and head_dim
DTYPES = {torch.bfloat16: 0, torch.float16: 1}
HEAD_DIMS = (64, 128)
# the backward's work items are 128 rows of one (batch, head)
ITEM_ROWS = 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    lib.tk8s_attn_fwd.argtypes = [_I, _I, _P, _P, _P, _P, _P, _STRIDES,
                                  _I, _I, _I, _I, _F, _P]
    lib.tk8s_attn_fwd.restype = _I
    lib.tk8s_attn_bwd.argtypes = [_I, _I, _P, _P, _P, _P, _P, _P, _P,
                                  _P, _P, _P, _STRIDES, _I, _I, _I, _I,
                                  _F, _P]
    lib.tk8s_attn_bwd.restype = _I
    lib.tk8s_error_string.argtypes = [_I]
    lib.tk8s_error_string.restype = ctypes.c_char_p
    return lib


def _bsh(x: torch.Tensor, layout: str) -> tuple[int, int, int]:
    """(batch, seq, head) strides of a (B, S, H, D) or (B, H, S, D) tensor."""
    b, one, two, _ = x.stride()
    return (b, one, two) if layout == "bshd" else (b, two, one)


def _strides(layout: str, *tensors: torch.Tensor):
    flat = [s for x in tensors for s in _bsh(x, layout)]
    return (ctypes.c_longlong * len(flat))(*flat)


def dims(shape, layout: str) -> tuple[int, int, int, int]:
    """(batch, heads, seq, head_dim) of a q/k/v shape in `layout`."""
    if layout == "bshd":
        b, s, h, d = shape
    else:
        b, h, s, d = shape
    return b, h, s, d


def rows_numel(batch: int, heads: int, seq: int) -> int:
    """f32 values of the backward's scratch: per (batch, head), a
    logsumexp and a rowsum(dO * O) for each q row of the sequence padded
    to whole items."""
    return batch * heads * 2 * -(-seq // ITEM_ROWS) * ITEM_ROWS


def check_tma_operand(name: str, x: torch.Tensor) -> None:
    """Raise unless K2's TMA can address `x` in place: a unit head_dim
    stride, the other strides multiples of 8 elements (16 bytes), a
    16-byte aligned start."""
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]):
        raise ValueError(
            f"K2 reads {name} through a TMA tensor map, which needs a unit "
            f"head_dim stride and the other strides in multiples of 8 elements, got "
            f"strides {tuple(x.stride())}"
        )
    if x.data_ptr() % 16:
        raise ValueError(
            f"K2 reads {name} through a TMA tensor map, which needs a 16-byte "
            f"aligned start, got an address {x.data_ptr() % 16} bytes past one"
        )


def _raise_on(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"K2 {what} launch failed: {lib.tk8s_error_string(code).decode()} ({code})"
        )


def forward(q, k, v, out, lse, causal: bool, layout: str) -> None:
    """O and the (B, H, S) f32 logsumexp into `out` and `lse`."""
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        check_tma_operand(name, x)
    lib = _lib()
    b, h, s, d = dims(q.shape, layout)
    code = lib.tk8s_attn_fwd(
        DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), _strides(layout, q, k, v, out),
        b, h, s, int(causal), d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, code, "forward")


def backward(dout, q, k, v, out, lse, rows, dq, dk, dv, causal: bool,
             layout: str) -> None:
    """dq, dk, dv; `rows` is f32 scratch of `rows_numel` values."""
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout),
                    ("dq", dq), ("dk", dk), ("dv", dv)):
        check_tma_operand(name, x)
    lib = _lib()
    b, h, s, d = dims(q.shape, layout)
    code = lib.tk8s_attn_bwd(
        DTYPES[q.dtype], d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), rows.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(layout, q, k, v, out, dout, dq, dk, dv),
        b, h, s, int(causal), d ** -0.5, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, code, "backward")
