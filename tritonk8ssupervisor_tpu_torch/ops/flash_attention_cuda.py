"""K2's launcher: the ctypes binding of `csrc/flash_attention.cu` and of
its f32 instance, `csrc/flash_attention_tf32.cu`.

The kernel sources say what they replace and how they are built; this
module picks the instance an input runs on from its dtype and head_dim
alone (`instance`): the wgmma kernels at the tile width that holds the
head_dim (`tile_width`), bf16 and fp16 products for bf16 and fp16 and
3xTF32 products for float32. It turns tensors into their arguments:
data pointers, strides for either layout, and PyTorch's current stream.
The caller (`ops/flash_attention.py`) has checked device, dtype and
head_dim, padded a bf16/fp16 head_dim that is not a multiple of 8
(`padded_width`) and allocated the outputs. The bf16/fp16 instances read
and write every tile through TMA tensor maps, which take only what
`check_tma_operand` lets through; the f32 instance reads and writes any
strides. A launch that the runtime refuses raises here; nothing picks
another instance.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tritonk8ssupervisor_tpu_torch.ops import cuda_build

SOURCE = "flash_attention.cu"
TF32_SOURCE = "flash_attention_tf32.cu"
# what the wgmma kernels are instantiated for: dtype -> its code in the C
# interface, and the tile widths; a head_dim d runs on the narrowest tile
# that holds it, with the columns [d, tile) read as zeros
DTYPES = {torch.bfloat16: 0, torch.float16: 1}
# what the 3xTF32 kernels take, at head_dim 1-256 too
TF32_DTYPES = (torch.float32,)
TILE_WIDTHS = (64, 128, 256)
MAX_HEAD_DIM = TILE_WIDTHS[-1]
# TMA reads rows of whole 16-byte units: a head_dim of bf16 or fp16 that
# is not a multiple of 8 is padded to one
HEAD_DIM_MULTIPLE = 8
# the backward's work items are 128 rows of one (batch, head)
ITEM_ROWS = 128

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)


@functools.cache
def _tf32_lib() -> ctypes.CDLL:
    lib = cuda_build.load(TF32_SOURCE)
    lib.tk8s_attn_tf32_fwd.argtypes = [_I, _P, _P, _P, _P, _P, _STRIDES,
                                       _I, _I, _I, _I, _F, _P]
    lib.tk8s_attn_tf32_fwd.restype = _I
    lib.tk8s_attn_tf32_bwd.argtypes = [_I, _P, _P, _P, _P, _P, _P, _P,
                                       _P, _P, _P, _STRIDES, _I, _I, _I, _I,
                                       _F, _P]
    lib.tk8s_attn_tf32_bwd.restype = _I
    lib.tk8s_attn_tf32_error_string.argtypes = [_I]
    lib.tk8s_attn_tf32_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    lib.tk8s_attn_fwd.argtypes = [_I, _I, _I, _P, _P, _P, _P, _P, _STRIDES,
                                  _I, _I, _I, _I, _F, _P]
    lib.tk8s_attn_fwd.restype = _I
    lib.tk8s_attn_bwd.argtypes = [_I, _I, _I, _P, _P, _P, _P, _P, _P, _P,
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


def _full_strides(layout: str, *tensors: torch.Tensor):
    """(batch, seq, head, head_dim) strides of each tensor, flat."""
    flat = [s for x in tensors for s in (*_bsh(x, layout), x.stride(-1))]
    return (ctypes.c_longlong * len(flat))(*flat)


def dims(shape, layout: str) -> tuple[int, int, int, int]:
    """(batch, heads, seq, head_dim) of a q/k/v shape in `layout`."""
    if layout == "bshd":
        b, s, h, d = shape
    else:
        b, h, s, d = shape
    return b, h, s, d


def tile_width(head_dim: int) -> int:
    """The kernels' tile width for `head_dim`: the narrowest of
    `TILE_WIDTHS` that holds it. Raises above `MAX_HEAD_DIM`."""
    for tile in TILE_WIDTHS:
        if 1 <= head_dim <= tile:
            return tile
    raise ValueError(
        f"K2 takes a head_dim from 1 to {MAX_HEAD_DIM}, got {head_dim}: wider heads are "
        "outside its contract (ROADMAP.md, the kernels' limits)"
    )


def instance(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel instance that takes q, k, v of `dtype` at `head_dim`, a
    function of those two alone: "wgmma-64", "wgmma-128" or "wgmma-256"
    (the tile) for bf16 and fp16, "tf32x3-64", "tf32x3-128" or
    "tf32x3-256" for float32. Raises TypeError for any other dtype and
    ValueError for a head_dim outside 1-256."""
    if dtype not in DTYPES and dtype not in TF32_DTYPES:
        raise TypeError(
            f"K2 takes float32, bf16 or fp16 q, k, v, got {dtype}: other dtypes are "
            "outside its contract (ROADMAP.md, the kernels' limits)"
        )
    tile = tile_width(head_dim)
    return f"tf32x3-{tile}" if dtype in TF32_DTYPES else f"wgmma-{tile}"


def padded_width(head_dim: int) -> int:
    """The width K2 reads a head_dim at: the next multiple of 8 (itself
    when it is one). Narrower rows are copied into zero-padded ones."""
    return -(-head_dim // HEAD_DIM_MULTIPLE) * HEAD_DIM_MULTIPLE


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


def _raise_on_tf32(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(
            f"K2 f32 {what} launch failed: {lib.tk8s_attn_tf32_error_string(code).decode()} "
            f"({code})"
        )


def forward(q, k, v, out, lse, causal: bool, layout: str,
            scale: float | None = None) -> None:
    """O and the (B, H, S) f32 logsumexp into `out` and `lse`; the scores
    are scaled by `scale` (1/sqrt(head_dim) of the tensors' own by
    default; the caller's real head_dim where it padded them)."""
    b, h, s, d = dims(q.shape, layout)
    scale = d ** -0.5 if scale is None else scale
    if instance(q.dtype, d).startswith("tf32x3"):
        lib = _tf32_lib()
        code = lib.tk8s_attn_tf32_fwd(
            d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
            _full_strides(layout, q, k, v, out),
            b, h, s, int(causal), scale, torch.cuda.current_stream(q.device).cuda_stream,
        )
        _raise_on_tf32(lib, code, "forward")
        return
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out)):
        check_tma_operand(name, x)
    tile = tile_width(d)
    lib = _lib()
    code = lib.tk8s_attn_fwd(
        DTYPES[q.dtype], tile, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), lse.data_ptr(), _strides(layout, q, k, v, out),
        b, h, s, int(causal), scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, code, "forward")


def backward(dout, q, k, v, out, lse, rows, dq, dk, dv, causal: bool,
             layout: str, scale: float | None = None) -> None:
    """dq, dk, dv; `rows` is f32 scratch of `rows_numel` values; `scale`
    as the forward's."""
    b, h, s, d = dims(q.shape, layout)
    scale = d ** -0.5 if scale is None else scale
    if instance(q.dtype, d).startswith("tf32x3"):
        lib = _tf32_lib()
        code = lib.tk8s_attn_tf32_bwd(
            d, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            lse.data_ptr(), rows.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            _full_strides(layout, q, k, v, out, dout, dq, dk, dv),
            b, h, s, int(causal), scale, torch.cuda.current_stream(q.device).cuda_stream,
        )
        _raise_on_tf32(lib, code, "backward")
        return
    for name, x in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout),
                    ("dq", dq), ("dk", dk), ("dv", dv)):
        check_tma_operand(name, x)
    tile = tile_width(d)
    lib = _lib()
    code = lib.tk8s_attn_bwd(
        DTYPES[q.dtype], tile, d, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), dout.data_ptr(), lse.data_ptr(), rows.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _strides(layout, q, k, v, out, dout, dq, dk, dv),
        b, h, s, int(causal), scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(lib, code, "backward")
