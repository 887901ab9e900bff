"""K3's launcher: the ctypes binding of `csrc/decode_attention.cu`.

The kernel source says what it replaces and how it is built; this module
turns tensors into its arguments: data pointers, the (batch, window or
length, head) strides of every operand, the position (a device pointer or
one scalar), and PyTorch's current stream. The caller
(`ops/decode_attention.py`) has checked device, dtypes, widths and
alignment and allocated the output; a launch that the runtime refuses
raises here.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from tritonk8ssupervisor_tpu_torch.ops import cuda_build

SOURCE = "decode_attention.cu"
# q's dtypes the kernel is instantiated for -> their code in the C interface
DTYPES = {torch.bfloat16: 0, torch.float16: 1, torch.float32: 2}
HEAD_DIM_MULTIPLE = 16  # a key row is whole 16-byte vectors of int8
MAX_HEAD_DIM = 256
# the shared memory a block can use on the H100 (227 KB)
MAX_SMEM_BYTES = 232448

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    lib.tk8s_decode_attn_int8.argtypes = [_I, _P, _P, _P, _P, _P, _P, _I, _P, _STRIDES,
                                          _I, _I, _I, _I, _I, _F, _P]
    lib.tk8s_decode_attn_int8.restype = _I
    lib.tk8s_decode_attn_error_string.argtypes = [_I]
    lib.tk8s_decode_attn_error_string.restype = ctypes.c_char_p
    lib.tk8s_decode_attn_smem_bytes.argtypes = [_I, _I, _I]
    lib.tk8s_decode_attn_smem_bytes.restype = ctypes.c_longlong
    return lib


@functools.lru_cache(maxsize=None)
def smem_bytes(w: int, length: int, d: int) -> int:
    """Dynamic shared memory of one launch (the kernel's own count): q and
    the scores of all `w` queries over `length` positions, the value
    reduction of up to 8 queries over 8 warps, and per-query positions.
    Asked of the library once a shape."""
    return _lib().tk8s_decode_attn_smem_bytes(w, length, d)


def forward(q, k8, k_scale, v8, v_scale, pos, out, layout: str) -> None:
    """out (B, W, H, D) from q (B, W, H, D), the cache in `layout`
    ("bhld" or "blhd") and `pos`: an int, or an int32 tensor of shape
    (B,) or (B, W)."""
    lib = _lib()
    b, w, h, d = q.shape
    # (b, l, h) strides of the cache operands in either layout
    if layout == "bhld":
        cache = [(x.stride(0), x.stride(2), x.stride(1)) for x in (k8, k_scale, v8, v_scale)]
        length = k8.shape[2]
    else:
        cache = [(x.stride(0), x.stride(1), x.stride(2)) for x in (k8, k_scale, v8, v_scale)]
        length = k8.shape[1]
    if isinstance(pos, torch.Tensor):
        pos_ptr, pos_scalar = pos.data_ptr(), 0
        pos_strides = (pos.stride(0), pos.stride(1) if pos.dim() == 2 else 0)
    else:
        pos_ptr, pos_scalar, pos_strides = None, int(pos), (0, 0)
    flat = [*q.stride()[:3], *(s for st in cache for s in st), *pos_strides, *out.stride()[:3]]
    code = lib.tk8s_decode_attn_int8(
        DTYPES[q.dtype], q.data_ptr(), k8.data_ptr(), k_scale.data_ptr(), v8.data_ptr(),
        v_scale.data_ptr(), pos_ptr, pos_scalar, out.data_ptr(),
        (ctypes.c_longlong * len(flat))(*flat), b, w, h, length, d, 1.0 / d ** 0.5,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    if code != 0:
        raise RuntimeError(
            f"K3 launch failed at (B, W, H, L, D) = {(b, w, h, length, d)}: "
            f"{lib.tk8s_decode_attn_error_string(code).decode()} ({code})"
        )
